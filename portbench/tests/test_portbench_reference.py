"""The plain reference against plain math and against torch's own modules
at tiny sizes."""

import numpy as np
import pytest
import torch

from portbench.recipes.granule import make_granule
from portbench.recipes.template import band_centers, ch4_template
from portbench.recipes.weights import make_params
from portbench.reference import mag1c, train, unet


def oracle(x, template, num_iter, alpha):
    """The reference filter's float64 numpy statement, every pixel valid."""
    b, p, s = x.shape
    tpl = template[None, None, :]

    def stats(v):
        mu = v.mean(axis=1, keepdims=True)
        vm = v - mu
        c = np.einsum("bps,bpt->bst", vm, vm) / p
        c = (1 - alpha) * c + alpha * np.eye(s)[None] * np.diagonal(c, axis1=1, axis2=2)[:, None]
        return mu, c

    mu, c = stats(x)
    target = tpl * mu
    cit = np.linalg.solve(c, target[:, 0, :, None])
    norm = np.einsum("bs,bso->bo", target[:, 0], cit)[:, None]
    r = np.einsum("bps,bs->bp", x, mu[:, 0])[..., None] / np.einsum(
        "bs,bs->b", mu[:, 0], mu[:, 0])[:, None, None]
    mf = np.maximum(np.einsum("bps,bso->bpo", x - mu, cit) / (r * norm), 0)
    for _ in range(num_iter):
        mu, c = stats(x - r * mf * target)
        target = tpl * mu
        cit = np.linalg.solve(c, target[:, 0, :, None])
        norm = np.maximum(np.einsum("bs,bso->bo", target[:, 0], cit)[:, None], 1.0)
        reg = 1.0 / (r * (mf + 1e-9))
        mf = np.maximum((np.einsum("bps,bso->bpo", x - mu, cit) - reg) / (r * norm), 0)
    return mf[..., 0] * 1e5, r[..., 0]


def test_filter_matches_the_oracle():
    rng = np.random.default_rng(0)
    x = rng.uniform(1, 3, (2, 300, 6)) + rng.normal(0, 0.02, (2, 300, 6))
    tpl = -np.abs(rng.normal(0, 1, 6))
    want_mf, want_r = oracle(x, tpl, 5, 1e-4)
    got_mf, got_r = mag1c.acrwl1mf(torch.as_tensor(x), torch.as_tensor(tpl),
                                   torch.ones(2, 300, dtype=torch.float64), num_iter=5,
                                   alpha=1e-4)
    np.testing.assert_allclose(got_r.numpy(), want_r, rtol=1e-12)
    np.testing.assert_allclose(got_mf.numpy(), want_mf, rtol=1e-9, atol=1e-6)


def test_invalid_pixels_leave_the_statistics():
    """Weights 0 act as if the pixels were absent; a ragged last block and a
    wholly invalid block come out NODATA."""
    rng = np.random.default_rng(1)
    cube = torch.as_tensor(rng.uniform(1, 3, (8, 10, 5)))
    valid = torch.ones(8, 10, dtype=torch.bool)
    valid[:, 4:8] = False
    tpl = torch.as_tensor(-np.abs(rng.normal(0, 1, 5)))
    mf, _ = mag1c.column_blocks(cube, tpl, valid, column_step=4, num_iter=3)
    assert (mf[:, 4:8] == mag1c.NODATA).all() and (mf[:, :4] != mag1c.NODATA).all()
    alone, _ = mag1c.column_blocks(cube[:, :4], tpl, valid[:, :4], column_step=4, num_iter=3)
    torch.testing.assert_close(mf[:, :4], alone, rtol=1e-12, atol=1e-9)
    tail, _ = mag1c.column_blocks(cube[:, 8:], tpl, valid[:, 8:], column_step=4, num_iter=3)
    torch.testing.assert_close(mf[:, 8:], tail, rtol=1e-12, atol=1e-9)


def test_unet_matches_torch_modules():
    """The functional U-Net against a module built from torch.nn pieces by
    the published description: the stem convolution and batch norm."""
    p = {k: v.double() for k, v in make_params(2, "cpu").items()}
    x = torch.rand(1, 4, 32, 32, dtype=torch.float64)
    conv = torch.nn.Conv2d(4, 32, 3, 2, 1, bias=False).double()
    bn = torch.nn.BatchNorm2d(32).double().eval()
    with torch.no_grad():
        conv.weight.copy_(p["encoder.features.0.0.weight"])
        for k in ("weight", "bias", "running_mean", "running_var"):
            getattr(bn, k).copy_(p[f"encoder.features.0.1.{k}"])
        want = torch.clamp(bn(conv(x)), 0, 6)
        got = unet._cbr6(x, p, "encoder.features.0", 2)
    torch.testing.assert_close(got, want)
    out = unet.unet_logits(torch.rand(2, 4, 64, 64, dtype=torch.float64), p)
    assert out.shape == (2, 1, 64, 64) and torch.isfinite(out).all()


def test_loss_and_adam_match_torch():
    gen = torch.Generator().manual_seed(4)
    logits = torch.randn(2, 1, 4, 4, dtype=torch.float64, generator=gen)
    y = (torch.rand(2, 1, 4, 4, generator=gen) > 0.5).double()
    w = torch.rand(2, 1, 4, 4, dtype=torch.float64, generator=gen)
    want = (torch.nn.functional.binary_cross_entropy_with_logits(
        logits, y, reduction="none", pos_weight=torch.tensor(15.0, dtype=torch.float64)) * w).mean()
    torch.testing.assert_close(train.weighted_bce(logits, y, w, 15.0), want)

    p = {k: v.double() for k, v in make_params(3, "cpu").items()}
    gen = torch.Generator().manual_seed(5)
    batch = {"input": torch.rand(2, 4, 32, 32, dtype=torch.float64, generator=gen) * 100,
             "output": (torch.rand(2, 1, 32, 32, generator=gen) > 0.8).double(),
             "weight_loss": torch.rand(2, 1, 32, 32, dtype=torch.float64, generator=gen)}
    model_cfg = {"input_factors": [1750.0, 60.0, 60.0, 60.0]}
    cfg = {"adam_b1": 0.9, "adam_b2": 0.999, "adam_eps": 1e-8, "lr": 1e-3, "pos_weight": 15.0}
    losses, g1, after = train.adam_steps(p, [batch, batch], model_cfg, cfg)
    names = [k for k in p if not k.endswith(("running_mean", "running_var"))]
    leaves = [p[k].clone().requires_grad_(True) for k in names]
    opt = torch.optim.Adam(leaves, lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
    for _ in range(2):
        full = {**p, **dict(zip(names, leaves))}
        x = unet.normalize_input(batch["input"], model_cfg["input_factors"])
        loss = train.weighted_bce(unet.unet_logits(x, full, train=True), batch["output"],
                                  batch["weight_loss"], 15.0)
        opt.zero_grad()
        loss.backward()
        opt.step()
    assert abs(float(loss.detach()) - losses[1]) < 1e-8 * abs(losses[1])
    # Leaves whose gradient is nought to rounding (a batch norm's shift that
    # the next batch norm removes) move by Adam's sign of round-off alone.
    median = float(np.median([float(g1[k].norm()) for k in names]))
    moved = [k for k in names if float(g1[k].norm()) >= 1e-3 * median]
    assert len(moved) > len(names) // 2
    for k, leaf in zip(names, leaves):
        if k in moved:
            torch.testing.assert_close(after[k], leaf.detach(), rtol=1e-8, atol=1e-6)


def test_rotation_judge_finds_the_angle():
    """A window rotated by a drawn angle and flipped is found with a gap at
    rounding; a shifted window is not."""
    torch.manual_seed(0)
    win = {"input": torch.rand(4, 24, 24) * 50, "weight_loss": torch.rand(1, 24, 24),
           "output": (torch.rand(1, 24, 24) > 0.7).float()}
    angle = torch.tensor([37.25], dtype=torch.float64)
    row = {k: train.rotate(v, angle, k == "output")[0].float().flip(-1) for k, v in win.items()}
    gap, ref = train.judge_row(row, win)
    assert gap < 1e-6
    torch.testing.assert_close(ref["input"].float(), row["input"], rtol=1e-5, atol=1e-4)
    shifted = {k: torch.roll(v, 1, -1) for k, v in row.items()}
    assert train.judge_row(shifted, win)[0] > 1e-2
    plain = {k: v.flip(-2) for k, v in win.items()}
    assert train.judge_row(plain, win)[0] == 0.0


def test_granule_recipe_is_seeded():
    centers = band_centers((2122.0, 2488.0), 7.4)
    assert len(centers) == 50
    tpl = ch4_template(centers, np.full_like(centers, 8.0))
    p = dict(lines=40, samples=70, plumes=2, max_concentration=4000.0, noise=0.01,
             fill_corner=[4, 10], fill_block=1, column_step=32, fill_share=0.01)
    a = make_granule(2**31 + 3, 0, tpl, p, "cpu")
    b = make_granule(2**31 + 3, 0, tpl, p, "cpu")
    c = make_granule(2**31 + 3, 1, tpl, p, "cpu")
    assert torch.equal(a["cube"], b["cube"]) and not torch.equal(a["cube"], c["cube"])
    assert not a["valid"][:, 32:64].any() and not a["valid"][:4, :10].any()
    assert 0.3 < a["valid"].float().mean() < 0.6


@pytest.mark.parametrize("seed", [0, 2**31 + 11])
def test_weights_are_seeded(seed):
    a, b = make_params(seed, "cpu"), make_params(seed, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    w = a["encoder.features.0.0.weight"]
    assert w[:, 0].abs().mean() > 100 * w[:, 1].abs().mean()
