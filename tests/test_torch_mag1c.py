"""The port's matched filter (starcop_tpu_torch.ops) against the JAX package.

Same inputs, made with numpy seeds, go through the JAX function (Pallas
kernels in interpret mode, or the plain XLA route) and its port counterpart
on the CPU, where the port's kernel wrappers run their plain torch twins.
Bars are the JAX suite's own (tests/test_mag1c.py:392-397): mf correlation
> 0.9999, threshold-500 agreement >= 0.999 with detections, albedo rtol 1e-4.
"""

import numpy as np
import pytest

import jax.numpy as jnp

torch = pytest.importorskip("torch")

import cpu_share  # noqa: E402,F401

from starcop_tpu.ops import mag1c as jm  # noqa: E402
from starcop_tpu.ops import mag1c_pallas as jp  # noqa: E402
from starcop_tpu_torch.ops import _build  # noqa: E402
from starcop_tpu_torch.ops import mag1c as tm  # noqa: E402
from starcop_tpu_torch.ops import mag1c_kernels as tk  # noqa: E402

H, W, S, NB, STEP = 128, 48, 12, 3, 16


def _cube():
    """The JAX suite's direct-swh geometry and data (tests/test_mag1c.py:346-356)."""
    rng = np.random.default_rng(11)
    template = -np.abs(np.sin(np.linspace(0.3, 3 * np.pi, S)))
    base = rng.uniform(2.0, 6.0, size=(1, 1, S))
    x = rng.uniform(0.5, 2.0, (H, W, 1)) * base * (1 + 0.02 * rng.normal(size=(H, W, S)))
    conc = np.zeros((H, W))
    conc[40:80, 10:30] = rng.uniform(1000, 6000, size=(40, 20))
    x = x * np.exp(conc[..., None] * template[None, None, :] / 1e5)
    return x.astype(np.float32), template.astype(np.float32)


def _unblock_j_major(v, h, nb, step):
    """Invert the JAX resident route's p = j*H + h order (ops/mag1c.py:649-652)."""
    return np.asarray(v)[..., 0].reshape(nb, step, h).transpose(2, 0, 1).reshape(h, nb * step)


def _assert_detection_parity(mf, ref, alb=None, alb_ref=None):
    a, b = np.asarray(mf, np.float64).ravel(), np.asarray(ref, np.float64).ravel()
    assert np.corrcoef(a, b)[0, 1] > 0.9999
    assert (b > 500).sum() > 0
    assert ((a > 500) == (b > 500)).mean() >= 0.999
    if alb is not None:
        np.testing.assert_allclose(np.asarray(alb), np.asarray(alb_ref), rtol=1e-4)


def test_init_stats_plain_matches_f64():
    x, _ = _cube()
    m0, c0 = tk.init_stats_plain(torch.from_numpy(x), NB, STEP)
    xb = x.astype(np.float64).reshape(H, NB, STEP, S).transpose(1, 0, 2, 3).reshape(NB, -1, S)
    want_m = xb.mean(1)
    xc = xb - want_m[:, None, :]
    want_c = np.einsum("bps,bpt->bst", xc, xc) / xb.shape[1]
    np.testing.assert_allclose(m0.numpy(), want_m, rtol=1e-5)
    np.testing.assert_allclose(c0.numpy(), want_c, rtol=1e-5)


def test_resident_filter_matches_pallas_interpret():
    x, tpl = _cube()
    mf, alb = tk.acrwl1mf_resident(x, tpl, NB, STEP, num_iter=4, alpha=1e-4, device="cpu")
    assert mf.shape == (NB, H * STEP)
    swh = jnp.transpose(jnp.asarray(x), (2, 1, 0))
    out = jp.acrwl1mf_resident_swh(swh, jnp.asarray(tpl), NB, STEP, num_iter=4, alpha=1e-4,
                                   interpret=True)
    assert out is not None
    _assert_detection_parity(
        tm.unblock_columns(mf, H, STEP), _unblock_j_major(out[0], H, NB, STEP),
        tm.unblock_columns(alb, H, STEP), _unblock_j_major(out[1], H, NB, STEP))


def test_column_blocks_match_pallas_and_oracle():
    x, tpl = _cube()
    kw = dict(column_step=STEP, num_iter=4, alpha=1e-4)
    mf, alb = tm.mag1c_column_blocks(x, tpl, None, device="cpu", **kw)
    assert mf.shape == (H, W) and mf.dtype == torch.float32
    mf_p, alb_p = jm.mag1c_column_blocks(jnp.asarray(x), jnp.asarray(tpl), None,
                                         use_pallas=True, interpret=True, **kw)
    _assert_detection_parity(mf, mf_p, alb, alb_p)

    xb = x.astype(np.float64).reshape(H, NB, STEP, S).transpose(1, 0, 2, 3).reshape(NB, -1, S)
    mf_o, alb_o = tm.reference_oracle_acrwl1mf(xb, tpl, num_iter=4, alpha=1e-4)
    mf_oj, alb_oj = jm.reference_oracle_acrwl1mf(xb, tpl, num_iter=4, alpha=1e-4)
    np.testing.assert_array_equal(mf_o, mf_oj)  # the port's copy of the judge
    np.testing.assert_array_equal(alb_o, alb_oj)
    unb = lambda v: v[..., 0].reshape(NB, H, STEP).transpose(1, 0, 2).reshape(H, W)  # noqa: E731
    _assert_detection_parity(mf, unb(mf_o), alb, unb(alb_o))


def test_resident_twin_f64_matches_oracle():
    """Without shrinkage the rank-2 Woodbury update is exact (with alpha > 0
    the glue adds one Neumann term), so in float64 the plain twins reproduce
    the oracle's direct solves."""
    x, tpl = _cube()
    xd, td = torch.from_numpy(x).double(), torch.from_numpy(tpl).double()
    m0, c0 = tk.init_stats_plain(xd, NB, STEP)
    base = tk._woodbury_base(c0, m0, td, 0.0)
    mf, r = tk.resident_filter_plain(xd, NB, STEP, m0, *base, td, num_iter=6, alpha=0.0)
    mf_o, r_o = tm.reference_oracle_acrwl1mf(tm.block_columns(xd, NB, STEP).numpy(), tpl,
                                             num_iter=6, alpha=0.0)
    np.testing.assert_allclose(r.numpy(), r_o[..., 0], rtol=1e-10)
    np.testing.assert_allclose(mf.numpy(), mf_o[..., 0], rtol=1e-6, atol=1e-3)


def test_glue_twin_matches_jax_glue_math():
    rng = np.random.default_rng(3)
    s = 8
    a = rng.normal(size=(2, s, s))
    c0 = a @ a.transpose(0, 2, 1) + s * np.eye(s)
    k0 = np.linalg.inv(c0)
    m0, tpl = rng.uniform(1, 3, (2, s)), -rng.uniform(0, 1, s)
    target, u = tpl * m0, rng.normal(size=(2, s))
    mom0, mom1, n = rng.uniform(1, 2, 2), rng.uniform(5, 6, 2), 100.0
    carry = np.zeros((2, 4, s))
    carry[:, 1] = target
    stats = np.concatenate([u * n, mom0[:, None], mom1[:, None]], 1)[:, None, :]
    got = tk.filter_glue_plain(torch.from_numpy(stats), torch.from_numpy(carry),
                               torch.from_numpy(m0), torch.from_numpy(tpl),
                               torch.from_numpy(k0), n=n, alpha=1e-4).numpy()
    for b in range(2):
        col = lambda v: jnp.asarray(v[:, None])  # noqa: E731
        want = jp._glue_math(col(u[b] * n), mom0[b], mom1[b], 1.0 / n, col(target[b]),
                             col(m0[b]), col(tpl), jnp.asarray(k0[b]), 1e-4)
        for row, w in enumerate(want[:3]):
            np.testing.assert_allclose(got[b, row], np.asarray(w)[:, 0], rtol=1e-10)
        np.testing.assert_allclose(got[b, 3], float(want[3]), rtol=1e-10)


def test_spd_inverse_and_woodbury_base_match_jax():
    rng = np.random.default_rng(4)
    for s in (5, 12):
        a = rng.normal(size=(3, s, s))
        c = a @ a.transpose(0, 2, 1) + 0.1 * np.eye(s)
        got = tm.spd_inverse_recursive(torch.from_numpy(c)).numpy()
        np.testing.assert_allclose(got, np.asarray(jm.spd_inverse_recursive(jnp.asarray(c))),
                                   rtol=1e-9, atol=1e-12)
        m0, tpl = rng.uniform(1, 3, (3, s)), -rng.uniform(0, 1, s)
        got = tk._woodbury_base(torch.from_numpy(c), torch.from_numpy(m0),
                                torch.from_numpy(tpl), 1e-4)
        want = jp._woodbury_base(jnp.asarray(c), jnp.asarray(m0), jnp.asarray(tpl), 1e-4)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-8, atol=1e-12)


def test_rmf_and_acrwl1mf_match_jax_f64(synthetic_radiance):
    x, tpl = synthetic_radiance
    got = tm.rmf(torch.from_numpy(x), torch.from_numpy(tpl), alpha=1e-4)
    want = jm.rmf(jnp.asarray(x), jnp.asarray(tpl), alpha=1e-4)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-8, atol=1e-8)
    got = tm.acrwl1mf(torch.from_numpy(x), torch.from_numpy(tpl), num_iter=5, alpha=1e-4)
    want = jm.acrwl1mf(jnp.asarray(x), jnp.asarray(tpl), num_iter=5, alpha=1e-4)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-7, atol=1e-6)


def test_masked_route_matches_jax_acrwl1mf(synthetic_radiance):
    """Weighted plain route (the CPU masked route) vs JAX acrwl1mf with weights."""
    x, tpl = synthetic_radiance
    weights = (np.random.default_rng(5).uniform(size=x.shape[:2]) > 0.1).astype(np.float32)
    x32, t32 = x.astype(np.float32), tpl.astype(np.float32)
    mf, r = tm.acrwl1mf(torch.from_numpy(x32), torch.from_numpy(t32),
                        torch.from_numpy(weights), num_iter=10, alpha=1e-4)
    mf_j, r_j = jm.acrwl1mf(jnp.asarray(x32), jnp.asarray(t32), jnp.asarray(weights),
                            num_iter=10, alpha=1e-4)
    assert mf.dtype == torch.float32
    assert (mf.numpy()[weights == 0] == 0).all()
    keep = weights > 0
    _assert_detection_parity(mf.numpy()[keep], np.asarray(mf_j)[keep],
                             r.numpy()[keep], np.asarray(r_j)[keep])


def test_column_blocks_masked_ragged_match_jax():
    x, tpl = _cube()
    x = x[:, :45]  # ragged last block: 45 = 2 * 16 + 13
    valid = np.ones((H, 45), bool)
    valid[5:9, 3:30] = False
    kw = dict(column_step=STEP, num_iter=4, alpha=1e-4)
    for mask in (valid, None):
        mf, alb = tm.mag1c_column_blocks(x, tpl, mask, device="cpu", **kw)
        mf_j, alb_j = jm.mag1c_column_blocks(jnp.asarray(x), jnp.asarray(tpl), mask,
                                             use_pallas=False, **kw)
        fill = np.asarray(mf_j) == tm.NODATA
        np.testing.assert_array_equal(mf.numpy() == tm.NODATA, fill)
        _assert_detection_parity(mf.numpy()[~fill], np.asarray(mf_j)[~fill],
                                 alb.numpy()[~fill], np.asarray(alb_j)[~fill])


def test_kernel_route_contracts():
    x, tpl = _cube()
    with pytest.raises(ValueError, match="num_iter must be >= 1"):
        tk.acrwl1mf_resident(x, tpl, NB, STEP, num_iter=0, device="cpu")
    with pytest.raises(ValueError, match="nb\\*step"):
        tk.acrwl1mf_resident(x, tpl, NB, 15, device="cpu")
    # CPU tensors take the plain twins and launch nothing.
    tk.reset_launch_counts()
    xt = torch.from_numpy(x)
    m0, c0 = tk.init_stats(xt, NB, STEP)
    want = tk.init_stats_plain(xt, NB, STEP)
    assert torch.equal(m0, want[0]) and torch.equal(c0, want[1])
    tk.acrwl1mf_resident(xt, tpl, NB, STEP, num_iter=2, device="cpu")
    tk.acrwl1mf_masked(xt[:, :45], tpl, np.ones((H, 45), bool), NB, STEP, num_iter=2,
                       device="cpu")
    assert set(tk.LAUNCH_COUNTS) >= {"init_stats", "filter_round", "filter_glue"}
    assert all(v == 0 for v in tk.LAUNCH_COUNTS.values())


@pytest.mark.parametrize("mode", [tk.FIRST, tk.LOOP, tk.FINAL])
def test_round_twin_modes(mode):
    """FIRST computes R from the cube and uses the unclamped norm; LOOP adds
    the regulariser; FINAL scales by 1e5 and returns no statistics."""
    x, tpl = _cube()
    xt = torch.from_numpy(x).double()
    m0, c0 = tk.init_stats_plain(xt, NB, STEP)
    k0, tgt0, cit0, norm0 = tk._woodbury_base(c0, m0, torch.from_numpy(tpl).double(), 1e-4)
    carry = tk.pack_carry(tgt0, cit0, norm0)
    mf0, r, _ = tk.filter_round_plain(xt, NB, STEP, m0, carry, None, None, mode=tk.FIRST)
    xb = tm.block_columns(xt, NB, STEP)
    np.testing.assert_allclose(
        r.numpy(), (xb @ m0[:, :, None])[..., 0].numpy() / (m0 * m0).sum(1, keepdim=True).numpy(),
        rtol=1e-12)
    mf, r2, stats = tk.filter_round_plain(xt, NB, STEP, m0, carry, r, mf0, mode=mode)
    assert torch.equal(r2, r)
    if mode == tk.FINAL:
        assert stats is None
        mf_loop, _, _ = tk.filter_round_plain(xt, NB, STEP, m0, carry, r, mf0, mode=tk.LOOP)
        torch.testing.assert_close(mf, mf_loop * tm.SCALING)
    else:
        assert stats.shape == (NB, 1, S + 2)
        assert (mf >= 0).all()


def test_build_commands_target_hopper(monkeypatch):
    from torch.utils import cpp_extension

    monkeypatch.setattr(cpp_extension, "CUDA_HOME", "/usr/local/cuda")  # no toolkit here
    cmds = _build.build_commands("nvcc", "/tmp/out")
    *compile_cus, compile_cpp, link = cmds
    assert _build.ARCH == "-gencode=arch=compute_90a,code=sm_90a"
    assert [c[-3].rsplit("/", 1)[-1] for c in compile_cus] == list(_build.CUDA_SOURCES)
    assert all(_build.ARCH in c for c in compile_cus)
    assert all(c[-1] in link for c in compile_cus)
    assert any(a.startswith("-D_GLIBCXX_USE_CXX11_ABI=") for a in compile_cpp)
    assert any(a.startswith("-I") for a in compile_cpp)
    assert "-shared" in link and "-ltorch" in link
    assert all(c[0] == "nvcc" for c in cmds)


# ---------------------------------------------------------------------------
# The masked route (TPU kernels 5 and 6): weighted twins against the JAX package
# ---------------------------------------------------------------------------


def _masked_case(empty_block=False):
    """The direct-swh cube cut to a ragged width (45 = 2 * 16 + 13), with the
    fill value -9999 in every band at invalid pixels (a rectangle and 1 %
    scattered) and, if asked, over the whole of block 1."""
    x, tpl = _cube()
    x = x[:, :45].copy()
    valid = np.random.default_rng(7).random((H, 45)) >= 0.01
    valid[5:9, 3:30] = False
    if empty_block:
        valid[:, 16:32] = False
    x[~valid] = tm.NODATA
    return x, tpl, valid


def _jax_blocks(x, valid):
    """JAX's (B, P, S) blocks (ops/mag1c.py:616-619, :735-742): padded to
    nb * step columns, invalid pixels zeroed, and the (B, P) weight rows."""
    pad = NB * STEP - x.shape[1]
    xp = np.pad(np.where(valid[..., None], x, 0), ((0, 0), (0, pad), (0, 0)))
    vp = np.pad(valid, ((0, 0), (0, pad)))
    xb = xp.reshape(H, NB, STEP, -1).transpose(1, 0, 2, 3).reshape(NB, H * STEP, -1)
    wb = vp.reshape(H, NB, STEP).transpose(1, 0, 2).reshape(NB, H * STEP)
    return xb, wb


def test_masked_twins_match_pallas_fused_interpret():
    """The sequence of weighted twins against acrwl1mf_fused(glue="fused")
    with a weight row, i.e. _first_round_kernel and _loop_round_kernel in
    interpret mode (the pattern of tests/test_mag1c.py:140-170)."""
    x, tpl, valid = _masked_case()
    mf, r = tk.acrwl1mf_masked(x, tpl, valid, NB, STEP, num_iter=4, alpha=1e-4, device="cpu")
    assert mf.shape == r.shape == (NB, H * STEP)
    xb, wb = _jax_blocks(x, valid)
    mf_j, r_j = jp.acrwl1mf_fused(jnp.asarray(xb), jnp.asarray(tpl),
                                  jnp.asarray(wb, jnp.float32), num_iter=4, alpha=1e-4,
                                  tile_p=256, interpret=True)
    keep = wb
    assert (mf.numpy()[~keep] == 0).all() and (r.numpy()[~keep] == 1).all()
    _assert_detection_parity(mf.numpy()[keep], np.asarray(mf_j)[..., 0][keep],
                             r.numpy()[keep], np.asarray(r_j)[..., 0][keep])


def test_masked_twins_f64_match_jax_acrwl1mf():
    """Without shrinkage the rank-2 Woodbury update is exact, so the float64
    twins reproduce JAX's weighted acrwl1mf (a Cholesky solve per iteration)."""
    x, tpl, valid = _masked_case()
    xd, vt, td = torch.from_numpy(x).double(), torch.from_numpy(valid), torch.from_numpy(tpl).double()
    m0, c0 = tk.init_stats_masked_plain(xd, vt, NB, STEP)
    base = tk._woodbury_base(c0, m0, td, 0.0)
    mf, r = tk.masked_filter_plain(xd, vt, NB, STEP, m0, *base, td, num_iter=6, alpha=0.0)
    xb, wb = _jax_blocks(x.astype(np.float64), valid)
    mf_j, r_j = jm.acrwl1mf(jnp.asarray(xb), jnp.asarray(tpl, jnp.float64),
                            jnp.asarray(wb, jnp.float64), num_iter=6, alpha=0.0)
    np.testing.assert_allclose(r.numpy(), np.asarray(r_j)[..., 0], rtol=1e-6)
    np.testing.assert_allclose(mf.numpy(), np.asarray(mf_j)[..., 0], rtol=1e-6, atol=1e-3)


def test_column_blocks_masked_ragged_match_pallas():
    """The served route, with one wholly invalid block, against JAX's
    use_pallas=True, interpret=True: fill where invalid, parity elsewhere."""
    x, tpl, valid = _masked_case(empty_block=True)
    kw = dict(column_step=STEP, num_iter=4, alpha=1e-4)
    mf, alb = tm.mag1c_column_blocks(x, tpl, valid, device="cpu", **kw)
    mf_j, alb_j = jm.mag1c_column_blocks(jnp.asarray(x), jnp.asarray(tpl), valid,
                                         use_pallas=True, interpret=True, **kw)
    mf, alb, mf_j, alb_j = (np.asarray(a) for a in (mf, alb, mf_j, alb_j))
    np.testing.assert_array_equal(mf == tm.NODATA, ~valid)
    np.testing.assert_array_equal(alb == tm.NODATA, ~valid)
    np.testing.assert_array_equal(mf_j == tm.NODATA, ~valid)
    assert (mf[:, 16:32] == tm.NODATA).all() and np.isfinite(mf).all()
    _assert_detection_parity(mf[valid], mf_j[valid], alb[valid], alb_j[valid])


def test_init_stats_masked_plain_matches_f64():
    """Mean and centred covariance over the valid pixels of each block (the
    ragged block's columns below W only); an empty block gets m0 = 0, C0 = 0
    (n clamped to 1, as JAX's max(sum w, 1))."""
    x, _, valid = _masked_case(empty_block=True)
    m0, c0 = tk.init_stats_masked_plain(torch.from_numpy(x).double(), torch.from_numpy(valid),
                                        NB, STEP)
    counts = tk.block_valid_counts(torch.from_numpy(valid), NB, STEP)
    for b in range(NB):
        cols = slice(b * STEP, min((b + 1) * STEP, 45))
        px = x[:, cols][valid[:, cols]].astype(np.float64)
        assert int(counts[b]) == len(px)
        if not len(px):
            assert (m0[b] == 0).all() and (c0[b] == 0).all()
            continue
        m = px.mean(0)
        np.testing.assert_allclose(m0[b].numpy(), m, rtol=1e-12)
        np.testing.assert_allclose(c0[b].numpy(), (px - m).T @ (px - m) / len(px), rtol=1e-9,
                                   atol=1e-15)


def test_glue_twin_takes_n_per_block():
    """filter_glue_plain with an (nb,) n equals each block's glue with its own n."""
    rng = np.random.default_rng(5)
    s, nb = 6, 3
    a = rng.normal(size=(nb, s, s))
    k0 = torch.from_numpy(np.linalg.inv(a @ a.transpose(0, 2, 1) + s * np.eye(s)))
    m0, tpl = torch.from_numpy(rng.uniform(1, 3, (nb, s))), torch.from_numpy(-rng.uniform(0, 1, s))
    carry = torch.zeros((nb, 4, s), dtype=torch.float64)
    carry[:, 1] = tpl * m0
    stats = torch.from_numpy(rng.normal(size=(nb, 2, s + 2)))
    n = torch.tensor([100.0, 1.0, 37.0], dtype=torch.float64)
    got = tk.filter_glue_plain(stats, carry, m0, tpl, k0, n=n, alpha=1e-4)
    for b in range(nb):
        one = tk.filter_glue_plain(stats[b:b + 1], carry[b:b + 1], m0[b:b + 1], tpl,
                                   k0[b:b + 1], n=float(n[b]), alpha=1e-4)
        torch.testing.assert_close(got[b:b + 1], one, rtol=1e-12, atol=0)


class _FakeKernels:
    """Stands in for torch.ops.starcop_mag1c: records each op it is asked
    for and launches nothing (the outputs stay as the wrapper allocated them)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return lambda *args: self.calls.append(name)


def test_masked_route_launches_masked_kernels(monkeypatch):
    """A masked call on a device tensor (the meta device here; CUDA on the
    card) takes the masked kernels, 1 / num_iter + 1 / num_iter launches, and
    none of the resident ones; the unmasked call takes the resident ones.
    Either takes one woodbury_base. Only CPU tensors run the twins."""
    fake = _FakeKernels()
    monkeypatch.setattr(tk, "_kernels", lambda: fake)
    monkeypatch.setattr(tk, "_stream", lambda x: 0)
    x, tpl, valid = _masked_case()
    tk.reset_launch_counts()
    mf, alb = tm.mag1c_column_blocks(x, tpl, valid, column_step=STEP, num_iter=3, device="meta")
    assert mf.device.type == alb.device.type == "meta" and mf.shape == (H, 45)
    want = {k: 0 for k in tk.LAUNCH_COUNTS}
    want.update(filter_glue=3, init_stats_masked=1, filter_round_masked_first=1,
                filter_round_masked_loop=3, woodbury_base=1)
    assert tk.LAUNCH_COUNTS == want
    assert fake.calls == (["init_stats_masked", "woodbury_base"]
                          + ["filter_round_masked", "filter_glue"] * 3
                          + ["filter_round_masked"])
    fake.calls.clear()
    tk.reset_launch_counts()
    xr, tpl = _cube()
    tm.mag1c_column_blocks(xr, tpl, None, column_step=STEP, num_iter=3, device="meta")
    assert tk.LAUNCH_COUNTS["init_stats"] == 1 and tk.LAUNCH_COUNTS["filter_round"] == 4
    assert tk.LAUNCH_COUNTS["init_stats_masked"] == 0 and tk.LAUNCH_COUNTS["woodbury_base"] == 1
    assert fake.calls[:2] == ["init_stats", "woodbury_base"]
    assert "filter_round_masked" not in fake.calls


@pytest.mark.parametrize("masked", [False, True])
def test_bf16_routes_launch_bsp_kernels(monkeypatch, masked):
    """stream_dtype=bf16 on a device tensor (meta here) takes the bf16
    stream's kernels: unmasked, K1's init_stats on the cube, one centred
    bf16 transpose, num_iter + 1 filter_round_bsp and num_iter glues; masked
    (and ragged), one masked bf16 transpose, init_stats_bsp and the masked
    rounds with bf16 dots. No K1 or K2 round either way."""
    fake = _FakeKernels()
    monkeypatch.setattr(tk, "_kernels", lambda: fake)
    monkeypatch.setattr(tk, "_stream", lambda x: 0)
    if masked:
        x, tpl, valid = _masked_case()
    else:
        (x, tpl), valid = _cube(), None
    tk.reset_launch_counts()
    mf, _ = tm.mag1c_column_blocks(x, tpl, valid, column_step=STEP, num_iter=3,
                                   stream_dtype=torch.bfloat16, device="meta")
    assert mf.device.type == "meta" and mf.shape == x.shape[:2]
    want = {k: 0 for k in tk.LAUNCH_COUNTS}
    if masked:
        want.update(blocked_transpose=1, init_stats_bsp=1, filter_round_bsp_masked_first=1,
                    filter_round_bsp_masked_loop=3, filter_glue=3, woodbury_base=1)
        head = ["blocked_transpose", "init_stats_bsp", "woodbury_base"]
    else:
        want.update(init_stats=1, blocked_transpose=1, filter_round_bsp=4, filter_glue=3,
                    woodbury_base=1)
        head = ["init_stats", "woodbury_base", "blocked_transpose"]
    assert tk.LAUNCH_COUNTS == want
    assert fake.calls == head + ["filter_round_bsp", "filter_glue"] * 3 + ["filter_round_bsp"]
    with pytest.raises(ValueError, match="stream_dtype"):
        tm.mag1c_column_blocks(x, tpl, valid, column_step=STEP, stream_dtype=torch.float16,
                               device="cpu")
