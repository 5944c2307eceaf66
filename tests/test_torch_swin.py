"""SwinV2 + UperNet (starcop_tpu_torch/models/swin.py) against the plain
reference of the benchmark (portbench/reference/swin.py, plain torch, none
of the program), on the recipe's seeded weights
(portbench/recipes/swin_weights.py) at a tiny size: embed 16, depths [2, 2,
2, 2], heads [2, 2, 4, 4], window 4, a 16-channel head, input 2 x 4 x 96 x
160. The stage maps are 24 x 40, 12 x 20, 6 x 10 and 3 x 5: the last two
are padded to 8 x 12 and 4 x 8 for the windows, and the last shifts along
its width only (its padded height is one window). Imports no JAX.

Tolerances, relative to the reference's largest |logit|:

  * f64: 1e-9. The same equations in another order (SDPA's fused softmax
    with the bias and mask as one additive mask and the logit scale folded
    into q, torch's layer norm and convolutions); the gaps read ~1e-15.
  * f32 (TF32 off): 1e-5. f32's unit roundoff is 6e-8 and a forward chains
    ~20 normalised layers; the gaps read below 1e-6. Each planted fault of
    ``portbench/controls/faults_swin.py`` (a stage-3 block's shift mask,
    position bias or cosine attention, PPM's pooled branches) moves the
    output by far more.
  * bf16 (autocast, or bf16 weights): 0.05. bf16 keeps 8 bits (a rounding
    of 3.9e-3) at every projection; the gaps read ~1e-2. The route must
    also part from f32 by more than f32's tolerance, so that it is seen to
    compute in bf16.

On the card (marker ``cuda``, skipped here; run with ``python -m pytest
--noconftest -m cuda tests/test_torch_swin.py``): the backend
``scaled_dot_product_attention`` takes for SwinV2-B's stage-1 window batch
at f32 with the bias and the shift mask, its gap to the f64 product, and the
full-width network against the reference at 256 x 256.
"""

import functools
import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import cpu_share  # noqa: E402,F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from portbench.controls.faults_swin import FAULTS, planted  # noqa: E402
from portbench.recipes.granule import make_granule  # noqa: E402
from portbench.recipes.swin_weights import make_params  # noqa: E402
from portbench.recipes.template import emit_template  # noqa: E402
from portbench.recipes.weights import load_into  # noqa: E402
from portbench.reference import swin as reference  # noqa: E402
from starcop_tpu_torch.device import float32_precision  # noqa: E402
from starcop_tpu_torch.models import segmenter, swin  # noqa: E402
from starcop_tpu_torch.models.segmenter import SegmentationModel, cast_for_inference  # noqa: E402
from starcop_tpu_torch.models.swin import SwinV2UperNet  # noqa: E402
from starcop_tpu_torch.scenes.emit_pipeline import emit_granule_to_mask  # noqa: E402
from starcop_tpu_torch.utils.profiling import clear_spans, spans  # noqa: E402

with open(os.path.join(ROOT, "portbench", "configs", "swinv2_b_upernet_emit.json")) as _fh:
    CONFIG = json.load(_fh)
SHAPE = {"embed_dim": 16, "depths": [2, 2, 2, 2], "num_heads": [2, 2, 4, 4], "window": 4,
         "channels": 16}
TINY = {**CONFIG["model"], **SHAPE}
TOL = {torch.float64: 1e-9, torch.float32: 1e-5, torch.bfloat16: 0.05}


def tiny_net(**kw) -> SwinV2UperNet:
    return SwinV2UperNet(4, 1, **SHAPE, **kw)


def seeded(dtype=torch.float64, seed=3, **kw):
    params = make_params(seed, "cpu", TINY, dtype)
    net = tiny_net(**kw).to(dtype).eval()
    load_into(net, params)
    return net, params


def as_f64(params):
    return {k: v.double() if v.is_floating_point() else v for k, v in params.items()}


def inputs(dtype=torch.float64, seed=1):
    x = torch.rand(2, 4, 96, 160, dtype=torch.float64,
                   generator=torch.Generator().manual_seed(seed))
    return (x * 2).to(dtype)


def rel_gap(got, want) -> float:
    return float((got.double() - want.double()).abs().max() / want.double().abs().max())


@pytest.fixture
def tiny_registry(monkeypatch):
    """``swinv2_b_upernet`` built at the tiny widths through the segmenter."""
    monkeypatch.setitem(segmenter.ARCHITECTURES, "swinv2_b_upernet",
                        functools.partial(SwinV2UperNet, **SHAPE))


@pytest.fixture(autouse=True)
def empty_log():
    clear_spans()
    yield
    clear_spans()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_forward_matches_reference(dtype):
    net, params = seeded(dtype)
    want = reference.swin_logits(inputs(), as_f64(params), TINY)
    with torch.no_grad(), float32_precision():
        got = net(inputs(dtype))
    assert got.dtype == dtype and got.shape == (2, 1, 96, 160)
    assert rel_gap(got, want) < TOL[dtype]


def test_stage_geometry_pads_and_shifts_as_torchvision():
    """Padded sizes and shifts of the tiny stage maps (no shift along a
    padded side of one window), and the shift mask against the
    reference's regions on every shifted map."""
    maps = [(24, 40), (12, 20), (6, 10), (3, 5)]
    geometry = [swin.stage_geometry(h, w, 4) for h, w in maps]
    assert geometry == [(24, 40, (2, 2)), (12, 20, (2, 2)), (8, 12, (2, 2)), (4, 8, (0, 2))]
    for ph, pw, shift in geometry:
        got = swin.shift_mask(ph, pw, 4, shift, "cpu")
        want = reference.region_mask(ph, pw, 4, shift, torch.float32, "cpu")
        assert torch.equal(got, want)
    assert float(swin.shift_mask(4, 8, 4, (0, 2), "cpu").min()) == -100.0


def test_shift_mask_built_once_a_stage_a_forward(monkeypatch):
    """One mask a stage a forward, whatever the number of shifted blocks."""
    net, _ = seeded(torch.float32)
    built = []
    real = swin.shift_mask
    monkeypatch.setattr(swin, "shift_mask", lambda *a: built.append(a[:2]) or real(*a))
    with torch.no_grad():
        net(inputs(torch.float32))
    assert built == [(24, 40), (12, 20), (8, 12), (4, 8)]


def test_training_loss_and_gradients_match_reference():
    """Training mode at drop-path and dropout 0 (the head's batch norms on
    the batch's statistics): the loss and every gradient in f64."""
    net, params = seeded(torch.float64, drop_path=0.0, dropout_rate=0.0)
    net.train()
    x = inputs()
    target = (torch.rand(2, 1, 96, 160, dtype=torch.float64,
                         generator=torch.Generator().manual_seed(5)) > 0.7).double()
    loss = torch.nn.functional.binary_cross_entropy_with_logits(net(x), target)
    loss.backward()
    buffers = ("running_mean", "running_var", "relative_coords_table", "relative_position_index")
    leaves = {k: v.clone().requires_grad_(v.is_floating_point() and not k.endswith(buffers))
              for k, v in params.items()}
    ref = torch.nn.functional.binary_cross_entropy_with_logits(
        reference.swin_logits(x, leaves, TINY, train=True), target)
    ref.backward()
    assert abs(loss.item() - ref.item()) <= 1e-12 * abs(ref.item())
    named = dict(net.named_parameters())
    assert set(named) == {k for k, v in leaves.items() if v.requires_grad}
    # Some gradients are rounding noise about 0 (a shift ahead of a batch
    # norm, qkv's held k bias): each leaf within 1e-9 of the largest.
    largest = max(float(v.grad.abs().max()) for v in leaves.values()
                  if v.requires_grad and v.grad is not None)
    for k, p in named.items():
        want = leaves[k].grad if leaves[k].grad is not None else torch.zeros_like(p)
        assert float((p.grad - want).abs().max()) <= 1e-9 * largest, k


def test_training_draws_from_the_generator():
    """Stochastic depth and the head's channel dropout act in training only,
    drawn from the forward's generator."""
    net, _ = seeded(torch.float64)
    assert net.dropout_rate == pytest.approx(0.5)
    rates = [b.drop_path for i in range(4) for b in net.features[2 * i + 1]]
    assert rates == pytest.approx([0.5 * j / 7 for j in range(8)])
    x = inputs()
    with torch.no_grad():
        plain = net(x)
        assert torch.equal(net(x, generator=torch.Generator().manual_seed(7)), plain)
        net.train()
        with pytest.raises(ValueError, match="generator"):
            net(x)
        a = net(x, generator=torch.Generator().manual_seed(7))
        b = net(x, generator=torch.Generator().manual_seed(7))
        c = net(x, generator=torch.Generator().manual_seed(8))
    assert torch.equal(a, b) and not torch.equal(a, c)


@pytest.mark.parametrize("route", ["autocast", "bf16_weights"])
def test_bf16_routes_stay_within_bf16_tolerance(tiny_registry, route):
    """``model_dtype=bf16`` (autocast, parameters f32) and
    ``cast_for_inference`` (bf16 weights) through ``SegmentationModel``."""
    params = make_params(3, "cpu", TINY, torch.float32)
    kw = {"model_dtype": torch.bfloat16} if route == "autocast" else {}
    model = SegmentationModel(model_type="swinv2_b_upernet", **kw)
    load_into(model.network, params)
    if route == "bf16_weights":
        cast_for_inference(model)
    model.eval()
    x = inputs(torch.float32) * 500
    want = reference.swin_logits(model.normalizer.normalize_x(x).double(), as_f64(params), TINY)
    with torch.no_grad():
        got = model(x)
    assert got.dtype == torch.float32
    assert TOL[torch.float32] < rel_gap(got, want) < TOL[torch.bfloat16]


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_moves_output_beyond_f32_tolerance(fault):
    """Each planted fault (a stage-3 block's shift mask, position bias or
    cosine attention; PPM's pooled branches) moves the logits far beyond
    f32's tolerance: every mechanism shows in the output."""
    net, params = seeded(torch.float32)
    x = inputs(torch.float32)
    with torch.no_grad():
        sound = net(x)
        with planted(fault):
            broken, _ = seeded(torch.float32)
            out = broken(x)
    assert rel_gap(out, sound) > 100 * TOL[torch.float32]


def test_granule_to_mask_runs_swin_unchanged(tiny_registry):
    """``emit_granule_to_mask`` with a SwinV2 ``SegmentationModel`` on a
    1280 x 96 granule (the masked route at step 32): the mask equals the
    reference's ``plume_probability`` on the program's own mf within f32's
    tolerance (the mask is a probability, so absolute)."""
    cfg = {**CONFIG["granule"], **CONFIG["filter"], "lines": 1280, "samples": 96, "plumes": 2,
           "max_concentration": 4000.0, "noise": 0.01, "fill_corner": [128, 20],
           "fill_block": 1, "fill_share": 0.006}
    template = emit_template(CONFIG)
    g = make_granule(4, 0, template, cfg, "cpu")
    params = make_params(5, "cpu", TINY, torch.float32)
    model = SegmentationModel(model_type="swinv2_b_upernet")
    load_into(model.network, params)
    model.eval()
    pred, mf = emit_granule_to_mask(g["cube"].numpy(), g["rgb"].numpy(), template, model,
                                    valid_mask=g["valid"].numpy(), column_step=32, num_iter=2,
                                    device="cpu")
    want = reference.plume_probability(mf.double(), g["rgb"], params, TINY)
    assert pred.shape == mf.shape == (1280, 96)
    assert float((pred.double() - want).abs().max()) < TOL[torch.float32]
    assert 0.0 < float(want.min()) and float(want.max()) < 1.0


def test_swinv2_b_at_published_widths_and_init():
    """``swinv2_b_upernet``: torchvision's ``swin_v2_b`` features (86,905,848
    parameters at 4 inputs: with 3, its classifier's norm and its 1,000-way
    head they are torchvision's published 87,930,848) with the dense output
    norms, and the 512-channel UperNet head; ``init`` draws the sources'
    rule, not Flax's."""
    model = SegmentationModel(model_type="swinv2_b_upernet")
    net = model.network
    count = lambda m: sum(p.numel() for p in m.parameters())  # noqa: E731
    norms = sum(count(getattr(net, f"norm{i}")) for i in range(4))
    assert count(net.features) == 86_905_848 and norms == 3_840
    assert count(net.decode_head) == 33_239_553
    assert [len(net.features[2 * i + 1]) for i in range(4)] == [2, 2, 18, 2]
    attn = [net.features[2 * i + 1][0].attn for i in range(4)]
    assert [a.num_heads for a in attn] == [4, 8, 16, 32]
    assert [a.qkv.in_features for a in attn] == [128, 256, 512, 1024]
    assert {a.window for a in attn} == {8}
    assert net.features[0][0].kernel_size == (4, 4) and net.features[0][0].stride == (4, 4)
    head = net.decode_head
    assert head.fpn_bottleneck.conv.in_channels == 2048 and head.bottleneck.conv.in_channels == 3072
    assert [m[0].output_size for m in head.psp_modules] == [1, 2, 3, 6]

    small = SegmentationModel(model_type="cnn")
    small.network = tiny_net()
    small.init(torch.Generator().manual_seed(0))
    again = tiny_net().init_weights(torch.Generator().manual_seed(0))
    for (k, a), b in zip(small.network.state_dict().items(), again.state_dict().values()):
        assert torch.equal(a, b), k
    block = small.network.features[1][0]
    assert abs(float(block.mlp[0].weight.detach().std()) - 0.02) < 0.004
    assert not block.mlp[0].bias.any() and not block.attn.qkv.bias.any()
    assert torch.allclose(block.attn.logit_scale, torch.full((2, 1, 1), np.log(10.0)))
    assert torch.equal(block.norm1.weight, torch.ones(16)) and not block.norm1.bias.any()
    seg = small.network.decode_head.conv_seg
    assert float(seg.weight.detach().std()) < 0.03 and not seg.bias.any()


def test_traced_forward_spans_and_counters():
    """Under the profiler: four stage spans keyed 0-3, three merges, an
    attention span a block with its windows, tokens, heads and shift, an
    MLP span a block, one head span with PPM, FPN and fuse inside;
    untraced, nothing is logged."""
    net, _ = seeded(torch.float32)
    x = inputs(torch.float32)[:1]
    with torch.no_grad():
        net(x)
        assert spans() == []
        with profile(activities=[ProfilerActivity.CPU]):
            net(x)
    found = spans()
    names = [s.name for s in found]
    assert names.count("swin.stage") == 4 and names.count("swin.merge") == 3
    assert names.count("swin.attention") == names.count("swin.mlp") == 8
    assert [s.key for s in found if s.name == "swin.stage"] == [0, 1, 2, 3]
    assert [names.count(n) for n in ("upernet.head", "upernet.ppm", "upernet.fpn",
                                     "upernet.fuse")] == [1, 1, 1, 1]
    windows = {0: 6 * 10, 1: 3 * 5, 2: 2 * 3, 3: 1 * 2}
    attention = [s for s in found if s.name == "swin.attention"]
    for j, s in enumerate(attention):
        assert s.counts == {"windows": windows[s.key], "window_tokens": 16,
                            "heads": SHAPE["num_heads"][s.key], "shifted": j % 2}
    head = next(s for s in found if s.name == "upernet.head")
    inner = [s for s in found if s.name.startswith("upernet.") and s is not head]
    assert len(inner) == 3 and all(s.parent == head.id for s in inner)


@pytest.mark.parametrize("cli", ["serve", "infer_emit"])
def test_cli_model_type_builds_the_named_network(cli, tiny_registry, tmp_path, monkeypatch):
    """``--model-type swinv2_b_upernet`` builds the SwinV2 network for the
    checkpoint."""
    from starcop_tpu_torch.cli import infer_emit, serve
    from starcop_tpu_torch.models import weights
    from starcop_tpu_torch.scenes import emit_pipeline
    from starcop_tpu_torch.serve import pipeline

    built = {}
    monkeypatch.setattr(weights, "load_pretrained_state_dict", lambda path: built.setdefault(
        "state", segmenter.ARCHITECTURES["swinv2_b_upernet"](4, 1).state_dict()))

    def served(model, *args, **kwargs):
        built["model"] = model

    def inferred(scene, model, **kwargs):
        built["model"] = model
        return {"prediction": np.zeros((2, 2), np.float32)}

    class Scene:
        transform = crs_epsg = None

        def __init__(self, path):
            pass

        def close(self):
            pass

    monkeypatch.setattr(pipeline, "emit_serving_pipeline", served)
    monkeypatch.setattr(emit_pipeline, "emit_inference", inferred)
    monkeypatch.setattr("starcop_tpu_torch.data.emit.EMITRawScene", Scene)
    common = ["--checkpoint", "ckpt.pt", "--output", str(tmp_path / "out"), "--device", "cpu",
              "--model-dtype", "f32", "--model-type", "swinv2_b_upernet"]
    if cli == "serve":
        assert serve.main(["--granules-dir", str(tmp_path), *common]) == 0
    else:
        assert infer_emit.main(["granule.nc", *common]) == 0
    model = built["model"]
    assert model.model_type == "swinv2_b_upernet" and type(model.network) is SwinV2UperNet


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_sdpa_route_of_stage1_windows_with_the_mask(card):
    """SwinV2-B's stage 1 at the padded granule (1,560 windows of 64 tokens,
    4 heads of 32, a shifted block's bias plus mask as one additive f32
    mask, scale 1): inside ``float32_precision`` the default backend is an
    f32 one that takes an additive mask (the memory-efficient kernel, or
    the math route) within 4x the f32 math product's gap to f64."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    gen = torch.Generator(device=card).manual_seed(0)
    q, k, v = (torch.randn(1560, 4, 64, 32, device=card, generator=gen) for _ in range(3))
    q = torch.nn.functional.normalize(q, dim=-1) * 10.0
    k = torch.nn.functional.normalize(k, dim=-1)
    mask = swin.shift_mask(320, 312, 8, (4, 4), card)
    bias = 16 * torch.sigmoid(torch.randn(4, 64, 64, device=card, generator=gen))
    add = bias[None] + mask[:, None]
    exact = torch.softmax(q.double() @ k.double().transpose(-1, -2) + add.double(), -1) @ v.double()
    with float32_precision():
        default = torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=add,
                                                                   scale=1.0)
        plain = torch.softmax(q @ k.transpose(-1, -2) + add, -1) @ v
        backend = None
        for b in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                  SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
            try:
                with sdpa_kernel(b):
                    out = torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=add,
                                                                           scale=1.0)
            except RuntimeError:
                continue
            if torch.equal(out, default):
                backend = b.name
                break
    assert backend in ("EFFICIENT_ATTENTION", "MATH"), backend
    gap, plain_gap = ((t.double() - exact).abs().max() for t in (default, plain))
    assert gap <= 4 * plain_gap, (backend, gap, plain_gap)


@pytest.mark.cuda
def test_full_width_swin_on_card_matches_reference(card):
    """``swinv2_b_upernet`` on the card at 256 x 256 with the recipe's
    weights: f32 (TF32 off) within f32's tolerance of the f64 reference,
    bf16 autocast within bf16's."""
    m = CONFIG["model"]
    params = make_params(11, card, m, torch.float32)
    x = torch.rand(1, 4, 256, 256, device=card, generator=torch.Generator(card).manual_seed(2))
    want = reference.swin_logits(x.double(), as_f64(params), m)
    model = SegmentationModel(model_type="swinv2_b_upernet")
    load_into(model.network, params)
    net = model.network.to(card).eval()
    with torch.no_grad(), float32_precision():
        got = net(x)
        with torch.autocast("cuda", dtype=torch.bfloat16):
            got16 = net(x)
    assert rel_gap(got, want) < TOL[torch.float32]
    assert TOL[torch.float32] < rel_gap(got16, want) < TOL[torch.bfloat16]
