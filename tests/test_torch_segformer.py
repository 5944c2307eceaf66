"""SegFormer (starcop_tpu_torch/models/segformer.py) against the plain
reference of the benchmark (portbench/reference/segformer.py, plain torch,
none of the program), on the recipe's seeded weights
(portbench/recipes/segformer_weights.py) at a tiny size: widths [8, 16, 24,
32], heads [1, 2, 3, 4], depths [1, 1, 2, 1], reductions [8, 4, 2, 1], a 32
channel head, input 2 x 4 x 64 x 96. Imports no JAX.

Tolerances, relative to the reference's largest |logit|:

  * f64: 1e-9. The same equations in another order (SDPA's fused softmax,
    torch's layer norm, the 1x1 convolutions as convolutions); the gaps
    read ~1e-15.
  * f32 (TF32 off): 1e-5. f32's unit roundoff is 6e-8 and a forward chains
    ~20 normalised layers; the gaps read 4e-7 to 1.2e-6 over four seeds.
    Taking the attention out of one stage-3 block moves the output by 8e-3
    to 3e-2, far beyond it.
  * bf16 (autocast, or bf16 weights): 0.05. bf16 keeps 8 bits (a rounding
    of 3.9e-3) at every projection; the gaps read 1.2e-2 to 1.8e-2. The
    route must also part from f32 by more than f32's tolerance, so that it
    is seen to compute in bf16.

On the card (marker ``cuda``, skipped here; run with ``python -m pytest
--noconftest -m cuda tests/test_torch_segformer.py``): the backends
``scaled_dot_product_attention`` takes at MiT-b5's stage-1 shape, f32 and
bf16, the f32 one's gap to the f64 product, and the full-width network
against the reference at 256 x 256.
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

from portbench.recipes.granule import make_granule  # noqa: E402
from portbench.recipes.segformer_weights import make_params  # noqa: E402
from portbench.recipes.template import emit_template  # noqa: E402
from portbench.recipes.weights import load_into  # noqa: E402
from portbench.reference import segformer as reference  # noqa: E402
from starcop_tpu_torch.device import float32_precision  # noqa: E402
from starcop_tpu_torch.models import segmenter  # noqa: E402
from starcop_tpu_torch.models.segformer import SegFormer  # noqa: E402
from starcop_tpu_torch.models.segmenter import SegmentationModel, cast_for_inference  # noqa: E402
from starcop_tpu_torch.scenes.emit_pipeline import emit_granule_to_mask  # noqa: E402
from starcop_tpu_torch.utils.profiling import clear_spans, spans  # noqa: E402

with open(os.path.join(ROOT, "portbench", "configs", "segformer_b5_emit.json")) as _fh:
    CONFIG = json.load(_fh)
SHAPE = {"embed_dims": [8, 16, 24, 32], "num_heads": [1, 2, 3, 4], "depths": [1, 1, 2, 1],
         "decoder_dim": 32}
TINY = {**CONFIG["model"], **SHAPE}
TOL = {torch.float64: 1e-9, torch.float32: 1e-5, torch.bfloat16: 0.05}


def tiny_net(**kw) -> SegFormer:
    return SegFormer(4, 1, sr_ratios=TINY["sr_ratios"], **SHAPE, **kw)


def seeded(dtype=torch.float64, seed=3, **kw):
    params = make_params(seed, "cpu", TINY, dtype)
    net = tiny_net(**kw).to(dtype).eval()
    load_into(net, params)
    return net, params


def inputs(dtype=torch.float64, seed=1):
    x = torch.rand(2, 4, 64, 96, dtype=torch.float64, generator=torch.Generator().manual_seed(seed))
    return (x * 2).to(dtype)


def rel_gap(got, want) -> float:
    return float((got.double() - want.double()).abs().max() / want.double().abs().max())


@pytest.fixture
def tiny_registry(monkeypatch):
    """``segformer_b5`` built at the tiny widths through the segmenter."""
    monkeypatch.setitem(segmenter.ARCHITECTURES, "segformer_b5",
                        functools.partial(SegFormer, sr_ratios=TINY["sr_ratios"], **SHAPE))


@pytest.fixture(autouse=True)
def empty_log():
    clear_spans()
    yield
    clear_spans()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_forward_matches_reference(dtype):
    net, params = seeded(dtype)
    want = reference.segformer_logits(inputs(), {k: v.double() for k, v in params.items()}, TINY)
    with torch.no_grad(), float32_precision():
        got = net(inputs(dtype))
    assert got.dtype == dtype and got.shape == (2, 1, 64, 96)
    assert rel_gap(got, want) < TOL[dtype]


def test_training_loss_and_gradients_match_reference():
    """Training mode at drop-path and dropout 0 (the head's batch norm on
    the batch's statistics): the loss and every gradient in f64."""
    net, params = seeded(torch.float64, drop_path=0.0, dropout_rate=0.0)
    net.train()
    x = inputs()
    target = (torch.rand(2, 1, 64, 96, dtype=torch.float64,
                         generator=torch.Generator().manual_seed(5)) > 0.7).double()
    loss = torch.nn.functional.binary_cross_entropy_with_logits(net(x), target)
    loss.backward()
    leaves = {k: v.clone().requires_grad_(not k.endswith(("running_mean", "running_var")))
              for k, v in params.items()}
    ref = torch.nn.functional.binary_cross_entropy_with_logits(
        reference.segformer_logits(x, leaves, TINY, train=True), target)
    ref.backward()
    assert abs(loss.item() - ref.item()) <= 1e-12 * abs(ref.item())
    named = dict(net.named_parameters())
    assert set(named) == {k for k, v in leaves.items() if v.requires_grad}
    # Some gradients are rounding noise about 0 (a stage norm's shift ahead
    # of the head's batch norm): each leaf within 1e-9 of the largest.
    largest = max(float(v.grad.abs().max()) for v in leaves.values() if v.requires_grad)
    for k, p in named.items():
        assert float((p.grad - leaves[k].grad).abs().max()) <= 1e-9 * largest, k


def test_training_draws_from_the_generator():
    """Drop-path and the head's channel dropout act in training only, drawn
    from the forward's generator; the trainer hands one to the network."""
    net, _ = seeded(torch.float64)
    assert net.dropout_rate == pytest.approx(0.1)
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
        net.decode_head.linear_fuse.bn.eval()  # the batch's statistics out of the way
        d = net(x, generator=torch.Generator().manual_seed(7))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.equal(d, plain)


@pytest.mark.parametrize("route", ["autocast", "bf16_weights"])
def test_bf16_routes_stay_within_bf16_tolerance(tiny_registry, route):
    """``model_dtype=bf16`` (autocast, parameters f32) and
    ``cast_for_inference`` (bf16 weights) through ``SegmentationModel``."""
    params = make_params(3, "cpu", TINY, torch.float32)
    kw = {"model_dtype": torch.bfloat16} if route == "autocast" else {}
    model = SegmentationModel(model_type="segformer_b5", **kw)
    load_into(model.network, params)
    if route == "bf16_weights":
        cast_for_inference(model)
    model.eval()
    x = inputs(torch.float32) * 500
    want = reference.segformer_logits(model.normalizer.normalize_x(x).double(),
                                      {k: v.double() for k, v in params.items()}, TINY)
    with torch.no_grad():
        got = model(x)
    assert got.dtype == torch.float32
    assert TOL[torch.float32] < rel_gap(got, want) < TOL[torch.bfloat16]


def test_attention_off_moves_output_beyond_f32_tolerance():
    """The mask's dependence on attention: one stage-3 block's attention
    branch taken out moves the logits far beyond f32's tolerance."""
    net, params = seeded(torch.float32)
    x = inputs(torch.float32)
    with torch.no_grad():
        sound = net(x)
        net.backbone.block3[0].attn.forward = lambda t, h, w: torch.zeros_like(t)
        broken = net(x)
    assert rel_gap(broken, sound) > 100 * TOL[torch.float32]


def test_granule_to_mask_runs_segformer_unchanged(tiny_registry):
    """``emit_granule_to_mask`` with a SegFormer ``SegmentationModel`` on a
    1280 x 96 granule (the masked route at step 32): the mask equals the
    reference's ``plume_probability`` on the program's own mf within f32's
    tolerance (the mask is a probability, so absolute)."""
    cfg = {**CONFIG["granule"], **CONFIG["filter"], "lines": 1280, "samples": 96, "plumes": 2,
           "max_concentration": 4000.0, "noise": 0.01, "fill_corner": [128, 20],
           "fill_block": 1, "fill_share": 0.006}
    template = emit_template(CONFIG)
    g = make_granule(4, 0, template, cfg, "cpu")
    params = make_params(5, "cpu", TINY, torch.float32)
    model = SegmentationModel(model_type="segformer_b5")
    load_into(model.network, params)
    model.eval()
    pred, mf = emit_granule_to_mask(g["cube"].numpy(), g["rgb"].numpy(), template, model,
                                    valid_mask=g["valid"].numpy(), column_step=32, num_iter=2,
                                    device="cpu")
    want = reference.plume_probability(mf.double(), g["rgb"], params, TINY)
    assert pred.shape == mf.shape == (1280, 96)
    assert float((pred.double() - want).abs().max()) < TOL[torch.float32]
    assert 0.0 < float(want.min()) and float(want.max()) < 1.0


def test_segformer_b5_at_published_widths_and_nvlabs_init():
    """``segformer_b5``: MiT-b5 (81.4 M parameters at 4 inputs, the paper's
    Table 1 at 3) and the 768-wide head (3.15 M); ``init`` draws NVlabs'
    ``_init_weights``, not Flax's rule."""
    model = SegmentationModel(model_type="segformer_b5")
    net = model.network
    count = lambda m: sum(p.numel() for p in m.parameters())  # noqa: E731
    assert count(net.backbone) == 81_446_144 and count(net.decode_head) == 3_151_105
    assert [len(getattr(net.backbone, f"block{i}")) for i in range(1, 5)] == [3, 6, 40, 3]
    attn = [getattr(net.backbone, f"block{i}")[0].attn for i in range(1, 5)]
    assert [a.num_heads for a in attn] == [1, 2, 5, 8]
    assert [a.sr_ratio for a in attn] == [8, 4, 2, 1]
    assert [a.q.in_features for a in attn] == [64, 128, 320, 512]

    small = SegmentationModel(model_type="cnn")
    small.network = tiny_net()
    small.init(torch.Generator().manual_seed(0))
    again = tiny_net().init_weights(torch.Generator().manual_seed(0))
    for (k, a), b in zip(small.network.state_dict().items(), again.state_dict().values()):
        assert torch.equal(a, b), k
    fc1 = small.network.backbone.block1[0].mlp.fc1
    assert abs(float(fc1.weight.detach().std()) - 0.02) < 0.004 and not fc1.bias.any()
    dw = small.network.backbone.block1[0].mlp.dwconv.dwconv
    assert abs(float(dw.weight.detach().std()) - (2 / 9) ** 0.5) < 0.05
    norm = small.network.backbone.block1[0].norm1
    assert torch.equal(norm.weight, torch.ones(8)) and not norm.bias.any()


def test_traced_forward_spans_and_counters():
    """Under the profiler: four stage spans keyed 0-3, an attention span a
    block with its queries, reduced keys and heads, a MixFFN span a block,
    one head span; untraced, nothing is logged."""
    net, _ = seeded(torch.float32)
    x = inputs(torch.float32)[:1]
    with torch.no_grad():
        net(x)
        assert spans() == []
        with profile(activities=[ProfilerActivity.CPU]):
            net(x)
    found = spans()
    names = [s.name for s in found]
    assert names.count("segformer.stage") == 4 and names.count("segformer.decode") == 1
    assert names.count("segformer.attention") == names.count("segformer.mixffn") == 5
    assert [s.key for s in found if s.name == "segformer.stage"] == [0, 1, 2, 3]
    maps = {0: (16, 24), 1: (8, 12), 2: (4, 6), 3: (2, 3)}
    for s in found:
        if s.name == "segformer.attention":
            (h, w), r = maps[s.key], TINY["sr_ratios"][s.key]
            assert s.counts == {"queries": h * w, "keys": (h // r) * (w // r),
                                "heads": TINY["num_heads"][s.key]}


@pytest.mark.parametrize("cli", ["serve", "infer_emit"])
@pytest.mark.parametrize("model_type", [None, "segformer_b5"])
def test_cli_model_type_builds_the_named_network(cli, model_type, tiny_registry, tmp_path,
                                                 monkeypatch):
    """``--model-type`` builds the named network for the checkpoint (the
    U-Net when it is not given)."""
    from starcop_tpu_torch.cli import infer_emit, serve
    from starcop_tpu_torch.models import weights
    from starcop_tpu_torch.scenes import emit_pipeline
    from starcop_tpu_torch.serve import pipeline

    built = {}
    monkeypatch.setattr(weights, "load_pretrained_state_dict", lambda path: built.setdefault(
        "state", segmenter.ARCHITECTURES[model_type or "unet_semseg"](4, 1).state_dict()))

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
    extra = [] if model_type is None else ["--model-type", model_type]
    common = ["--checkpoint", "ckpt.pt", "--output", str(tmp_path / "out"), "--device", "cpu",
              "--model-dtype", "f32", *extra]
    if cli == "serve":
        assert serve.main(["--granules-dir", str(tmp_path), *common]) == 0
    else:
        assert infer_emit.main(["granule.nc", *common]) == 0
    model = built["model"]
    assert model.model_type == (model_type or "unet_semseg")
    want = SegFormer if model_type else segmenter.ARCHITECTURES["unet_semseg"]
    assert type(model.network) is want


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _sdpa_backend(q, k, v):
    """The backend whose output equals the default's bitwise, of flash,
    efficient, cuDNN and math (the first that takes the inputs)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    default = torch.nn.functional.scaled_dot_product_attention(q, k, v)
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel(backend):
                out = torch.nn.functional.scaled_dot_product_attention(q, k, v)
        except RuntimeError:
            continue
        if torch.equal(out, default):
            return backend.name, default
    return None, default


@pytest.mark.cuda
def test_sdpa_routes_at_stage1_shape(card):
    """MiT-b5's stage 1 at the padded granule (99,840 queries, 1,560 keys, a
    head of 64): at f32 inside ``float32_precision`` the default backend is
    an f32 one (the memory-efficient kernel on torch 2.11) within 4x the
    f32 math product's gap to f64; bf16 takes a flash kernel (cuDNN's sm90
    flash kernel on torch 2.11, FlashAttention's elsewhere)."""
    gen = torch.Generator(device=card).manual_seed(0)
    q = torch.randn(1, 1, 99840, 64, device=card, generator=gen)
    k, v = (torch.randn(1, 1, 1560, 64, device=card, generator=gen) for _ in range(2))
    exact = torch.softmax(q.double() @ k.double().transpose(-1, -2) / 8.0, -1) @ v.double()
    with float32_precision():
        backend, out = _sdpa_backend(q, k, v)
        plain = torch.softmax(q @ k.transpose(-1, -2) / 8.0, -1) @ v
    assert backend in ("EFFICIENT_ATTENTION", "MATH")
    gap, plain_gap = ((t.double() - exact).abs().max() for t in (out, plain))
    assert gap <= 4 * plain_gap, (backend, gap, plain_gap)
    backend16, _ = _sdpa_backend(q.bfloat16(), k.bfloat16(), v.bfloat16())
    assert backend16 in ("FLASH_ATTENTION", "CUDNN_ATTENTION")


@pytest.mark.cuda
def test_full_width_segformer_on_card_matches_reference(card):
    """``segformer_b5`` on the card at 256 x 256 with the recipe's weights:
    f32 (TF32 off) within f32's tolerance of the f64 reference, bf16
    autocast within bf16's."""
    m = CONFIG["model"]
    params = make_params(11, card, m, torch.float32)
    x = torch.rand(1, 4, 256, 256, device=card, generator=torch.Generator(card).manual_seed(2))
    want = reference.segformer_logits(x.double(), {k: v.double() for k, v in params.items()}, m)
    model = SegmentationModel(model_type="segformer_b5")
    load_into(model.network, params)
    net = model.network.to(card).eval()
    with torch.no_grad(), float32_precision():
        got = net(x)
        with torch.autocast("cuda", dtype=torch.bfloat16):
            got16 = net(x)
    assert rel_gap(got, want) < TOL[torch.float32]
    assert TOL[torch.float32] < rel_gap(got16, want) < TOL[torch.bfloat16]
