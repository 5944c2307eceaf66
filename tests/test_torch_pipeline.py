"""The port's slice, raw granule -> plume mask, against the JAX package, plus
the host-side pieces it carries (padding, renormalisation, template, synthetic
scenes) and the port's guards (no JAX imports, no silent CPU fallback)."""

import ast
import filecmp
import pathlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

import cpu_share  # noqa: E402,F401

from starcop_tpu.data import emit as jemit  # noqa: E402
from starcop_tpu.data.synthetic import synthetic_scene as j_synthetic_scene  # noqa: E402
from starcop_tpu.models import SegmentationModel as FlaxSegmentationModel  # noqa: E402
from starcop_tpu.ops import ch4_template as jct  # noqa: E402
from starcop_tpu.ops import padding as jpad  # noqa: E402
from starcop_tpu.scenes import emit_pipeline as jpipe  # noqa: E402
from starcop_tpu_torch import device as tdevice  # noqa: E402
from starcop_tpu_torch.cli.prepare_data import process_scene  # noqa: E402
from starcop_tpu_torch.data import emit as temit  # noqa: E402
from starcop_tpu_torch.data.mining import mag1c_window_stats  # noqa: E402
from starcop_tpu_torch.data.sensors import transform_to_worldview_3  # noqa: E402
from starcop_tpu_torch.data.synthetic import synthetic_scene  # noqa: E402
from starcop_tpu_torch.models.segmenter import EMIT_INPUT_PRODUCTS, SegmentationModel  # noqa: E402
from starcop_tpu_torch.models.weights import flax_to_torch_state_dict  # noqa: E402
from starcop_tpu_torch.ops import ch4_template as tct  # noqa: E402
from starcop_tpu_torch.ops import padding as tpad  # noqa: E402
from starcop_tpu_torch.ops.mag1c import mag1c_column_blocks  # noqa: E402
from starcop_tpu_torch.ops.mag1c_kernels import acrwl1mf_resident  # noqa: E402
from starcop_tpu_torch.scenes import emit_pipeline as tpipe  # noqa: E402
from starcop_tpu_torch.serve.pipeline import emit_serving_pipeline  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
H, W, S, STEP = 128, 48, 12, 16


def _scene():
    template = -np.abs(np.sin(np.linspace(0.3, 3 * np.pi, S)))
    sc = synthetic_scene(np.random.default_rng(2), H, W, n_plumes=2, template=template,
                         max_concentration=8000.0)
    rgb = np.ascontiguousarray(np.moveaxis(sc["rgb"], -1, 0))
    return sc["radiance"], rgb, template.astype(np.float32)


def test_granule_to_mask_matches_jax():
    cube, rgb, tpl = _scene()
    jmodel = FlaxSegmentationModel(list(EMIT_INPUT_PRODUCTS), model_type="unet_semseg",
                                   encoder_weights=None)
    init = jax.jit(lambda key, x: jmodel.init(key, x))
    variables = init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 32, 32), jnp.float32))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    stats = jax.tree_util.tree_leaves_with_path(variables["batch_stats"])
    rng = np.random.default_rng(0)
    for path, leaf in stats:  # randomised BN statistics
        node = variables["batch_stats"]
        for key in path[:-1]:
            node = node[key.key]
        node[path[-1].key] = (rng.uniform(0.8, 1.2, leaf.shape) if path[-1].key == "var"
                              else rng.normal(0, 0.05, leaf.shape)).astype(np.float32)

    model = SegmentationModel(EMIT_INPUT_PRODUCTS).eval()
    model.network.load_state_dict(flax_to_torch_state_dict(variables), strict=True)
    kw = dict(column_step=STEP, num_iter=4, alpha=1e-4)
    pred_t, mf_t = tpipe.emit_granule_to_mask(cube, rgb, tpl, model, device="cpu", **kw)
    assert isinstance(pred_t, torch.Tensor) and pred_t.device.type == "cpu"
    pred, mf = pred_t.numpy(), mf_t.numpy()

    fused = jax.jit(lambda c, r: jpipe.emit_granule_to_mask(
        c, r, jnp.asarray(tpl), lambda b: jmodel.apply(variables, b, train=False), **kw))
    pred_j, mf_j = (np.asarray(a) for a in fused(jnp.asarray(cube), jnp.asarray(rgb)))

    assert pred.shape == mf.shape == (H, W) and pred.dtype == np.float32
    a, b = mf.astype(np.float64).ravel(), mf_j.astype(np.float64).ravel()
    assert np.corrcoef(a, b)[0, 1] > 0.9999
    assert (b > 500).sum() > 0 and ((a > 500) == (b > 500)).mean() >= 0.999
    assert np.corrcoef(pred.ravel(), pred_j.ravel())[0, 1] > 0.9999
    assert (np.abs(pred - pred_j) <= 1e-3).mean() >= 0.999


def test_emit_mag1c_matches_jax():
    """Band selection + template + filter; unmasked (resident twins) and
    masked (weighted plain route) against the JAX package on the CPU."""
    rng = np.random.default_rng(4)
    wl = np.arange(2000.0, 2560.0, 10.0)
    fwhm = np.full_like(wl, 9.0)
    sel = (wl >= 2122.0) & (wl <= 2488.0)
    tpl = jct.generate_template_from_bands(wl[sel], fwhm[sel])[:, 1]
    full_tpl = np.zeros(len(wl))
    full_tpl[sel] = tpl
    sc = synthetic_scene(rng, 64, 32, n_plumes=2, template=full_tpl, max_concentration=8000.0)
    valid = np.ones((64, 32), bool)
    valid[:4] = False
    for mask in (None, valid):
        got = tpipe.emit_mag1c(sc["radiance"], wl, fwhm, mask, column_step=16, num_iter=3,
                               device="cpu")
        want = jpipe.emit_mag1c(sc["radiance"], wl, fwhm, mask, column_step=16, num_iter=3)
        np.testing.assert_array_equal(got[0] == -9999.0, want[0] == -9999.0)
        keep = want[0] != -9999.0
        assert np.corrcoef(got[0][keep], want[0][keep])[0, 1] > 0.9999
        np.testing.assert_allclose(got[1][keep], want[1][keep], rtol=1e-4)


@pytest.mark.parametrize("shape", [(3, 37, 50), (2, 64, 32), (1, 5, 70)])
def test_padded_apply_matches_jax(shape):
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    for v in (1, 31, 32, 33, 1242):
        assert tpad.find_padding(v, 32) == jpad.find_padding(v, 32)
    fn3 = lambda b: 2 * b[:, :1] + b.sum(1, keepdims=True)  # noqa: E731
    got = tpad.padded_apply(torch.from_numpy(x), fn3, divisor=32).numpy()
    want = np.asarray(jpad.padded_apply(jnp.asarray(x), fn3, divisor=32))
    assert got.shape == (1,) + shape[1:]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    fn2 = lambda b: b[:, 0]  # noqa: E731  (1, H', W') output: cropped to (H, W)
    got = tpad.padded_apply(torch.from_numpy(x), fn2, divisor=32).numpy()
    np.testing.assert_array_equal(got, np.asarray(jpad.padded_apply(jnp.asarray(x), fn2)))


def test_renormalize_constants_and_template_match_jax():
    rng = np.random.default_rng(0)
    mf, rgb = rng.uniform(-100, 900, (8, 9)), rng.uniform(0, 60, (3, 8, 9))
    got = temit.renormalize_emit_to_aviris(torch.from_numpy(mf), torch.from_numpy(rgb))
    want = jemit.renormalize_emit_to_aviris(mf, rgb)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6)
    for name in ("MAGIC_DIV_BY", "MAGIC_MULT_BY", "RGB_DIV_BY", "RGB_MULT_BY",
                 "DEFAULT_WAVELENGTH_RANGE"):
        assert getattr(temit, name) == getattr(jemit, name)
    assert filecmp.cmp(ROOT / "starcop_tpu_torch/assets/ch4_lut.npz",
                       ROOT / "starcop_tpu/assets/ch4_lut.npz", shallow=False)
    centers = np.arange(2122.0, 2488.0, 7.4)
    np.testing.assert_array_equal(
        tct.generate_template_from_bands(centers, np.full_like(centers, 8.0)),
        jct.generate_template_from_bands(centers, np.full_like(centers, 8.0)))


def test_synthetic_scene_matches_jax():
    got = synthetic_scene(np.random.default_rng(3), 40, 24, n_plumes=2, n_confounders=1)
    want = j_synthetic_scene(np.random.default_rng(3), 40, 24, n_plumes=2, n_confounders=1)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])


def test_port_imports_nothing_of_jax():
    """Every module of the port and chip_smoke.py: no import of jax, flax,
    optax or the JAX package."""
    banned = {"jax", "jaxlib", "flax", "optax", "starcop_tpu"}
    files = sorted((ROOT / "starcop_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    assert {ROOT / "starcop_tpu_torch" / rel for rel in (
        "cli/__init__.py", "cli/serve.py", "cli/prepare_data.py", "utils/storage.py",
        "data/srf.py", "data/sensors.py", "data/mining.py", "data/permian.py",
        "data/ingest.py", "data/vectorize.py", "data/geo.py", "data/emit.py",
        "parallel/__init__.py", "parallel/mesh.py", "parallel/scene_mag1c.py",
        "parallel/launch.py", "utils/profiling.py", "entry.py",
        "experiments/__init__.py", "experiments/paper_reproduction.py",
        "experiments/srf_sensitivity.py", "examples/__init__.py", "examples/emit_zero_shot.py",
        "examples/model_demo_synthetic.py", "examples/dataset_exploration.py",
        "examples/training_demo.py", "examples/srf_simulation_demo.py")} <= set(files)
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in banned, f"{path}: imports {name}"


def test_entry_points_need_a_card_or_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the no-card refusal cannot be shown")
    cube, rgb, tpl = _scene()
    calls = [
        lambda: tdevice.resolve_device(),
        lambda: mag1c_column_blocks(cube, tpl, column_step=STEP),
        lambda: acrwl1mf_resident(cube, tpl, W // STEP, STEP),
        lambda: tpipe.emit_granule_to_mask(cube, rgb, tpl, lambda b: b[:, :1]),
        lambda: tpipe.emit_mag1c(cube, np.linspace(2122, 2400, S), np.full(S, 8.0)),
        lambda: emit_serving_pipeline(lambda b: b[:, :1], str(tmp_path)),
        lambda: mag1c_window_stats(cube[..., 0], size=16, overlap=8),
        lambda: transform_to_worldview_3(cube, np.linspace(2122, 2400, S)),
        lambda: process_scene(str(tmp_path / "scene"), "s", cube, np.linspace(2122, 2400, S),
                              np.full(S, 8.0)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert tdevice.resolve_device("cpu") == torch.device("cpu")
    assert len(emit_serving_pipeline(lambda b: b[:, :1], str(tmp_path),
                                     devices=[torch.device("cpu")]).compute_fns) == 1


def test_float32_precision_turns_tf32_off_and_restores():
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    try:
        with tdevice.float32_precision():
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
