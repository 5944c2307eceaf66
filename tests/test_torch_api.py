"""The port's package API (starcop_tpu_torch and its subpackages'
``__init__``) against the JAX package's, and ``ops.mag1c.spd_inverse_newton``
against JAX's, on the CPU.

Each subpackage of the port exposes every name that its JAX counterpart's
``__init__`` re-exports (parsed from the JAX file and checked on the
imported JAX module), with two documented maps:

  * ``models.cast_variables_for_inference`` -> ``models.cast_for_inference``
    (it casts a module in place instead of returning a cast variable tree);
  * ``utils.enable_persistent_compilation_cache`` -> none (the kernels'
    build cache is ``ops/_build.py``'s).

Importing every subpackage builds no kernel and imports nothing of JAX.
``spd_inverse_newton`` in float64 equals JAX's to 1e-10 of the inverse's
largest entry; in float32 its forward error meets JAX's own bar
(tests/test_mag1c.py:656-680: at most 3x the float32 Cholesky route's, or
1e-5).
"""

import ast
import importlib
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

import cpu_share  # noqa: E402,F401

from starcop_tpu.ops import mag1c as jm  # noqa: E402
from starcop_tpu_torch.ops import mag1c as tm  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
SUBPACKAGES = ("ops", "models", "data", "scenes", "serve", "eval", "parallel", "train", "utils")
# JAX name -> the port's name (None: no counterpart), per subpackage.
NAME_MAPS = {
    "models": {"cast_variables_for_inference": "cast_for_inference"},
    "utils": {"enable_persistent_compilation_cache": None},
}


def jax_exports(sub: str):
    """The names the JAX package's ``__init__`` imports (its re-exports)."""
    path = ROOT / "starcop_tpu" / (f"{sub}/__init__.py" if sub else "__init__.py")
    names = []
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.ImportFrom):
            names += [a.asname or a.name for a in node.names]
    return names


@pytest.mark.parametrize("sub", SUBPACKAGES + ("",))
def test_subpackage_exports_jax_names(sub):
    names = jax_exports(sub)
    assert names, sub
    jmod = importlib.import_module("starcop_tpu" + (f".{sub}" if sub else ""))
    tmod = importlib.import_module("starcop_tpu_torch" + (f".{sub}" if sub else ""))
    renames = NAME_MAPS.get(sub, {})
    for name in names:
        assert hasattr(jmod, name), f"starcop_tpu.{sub}: {name}"
        port_name = renames.get(name, name)
        if port_name is None:
            assert not hasattr(tmod, name), f"{sub}.{name} is mapped to no counterpart"
            continue
        assert hasattr(tmod, port_name), f"starcop_tpu_torch.{sub} lacks {port_name}"
    for name, port_name in renames.items():
        assert name in names and not hasattr(tmod, name), (sub, name)
        if port_name is not None:
            assert callable(getattr(tmod, port_name))


def test_top_level_config_is_the_ports():
    import starcop_tpu_torch
    from starcop_tpu_torch import config

    assert starcop_tpu_torch.config is config
    assert config.Config().training.accelerator == "gpu"


def test_exports_are_the_modules_objects():
    """A re-export is the defining module's object, not a copy."""
    from starcop_tpu_torch import data, models, ops, scenes, serve
    from starcop_tpu_torch.data import datamodule, features
    from starcop_tpu_torch.models import baselines, segmenter
    from starcop_tpu_torch.scenes import aviris_pipeline, emit_pipeline
    from starcop_tpu_torch.serve import pipeline

    assert ops.mag1c_column_blocks is tm.mag1c_column_blocks and ops.NODATA == tm.NODATA
    assert models.SegmentationModel is segmenter.SegmentationModel
    assert models.cast_for_inference is segmenter.cast_for_inference
    assert models.Mag1cBaseline is baselines.Mag1cBaseline
    assert data.DataModule is datamodule.DataModule and data.FEATURES is features.FEATURES
    assert scenes.emit_mag1c is emit_pipeline.emit_mag1c
    assert scenes.run_mag1c_groups is aviris_pipeline.run_mag1c_groups
    assert serve.ScenePipeline is pipeline.ScenePipeline
    # As in JAX, spd_inverse_newton is exported from ops.mag1c, not from ops.
    assert hasattr(jm, "spd_inverse_newton") and hasattr(tm, "spd_inverse_newton")
    assert not hasattr(importlib.import_module("starcop_tpu.ops"), "spd_inverse_newton")
    assert not hasattr(ops, "spd_inverse_newton")


def test_importing_every_subpackage_builds_no_kernel():
    """In a fresh interpreter: every subpackage, the examples and the
    experiments import without building a kernel (``ops/_build.load`` not
    called) and without importing JAX."""
    mods = [f"starcop_tpu_torch.{s}" for s in SUBPACKAGES] + [
        "starcop_tpu_torch.experiments.paper_reproduction",
        "starcop_tpu_torch.experiments.srf_sensitivity",
        "starcop_tpu_torch.examples.model_demo_synthetic",
        "starcop_tpu_torch.examples.dataset_exploration",
        "starcop_tpu_torch.examples.srf_simulation_demo",
        "starcop_tpu_torch.examples.training_demo",
        "starcop_tpu_torch.examples.emit_zero_shot",
    ]
    code = "\n".join([
        "import sys",
        *[f"import {m}" for m in mods],
        "from starcop_tpu_torch.ops import _build",
        "assert _build.load.cache_info().currsize == 0, _build.load.cache_info()",
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'starcop_tpu')]",
        "assert not bad, bad",
        "print('ok')",
    ])
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-2000:]


# ---------------------------------------------------------------------------
# spd_inverse_newton
# ---------------------------------------------------------------------------


def _shrunk_covariance(x64):
    """JAX's test's covariance class: the diagonally shrunk radiance
    covariance of each batch entry (tests/test_mag1c.py:662-667)."""
    xm = x64 - x64.mean(axis=1, keepdims=True)
    c64 = np.einsum("bps,bpt->bst", xm, xm) / x64.shape[1]
    return (1 - 1e-4) * c64 + 1e-4 * np.eye(c64.shape[-1]) * np.diagonal(
        c64, axis1=-2, axis2=-1)[:, None, :]


def test_spd_inverse_newton_matches_jax(synthetic_radiance):
    x64, _ = synthetic_radiance
    c64 = _shrunk_covariance(x64)
    truth = np.linalg.inv(c64)
    assert np.linalg.cond(c64).max() < 2**24  # the regime the iteration count covers

    def rel(k):
        return np.abs(np.asarray(k, np.float64) - truth).max() / np.abs(truth).max()

    # float64: the same recurrence, seed and symmetrisation as JAX's.
    k_j64 = np.asarray(jm.spd_inverse_newton(jnp.asarray(c64)))
    k_t64 = tm.spd_inverse_newton(torch.from_numpy(c64)).numpy()
    assert k_t64.dtype == np.float64 and np.array_equal(k_t64, k_t64.transpose(0, 2, 1))
    assert np.abs(k_t64 - k_j64).max() <= 1e-10 * np.abs(k_j64).max()
    assert rel(k_t64) <= 1e-6, rel(k_t64)

    # float32: JAX's forward-error bar against the f32 Cholesky route.
    c32 = c64.astype(np.float32)
    k_t32 = tm.spd_inverse_newton(torch.from_numpy(c32)).numpy()
    with jax.default_matmul_precision("highest"):
        k_cho = np.asarray(jm._cho_inverse(jnp.asarray(c32)), np.float64)
        k_j32 = np.asarray(jm.spd_inverse_newton(jnp.asarray(c32)), np.float64)
    assert k_t32.dtype == np.float32
    assert rel(k_t32) <= max(3.0 * rel(k_cho), 1e-5), (rel(k_t32), rel(k_cho))
    assert rel(k_t32) <= 3.0 * rel(k_j32) + 1e-6, (rel(k_t32), rel(k_j32))


def test_spd_inverse_newton_num_iter_and_batch_shapes():
    """``num_iter`` is the recurrence's step count (0 returns the seed
    I / ||C||_inf); any leading batch shape, an unbatched matrix too."""
    rng = np.random.default_rng(3)
    a = rng.normal(size=(2, 3, 40, 6))
    c = np.einsum("...ps,...pt->...st", a, a) / 40 + 0.1 * np.eye(6)
    k = tm.spd_inverse_newton(torch.from_numpy(c)).numpy()
    np.testing.assert_allclose(k, np.linalg.inv(c), rtol=1e-9, atol=1e-12)
    seed = tm.spd_inverse_newton(torch.from_numpy(c), num_iter=0).numpy()
    np.testing.assert_allclose(
        seed, np.eye(6) / np.abs(c).sum(-1).max(-1)[..., None, None], rtol=1e-15)
    k1 = tm.spd_inverse_newton(torch.from_numpy(c[0, 0])).numpy()
    np.testing.assert_allclose(k1, k[0, 0], rtol=1e-12)
    j = np.asarray(jm.spd_inverse_newton(jnp.asarray(c), num_iter=5))
    np.testing.assert_allclose(tm.spd_inverse_newton(torch.from_numpy(c), num_iter=5).numpy(),
                               j, rtol=1e-10, atol=1e-14)
