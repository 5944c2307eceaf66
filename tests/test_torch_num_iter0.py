"""``mag1c_column_blocks(num_iter=0)``, the rmf-only result, against the JAX
package: JAX routes it to its plain XLA ``acrwl1mf`` on every platform
(starcop_tpu/ops/mag1c.py:621-630) and the port to its plain ``acrwl1mf``
over the same blocks. The bar is the JAX suite's own for this route
(tests/test_mag1c.py:827-828): rtol 1e-4, atol 2.0 and threshold-500
agreement >= 0.999. The kernel filters refuse num_iter=0, as JAX's
``acrwl1mf_fused`` does (tests/test_mag1c.py:810-811)."""

import numpy as np
import pytest

import jax.numpy as jnp

torch = pytest.importorskip("torch")

import cpu_share  # noqa: E402,F401

from starcop_tpu.ops import mag1c as jm  # noqa: E402
from starcop_tpu.scenes import emit_pipeline as jep  # noqa: E402
from starcop_tpu_torch.ops import mag1c as tm  # noqa: E402
from starcop_tpu_torch.ops import mag1c_kernels as tk  # noqa: E402
from starcop_tpu_torch.ops.mag1c_fused import acrwl1mf_fused  # noqa: E402
from starcop_tpu_torch.scenes import emit_pipeline as tep  # noqa: E402

H, W, S, STEP = 128, 48, 12, 16


def _cube(seed=11):
    rng = np.random.default_rng(seed)
    template = -np.abs(np.sin(np.linspace(0.3, 3 * np.pi, S)))
    base = rng.uniform(2.0, 6.0, size=(1, 1, S))
    x = rng.uniform(0.5, 2.0, (H, W, 1)) * base * (1 + 0.02 * rng.normal(size=(H, W, S)))
    conc = np.zeros((H, W))
    conc[40:80, 10:30] = rng.uniform(1000, 6000, size=(40, 20))
    x = x * np.exp(conc[..., None] * template[None, None, :] / 1e5)
    return x.astype(np.float32), template.astype(np.float32)


def _assert_rmf_parity(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2.0)
    assert (want > 500).sum() > 0
    assert ((got > 500) == (want > 500)).mean() >= 0.999


@pytest.mark.parametrize("case", ["unmasked", "masked", "ragged", "shw", "empty_block"])
def test_num_iter0_matches_jax(case):
    """``empty_block``: block 1 has no valid pixel (C = 0, JAX's Cholesky
    gives NaN there); it comes out at the fill value and nothing raises."""
    x, tpl = _cube()
    valid = None
    if case in ("masked", "empty_block"):
        valid = np.random.default_rng(7).random((H, W)) >= 0.01
        valid[5:9, 3:30] = False
        if case == "empty_block":
            valid[:, STEP:2 * STEP] = False
        x[~valid] = tm.NODATA
    elif case == "ragged":
        x = np.ascontiguousarray(x[:, :45])  # 45 = 2 * 16 + 13
    kw = dict(column_step=STEP, num_iter=0, alpha=1e-4)
    scene, layout = x, "hws"
    if case == "shw":
        scene, layout = np.ascontiguousarray(x.transpose(2, 0, 1)), "shw"
    mf, alb = tm.mag1c_column_blocks(scene, tpl, valid, scene_layout=layout, device="cpu", **kw)
    mf_j, alb_j = jm.mag1c_column_blocks(jnp.asarray(scene), jnp.asarray(tpl), valid,
                                         scene_layout=layout, compute_dtype=jnp.float32, **kw)
    assert mf.shape == x.shape[:2] and mf.dtype == torch.float32
    fill = np.asarray(mf_j) == tm.NODATA
    np.testing.assert_array_equal(mf.numpy() == tm.NODATA, fill)
    np.testing.assert_array_equal(alb.numpy() == tm.NODATA, fill)
    if valid is not None:
        np.testing.assert_array_equal(fill, ~valid)
    _assert_rmf_parity(mf.numpy()[~fill], np.asarray(mf_j)[~fill])
    np.testing.assert_allclose(alb.numpy()[~fill], np.asarray(alb_j)[~fill], rtol=1e-4)


def test_num_iter0_bf16_stream_is_the_f32_result():
    """stream_dtype is still validated but does not change the result (JAX's
    XLA path also runs at compute_dtype, starcop_tpu/ops/mag1c.py:753-756)."""
    x, tpl = _cube()
    kw = dict(column_step=STEP, num_iter=0, alpha=1e-4, device="cpu")
    mf, _ = tm.mag1c_column_blocks(x, tpl, None, **kw)
    mf_b, _ = tm.mag1c_column_blocks(x, tpl, None, stream_dtype=torch.bfloat16, **kw)
    assert torch.equal(mf, mf_b)
    with pytest.raises(ValueError, match="stream_dtype"):
        tm.mag1c_column_blocks(x, tpl, None, stream_dtype=torch.float16, **kw)


def test_emit_mag1c_num_iter0_returns():
    """emit_mag1c(num_iter=0) returns (it raised in the kernel filters) and
    agrees with JAX's emit_mag1c."""
    rng = np.random.default_rng(3)
    centers = np.arange(2122.0, 2488.0, 7.4)
    fwhm = np.full_like(centers, 8.0)
    nbands = len(centers)
    radiance = (rng.uniform(0.5, 2.0, (64, 40, 1)) * rng.uniform(2.0, 6.0, (1, 1, nbands))
                * (1 + 0.02 * rng.normal(size=(64, 40, nbands)))).astype(np.float32)
    kw = dict(column_step=20, num_iter=0)
    mf, alb = tep.emit_mag1c(radiance, centers, fwhm, device="cpu", **kw)
    mf_j, alb_j = jep.emit_mag1c(radiance, centers, fwhm, **kw)
    assert mf.shape == alb.shape == (64, 40) and np.isfinite(mf).all()
    np.testing.assert_allclose(mf, np.asarray(mf_j), rtol=1e-4, atol=2.0)
    np.testing.assert_allclose(alb, np.asarray(alb_j), rtol=1e-4)


@pytest.mark.parametrize("route", ["resident", "masked", "resident_bsp", "masked_bf16", "fused"])
def test_kernel_filters_refuse_num_iter0(route):
    x, tpl = _cube()
    valid = np.ones((H, W), bool)
    nb = W // STEP
    with pytest.raises(ValueError, match="num_iter must be >= 1"):
        if route == "resident":
            tk.acrwl1mf_resident(x, tpl, nb, STEP, num_iter=0, device="cpu")
        elif route == "masked":
            tk.acrwl1mf_masked(x, tpl, valid, nb, STEP, num_iter=0, device="cpu")
        elif route == "resident_bsp":
            tk.acrwl1mf_resident_bsp(x, tpl, nb, STEP, num_iter=0, device="cpu")
        elif route == "masked_bf16":
            tk.acrwl1mf_masked_bf16(x, tpl, valid, nb, STEP, num_iter=0, device="cpu")
        else:
            acrwl1mf_fused(tm.block_columns(torch.from_numpy(x), nb, STEP), tpl, num_iter=0,
                           device="cpu")
