"""The port's AVIRIS scene path against the JAX package: get_mask_bad_bands,
the bucket ladder, run_mag1c_groups / run_mag1c_scene, cli/mag1c, the
filter's energy series and compute_dtype.

Same inputs, made with numpy seeds, go through both packages on the CPU. At
float64 both run the plain filter, held at the JAX suite's 1e-6
(tests/test_pipeline.py:237-288). At float32 the port runs the kernels' plain
twins (acrwl1mf_fused's fused rounds) and JAX its plain XLA filter, held at
the port's filter bars: mf correlation > 0.9999 and threshold-500 agreement
>= 0.999 with detections, albedo within rtol 1e-4.
"""

import numpy as np
import pytest

import jax.numpy as jnp

torch = pytest.importorskip("torch")

import cpu_share  # noqa: E402,F401

from starcop_tpu.cli import mag1c as jcli  # noqa: E402
from starcop_tpu.data import geotiff as jgeotiff  # noqa: E402
from starcop_tpu.data.synthetic import synthetic_scene  # noqa: E402
from starcop_tpu.ops import ch4_template as jct  # noqa: E402
from starcop_tpu.ops import mag1c as jm  # noqa: E402
from starcop_tpu.scenes import aviris_pipeline as jav  # noqa: E402
from starcop_tpu_torch.cli import mag1c as tcli  # noqa: E402
from starcop_tpu_torch.data.geotiff import load_raster  # noqa: E402
from starcop_tpu_torch.ops import ch4_template as tct  # noqa: E402
from starcop_tpu_torch.ops import mag1c as tm  # noqa: E402
from starcop_tpu_torch.ops import mag1c_fused as tfused  # noqa: E402
from starcop_tpu_torch.scenes import aviris_pipeline as tav  # noqa: E402

F64 = dict(compute_dtype=torch.float64, device="cpu")
F32 = dict(device="cpu")


def _assert_f32_parity(mf, ref, alb=None, alb_ref=None):
    a, b = np.asarray(mf, np.float64).ravel(), np.asarray(ref, np.float64).ravel()
    live = b != -9999.0
    assert np.array_equal(a != -9999.0, live)
    assert np.corrcoef(a[live], b[live])[0, 1] > 0.9999
    assert (b > 500).sum() > 0
    assert ((a[live] > 500) == (b[live] > 500)).mean() >= 0.999
    if alb is not None:
        np.testing.assert_allclose(np.asarray(alb), np.asarray(alb_ref), rtol=1e-4)


def _scene(seed, h, w, n_plumes=1):
    sc = synthetic_scene(np.random.default_rng(seed), h, w, n_plumes=n_plumes,
                         max_concentration=8000.0)
    return sc["radiance"].astype(np.float64), sc["template"]


def test_get_mask_bad_bands_equal():
    wave = np.arange(350.0, 2550.5, 0.5)
    got = tct.get_mask_bad_bands(wave)
    assert np.array_equal(got, jct.get_mask_bad_bands(wave))
    assert got.sum() < len(wave) and got[wave == 2485.0].all() and not got[wave == 2485.5].any()


def test_bucket_sizes_equal():
    sizes = list(range(1, 20001))
    got = tav._bucket_sizes(sizes)
    assert got == jav._bucket_sizes(sizes)
    assert sorted(set(got.values()))[:6] == [128, 256, 384, 512, 768, 1024]


@pytest.mark.parametrize("scale", [1.0, 0.7])
def test_groups_per_column_f64(scale):
    """The JAX suite's per-column case (tests/test_pipeline.py:237-253) in
    float64: the port equals JAX's groups and its own column blocks."""
    cube, template = _scene(3, 32, 24)
    groups = np.broadcast_to(np.arange(24) // 8, (32, 24))
    kw = dict(template=template, num_iter=3, alpha=1e-4, covariance_update_scaling=scale)
    mf, alb = tav.run_mag1c_groups(cube, groups, None, **kw, **F64)
    mf_j, alb_j = jav.run_mag1c_groups(cube, groups, None, **kw, compute_dtype=jnp.float64)
    np.testing.assert_allclose(mf, mf_j, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(alb, alb_j, rtol=1e-6, atol=1e-6)
    if scale == 1.0:
        mf_b, _ = tm.mag1c_column_blocks(cube, template, None, column_step=8, num_iter=3,
                                         alpha=1e-4, **F64)
        np.testing.assert_allclose(mf, mf_b.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("scale", [1.0, 0.7])
def test_groups_f32_kernel_twins(scale):
    """float32: the fused rounds' twins against JAX's f32 filter on ragged
    groups of AVIRIS's 74 bands: two buckets (600 and 1,024 pixels) and a
    group below the skip rule. Groups of a few hundred pixels at 74 bands are
    ill-conditioned in f32 (the Woodbury rounds, JAX's Pallas route as much
    as the port's, part from the f64 filter by up to 5e-4 in correlation), so
    the groups here hold as many pixels as a detector column's."""
    cube, template = _scene(8, 512, 10, n_plumes=2)
    groups = np.broadcast_to(np.arange(10) // 2, (512, 10))
    valid = np.ones((512, 10), bool)
    valid[:212, :2] = False
    valid[:, 8:] = False
    valid[5:10, 8] = True  # group 4: 5 valid pixels, skipped
    kw = dict(template=template, num_iter=30, alpha=1e-4, covariance_update_scaling=scale)
    mf, alb = tav.run_mag1c_groups(cube.astype(np.float32), groups, valid, **kw, **F32)
    mf_j, alb_j = jav.run_mag1c_groups(cube.astype(np.float32), groups, valid, **kw,
                                       compute_dtype=jnp.float32)
    mf_64, _ = tav.run_mag1c_groups(cube, groups, valid, **kw, **F64)
    assert mf.dtype == np.float32 and (mf[:, 8:] == -9999.0).all() and (alb[:, 8:] == -9999.0).all()
    live = mf_j != -9999.0
    _assert_f32_parity(mf, mf_j, alb[live], alb_j[live])
    _assert_f32_parity(mf, mf_64)


def test_groups_skip_tiny_and_fill_value():
    """tests/test_pipeline.py:256-266: a group of 6 valid pixels is skipped;
    its pixels and the invalid ones carry ``fill_value``."""
    cube, template = _scene(4, 16, 12, n_plumes=0)
    groups = np.zeros((16, 12), int)
    groups[:, -1] = 99
    valid = np.ones((16, 12), bool)
    valid[6:, -1] = False
    for fill in (-9999.0, -1.0):
        mf, alb = tav.run_mag1c_groups(cube, groups, valid, template=template, num_iter=2,
                                       fill_value=fill, **F64)
        mf_j, alb_j = jav.run_mag1c_groups(cube, groups, valid, template=template, num_iter=2,
                                           fill_value=fill, compute_dtype=jnp.float64)
        assert np.all(mf[:, -1] == fill) and np.all(alb[:, -1] == fill)
        assert np.all(mf[:, :-1] != fill)
        np.testing.assert_allclose(mf, mf_j, rtol=1e-6, atol=1e-6)


def test_groups_chunks_unpadded(monkeypatch):
    """tests/test_pipeline.py:453-475: five groups at groups_per_batch=2 run as
    chunks of 2, 2 and 1 groups (no padded rows, a deviation from JAX), equal
    to one-shot batching and to JAX's padded chunks."""
    cube, template = _scene(7, 24, 30, n_plumes=0)
    groups = np.broadcast_to(np.arange(30) // 6, (24, 30))
    kw = dict(template=template, num_iter=2, alpha=1e-4)
    mf, _ = tav.run_mag1c_groups(cube, groups, None, groups_per_batch=2, **kw, **F64)
    mf_all, _ = tav.run_mag1c_groups(cube, groups, None, groups_per_batch=64, **kw, **F64)
    mf_j, _ = jav.run_mag1c_groups(cube, groups, None, groups_per_batch=2, **kw,
                                   compute_dtype=jnp.float64)
    assert np.isfinite(mf).all()
    np.testing.assert_allclose(mf, mf_all, rtol=1e-8)
    np.testing.assert_allclose(mf, mf_j, rtol=1e-6, atol=1e-6)

    seen = []
    real = tfused.acrwl1mf_fused

    def spy(x, *args, **kwargs):
        seen.append(tuple(x.shape))
        return real(x, *args, **kwargs)

    monkeypatch.setattr(tfused, "acrwl1mf_fused", spy)
    mf32, _ = tav.run_mag1c_groups(cube.astype(np.float32), groups, None,
                                   groups_per_batch=2, **kw, **F32)
    assert seen == [(2, 256, cube.shape[-1]), (2, 256, cube.shape[-1]), (1, 256, cube.shape[-1])]
    assert np.isfinite(mf32).all()


def test_zero_weight_rows_leave_real_rows():
    """A padded row of zero weights (n clamped to 1, C0 = 0) neither raises
    nor changes the real rows of acrwl1mf_fused's fused route."""
    cube, template = _scene(9, 32, 8)
    xb = cube.reshape(2, 128, cube.shape[-1]).astype(np.float32)
    wb = (np.random.default_rng(9).random((2, 128)) > 0.1).astype(np.float32)
    padded_x = np.concatenate([xb, np.zeros_like(xb[:1])])
    padded_w = np.concatenate([wb, np.zeros_like(wb[:1])])
    kw = dict(num_iter=5, alpha=1e-4, device="cpu")
    mf, r = tfused.acrwl1mf_fused(xb, template, wb, **kw)
    mf_p, r_p = tfused.acrwl1mf_fused(padded_x, template, padded_w, **kw)
    assert torch.isfinite(mf_p[:2]).all() and torch.isfinite(r_p[:2]).all()
    np.testing.assert_allclose(mf_p[:2].numpy(), mf.numpy(), rtol=1e-6, atol=1e-3)
    np.testing.assert_allclose(r_p[:2].numpy(), r.numpy(), rtol=1e-6)
    assert (mf_p[2] == 0).all() and (r_p[2] == 1).all()


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_scene_band_masking(dtype):
    """tests/test_pipeline.py:269-280: the band mask and the wavelength window
    leave 36 of 40 bands; the port equals JAX's scene."""
    rng = np.random.default_rng(5)
    wl = np.arange(2100.0, 2500.0, 10.0)
    fwhm = np.full_like(wl, 10.0)
    cube = rng.uniform(1, 5, size=(24, 16, len(wl)))
    glt = np.broadcast_to(np.arange(16) // 8, (24, 16))
    if dtype == "f64":
        mf, alb = tav.run_mag1c_scene(cube, wl, fwhm, glt_samples=glt, num_iter=2, **F64)
        mf_j, alb_j = jav.run_mag1c_scene(cube, wl, fwhm, glt_samples=glt, num_iter=2,
                                          compute_dtype=jnp.float64)
        np.testing.assert_allclose(mf, mf_j, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(alb, alb_j, rtol=1e-6, atol=1e-6)
    else:
        mf, alb = tav.run_mag1c_scene(cube.astype(np.float32), wl, fwhm, glt_samples=glt,
                                      num_iter=2, **F32)
        mf_j, alb_j = jav.run_mag1c_scene(cube.astype(np.float32), wl, fwhm, glt_samples=glt,
                                          num_iter=2)
        assert np.corrcoef(mf.ravel(), mf_j.ravel())[0, 1] > 0.9999
        np.testing.assert_allclose(alb, alb_j, rtol=1e-4)
    assert mf.shape == (24, 16) and np.isfinite(mf).all()


@pytest.mark.parametrize("glt", [False, True])
def test_mag1c_cli_matches_jax(tmp_path, glt):
    """Both modes of the CLI (tests/test_aux.py:106-127's scene) against JAX's
    CLI output: values at the f32 bars, the same tags and descriptions."""
    scene = synthetic_scene(np.random.default_rng(0), 64, 64, n_plumes=1)
    wl = np.arange(2122.0, 2488.0, 5.0)
    np.save(tmp_path / "scene.npy", scene["radiance"])
    np.save(tmp_path / "wl.npy", wl)
    np.save(tmp_path / "fwhm.npy", np.full_like(wl, 5.5))
    args = [str(tmp_path / "scene.npy"), "--wavelengths", str(tmp_path / "wl.npy"),
            "--fwhm", str(tmp_path / "fwhm.npy"), "--column-step", "16", "--num-iter", "5"]
    if glt:
        np.save(tmp_path / "glt.npy", np.broadcast_to(np.arange(64) // 16, (64, 64)))
        args += ["--glt", str(tmp_path / "glt.npy")]
    out = {}
    for name, main, extra in (("port", tcli.main, ["--device", "cpu"]), ("jax", jcli.main, [])):
        mf_path, alb_path = tmp_path / f"{name}_mf.tif", tmp_path / f"{name}_alb.tif"
        assert main(args + ["--output", str(mf_path), "--albedo-output", str(alb_path)]
                    + extra) == 0
        out[name] = (load_raster(str(mf_path)), load_raster(str(alb_path)))
    (mf, alb), (mf_j, alb_j) = out["port"], out["jax"]
    assert mf.shape == (64, 64) and mf.dtype == np.float32 and mf.max() > 500
    _assert_f32_parity(mf, mf_j, alb, alb_j)
    # The same tags and band descriptions: the port's raster rewritten by JAX's
    # writer with JAX's metadata is byte-identical to the port's file.
    tags = {"wavelengths": ",".join(f"{w:.1f}" for w in wl), "mag1c": "acfwl1mf"}
    for arr, name, desc in ((mf, "mf", "CH4 Absorption (ppm x m)"), (alb, "alb", "Albedo")):
        ref = jgeotiff.save_raster(str(tmp_path / f"ref_{name}.tif"), arr, nodata=-9999.0,
                                   tags=tags, descriptions=[desc])
        assert (tmp_path / f"port_{name}.tif").read_bytes() == open(ref, "rb").read()
    if glt:  # in-process, the CLI's result is run_mag1c_scene's
        want, _ = tav.run_mag1c_scene(scene["radiance"], wl, np.full_like(wl, 5.5),
                                      glt_samples=np.broadcast_to(np.arange(64) // 16, (64, 64)),
                                      num_iter=5, alpha=1e-4, **F32)
        assert np.array_equal(mf, want)


def _energy_inputs(masked):
    rng = np.random.default_rng(12)
    s, p = 6, 48
    tpl = -np.abs(np.sin(np.linspace(0.3, 3.0, s)))
    x = rng.uniform(0.5, 2.0, (2, p, 1)) * rng.uniform(2.0, 6.0, (2, 1, s))
    x = x * (1 + 0.05 * rng.normal(size=(2, p, s)))
    x[:, :6] *= np.exp(3000.0 * tpl / 1e5)
    w = (rng.random((2, p)) > 0.2).astype(np.float64) if masked else None
    return x, tpl, w


@pytest.mark.parametrize("masked", [False, True])
def test_energy_series_matches_jax(masked):
    """The energy of rmf and the series of acrwl1mf against JAX's at f64 (a
    mask sums only its valid rows, JAX's deviation); unmasked, the oracle's
    literal (B, P, P) series too."""
    x, tpl, w = _energy_inputs(masked)
    xt, tt = torch.from_numpy(x), torch.from_numpy(tpl)
    wt = None if w is None else torch.from_numpy(w)
    wj = None if w is None else jnp.asarray(w)
    mf, r, e = tm.rmf(xt, tt, wt, alpha=1e-3, compute_energy=True)
    mf_j, r_j, e_j = jm.rmf(jnp.asarray(x), jnp.asarray(tpl), wj, alpha=1e-3, compute_energy=True)
    assert e.shape == ()
    np.testing.assert_allclose(float(e), float(e_j), rtol=1e-9)
    np.testing.assert_allclose(mf.numpy(), np.asarray(mf_j), rtol=1e-9, atol=1e-12)
    kw = dict(num_iter=4, alpha=1e-3, covariance_update_scaling=0.8)
    mf, r, es = tm.acrwl1mf(xt, tt, wt, compute_energy=True, **kw)
    mf_j, r_j, es_j = jm.acrwl1mf(jnp.asarray(x), jnp.asarray(tpl), wj, compute_energy=True, **kw)
    assert es.shape == (5,)
    np.testing.assert_allclose(es.numpy(), np.asarray(es_j), rtol=1e-9)
    np.testing.assert_allclose(mf.numpy(), np.asarray(mf_j), rtol=1e-8, atol=1e-8)
    assert tm.acrwl1mf(xt, tt, wt, **kw)[0].shape == mf.shape  # two outputs without it
    if not masked:
        mf_o, _, es_o = tm.reference_oracle_acrwl1mf(x, tpl, compute_energy=True, **kw)
        _, _, es_oj = jm.reference_oracle_acrwl1mf(x, tpl, compute_energy=True, **kw)
        np.testing.assert_allclose(es_o, es_oj, rtol=1e-12)
        np.testing.assert_allclose(es.numpy(), es_o, rtol=1e-8)


@pytest.mark.parametrize("case", ["mask_ragged", "unmasked"])
def test_column_blocks_f64_matches_jax(case):
    """mag1c_column_blocks(compute_dtype=float64) against JAX's f64 route."""
    cube, template = _scene(6, 40, 32)
    x, valid = cube, None
    if case == "mask_ragged":
        x, valid = cube[:, :30], np.random.default_rng(1).random((40, 30)) > 0.1
    kw = dict(column_step=8, num_iter=4, alpha=1e-4)
    mf, alb = tm.mag1c_column_blocks(x, template, valid, **kw, **F64)
    mf_j, alb_j = jm.mag1c_column_blocks(jnp.asarray(x), jnp.asarray(template),
                                         None if valid is None else jnp.asarray(valid),
                                         compute_dtype=jnp.float64, **kw)
    assert mf.dtype == torch.float64
    np.testing.assert_allclose(mf.numpy(), np.asarray(mf_j), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(alb.numpy(), np.asarray(alb_j), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        tm.mag1c_column_blocks(x, template, None, compute_dtype=torch.float16, **kw, device="cpu")
