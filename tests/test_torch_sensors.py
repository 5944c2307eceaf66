"""The port's sensor simulation and SRF tables (starcop_tpu_torch.data.sensors,
.data.srf) against the JAX package on the CPU.

Bars: the SRF weight functions, the tables, the solar geometry and the CSV path
exact; ``radiance_to_reflectance`` within 1e-6 relative (the same three f32
operations); the WV3 and S2 simulations within 1e-6 of JAX's f32 result
relative to its largest value (~8 f32 ulps; JAX's f32 run and its f64-product
run differ by ~2e-7 here); the bilinear resize, which the port computes in
f64, no farther from JAX's f64 resize than JAX's own f32 resize is.
"""

import filecmp
import os
from datetime import datetime, timezone

import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from starcop_tpu.data import sensors as jsensors  # noqa: E402
from starcop_tpu.data import srf as jsrf  # noqa: E402
from starcop_tpu_torch.data import sensors  # noqa: E402
from starcop_tpu_torch.data import srf  # noqa: E402

FULL_WL = np.arange(380.0, 2511.0, 5.0)  # 427 bands, 380-2510 nm
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "srf_s2a_b12.csv")
SIM_BAR = 1e-6


def _close(got, want, bar=SIM_BAR):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= bar, err


@pytest.fixture(scope="module")
def full_cube():
    """A 64 x 40 cube over 380-2510 nm at 5 nm (f32)."""
    return np.random.default_rng(5).uniform(0.5, 5.0, size=(64, 40, len(FULL_WL))).astype(
        np.float32)


# ---------------------------------------------------------------------------
# SRF weight functions, tables, solar geometry: exact
# ---------------------------------------------------------------------------


def test_srf_asset_byte_identical():
    port = os.path.join(os.path.dirname(srf.__file__), "..", "assets", "srf_tables.npz")
    jax_asset = os.path.join(os.path.dirname(jsrf.__file__), "..", "assets", "srf_tables.npz")
    assert filecmp.cmp(port, jax_asset, shallow=False)


@pytest.mark.parametrize("sensor", ["S2A", "S2B", "WV3"])
def test_tables_exact(sensor, tmp_path):
    for got, want in ((srf.get_srf(sensor, cache=False), jsrf.get_srf(sensor, cache=False)),
                      (srf.build_srf_table(sensor), jsrf.build_srf_table(sensor))):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2]
    with np.load(srf.write_srf_asset(str(tmp_path / "t.npz"))) as a, \
            np.load(jsrf.write_srf_asset(str(tmp_path / "j.npz"))) as b:
        assert a.files == b.files and all(np.array_equal(a[k], b[k]) for k in a.files)


@pytest.mark.parametrize("sensor,bands", [("S2A", None), ("S2B", ["B11", "B12"]),
                                          ("WV3", None), ("WV3", ["SWIR5", "SWIR8"])])
def test_srf_table_weights_exact(sensor, bands):
    got, gb = srf.srf_table_weights(FULL_WL, sensor, bands=bands)
    want, wb = jsrf.srf_table_weights(FULL_WL, sensor, bands=bands)
    np.testing.assert_array_equal(got, want)
    assert gb == wb


def test_csv_path_exact():
    got, want = srf.load_srf_csv(FIXTURE), jsrf.load_srf_csv(FIXTURE)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2] == ["B12"]
    wl = np.arange(2000.0, 2400.0, 5.0)
    np.testing.assert_array_equal(
        srf.srf_table_weights(wl, "S2A", ["B12"], path_override=FIXTURE)[0],
        jsrf.srf_table_weights(wl, "S2A", ["B12"], path_override=FIXTURE)[0])


@pytest.mark.parametrize("table", ["WV3_SWIR_CENTERS_FWHM", "S2_BAND_CENTERS_FWHM"])
@pytest.mark.parametrize("wl", [FULL_WL, np.arange(2122.0, 2488.0, 5.0)])
def test_gaussian_weights_and_covered_bands_exact(table, wl):
    t = getattr(sensors, table)
    assert t == getattr(jsensors, table)
    cov = sensors.covered_bands(wl, t)
    assert cov == jsensors.covered_bands(wl, t)
    if cov:
        got, gb = sensors.gaussian_srf_weights(wl, t, cov)
        want, wb = jsensors.gaussian_srf_weights(wl, t, cov)
        np.testing.assert_array_equal(got, want)
        assert gb == wb


def test_srf_from_table_exact():
    wl_aviris = np.array([500.0, 505.0, 510.0, 515.0])
    srf_wl = np.array([499.0, 504.0, 506.0, 511.0])
    vals = np.array([[0.2, 0.0], [0.4, 1e-5], [0.4, 0.3], [0.2, 0.9]])
    np.testing.assert_array_equal(sensors.srf_from_table(wl_aviris, srf_wl, vals),
                                  jsensors.srf_from_table(wl_aviris, srf_wl, vals))


@pytest.mark.parametrize("when", [datetime(2019, 10, 21, 19, 0, tzinfo=timezone.utc),
                                  datetime(2019, 1, 4, 12, 30),
                                  datetime(2020, 2, 29, 5, 0, tzinfo=timezone.utc)])
def test_solar_geometry_exact(when):
    assert sensors.earth_sun_distance_correction_factor(when) == \
        jsensors.earth_sun_distance_correction_factor(when)
    assert sensors.solar_zenith_angle(31.9, -102.1, when) == \
        jsensors.solar_zenith_angle(31.9, -102.1, when)
    assert sensors.observation_date_correction_factor((-102.1, 31.9), when) == \
        jsensors.observation_date_correction_factor((-102.1, 31.9), when)
    assert sensors.SOLAR_IRRADIANCE == jsensors.SOLAR_IRRADIANCE
    assert sensors.BANDS_S2_RESOLUTION == jsensors.BANDS_S2_RESOLUTION


@pytest.mark.parametrize("fill_value", [None, -9999.0])
def test_radiance_to_reflectance(fill_value):
    rng = np.random.default_rng(2)
    rad = rng.uniform(1, 300, size=(3, 9, 11)).astype(np.float32)
    rad[:, 2:4, 5] = -9999.0
    si = [1.8743, 0.24708, 0.08775]
    factor = sensors.observation_date_correction_factor(
        (-102.1, 31.9), datetime(2019, 10, 21, 19, 0, tzinfo=timezone.utc))
    got = sensors.radiance_to_reflectance(torch.from_numpy(rad), si, factor, fill_value)
    want = np.asarray(jsensors.radiance_to_reflectance(jnp.asarray(rad), si, factor, fill_value))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    if fill_value is not None:
        assert (got.numpy()[:, 2:4, 5] == fill_value).all()


# ---------------------------------------------------------------------------
# Simulations on a full-spectrum cube
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [{}, {"scale": 2.0}, {"bands": ["SWIR5", "SWIR7"], "scale": 1.6},
                                {"srf_source": "gaussian"}])
def test_worldview_3_matches_jax(kw, full_cube):
    got, gb = sensors.transform_to_worldview_3(full_cube, FULL_WL, device="cpu", **kw)
    want, wb = jsensors.transform_to_worldview_3(jnp.asarray(full_cube), FULL_WL, **kw)
    assert gb == wb and got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("sensor", ["S2A", "S2B"])
def test_sentinel_2_matches_jax(sensor, full_cube):
    """All 13 bands with the 10/8 downscale (64 x 40 -> 51 x 32) and the
    per-band sigmas (3.25 at 60 m: radius 10)."""
    bands = sensors.covered_bands(FULL_WL, sensors.S2_BAND_CENTERS_FWHM)
    assert len(bands) == 13
    got, _ = sensors.transform_to_sentinel_2(full_cube, FULL_WL, bands=bands, sensor=sensor,
                                             device="cpu")
    want, _ = jsensors.transform_to_sentinel_2(jnp.asarray(full_cube), FULL_WL, bands=bands,
                                               sensor=sensor)
    assert tuple(got.shape) == (13, 51, 32)
    _close(got, want)


def test_sentinel_2_measured_csv_and_valid_mask(full_cube):
    valid = np.ones(full_cube.shape[:2], bool)
    valid[10:20, 5:9] = False
    kw = dict(bands=["B12"], srf_csv=FIXTURE, valid_mask=valid, fill_value=-1.0)
    got, _ = sensors.transform_to_sentinel_2(full_cube, FULL_WL, device="cpu", **kw)
    want, _ = jsensors.transform_to_sentinel_2(jnp.asarray(full_cube), FULL_WL, **kw)
    _close(got, want)


def test_f64_cube_keeps_jax_dtypes(full_cube):
    """An f64 cube: the product in f64 without a blur (as JAX's under x64),
    f32 after one (JAX's blur runs in f32)."""
    cube = full_cube[:16, :12].astype(np.float64)
    got, _ = sensors.transform_to_worldview_3(cube, FULL_WL, device="cpu")
    want, _ = jsensors.transform_to_worldview_3(jnp.asarray(cube), FULL_WL)
    assert got.dtype == torch.float64 and np.asarray(want).dtype == np.float64
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)
    got, _ = sensors.transform_to_worldview_3(cube, FULL_WL, scale=2.0, device="cpu")
    want, _ = jsensors.transform_to_worldview_3(jnp.asarray(cube), FULL_WL, scale=2.0)
    assert got.dtype == torch.float32 and np.asarray(want).dtype == np.float32
    _close(got, want)


@pytest.mark.parametrize("shape,sigma", [((3, 7), 3.25), ((5, 40), 0.75), ((1, 1), 3.25)])
def test_blur_narrower_than_its_radius(shape, sigma):
    """A band narrower than the blur's radius: the reflect pad repeats as
    jnp.pad's does (F.pad(mode="reflect") would refuse it)."""
    band = np.random.default_rng(3).normal(size=shape).astype(np.float32)
    got = sensors.gaussian_blur(torch.from_numpy(band), sigma)
    want = np.asarray(jsensors.gaussian_blur(jnp.asarray(band), sigma))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_resize_f64_within_jax_own_f32_error():
    """At S2's 10/8 downscale of a full scene (1024 x 640 -> 819 x 512): the
    port's resize (f64 inside) is no farther from JAX's f64 resize than
    JAX's own f32 resize is."""
    x = np.random.default_rng(4).normal(size=(1, 1024, 640)).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x, jnp.float64), (1, 819, 512), "bilinear"))
    j32 = np.asarray(jax.image.resize(jnp.asarray(x), (1, 819, 512), "bilinear"))
    got = sensors.resize_bilinear(torch.from_numpy(x), (819, 512))
    assert got.dtype == torch.float32
    e_port = np.abs(got.numpy() - ref).max()
    e_jax = np.abs(j32 - ref).max()
    assert e_port <= e_jax, (e_port, e_jax)
