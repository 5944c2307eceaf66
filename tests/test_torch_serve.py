"""The port's serving runtime (starcop_tpu_torch.serve, data.{native_io,geotiff,emit},
scenes.emit_pipeline) against the JAX package on the CPU.

The same h5 granules, made with numpy seeds, go through both packages'
``emit_serving_pipeline``; the U-Net weights are Flax variables carried into
the port by ``models/weights.py``. The port's own contracts mirror
tests/test_serve.py, with its per-pixel probe for a model: stage overlap
and error isolation, the f16 download, the narrow uploads, odd geometries,
NaN on the u16 wire, several workers.
"""

import os
import threading
import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

import cpu_share  # noqa: E402,F401
h5py = pytest.importorskip("h5py")

from starcop_tpu.data import geotiff as jgeotiff  # noqa: E402
from starcop_tpu.data import native_io as jnative  # noqa: E402
from starcop_tpu.data.emit import EMITRawScene as JEMITRawScene  # noqa: E402
from starcop_tpu.data.emit import glt_gather as j_glt_gather  # noqa: E402
from starcop_tpu.models import SegmentationModel as FlaxSegmentationModel  # noqa: E402
from starcop_tpu.scenes import emit_pipeline as jpipe  # noqa: E402
from starcop_tpu.serve import pipeline as jserve  # noqa: E402
from starcop_tpu_torch.data import geotiff as tgeotiff  # noqa: E402
from starcop_tpu_torch.data import native_io as tnative  # noqa: E402
from starcop_tpu_torch.data.emit import EMITRawScene, glt_gather  # noqa: E402
from starcop_tpu_torch.data.normalizer import DataNormalizer  # noqa: E402
from starcop_tpu_torch.data.synthetic import synthetic_scene  # noqa: E402
from starcop_tpu_torch.models.segmenter import EMIT_INPUT_PRODUCTS, SegmentationModel  # noqa: E402
from starcop_tpu_torch.models.weights import flax_to_torch_state_dict  # noqa: E402
from starcop_tpu_torch.ops.ch4_template import generate_template_from_bands  # noqa: E402
from starcop_tpu_torch.scenes import emit_pipeline as tpipe  # noqa: E402
from starcop_tpu_torch.serve import pipeline as tserve  # noqa: E402
from starcop_tpu_torch.serve.pipeline import ScenePipeline, emit_serving_pipeline  # noqa: E402
from starcop_tpu_torch.utils import staging  # noqa: E402
from tests.test_mag1c import assert_bf16_detection_equivalent  # noqa: E402

WL = np.arange(2100.0, 2490.0, 7.4)  # selects 50 bands in [2122, 2488] nm
CPU = [torch.device("cpu")]
FILL = -9999.0


def _write_granule(path, cube, wl=WL, glt=None):
    with h5py.File(path, "w") as f:
        d = f.create_dataset("radiance", data=cube, chunks=(16, 16, cube.shape[-1]))
        d.attrs["_FillValue"] = [FILL]
        g = f.create_group("sensor_band_parameters")
        g.create_dataset("wavelengths", data=wl)
        g.create_dataset("fwhm", data=np.full_like(wl, 8.5))
        if glt is not None:
            loc = f.create_group("location")
            loc.create_dataset("glt_x", data=glt[0])
            loc.create_dataset("glt_y", data=glt[1])
            f.attrs["geotransform"] = np.array([500000.0, 60.0, 0.0, 4100000.0, 0.0, -60.0])
            f.attrs["spatial_ref"] = 'PROJCS["WGS 84 / UTM 11N",AUTHORITY["EPSG","32611"]]'
    return str(path)


def _granule(tmp_path, name, seed, h=64, w=45, wl=WL, n_plumes=2, glt=None):
    """An h5 granule whose SWIR window carries plumes on the template's
    signal, with fill-marked pixels (a corner in every band, scattered
    pixels in one band of the filter window). Returns (path, cube)."""
    swir = (wl >= 2122) & (wl <= 2488)
    template = generate_template_from_bands(wl[swir], np.full(int(swir.sum()), 8.5))[:, 1]
    scene = synthetic_scene(np.random.default_rng(seed), h, w, n_plumes=n_plumes,
                            template=template)
    rng = np.random.default_rng(seed + 100)
    cube = rng.uniform(1, 8, size=(h, w, len(wl))).astype(np.float32)
    cube[..., swir] = scene["radiance"]
    cube[:3, :5, :] = FILL
    rows, cols = np.nonzero(rng.random((h, w)) < 0.01)
    cube[rows, cols, rng.choice(np.nonzero(swir)[0], rows.size)] = FILL
    return _write_granule(tmp_path / f"{name}.nc", cube, wl, glt), cube


def _suite_granule(tmp_path, name, scene_seed, cube_seed, h, w, corner, wl=WL):
    """tests/test_serve.py's granule: plumes on the template's signal in the
    SWIR window, uniform radiance elsewhere, a fill-marked corner."""
    swir = (wl >= 2122) & (wl <= 2488)
    template = generate_template_from_bands(wl[swir], np.full_like(wl[swir], 8.5))[:, 1]
    scene = synthetic_scene(np.random.default_rng(scene_seed), h, w, n_plumes=2,
                            template=template)
    cube = np.random.default_rng(cube_seed).uniform(1, 8, size=(h, w, len(wl))).astype(np.float32)
    cube[..., swir] = scene["radiance"]
    cube[:corner[0], :corner[1], :] = FILL
    return _write_granule(tmp_path / f"{name}.nc", cube, wl)


@pytest.fixture(scope="module")
def unet():
    """(JAX apply, port model) with the same seeded full-width MobileNetV2
    U-Net: Flax variables of the model's shapes filled from numpy and carried
    into the port. Kaiming-normal (fan-out) kernels and randomised batch-norm
    statistics, as chip_smoke.py's seeded model: the mask spreads (std ~0.3
    here), so a prediction correlation can tell a wrong filter or wire from
    a right one (at fan-in scales the mask is near constant or chaotic)."""
    jmodel = FlaxSegmentationModel(list(EMIT_INPUT_PRODUCTS), model_type="unet_semseg",
                                   encoder_weights=None)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                                jnp.zeros((1, 4, 32, 32), jnp.float32)))
    rng = np.random.default_rng(0)

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":  # (kh, kw, in, out)
            fan_out = int(np.prod(leaf.shape[:2])) * leaf.shape[-1]
            v = rng.normal(size=leaf.shape) * np.sqrt(2.0 / fan_out)
        elif name in ("scale", "var"):
            v = rng.uniform(0.8, 1.2, leaf.shape)
        else:  # bias, mean
            v = rng.normal(0, 0.05, leaf.shape)
        return v.astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(fill, shapes)
    model = SegmentationModel(EMIT_INPUT_PRODUCTS).eval()
    model.network.load_state_dict(flax_to_torch_state_dict(variables), strict=True)
    return (lambda b: jmodel.apply(variables, b, train=False)), model


class _Probe(torch.nn.Module):
    """tests/test_serve.py's "single" model: the input normaliser and one
    seeded 1x1 convolution, a per-pixel linear probe over the products."""

    def __init__(self):
        super().__init__()
        self.normalizer = DataNormalizer(list(EMIT_INPUT_PRODUCTS))
        self.conv = torch.nn.Conv2d(4, 1, 1)
        with torch.no_grad():
            self.conv.weight.copy_(torch.from_numpy(
                np.random.default_rng(0).normal(0, 0.5, (1, 4, 1, 1)).astype(np.float32)))
            self.conv.bias.zero_()

    def forward(self, x):
        return self.conv(self.normalizer.normalize_x(x))


PROBE = _Probe().eval()


def _assert_served_parity(got, want):
    """NODATA set equal, mag1c detection parity, prediction correlation."""
    mf, mf_j = got["mag1c"], np.asarray(want["mag1c"])
    np.testing.assert_array_equal(mf == FILL, mf_j == FILL)
    keep = mf_j != FILL
    assert np.corrcoef(mf[keep], mf_j[keep])[0, 1] > 0.9999
    assert (mf_j[keep] > 500).sum() > 0
    assert ((mf[keep] > 500) == (mf_j[keep] > 500)).mean() >= 0.999
    p, p_j = got["prediction"].ravel(), np.asarray(want["prediction"]).ravel()
    assert np.corrcoef(p, p_j)[0, 1] > 0.9999


# ---------------------------------------------------------------------------
# ScenePipeline: the contracts of tests/test_serve.py:14-73
# ---------------------------------------------------------------------------


def test_pipeline_basic_order_and_results():
    written = {}
    results = ScenePipeline(lambda n: {"v": int(n)}, lambda p: {"out": p["v"] * 2},
                            lambda n, o: written.__setitem__(n, o["out"])).run(["1", "2", "3"])
    assert len(results) == 3 and all(r.error is None for r in results)
    assert written == {"1": 2, "2": 4, "3": 6}
    assert all({"read_s", "compute_s", "write_s"} <= set(r.timings) for r in results)


def test_pipeline_overlaps_stages():
    """The reader of scene N+1 runs while scene N computes."""
    events, lock = [], threading.Lock()

    def read_fn(name):
        with lock:
            events.append(f"read_start_{name}")
        time.sleep(0.05)
        return {}

    def compute_fn(payload):
        time.sleep(0.1)
        with lock:
            events.append("compute_end")
        return {}

    t0 = time.time()
    ScenePipeline(read_fn, compute_fn).run(["a", "b", "c"])
    wall = time.time() - t0
    # Sequential: 3 * (0.05 + 0.1) = 0.45 s; pipelined: ~0.05 + 3 * 0.1.
    assert wall < 0.42, wall
    assert events.index("read_start_b") < events.index("compute_end")


def test_pipeline_error_isolation():
    def read_fn(name):
        if name == "bad_read":
            raise IOError("corrupt granule")
        return {"v": name}

    def compute_fn(payload):
        if payload["v"] == "bad_compute":
            raise ValueError("device fault")
        return {"o": payload["v"]}

    def write_fn(name, outputs):
        if name == "bad_write":
            raise OSError("disk full")

    names = ["ok1", "bad_read", "bad_compute", "bad_write", "ok2"]
    by_name = {r.name: r for r in ScenePipeline(read_fn, compute_fn, write_fn).run(names)}
    assert set(by_name) == set(names)
    assert "corrupt" in by_name["bad_read"].error and by_name["bad_read"].error.startswith("read")
    assert by_name["bad_compute"].error.startswith("compute")
    assert by_name["bad_write"].error.startswith("write")
    assert by_name["ok1"].error is None and by_name["ok2"].error is None
    with pytest.raises(ValueError, match="exactly one"):
        ScenePipeline(read_fn)


# ---------------------------------------------------------------------------
# Host codecs, GeoTIFF, the granule reader
# ---------------------------------------------------------------------------


def _unpack(case, wire, shape):
    """The grid values q (..., S) of a u12 or u10 wire of a cube of ``shape``."""
    w = wire.astype(np.uint16)
    if case == "pack12":
        q = np.stack([w[0] | ((w[1] & 0xF) << 8), (w[1] >> 4) | (w[2] << 4)], axis=-1)
        return q.reshape(shape)
    q = np.stack([w[0] | ((w[1] & 0x3) << 8), (w[1] >> 2) | ((w[2] & 0xF) << 6),
                  (w[2] >> 4) | ((w[3] & 0x3F) << 4), (w[3] >> 6) | (w[4] << 2)], axis=1)
    return q.reshape(-1, shape[-1])[:int(np.prod(shape[:-1]))].reshape(shape)


@pytest.mark.parametrize("case", ["valid_band_minmax", "band_minmax", "pack12", "pack10"])
def test_native_io_encoders_match_jax_numpy(case, monkeypatch):
    """The port's codecs (its native library) and their numpy twins are
    byte-identical to the JAX package's native library (what JAX's served
    path runs), and to its numpy fallback (the library switched off) but at
    half grid steps, which that fallback rounds to even and both libraries
    up: there, and only there, the grid values part by exactly one step."""
    rng = np.random.default_rng(1)
    cube = rng.uniform(0, 9, (37, 29, 6)).astype(np.float32)  # 1073 pixels: odd quads
    cube[3, 4, :] = FILL
    cube[5, 6, 2] = FILL
    cube[7, 8, 1] = np.nan
    valid, lo, hi = tnative.valid_band_minmax(cube, FILL)
    jax_native = {}
    if case in ("pack12", "pack10"):
        top = 4095.0 if case == "pack12" else 1023.0
        scale = np.maximum((hi - lo) / top, 1e-12).astype(np.float32)
        fn = "quantize_pack12" if case == "pack12" else "quantize_pack10"
        jax_native = getattr(jnative, fn)(cube, lo, scale)
    monkeypatch.setattr(jnative, "_load", lambda: None)
    if case == "valid_band_minmax":
        for n_mm in (None, 0, 4):
            want = jnative.valid_band_minmax(cube, FILL, n_minmax_bands=n_mm)
            for fn in (tnative.valid_band_minmax, tnative.valid_band_minmax_plain):
                for got, w in zip(fn(cube, FILL, n_minmax_bands=n_mm), want):
                    assert (got is None and w is None) or np.array_equal(got, w)
        assert not valid[3, 4] and not valid[5, 6] and valid[7, 8]
    elif case == "band_minmax":
        dead = cube.copy()
        dead[..., 5] = np.nan  # an all-NaN band pins (0, 1)
        for v in (None, valid):
            want = jnative.band_minmax(dead, v)
            for fn in (tnative.band_minmax, tnative.band_minmax_plain):
                for got, w in zip(fn(dead, v), want):
                    assert got.dtype == w.dtype and np.array_equal(got, w)
    else:
        got = getattr(tnative, fn)(cube, lo, scale)
        assert got.dtype == np.uint8 and np.array_equal(got, jax_native)
        assert np.array_equal(getattr(tnative, fn + "_plain")(cube, lo, scale), got)
        # JAX's numpy fallback: the same grid values but where f = (x - lo) /
        # scale sits at a half step, which it rounds to even and the
        # libraries up (f + 0.5 in f32): there, and only there, one step up.
        q_got, q_fb = (_unpack(case, w, cube.shape) for w in
                       (got, getattr(jnative, fn)(cube, lo, scale)))
        f = (cube - lo) * (1.0 / scale)
        near_half = np.abs(f - np.floor(f) - 0.5) < 1e-3
        diff = q_got.astype(np.int32) - q_fb.astype(np.int32)
        assert np.isin(diff, (0, 1)).all() and not (diff[~near_half]).any()
        rule = (np.clip(np.floor(f + np.float32(0.5)), 0, top) - np.clip(np.rint(f), 0, top))
        assert np.array_equal(diff, np.nan_to_num(rule).astype(np.int32))
        with pytest.raises(ValueError):
            getattr(tnative, fn)(cube[..., :5] if case == "pack12" else cube, lo[:3], scale[:3])


@pytest.mark.parametrize("kind", ["scene_f32", "bands_u16"])
def test_write_geotiff_byte_identical(kind, tmp_path):
    rng = np.random.default_rng(2)
    if kind == "scene_f32":
        arr = rng.normal(size=(300, 270)).astype(np.float32)
        kw = dict(nodata=FILL, descriptions=["CH4 Absorption (ppm x m)"], compress=False)
    else:
        arr = rng.integers(0, 60000, (3, 140, 90)).astype(np.uint16)
        kw = dict(transform=(60.0, 0.0, 5e5, 0.0, -60.0, 4.1e6), crs_epsg=32611,
                  tags={"wavelength": "2122-2488"}, compress=6)
    got = tgeotiff.write_geotiff(str(tmp_path / "port.tif"), arr, **kw)
    want = jgeotiff.write_geotiff(str(tmp_path / "jax.tif"), arr, **kw)
    with open(got, "rb") as a, open(want, "rb") as b:
        assert a.read() == b.read()
    back, meta = tgeotiff.read_geotiff(want)
    assert np.array_equal(back.reshape(arr.shape), arr)
    assert meta.nodata == kw.get("nodata") and meta.crs_epsg == kw.get("crs_epsg")
    window = (7, 11, 40, 33)
    np.testing.assert_array_equal(tgeotiff.read_geotiff(got, window=window)[0],
                                  jgeotiff.read_geotiff(want, window=window)[0])


def test_emit_raw_scene_and_glt_match_jax(tmp_path):
    h, w = 32, 24
    rng = np.random.default_rng(3)
    glt = (rng.integers(0, w + 1, (40, 30)), rng.integers(0, h + 1, (40, 30)))
    path, cube = _granule(tmp_path, "EMIT_geo", 3, h=h, w=w, glt=glt)
    port, ref = EMITRawScene(path), JEMITRawScene(path)
    try:
        sel = port.band_slice()
        np.testing.assert_array_equal(sel, ref.band_slice())
        np.testing.assert_array_equal(port.read_bands(sel), ref.read_bands(sel))
        np.testing.assert_array_equal(port.read_rgb(), ref.read_rgb())
        np.testing.assert_array_equal(port.invalid_mask(cube), ref.invalid_mask(cube))
        assert (port.transform, port.crs_epsg) == (ref.transform, ref.crs_epsg)
        assert port.crs_epsg == 32611 and port.fill_value == ref.fill_value == FILL
        raster = rng.normal(size=(h, w)).astype(np.float32)
        np.testing.assert_array_equal(port.georeference(raster), ref.georeference(raster))
        np.testing.assert_array_equal(glt_gather(*glt, raster, 0.0),
                                      j_glt_gather(*glt, raster, 0.0))
    finally:
        port.close()
        ref.close()


# ---------------------------------------------------------------------------
# emit_serving_pipeline against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("upload,download", [
    ("f32", "f16"), ("f32", "f32"), ("u12", "f16"), ("u10", "f16"), ("u16", "f16"),
    ("bf16", "f16")])
def test_serving_matches_jax(upload, download, unet, tmp_path):
    japply, model = unet
    path, _ = _granule(tmp_path, "EMIT_par", 5)
    jax_up = {"f32": None, "u12": "u12", "u10": "u10", "u16": jnp.uint16,
              "bf16": jnp.bfloat16}[upload]
    kw = dict(column_step=16, num_iter=3)
    (got,) = emit_serving_pipeline(model, str(tmp_path / "port"), devices=CPU,
                                   upload_dtype=upload, download_dtype=download, **kw).run([path])
    (want,) = jserve.emit_serving_pipeline(japply, str(tmp_path / "jax"), upload_dtype=jax_up,
                                           download_dtype=download, **kw).run([path])
    assert got.error is None and want.error is None
    assert got.outputs["mag1c"].shape == (64, 45)
    _assert_served_parity(got.outputs, want.outputs)
    base = tmp_path / "port" / "EMIT_par"
    mag1c, meta = tgeotiff.read_geotiff(str(base / "mag1c.tif"))
    np.testing.assert_array_equal(mag1c[0], got.outputs["mag1c"])
    assert meta.nodata == FILL


def test_f16_clamp_where_jax_gives_inf(monkeypatch, tmp_path):
    """The one intended deviation: |mf| past the f16 range (x16) saturates at
    +-65504 * 16 on the port's f16 download, where JAX's cast gives inf."""
    path, cube = _granule(tmp_path, "EMIT_big", 6, h=16, w=16)
    (r0, c0), (r1, c1) = np.argwhere(~(cube == FILL).any(-1))[[20, 40]]

    def huge(cube, rgb, template, model_apply, **kw):
        h, w = cube.shape[:2]
        if isinstance(cube, torch.Tensor):
            mf = torch.zeros((h, w))
            mf[r0, c0], mf[r1, c1] = 2e6, -2e6
        else:
            mf = jnp.zeros((h, w)).at[r0, c0].set(2e6).at[r1, c1].set(-2e6)
        return mf * 0, mf

    monkeypatch.setattr(jpipe, "emit_granule_to_mask", huge)
    monkeypatch.setattr(tserve, "emit_granule_to_mask", huge)
    (got,) = emit_serving_pipeline(None, str(tmp_path / "p"), devices=CPU).run([path])
    (want,) = jserve.emit_serving_pipeline(None, str(tmp_path / "j")).run([path])
    assert got.error is None and want.error is None
    mf, mf_j = got.outputs["mag1c"], want.outputs["mag1c"]
    assert mf[r0, c0] == 65504.0 * 16 and mf[r1, c1] == -65504.0 * 16
    assert np.isposinf(mf_j[r0, c0]) and np.isneginf(mf_j[r1, c1])
    assert np.isfinite(mf).all() and mf[0, 0] == FILL


def test_pipeline_f16_download_contract(tmp_path):
    """The lossy f16 default against the f32 download: prediction within
    2^-11, mag1c within 2^-11 relative, NODATA restored exactly."""
    model = PROBE
    path = _suite_granule(tmp_path, "EMIT_dl", 21, 22, 96, 64, (3, 5))
    res = {}
    for down in ("f32", "f16"):
        (r,) = emit_serving_pipeline(model, str(tmp_path / down), column_step=16, num_iter=5,
                                     upload_dtype="u10", download_dtype=down,
                                     devices=CPU).run([path])
        assert r.error is None
        res[down] = r.outputs
    mf32, mf16 = res["f32"]["mag1c"], res["f16"]["mag1c"]
    assert np.all(mf16[:3, :5] == FILL)
    valid = mf32 != FILL
    assert np.array_equal(valid, mf16 != FILL)
    denom = np.maximum(np.abs(mf32[valid]), 1.0)
    assert np.max(np.abs(mf16[valid] - mf32[valid]) / denom) <= 2 ** -11 + 1e-7
    p32, p16 = res["f32"]["prediction"], res["f16"]["prediction"]
    assert np.max(np.abs(p16 - p32)) <= 2 ** -11 + 1e-7
    assert np.all((p16 >= 0) & (p16 <= 1))


def test_pipeline_narrow_upload_detection(tmp_path):
    """Each narrow upload against the f32 upload, at tests/test_serve.py's
    contracts (f32 download, to isolate the upload)."""
    model = PROBE
    path = _suite_granule(tmp_path, "EMIT_up", 3, 9, 96, 64, (2, 2))
    outs, preds = {}, {}
    for up in ("f32", "u12", "u10", "u16", "bf16"):
        (r,) = emit_serving_pipeline(model, str(tmp_path / up), column_step=16, num_iter=5,
                                     upload_dtype=up, download_dtype=None,
                                     devices=CPU).run([path])
        assert r.error is None
        assert np.all(r.outputs["mag1c"][:2, :2] == FILL)
        outs[up], preds[up] = r.outputs["mag1c"].ravel(), r.outputs["prediction"].ravel()
    a, thr = outs["f32"], 500.0
    assert (a > 1000).sum() > 50
    big = a > 1000
    for up, agree, rel in (("u16", 0.999, 2e-3), ("u12", 0.999, 5e-3), ("u10", 0.995, 2e-2)):
        assert ((a > thr) == (outs[up] > thr)).mean() >= agree, up
        assert np.median(np.abs(outs[up][big] - a[big]) / a[big]) < rel, up
    assert ((a > thr) == (outs["bf16"] > thr)).mean() >= 0.985
    pf = preds["f32"]
    assert np.abs(preds["u16"] - pf).max() < 0.02
    assert np.abs(preds["u12"] - pf).mean() < 1e-3
    assert ((preds["u12"] > 0.5) == (pf > 0.5)).mean() >= 0.999
    assert np.abs(preds["u10"] - pf).mean() < 2e-3
    assert ((preds["u10"] > 0.5) == (pf > 0.5)).mean() >= 0.995


def test_pipeline_u10_odd_geometry(tmp_path):
    """37 x 29 = 1073 pixels: neither the u10 quads (4) nor the bit-packed
    mask (8) divide it; the last pixel is invalid."""
    model = PROBE
    swir = (WL >= 2122) & (WL <= 2488)
    template = generate_template_from_bands(WL[swir], np.full(int(swir.sum()), 8.5))[:, 1]
    scene = synthetic_scene(np.random.default_rng(31), 37, 29, n_plumes=1, template=template)
    cube = np.random.default_rng(32).uniform(1, 8, size=(37, 29, len(WL))).astype(np.float32)
    cube[..., swir] = scene["radiance"]
    cube[36, 28, :] = FILL
    cube[0, 3, 7] = FILL
    path = _write_granule(tmp_path / "EMIT_odd.nc", cube)
    res = {}
    for up in ("f32", "u10"):
        (r,) = emit_serving_pipeline(model, str(tmp_path / up), column_step=16, num_iter=5,
                                     upload_dtype=up, devices=CPU).run([path])
        assert r.error is None
        res[up] = r.outputs
    mf_f, mf_u = res["f32"]["mag1c"], res["u10"]["mag1c"]
    assert mf_f.shape == mf_u.shape == (37, 29)
    for m in (mf_f, mf_u):
        assert m[36, 28] == FILL and m[0, 3] == FILL
    assert np.array_equal(mf_f == FILL, mf_u == FILL)
    valid = mf_f != FILL
    assert ((mf_f > 500) == (mf_u > 500))[valid].mean() >= 0.995
    assert np.abs(res["u10"]["prediction"] - res["f32"]["prediction"]).mean() < 5e-3


def test_pipeline_u12_odd_band_tail(tmp_path):
    """An odd selected band count: the last band rides as an f32 tail plane."""
    model = PROBE
    wl = np.arange(2104.0, 2490.0, 7.4)
    assert int(((wl >= 2122) & (wl <= 2488)).sum()) % 2 == 1
    path = _suite_granule(tmp_path, "EMIT_tail", 5, 11, 96, 64, (2, 2), wl=wl)
    payload = tserve.encode_payload(tserve.read_granule(path), "u12")
    assert payload["wire"]["q_tail"].shape == (96, 64, 1)
    outs = {}
    for up in ("f32", "u12"):
        (r,) = emit_serving_pipeline(model, str(tmp_path / up), column_step=16, num_iter=5,
                                     upload_dtype=up, devices=CPU).run([path])
        assert r.error is None and np.all(r.outputs["mag1c"][:2, :2] == FILL)
        outs[up] = r.outputs["mag1c"].ravel()
    a = outs["f32"]
    assert (a > 1000).sum() > 50
    assert ((a > 500) == (outs["u12"] > 500)).mean() >= 0.999
    big = a > 1000
    assert np.median(np.abs(outs["u12"][big] - a[big]) / a[big]) < 5e-3


def test_pipeline_u16_wire_nan_determinism(tmp_path):
    """A NaN at a valid pixel reaches the u16 and u10 wires as grid point 0,
    with no platform-defined float -> uint cast."""
    import warnings

    model = PROBE
    path, cube = _granule(tmp_path, "EMIT_nan", 7, h=64, w=48)
    with h5py.File(path, "r+") as f:
        f["radiance"][10, 10, 5] = np.nan
        f["radiance"][12, 12, 2] = np.nan
    for up in ("u16", "u10"):
        pipe = emit_serving_pipeline(model, str(tmp_path / up), column_step=16, num_iter=3,
                                     upload_dtype=up, devices=CPU)
        with warnings.catch_warnings():
            warnings.filterwarnings("error", message=".*invalid value encountered in cast.*")
            (r,) = pipe.run([path])
        assert r.error is None, (up, r.error)
        assert np.isfinite(r.outputs["prediction"]).all(), up


def test_two_cpu_workers_match_one(tmp_path):
    """Scene-parallel serving: one compute worker per device draining a
    shared queue; a scene's outputs do not depend on the worker."""
    model = PROBE
    paths = [_granule(tmp_path, f"EMIT_mc_{i}", 10 + i, h=32, w=32)[0] for i in range(4)]
    two = emit_serving_pipeline(model, str(tmp_path / "two"), column_step=16, num_iter=3,
                                devices=CPU * 2)
    assert len(two.compute_fns) == 2
    res_two = {r.name: r for r in two.run(paths)}
    res_one = {r.name: r for r in emit_serving_pipeline(
        model, str(tmp_path / "one"), column_step=16, num_iter=3, devices=CPU).run(paths)}
    assert set(res_two) == set(paths) and all(r.error is None for r in res_two.values())
    for p in paths:
        for key in ("mag1c", "prediction"):
            np.testing.assert_allclose(res_two[p].outputs[key], res_one[p].outputs[key],
                                       rtol=1e-5, atol=1e-6)


def test_serving_options_refused(tmp_path):
    with pytest.raises(ValueError, match="stream_dtype"):
        emit_serving_pipeline(None, str(tmp_path), stream_dtype=torch.float16, devices=CPU)
    with pytest.raises(ValueError, match="upload_dtype"):
        emit_serving_pipeline(None, str(tmp_path), upload_dtype="u8", devices=CPU)
    with pytest.raises(ValueError, match="download_dtype"):
        emit_serving_pipeline(None, str(tmp_path), download_dtype="bf16", devices=CPU)
    assert [tserve.wire_codec(d) for d in (None, np.uint16, torch.bfloat16, "U12")] == [
        "f32", "u16", "bf16", "u12"]


def test_bf16_wire_matches_ml_dtypes():
    """The bf16 wire rounds as JAX's astype(bfloat16): to nearest even."""
    rng = np.random.default_rng(4)
    x = np.concatenate([rng.normal(0, 100, 5000), [0.0, -0.0, 1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8,
                                                     3.4e38, np.inf, -np.inf]]).astype(np.float32)
    want = np.asarray(jnp.asarray(x).astype(jnp.bfloat16)).view(np.uint16)
    np.testing.assert_array_equal(tserve._bf16_bits(x), want)
    back = tserve.decode_wire("bf16", {"cube": torch.from_numpy(tserve._bf16_bits(x).view(np.int16)),
                                       "rgb": torch.zeros(3, 1, 1),
                                       "valid": torch.from_numpy(np.packbits([True]))}, 1, 1)[0]
    np.testing.assert_array_equal(back.numpy().ravel(),
                                  np.asarray(jnp.asarray(x).astype(jnp.bfloat16), np.float32))


def test_uploader_staging_never_shares_a_buffer(monkeypatch):
    """Through the upload the ``Uploader`` runs on the card (its rings, its
    ``BUFFERS`` a wire array): two wire arrays of one shape and dtype
    (``q_lo`` and ``q_scale``) are staged in buffers of their own within one
    upload, and a buffer whose copy is still queued is not handed out again
    until that copy has finished."""

    class Queued:  # a copy's event: finished only once waited for
        def __init__(self):
            self.finished = False

        def record(self, stream=None):
            pass

        def synchronize(self):
            self.finished = True

    monkeypatch.setattr(torch.cuda, "Event", Queued)
    up = tserve.Uploader("cpu")
    lo = torch.zeros(7)

    def upload():
        return staging.upload({"q_lo": lo, "q_scale": lo}, up.device, None, up.rings,
                              up.BUFFERS)

    uploads = [upload() for _ in range(up.BUFFERS)]
    # q_lo and q_scale apart in each upload, and every queued copy its own buffer
    assert len({w[k].data_ptr() for w, _ in uploads for k in w}) == 2 * up.BUFFERS
    assert not any(ready.finished for _, ready in uploads)
    again, _ = upload()
    first, first_ready = uploads[0]
    assert first_ready.finished  # waited for before its buffers came back
    assert not any(ready.finished for _, ready in uploads[1:])
    assert all(again[k].data_ptr() == first[k].data_ptr() for k in first)


# ---------------------------------------------------------------------------
# emit_inference and emit_granule_to_mask_batched against the JAX package
# ---------------------------------------------------------------------------


def test_emit_inference_matches_jax(unet, tmp_path):
    japply, model = unet
    rng = np.random.default_rng(8)
    glt = (rng.integers(0, 45, (70, 50)), rng.integers(0, 65, (70, 50)))
    path, _ = _granule(tmp_path, "EMIT_inf", 8, glt=glt)
    scene, jscene = EMITRawScene(path), JEMITRawScene(path)
    try:
        got = tpipe.emit_inference(scene, model, column_step=16, num_iter=3, georeference=True,
                                   device="cpu")
        want = jpipe.emit_inference(jscene, jax.jit(japply), column_step=16, num_iter=3,
                                    georeference=True)
    finally:
        scene.close()
        jscene.close()
    assert set(got) == set(want)
    _assert_served_parity(got, want)
    np.testing.assert_array_equal(got["rgb"], want["rgb"])
    keep = want["albedo"] != FILL
    np.testing.assert_allclose(got["albedo"][keep], want["albedo"][keep], rtol=1e-4)
    np.testing.assert_array_equal(got["mag1c_geo"] == FILL, want["mag1c_geo"] == FILL)
    assert np.corrcoef(got["prediction_geo"].ravel(), want["prediction_geo"].ravel())[0, 1] > 0.9999


def test_granule_to_mask_batched_matches_jax(unet):
    japply, model = unet
    swir = (WL >= 2122) & (WL <= 2488)
    tpl = generate_template_from_bands(WL[swir], np.full(int(swir.sum()), 8.5))[:, 1]
    scenes = [synthetic_scene(np.random.default_rng(40 + i), 40, 32, n_plumes=2, template=tpl,
                              max_concentration=8000.0) for i in range(2)]
    cubes = np.stack([s["radiance"] for s in scenes])
    rgbs = np.stack([np.moveaxis(s["rgb"], -1, 0) for s in scenes])
    kw = dict(column_step=16, num_iter=3)
    pred, mf = tpipe.emit_granule_to_mask_batched(cubes, rgbs, tpl, model, device="cpu", **kw)
    assert pred.shape == mf.shape == (2, 40, 32)
    fused = jax.jit(lambda c, r: jpipe.emit_granule_to_mask_batched(
        c, r, jnp.asarray(tpl, jnp.float32), japply, **kw))
    pred_j, mf_j = (np.asarray(a) for a in fused(jnp.asarray(cubes), jnp.asarray(rgbs)))
    _assert_served_parity({"mag1c": mf.numpy(), "prediction": pred.numpy()},
                          {"mag1c": mf_j, "prediction": pred_j})
    one_p, one_mf = tpipe.emit_granule_to_mask(cubes[1], rgbs[1], tpl, model, device="cpu", **kw)
    # One scene's blocks alone or beside another's: the same per-block math,
    # f32 sums over batches of another size.
    np.testing.assert_allclose(mf[1].numpy(), one_mf.numpy(), rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(pred[1].numpy(), one_p.numpy(), atol=1e-5)
    with pytest.raises(ValueError, match="multiple of column_step"):
        tpipe.emit_granule_to_mask_batched(cubes[:, :, :30], rgbs[..., :30], tpl, model,
                                           device="cpu", **kw)


def test_counts_and_precision_hold_across_worker_threads():
    """Compute workers share the launch counts and the process-wide TF32
    switches: many threads at a short switch interval lose no count, and
    TF32 stays off inside every overlapping float32_precision block and is
    restored after the last one."""
    import sys

    from starcop_tpu_torch import device as tdevice
    from starcop_tpu_torch.ops import mag1c_kernels as tk

    old_interval = sys.getswitchinterval()
    old_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    seen_on = []
    tk.reset_launch_counts()

    def work():
        for _ in range(300):
            with tdevice.float32_precision():
                tk._count("filter_glue")
                if torch.backends.cudnn.allow_tf32:
                    seen_on.append(True)

    try:
        sys.setswitchinterval(1e-6)
        threads = [threading.Thread(target=work) for _ in range(3 * (os.cpu_count() or 2))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old_interval)
    assert tk.LAUNCH_COUNTS["filter_glue"] == 300 * len(threads)
    assert not seen_on and torch.backends.cudnn.allow_tf32
    tk.reset_launch_counts()
    torch.backends.cudnn.allow_tf32 = old_tf32


# ---------------------------------------------------------------------------
# The serving CLI, the checkpoint loader and the bf16 stream
# ---------------------------------------------------------------------------


def _flax_variables(rng):
    """Flax variables of the U-Net's shapes (jax.eval_shape, no init
    compile) filled from numpy: LeCun-normal (fan-in) kernels, Flax's
    default, and randomised batch-norm statistics."""
    jmodel = FlaxSegmentationModel(list(EMIT_INPUT_PRODUCTS), model_type="unet_semseg",
                                   encoder_weights=None)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                                jnp.zeros((1, 4, 32, 32), jnp.float32)))

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":  # (kh, kw, in, out)
            v = rng.normal(size=leaf.shape) / np.sqrt(np.prod(leaf.shape[:3]))
        elif name in ("scale", "var"):
            v = rng.uniform(0.8, 1.2, leaf.shape)
        else:  # bias, mean
            v = rng.normal(0, 0.05, leaf.shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _save_npz(path, variables):
    """The JAX package's checkpoint layout (train/checkpoint.py): flat
    "params/..." and "batch_stats/..." keys, plus a step and optimiser state
    a loader must skip."""
    flat = {"step": np.asarray(7), "opt_state/0/mu": np.zeros(3, np.float32)}
    for keys, leaf in jax.tree_util.tree_leaves_with_path(variables):
        flat["/".join(k.key for k in keys)] = np.asarray(leaf)
    np.savez(path, **flat)


def test_load_pretrained_state_dict(tmp_path):
    """A framework .npz (file or folder, setup_shims.py's candidate names)
    gives the Flax variables' state_dict; a Lightning .ckpt its network's."""
    from starcop_tpu_torch.models.weights import CHECKPOINT_NAMES, load_pretrained_state_dict

    variables = _flax_variables(np.random.default_rng(1))
    want = flax_to_torch_state_dict(variables)
    folder = tmp_path / "run"
    folder.mkdir()
    _save_npz(folder / "best.npz", variables)
    for where in (folder, folder / "best.npz"):
        got = load_pretrained_state_dict(str(where))
        assert got.keys() == want.keys()
        assert all(torch.equal(got[k], want[k]) for k in want)
    ckpt = tmp_path / "lightning"
    ckpt.mkdir()
    state = {"network." + k: v for k, v in want.items()}
    state["normalizer.factors"] = torch.ones(4)
    torch.save({"state_dict": state, "epoch": 3}, ckpt / CHECKPOINT_NAMES[0])
    got = load_pretrained_state_dict(str(ckpt))
    assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in want)
    with pytest.raises(ValueError, match="not found"):
        load_pretrained_state_dict(str(tmp_path / "missing"))


def test_serve_cli_matches_jax_cli(tmp_path, capsys, monkeypatch):
    """Both serve CLIs on the same two h5 granules and .npz checkpoint, each
    with its defaults (bf16-resident U-Net, f16 download) and --bf16-stream.
    JAX on the CPU runs its f32 filter whatever the stream, so the port's
    bf16 mag1c is held to the bf16 detection contract against it; the masks
    come from two bf16 U-Nets fed slightly different mf. The granules have
    1,024 rows, so a step-32 block holds 32,768 pixels, near a served EMIT
    granule's 40,960: the smaller the blocks, the more often bf16 dots let a
    pixel escape the L1 reweighting's pin at 0 and end decisively above 500
    (at 512 rows one pixel of 45,197 did once the block means were summed in
    another order; at 64 rows JAX's own bf16 route does, test_torch_bf16.py::
    test_bf16_flips_on_small_blocks_are_jax_own)."""
    from starcop_tpu.cli.serve import main as jax_main
    from starcop_tpu_torch.cli.serve import main as port_main

    monkeypatch.setenv("STARCOP_COMPILE_CACHE", "0")
    gran = tmp_path / "granules"
    gran.mkdir()
    for i in range(2):
        _granule(gran, f"EMIT_cli_{i}", 50 + i, h=1024, w=93)
    (tmp_path / "ckpt").mkdir()
    _save_npz(tmp_path / "ckpt" / "best.npz", _flax_variables(np.random.default_rng(2)))
    common = ["--granules-dir", str(gran), "--checkpoint", str(tmp_path / "ckpt"),
              "--bf16-stream"]
    assert port_main(common + ["--output", str(tmp_path / "port"), "--device", "cpu"]) == 0
    assert jax_main(common + ["--output", str(tmp_path / "jax")]) == 0
    printed = capsys.readouterr().out
    assert printed.count(": ok read") == 4, printed

    for i in range(2):
        out = {}
        for pkg in ("port", "jax"):
            base = tmp_path / pkg / f"EMIT_cli_{i}"
            out[pkg] = {k: tgeotiff.read_geotiff(str(base / f"{k}.tif"))[0][0]
                        for k in ("mag1c", "prediction")}
        mf, mf_j = out["port"]["mag1c"], out["jax"]["mag1c"]
        np.testing.assert_array_equal(mf == FILL, mf_j == FILL)
        keep = mf_j != FILL
        assert (mf_j[keep] > 1000).sum() > 50
        assert_bf16_detection_equivalent(mf_j[keep], mf[keep])
        p, p_j = out["port"]["prediction"], out["jax"]["prediction"]
        assert np.all((p >= 0) & (p <= 1))
        assert np.corrcoef(p.ravel(), p_j.ravel())[0, 1] > 0.99
