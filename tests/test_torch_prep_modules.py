"""The port's data-preparation modules (starcop_tpu_torch.data.{geo, mining,
permian, vectorize, ingest, emit} and .utils.storage) against the JAX
package on the CPU: the JAX suite's cases (tests/test_geo.py,
test_permian.py, test_vectorize.py, test_ingest.py, test_storage.py,
test_emit_pipeline.py) restated as port-vs-JAX cases.

Bars: the host modules (geo, permian, vectorize, ingest, storage, the EMIT
evaluation set) equal to JAX's, value for value and byte for byte.
``mag1c_window_stats`` is held to JAX in production mode (x64 off, f32
percentile positions): max, min, valid fraction exact, percentiles within
1e-6 relative (the same f32 interpolation), mean and sum within 1e-6
relative (f32 sums in another order); under the tests' x64 JAX reads the
percentiles at f64 positions, up to 2e-6 apart at p99 here. Mined ids
equal.
"""

import json
import os
import sys
import tarfile

import numpy as np
import pytest

import jax

torch = pytest.importorskip("torch")

from starcop_tpu.data import emit as jemit  # noqa: E402
from starcop_tpu.data import geo as jgeo  # noqa: E402
from starcop_tpu.data import ingest as jingest  # noqa: E402
from starcop_tpu.data import mining as jmining  # noqa: E402
from starcop_tpu.data import permian as jpermian  # noqa: E402
from starcop_tpu.data import vectorize as jvectorize  # noqa: E402
from starcop_tpu.data.datamodule import BatchLoader as JBatchLoader  # noqa: E402
from starcop_tpu.utils import storage as jstorage  # noqa: E402
from starcop_tpu_torch.data import emit, geo, ingest, mining, permian, vectorize  # noqa: E402
from starcop_tpu_torch.data.geotiff import write_geotiff  # noqa: E402
from starcop_tpu_torch.utils import storage  # noqa: E402

T = (5.0, 0.0, 1000.0, 0.0, -5.0, 2000.0)


# ---------------------------------------------------------------------------
# geo
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("call", [
    ("pixel_to_world", (T, 10, 20)),
    ("world_to_pixel", (T, 1050.0, 1900.0)),
    ("world_to_pixel", ((2.0, 0.5, 3.0, -0.25, -2.0, 7.0), 3.3, -1.7)),
    ("window_transform", (T, 30, 12)),
    ("transforms_compatible", (T, (5.0, 0.0, 0.0, 0.0, -5.0, 9.0))),
    ("transforms_compatible", (T, (10.0, 0.0, 0.0, 0.0, -10.0, 0.0))),
    ("window_from_product", ((5.0, 0.0, 1150.0, 0.0, -5.0, 1940.0), (64, 48), T)),
    ("window_from_product", ((5.0, 0.0, 990.0, 0.0, -5.0, 2012.5), (8, 9), T)),
    ("window_from_product", ((5.0, 0.0, 990.0, 0.0, -5.0, 2012.5), (8, 9), T, False)),
])
def test_geo_matches_jax(call):
    name, args = call
    assert getattr(geo, name)(*args) == getattr(jgeo, name)(*args)


def test_geo_refusals_and_plume_windows():
    for mod in (geo, jgeo):
        with pytest.raises(ValueError, match="different grids"):
            mod.window_from_product(T, (8, 8), (10.0, 0.0, 0.0, 0.0, -10.0, 0.0))
        with pytest.raises(ValueError, match="Singular"):
            mod.world_to_pixel((1.0, 2.0, 0.0, 2.0, 4.0, 0.0), 1.0, 1.0)
    plumes = [{"name": "a", "transform": (5.0, 0.0, 1150.0, 0.0, -5.0, 1940.0), "shape": (4, 4)},
              {"name": "missing", "transform": T, "shape": (4, 4)}]
    products = {"a": {"transform": T}}
    got = geo.process_plume_windows(plumes, products)
    assert got == jgeo.process_plume_windows(plumes, products)
    assert got[0]["window_col_off"] == 30 and got[1]["window_col_off"] == -1


# ---------------------------------------------------------------------------
# mining
# ---------------------------------------------------------------------------


def _mag1c_map():
    """A 1024 x 640 map with nodata holes and, at 256^2 windows, wholly
    invalid ones (the last column band)."""
    rng = np.random.default_rng(0)
    m = rng.normal(100, 300, size=(1024, 640)).astype(np.float32)
    m[:, :100] = -9999.0
    m[600:900, 300:500] = -9999.0
    m[:, 384:] = -9999.0
    return m


def _assert_stats_match(got, want, exact=("window_row_off", "window_col_off", "window_height",
                                          "window_width", "max", "min", "percentage_valids")):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in g:
            if k in exact:
                assert g[k] == w[k], k
            else:
                np.testing.assert_allclose(g[k], w[k], rtol=1e-6, atol=0, err_msg=k)


@pytest.mark.parametrize("size,overlap", [(256, 128), (512, 256)])
def test_window_stats_match_jax_production(size, overlap):
    m = _mag1c_map()
    got = mining.mag1c_window_stats(m, size=size, overlap=overlap, device="cpu")
    with jax.enable_x64(False):
        want = jmining.mag1c_window_stats(m, size=size, overlap=overlap)
    _assert_stats_match(got, want)
    empty = [g for g in got if g["percentage_valids"] == 0]
    assert len(empty) == (7 if size == 256 else 0)  # the 256^2 windows of columns 384-640
    assert all(np.isnan(g["p50"]) and g["max"] == -np.inf for g in empty)


def test_window_stats_x64_difference_is_positions_only():
    """Under x64 JAX reads the percentiles at f64 positions; everything else
    is the production result."""
    m = _mag1c_map()
    got = mining.mag1c_window_stats(m, size=256, overlap=128, device="cpu")
    want = jmining.mag1c_window_stats(m, size=256, overlap=128)
    pct = ("p25", "p50", "p75", "p95", "p99")
    _assert_stats_match([{k: v for k, v in g.items() if k not in pct} for g in got],
                        [{k: v for k, v in w.items() if k not in pct} for w in want])
    for g, w in zip(got, want):
        np.testing.assert_allclose([g[k] for k in pct], [w[k] for k in pct], rtol=1e-5)


def test_window_offsets_and_selection_match_jax():
    for shape in ((1024, 1536), (1024, 640), (300, 200), (512, 512)):
        assert mining.sliding_window_offsets(*shape, 512, 256) == \
            jmining.sliding_window_offsets(*shape, 512, 256)
    rows = [{"window_row_off": r, "window_col_off": c, "window_width": 100,
             "window_height": 100} for r, c in ((0, 0), (50, 50), (200, 200), (400, 0))]
    for n, chosen in ((3, None), (2, [2]), (4, [1])):
        assert mining.select_non_overlapping(rows, n, chosen) == \
            jmining.select_non_overlapping(rows, n, chosen)
    with pytest.raises(ValueError):
        mining.select_non_overlapping(rows, 0)


@pytest.mark.parametrize("seed", [0, 1, 42])
def test_sampling_no_plumes_same_ids(seed):
    """On the window statistics of three scenes (each package's own), the
    same hard and random windows in the same order."""
    stats_t, stats_j = [], []
    for i, name in enumerate(("sceneA", "sceneB", "sceneC")):
        m = np.random.default_rng(10 + i).gamma(2.0, 60.0, size=(1024, 768)).astype(np.float32)
        m[: 100 * i] = -9999.0
        for rows, out in ((mining.mag1c_window_stats(m, 256, 128, device="cpu"), stats_t),
                          (jmining.mag1c_window_stats(m, 256, 128), stats_j)):
            out.extend(dict(r, name=name) for r in rows)
    got = mining.sampling_no_plumes(stats_t, n_hard=2, n_random=2, seed=seed)
    want = jmining.sampling_no_plumes(stats_j, n_hard=2, n_random=2, seed=seed)
    key = lambda r: (r["name"], r["window_row_off"], r["window_col_off"], r["difficulty"])  # noqa: E731
    assert [key(r) for r in got] == [key(r) for r in want]
    assert len(got) == 12


# ---------------------------------------------------------------------------
# permian
# ---------------------------------------------------------------------------


def _row(name, r, c, w=151, h=151, **kw):
    return dict(name=name, window_row_off=r, window_col_off=c, window_width=w, window_height=h,
                **kw)


def test_permian_constants_and_helpers():
    assert permian.TEST_DATES == jpermian.TEST_DATES
    assert permian.BAD_TEST_TILES == jpermian.BAD_TEST_TILES
    assert permian.MANUAL_HAS_PLUME_OVERRIDES == jpermian.MANUAL_HAS_PLUME_OVERRIDES
    for name in ("ang20191018t141549", "ang20190922t192642"):
        assert permian.flight_date(name) == jpermian.flight_date(name)
        assert permian.flight_datetime(name) == jpermian.flight_datetime(name)
    row = _row("ang20191018t141549", 8600, 403)
    assert permian.window_id(row) == jpermian.window_id(row)
    for size in ((512, 512), (100, 700)):
        assert permian.pad_window_to_size(row, size) == jpermian.pad_window_to_size(row, size)


@pytest.mark.parametrize("output_size", [(151, 151), (511, 511), (512, 512)])
def test_permian_rows_match_jax(output_size):
    plumes = [_row("ang20191018t141549", 8600, 403), _row("ang20191018t141549", 100, 50),
              _row("ang20190922t192642", 300, 20), _row("ang20190922t192642", 10, -1),
              _row("ang20190922t192642", 2000, 100)]
    got = permian.permian_plumes_rows(plumes, output_size=output_size)
    assert got == jpermian.permian_plumes_rows(plumes, output_size=output_size)
    stats = [
        _row("ang20190922t192642", 1792, 0, w=512, h=512, count=512 * 512, mean=40.0),
        _row("ang20190922t192642", 9000, 0, w=512, h=512, count=512 * 512, mean=10.0),
        _row("ang20190927t153023", 8192, 0, w=512, h=512, count=512 * 512, mean=90.0),
        _row("ang20190927t153023", 8448, 256, w=512, h=512, count=512 * 400, mean=20.0),
        _row("ang20191011t152413", 1792, 0, w=512, h=512, count=512 * 512, mean=5.0),
        _row("ang20191011t152413", 1792, -3, w=512, h=512, count=512 * 512, mean=5.0),
    ]
    assert permian.permian_mag1c_stats_rows(stats, got) == \
        jpermian.permian_mag1c_stats_rows(stats, got)


def test_permian_split_matches_jax():
    rng = np.random.default_rng(0)
    plume_rows = [_row("ang20191018t141549", 100, 50), _row("ang20190922t192642", 2000, 100)]
    stats_rows = [_row(name, r, 0, w=512, h=512, count=int(512 * 512 * rng.uniform(0.75, 1.0)),
                       mean=float(rng.uniform(5, 50)))
                  for name in ("ang20191018t141549", "ang20190922t192642", "ang20191021t160052")
                  for r in range(0, 12 * 256, 256)]
    for seed in (42, 7):
        got = permian.generate_permian_2019_split(plume_rows, stats_rows, n_hard=2, n_random=1,
                                                  seed=seed)
        want = jpermian.generate_permian_2019_split(plume_rows, stats_rows, n_hard=2, n_random=1,
                                                    seed=seed)
        assert got == want


# ---------------------------------------------------------------------------
# vectorize
# ---------------------------------------------------------------------------


def _masks():
    square = np.zeros((10, 10), bool)
    square[2:5, 3:7] = True
    comps = np.zeros((12, 12), bool)
    comps[1:4, 1:4] = True
    comps[8, 8] = True
    ell = np.zeros((8, 8), bool)
    ell[1:5, 1:3] = True
    ell[3:5, 3:6] = True
    pinch = np.array([[0, 1, 1], [1, 0, 1], [1, 1, 1]], bool)
    rng = np.random.default_rng(0)
    return [square, comps, ell, pinch] + [rng.uniform(size=(12, 12)) > 0.5 for _ in range(20)]


@pytest.mark.parametrize("transform,min_area", [(None, 1.0), (T, 1.0), (None, 2.0)])
def test_polygons_match_jax(transform, min_area):
    for mask in _masks():
        assert vectorize.get_polygons(mask, transform, min_area) == \
            jvectorize.get_polygons(mask, transform, min_area)


def test_vectorize_raster_and_join_match_jax(tmp_path):
    rgba = np.zeros((4, 32, 32), np.float32)
    rgba[3, 10:20, 5:15] = 255.0
    rgba[3, 25:28, 25:30] = 255.0
    tif = str(tmp_path / "ang20191018t141549_mask.tif")
    write_geotiff(tif, rgba, transform=(5.0, 0.0, 500000.0, 0.0, -5.0, 4000000.0), crs_epsg=32613)
    outs = {}
    for name, mod in (("port", vectorize), ("jax", jvectorize)):
        d = tmp_path / name
        d.mkdir()
        path = mod.vectorize_mask_raster(tif, str(d / "ang20191018t141549.geojson"))
        p2 = mod.write_geojson(str(d / "ang20191021t160052.geojson"),
                               mod.get_polygons(np.ones((3, 3), bool)), [{"k": 1}], crs_epsg=4326)
        joined = mod.join_plume_collections([path, p2], str(d / "all.geojson"))
        empty = str(d / "empty.tif")
        write_geotiff(empty, np.zeros((4, 8, 8), np.float32))
        assert mod.vectorize_mask_raster(empty, str(d / "e.geojson")) is None
        outs[name] = [open(p).read() for p in (path, p2, joined)]
    assert outs["port"] == outs["jax"]
    assert len(json.loads(outs["port"][0])["features"]) == 2


# ---------------------------------------------------------------------------
# ingest
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def envi_scene(tmp_path_factory):
    d = tmp_path_factory.mktemp("envi")
    rng = np.random.default_rng(0)
    cube = rng.uniform(0, 10, size=(40, 30, 12)).astype(np.float32)
    wl = np.linspace(2100, 2400, 12)
    bip = str(d / "scene_img")
    cube.tofile(bip)
    with open(bip + ".hdr", "w") as fh:
        fh.write("ENVI\nsamples = 30\nlines   = 40\nbands   = 12\nheader offset = 0\n"
                 "data type = 4\ninterleave = bip\nbyte order = 0\n"
                 "wavelength = {" + ", ".join(f"{v:.1f}" for v in wl) + "}\n"
                 "fwhm = {" + ", ".join("5.5" for _ in wl) + "}\n")
    bsq = str(d / "scene_bsq.img")
    with open(bsq, "wb") as fh:
        fh.write(b"\0" * 64)
        np.moveaxis(cube, -1, 0).astype(np.int16).tofile(fh)
    with open(str(d / "scene_bsq.hdr"), "w") as fh:
        fh.write("ENVI\nsamples = 30\nlines = 40\nbands = 12\nheader offset = 64\n"
                 "data type = 2\ninterleave = bsq\nbyte order = 0\n")
    return cube, bip, bsq


def test_envi_header_and_reader_match_jax(envi_scene):
    cube, bip, bsq = envi_scene
    for hdr in (bip + ".hdr", bsq[:-4] + ".hdr"):
        got, want = ingest.parse_envi_header(hdr), jingest.parse_envi_header(hdr)
        assert got.keys() == want.keys()
        for k in got:
            if isinstance(want[k], np.ndarray):
                np.testing.assert_array_equal(got[k], want[k])
            else:
                assert got[k] == want[k], k
    for path in (bip, bsq):
        r, jr = ingest.ENVIReader(path), jingest.ENVIReader(path)
        assert r.shape == jr.shape
        for win in ((5, 7, 10, 12), (0, 3, 8, 9), (39, 29, 1, 1)):
            got = r.read_window(*win)
            np.testing.assert_array_equal(got, jr.read_window(*win))
            assert got.dtype == jr.read_window(*win).dtype
        np.testing.assert_array_equal(r.read_all(), jr.read_all())
    np.testing.assert_array_equal(ingest.ENVIReader(bip).read_all(), cube)
    with pytest.raises(FileNotFoundError):
        ingest.ENVIReader(str(envi_scene[1]) + "_nohdr")


def test_column_windows_match_jax():
    for width, height, step in ((120, 40, 50), (50, 3, 50), (7, 9, 2)):
        assert ingest.column_windows(width, height, step) == \
            jingest.column_windows(width, height, step)


def test_save_scene_bands_match_jax(tmp_path):
    cube = np.random.default_rng(0).uniform(size=(8, 9, 3)).astype(np.float32)
    wl = np.array([2100.0, 2200.0, 2300.0])
    t = (5.0, 0.0, 500000.0, 0.0, -5.0, 4000000.0)
    for name, mod in (("port", ingest), ("jax", jingest)):
        mod.save_scene_bands(cube, wl, np.full(3, 5.5), str(tmp_path / name), transform=t,
                             crs_epsg=32613)
    for f in ("0.tif", "1.tif", "2.tif", "metadata.json"):
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f


def test_png_mask_to_binary_matches_jax(tmp_path):
    from PIL import Image

    rgba = np.zeros((16, 20, 4), np.uint8)
    rgba[4:8, 5:9, 3] = 255
    rgba[4:8, 5:9, 0] = 120
    rgb = np.zeros((6, 5, 3), np.uint8)
    rgb[1, 2, 1] = 9
    gray = np.zeros((8, 8), np.uint8)
    gray[2, 2] = 200
    for i, arr in enumerate((rgba, rgb, gray)):
        p = str(tmp_path / f"m{i}.png")
        Image.fromarray(arr).save(p)
        for threshold in (0, 100):
            got = ingest.png_mask_to_binary(p, threshold)
            want = jingest.png_mask_to_binary(p, threshold)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


def test_downloads_offline(tmp_path):
    """Only file:// URLs: a failed fetch raises the gate's RuntimeError; a
    tar.gz is fetched atomically and extracted; an unknown flight line
    raises KeyError; both packages leave the same files."""
    src = tmp_path / "src"
    (src / "ang20191018t141549").mkdir(parents=True)
    (src / "ang20191018t141549" / "x_img").write_bytes(b"abc")
    tar_path = tmp_path / "ang20191018t141549.tar.gz"
    with tarfile.open(tar_path, "w:gz") as tf:
        tf.add(src / "ang20191018t141549", arcname="ang20191018t141549")
    index = tmp_path / "index.csv"
    index.write_text(f"Name,link_ftp\nang20191018t141549,file://{tar_path}\n")
    trees = {}
    for name, mod in (("port", ingest), ("jax", jingest)):
        dest = tmp_path / name
        with pytest.raises(RuntimeError, match="network"):
            mod.download_product(f"file://{tmp_path}/missing.tar.gz", str(dest))
        assert not os.path.exists(dest / "missing.tar.gz.tmp")
        with pytest.raises(KeyError):
            mod.download_aviris("ang20190101t000000", str(index), str(dest))
        out = mod.download_aviris("ang20191018t141549", str(index), str(dest))
        assert out == str(dest / "ang20191018t141549")
        trees[name] = sorted(os.path.relpath(os.path.join(d, f), dest)
                             for d, _, fs in os.walk(dest) for f in fs)
        assert (dest / "ang20191018t141549" / "x_img").read_bytes() == b"abc"
    assert trees["port"] == trees["jax"]


# ---------------------------------------------------------------------------
# storage
# ---------------------------------------------------------------------------


def _storage_ops(mod, root):
    """The JAX suite's storage cases; returns what each observed."""
    seen = [mod.is_remote("gs://b/x"), mod.is_remote("s3://b/x"), mod.is_remote("/tmp/x"),
            mod.is_remote("relative/path.csv"), mod.get_filesystem("/tmp/x")]
    p = os.path.join(root, "a", "b", "f.txt")
    with mod.open_file(p, "w") as fh:
        fh.write("hello")
    with mod.open_file(p) as fh:
        seen += [mod.exists(p), fh.read()]
    seen.append(mod.read_json(mod.write_json(os.path.join(root, "meta.json"), {"f1": 0.9})))
    src = os.path.join(root, "src")
    mod.makedirs(os.path.join(src, "sub"))
    for rel, text in (("x.txt", "1"), ("sub/y.txt", "2"), ("a1.npz", ""), ("a2.npz", "")):
        with open(os.path.join(src, rel), "w") as fh:
            fh.write(text)
    mod.put(os.path.join(src, "x.txt"), os.path.join(root, "out", "x.txt"))
    mod.put(src, os.path.join(root, "tree"), recursive=True)
    mod.get(os.path.join(root, "tree", "x.txt"), os.path.join(root, "back.txt"))
    seen += [mod.listdir(os.path.join(root, "tree")), mod.exists(os.path.join(root, "back.txt")),
             [os.path.relpath(h, root) for h in mod.glob(os.path.join(root, "tree", "*.npz"))]]
    with open(os.path.join(root, "tree", "sub", "y.txt")) as fh:
        seen.append(fh.read())
    return seen


def test_storage_local_matches_jax(tmp_path):
    got = _storage_ops(storage, str(tmp_path / "port"))
    assert got == _storage_ops(jstorage, str(tmp_path / "jax"))
    assert got[-1] == "2" and got[-4] == ["a1.npz", "a2.npz", "sub", "x.txt"]


def test_remote_path_without_fsspec_names_it(monkeypatch):
    """fsspec is imported only for a remote path; without it the remote path
    raises ImportError naming it (local paths keep working)."""
    monkeypatch.setitem(sys.modules, "fsspec", None)
    with pytest.raises(ImportError, match="fsspec"):
        storage.exists("gs://bucket/x")
    assert storage.get_filesystem("/tmp/x") is None


# ---------------------------------------------------------------------------
# The EMIT evaluation set
# ---------------------------------------------------------------------------


def _assert_items_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            if isinstance(w[k], np.ndarray):
                assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            else:
                assert g[k] == w[k], k


def test_crop_and_eval_dataset_match_jax():
    rng = np.random.default_rng(0)
    a = np.ones((2, 70, 45))
    assert [x.shape for x in emit.crop_to_multiple([a, a[0]], 32)] == \
        [x.shape for x in jemit.crop_to_multiple([a, a[0]], 32)] == [(2, 64, 32), (64, 32)]
    mags = [rng.uniform(-50, 600, (70, 45)).astype(np.float32),
            rng.uniform(0, 480, (64, 96)).astype(np.float64)]
    rgbs = [rng.uniform(0, 50, (70, 45, 3)).astype(np.float32),
            rng.uniform(0, 40, (64, 96, 3)).astype(np.float32)]
    labels = [(rng.uniform(size=(70, 45)) > 0.98).astype(np.float32) * 255,
              np.zeros((64, 96), np.uint8)]
    masks = [rng.uniform(size=(70, 45)) > 0.5, np.zeros((64, 96), bool)]
    for kw in ({}, {"ids": ["s0", "s1"], "nodata_masks": masks}):
        got = emit.EMITEvalDataset(mags, rgbs, labels, **kw)
        want = jemit.EMITEvalDataset(mags, rgbs, labels, **kw)
        _assert_items_equal(got.items, want.items)
    with pytest.raises(ValueError):
        emit.EMITEvalDataset(mags, rgbs[:1], labels)


@pytest.fixture(scope="module")
def emit_folder(tmp_path_factory):
    """An EMIT folder: an npy scene with a label and one without under
    plume_events, ENVI pairs (one with label.tif, one with
    label_released.npy) and an empty scene folder under confounders."""
    root = tmp_path_factory.mktemp("emit")
    rng = np.random.default_rng(0)
    for name, label in (("sceneA", True), ("sceneA2", False)):
        a = root / "plume_events" / name
        a.mkdir(parents=True)
        np.save(a / "mag1c.npy", rng.uniform(0, 480, (64, 48)).astype(np.float32))
        np.save(a / "rgb.npy", rng.uniform(0, 40, (64, 48, 3)).astype(np.float32))
        if label:
            np.save(a / "label.npy", (rng.uniform(size=(64, 48)) > 0.97).astype(np.float32))
    for name, label in (("sceneB", "label.tif"), ("sceneC", "label_released.npy")):
        b = root / "confounders" / name
        b.mkdir(parents=True)
        rng.uniform(0, 480, (70, 50, 1)).astype(np.float32).tofile(b / f"{name}_magic")
        rng.uniform(0, 40, (70, 50, 3)).astype(np.float32).tofile(b / f"{name}_RGB")
        for fname, bands in ((f"{name}_magic.hdr", 1), (f"{name}_RGB.hdr", 3)):
            (b / fname).write_text(
                f"ENVI\nsamples = 50\nlines = 70\nbands = {bands}\nheader offset = 0\n"
                "data type = 4\ninterleave = bip\nbyte order = 0\n")
        lab = (rng.uniform(size=(70, 50)) > 0.9).astype(np.float32) * 255
        if label.endswith(".tif"):
            write_geotiff(str(b / label), lab)
        else:
            np.save(b / label, lab)
    (root / "confounders" / "empty").mkdir()
    return str(root)


def test_emit_folder_dataset_matches_jax(emit_folder):
    got = emit.load_emit_folder_dataset(emit_folder)
    want = jemit.load_emit_folder_dataset(emit_folder)
    assert [i["id"] for i in got.items] == ["plume_events/sceneA", "plume_events/sceneA2",
                                             "confounders/sceneB", "confounders/sceneC"]
    _assert_items_equal(got.items, want.items)
    assert got[2]["input"].shape == (4, 64, 32) and got[2]["has_plume"] == 1.0


def test_emit_datamodule_batches_match_jax(emit_folder):
    dm, jdm = emit.EMITDataModule(emit_folder).setup(), jemit.EMITDataModule(emit_folder)
    assert len(dm.dataset) == len(jdm.dataset) == 4
    loader = dm.test_loader()
    assert loader.batch_size == 1
    want = list(JBatchLoader(jdm.dataset, batch_size=1))
    got = list(loader)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            if isinstance(w[k], np.ndarray):
                np.testing.assert_array_equal(g[k], w[k])
            else:
                assert g[k] == w[k]
