"""The port's chip dataset path (data.synthetic's chip writers, data.dataset,
data.datamodule, data.geotiff's raster IO) against the JAX package on the
CPU: the same seeds give bitwise the same files, rows, samples and
batches (numpy on both sides); rotation at the JAX test's own bar.
"""

import csv
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from starcop_tpu.data import datamodule as jdm  # noqa: E402
from starcop_tpu.data import dataset as jds  # noqa: E402
from starcop_tpu.data import geotiff as jgeo  # noqa: E402
from starcop_tpu.data import synthetic as jsyn  # noqa: E402
from starcop_tpu_torch.data import datamodule as tdm  # noqa: E402
from starcop_tpu_torch.data import dataset as tds  # noqa: E402
from starcop_tpu_torch.data import geotiff as tgeo  # noqa: E402
from starcop_tpu_torch.data import synthetic as tsyn  # noqa: E402

PRODUCTS = ["mag1c", "TOA_AVIRIS_640nm", "TOA_AVIRIS_550nm", "TOA_AVIRIS_460nm"]


@pytest.fixture(scope="module")
def chips(tmp_path_factory):
    """The same 5-tile, 96-pixel dataset written by both packages (one
    plume-free tile at this seed)."""
    root = tmp_path_factory.mktemp("chips")
    index = {}
    for pkg, mod in (("jax", jsyn), ("port", tsyn)):
        index[pkg] = mod.write_synthetic_chip_dataset(str(root / pkg), np.random.default_rng(0),
                                                      n_tiles=5, size=96, max_confounders=2)
    return root, index


def _rows(path):
    with open(path, newline="") as fh:
        return list(csv.DictReader(fh))


def test_write_synthetic_chip_dataset_matches_jax(chips):
    root, index = chips
    want, got = _rows(index["jax"]), _rows(index["port"])
    assert [list(r) for r in got] == [list(r) for r in want]
    for g, w in zip(got, want):
        assert g["folder"] == w["folder"].replace(str(root / "jax"), str(root / "port"))
        assert {k: v for k, v in g.items() if k != "folder"} == \
            {k: v for k, v in w.items() if k != "folder"}
        jfiles = sorted(os.listdir(w["folder"]))
        assert sorted(os.listdir(g["folder"])) == jfiles and len(jfiles) == 6
        for f in jfiles:
            a, b = np.load(os.path.join(g["folder"], f)), np.load(os.path.join(w["folder"], f))
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b, err_msg=f)
    assert {r["has_plume"] for r in got} == {"True", "False"}


def test_write_synthetic_chip_dataset_with_the_filter(tmp_path):
    """run_matched_filter=True: every file but mag1c and its weights bitwise
    JAX's; mag1c from the port's f32 filter (its plain twins here) at
    detection parity with JAX's (which takes the scene's float64 template
    and, with x64 on in the tests, filters in float64). Two step-64 blocks
    of 8,192 pixels a tile."""
    idx = {pkg: mod.write_synthetic_chip_dataset(str(tmp_path / pkg), np.random.default_rng(5),
                                                 n_tiles=2, size=128, run_matched_filter=True,
                                                 **kw)
           for pkg, mod, kw in (("jax", jsyn, {}), ("port", tsyn, {"device": "cpu"}))}
    for g, w in zip(_rows(idx["port"]), _rows(idx["jax"])):
        for f in ("TOA_AVIRIS_640nm", "TOA_AVIRIS_550nm", "TOA_AVIRIS_460nm", "labelbinary"):
            np.testing.assert_array_equal(np.load(os.path.join(g["folder"], f + ".npy")),
                                          np.load(os.path.join(w["folder"], f + ".npy")))
        mf = np.load(os.path.join(g["folder"], "mag1c.npy"))
        mf_j = np.load(os.path.join(w["folder"], "mag1c.npy"))
        assert mf.min() >= 0 and (mf_j > 500).sum() > 0
        assert np.corrcoef(mf.ravel(), mf_j.ravel())[0, 1] > 0.9999
        assert ((mf > 500) == (mf_j > 500)).mean() >= 0.999


def test_synthetic_chip_batch_matches_jax():
    want = jsyn.synthetic_chip_batch(np.random.default_rng(4), batch_size=3, size=48,
                                     input_products=tuple(PRODUCTS) + ("other",))
    got = tsyn.synthetic_chip_batch(np.random.default_rng(4), batch_size=3, size=48,
                                    input_products=tuple(PRODUCTS) + ("other",))
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_read_index_csv_matches_jax(chips):
    _, index = chips
    got, want = tds.read_index_csv(index["port"]), jds.read_index_csv(index["jax"])
    for g, w in zip(got, want):
        assert {k: v for k, v in g.items() if k != "folder"} == \
            {k: v for k, v in w.items() if k != "folder"}
        assert isinstance(g["window_width"], int) and isinstance(g["has_plume"], bool)
        assert isinstance(g["qplume"], float)


def _datasets(chips, **kw):
    _, index = chips
    return (tds.ChipDataset(tds.read_index_csv(index["port"]), PRODUCTS, **kw),
            jds.ChipDataset(jds.read_index_csv(index["jax"]), PRODUCTS, **kw))


def _assert_same_sample(got, want):
    assert list(got) == list(want)
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            assert got[k] == v, k


@pytest.mark.parametrize("kw", [
    {},
    {"window_size_sample": (40, 56), "seed": 3},
    {"augment": True, "seed": 11},
    {"augment": True, "augment_rotation": "rot90", "window_size_sample": (64, 64), "seed": 7},
    {"add_rgb_aviris": True, "extra_products": ["labelbinary"], "weight_loss_product": None},
])
def test_chip_dataset_matches_jax(chips, kw):
    """Samples bitwise equal, augmented ones too: both packages draw from
    the same per-thread child generator of the seed (num_workers=0)."""
    tds_, jds_ = _datasets(chips, **kw)
    assert len(tds_) == len(jds_) == 5
    for i in (0, 3, 1, 0):  # a sample read again draws the next crop and flips
        _assert_same_sample(tds_[i], jds_[i])


def test_windowed_reads_match_jax(chips):
    """An index row with a window inside, across and outside the raster."""
    _, index = chips
    for window in ((8, 4, 40, 24), (-10, -6, 50, 40), (70, 80, 40, 30), (100, 0, 8, 8)):
        rows = {}
        for pkg, mod in (("port", tds), ("jax", jds)):
            row = dict(mod.read_index_csv(index[pkg])[1])
            row.update(zip(("window_col_off", "window_row_off", "window_width",
                            "window_height"), window))
            rows[pkg] = mod.ChipDataset([row], ["mag1c"], ["labelbinary"], None)[0]
        _assert_same_sample(rows["port"], rows["jax"])
        assert rows["port"]["input"].shape == (1, window[3], window[2])


def test_rotate_chw_matches_jax():
    img = np.random.default_rng(0).uniform(0, 10, size=(2, 33, 47)).astype(np.float32)
    for angle in (-90.0, -37.3, 0.0, 12.5, 45.0, 88.8):
        for order in (0, 1):
            got, want = tds.rotate_chw(img, angle, order), jds.rotate_chw(img, angle, order)
            assert got.dtype == want.dtype
            # tests/test_data_train_eval.py::test_rotate_chw_matches_cv2's bar
            # against cv2, held here against the JAX package's resampler.
            np.testing.assert_allclose(got, want, atol=0.35)
            assert np.mean(np.abs(got - want)) < 0.02
    with pytest.raises(ValueError, match="rotation"):
        tds.joint_augment({"input": img}, np.random.default_rng(0), rotation="shear")


def test_joint_augment_matches_jax():
    x = np.arange(2 * 16 * 16, dtype=np.float32).reshape(2, 16, 16)
    arrays = {"input": x, "output": (x[:1] % 7 < 3).astype(np.float32), "weight_loss": x[:1]}
    for seed in range(6):
        for rotation in ("continuous", "rot90", "none"):
            got = tds.joint_augment(arrays, np.random.default_rng(seed), rotation=rotation)
            want = jds.joint_augment(arrays, np.random.default_rng(seed), rotation=rotation)
            _assert_same_sample(got, want)


def test_windows_tiles_and_weights_match_jax(chips):
    _, index = chips
    for args in ((512, 512, 128, 64), (300, 200, 128, 32), (64, 90, 128, 64), (96, 96, 32, 0)):
        assert tdm.create_windows(*args) == jdm.create_windows(*args)
    got = tdm.tile_rows(tds.read_index_csv(index["port"]), training_size=32, overlap=16)
    want = jdm.tile_rows(jds.read_index_csv(index["jax"]), training_size=32, overlap=16)
    assert len(got) == len(want) == 5 * 25
    for g, w in zip(got, want):
        assert {k: v for k, v in g.items() if k != "folder"} == \
            {k: v for k, v in w.items() if k != "folder"}
    assert {r["has_plume"] for r in got} == {True, False}
    np.testing.assert_array_equal(tdm.sample_weights(got), jdm.sample_weights(want))


@pytest.mark.parametrize("kw", [
    {"batch_size": 2},
    {"batch_size": 2, "shuffle": True, "seed": 4},
    {"batch_size": 3, "weighted": True, "seed": 9, "drop_last": True},
    {"batch_size": 2, "num_workers": 2},
])
def test_batch_loader_matches_jax(chips, kw):
    tds_, jds_ = _datasets(chips, weight_loss_product="weight_mag1c")
    got, want = tdm.BatchLoader(tds_, **kw), jdm.BatchLoader(jds_, **kw)
    assert len(got) == len(want)
    for _ in range(2):  # a second epoch draws new indices from the loader's generator
        batches_g, batches_w = list(got), list(want)
        assert len(batches_g) == len(batches_w) == len(got)
        for g, w in zip(batches_g, batches_w):
            assert g["id"] == w["id"]
            _assert_same_sample(g, w)


def test_prefetch_to_device_cpu(chips):
    """device="cpu": numeric arrays become tensors, ids pass through, the
    batches in order; the card's pinned-buffer path runs in chip_smoke.py."""
    tds_, _ = _datasets(chips, weight_loss_product="weight_mag1c")
    loader = tdm.BatchLoader(tds_, batch_size=2)
    batches = list(tdm.prefetch_to_device(iter(loader), device="cpu", size=2))
    want = list(loader)
    assert len(batches) == len(want) == 3
    for g, w in zip(batches, want):
        assert g["id"] == w["id"] and isinstance(g["id"], list)
        for k in ("input", "output", "weight_loss", "has_plume"):
            assert isinstance(g[k], torch.Tensor) and g[k].device.type == "cpu"
            np.testing.assert_array_equal(g[k].numpy(), w[k])
    flags = next(tdm.prefetch_to_device(iter([{"valid": np.ones(3, bool), "n": [1, 2]}]),
                                        device="cpu"))
    assert isinstance(flags["valid"], np.ndarray) and torch.equal(flags["n"], torch.tensor([1, 2]))


@pytest.mark.parametrize("ext", [".npy", ".tif"])
def test_raster_io_matches_jax(tmp_path, ext):
    """save_raster / load_raster / find_raster: single- and multi-band
    rasters, windows inside, with negative offsets and overhanging."""
    rng = np.random.default_rng(6)
    for name, arr in (("one", rng.uniform(0, 9, (1, 37, 45)).astype(np.float32)),
                      ("three", rng.uniform(0, 9, (3, 37, 45)).astype(np.float32))):
        if ext == ".npy" and name == "one":
            arr = arr[0]
        tpath = tgeo.save_raster(str(tmp_path / f"t_{name}{ext}"), arr)
        jpath = jgeo.save_raster(str(tmp_path / f"j_{name}{ext}"), arr)
        assert tgeo.find_raster(str(tmp_path), f"t_{name}") == tpath
        assert jgeo.find_raster(str(tmp_path), f"t_{name}") == tpath
        for window in (None, (3, 5, 20, 10), (-7, -4, 30, 20), (30, 25, 40, 30),
                       (-5, -5, 60, 50), (50, 0, 5, 5)):
            got = tgeo.load_raster(tpath, window)
            want = jgeo.load_raster(jpath, window)
            assert got.dtype == want.dtype and got.shape == want.shape, window
            np.testing.assert_array_equal(got, want)
        full = tgeo.load_raster(tpath)
        win = tgeo.load_raster(tpath, (-7, -4, 30, 20))
        np.testing.assert_array_equal(win[..., 4:, 7:], full[..., :16, :23])
        assert not win[..., :4, :].any() and not win[..., :, :7].any()
    assert tgeo.find_raster(str(tmp_path), "missing") is None
