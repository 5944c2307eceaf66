"""The port's dataset production CLI (starcop_tpu_torch.cli.prepare_data)
against the JAX package's on the CPU.

Bars:
  * ``process_scene`` on a small full-spectrum plume cube: mag1c.tif and
    albedo.tif at the unmasked route's bar of tests/test_torch_mag1c.py (mf
    correlation > 0.9999, threshold-500 agreement >= 0.999 with detections,
    albedo rtol 1e-4); wv3.tif, s2a.tif and s2b.tif within 1e-6 of JAX's
    relative to their largest value; the same tags, descriptions, nodata and
    geo metadata.
  * both CLIs at ``--synthetic 2`` (chip 256, overlap 128, one hard and one
    random negative): the same stats_mag1c.json windows and keys; every
    window statistic within what the two scenes' mag1c maps differ by (max,
    min, mean and the percentiles move by at most the maps' largest
    difference, the sum by that times the valid count; 1e-4 relative on top
    for the statistics' own f32 rounding); the valid fraction exact; the
    same chip ids and kinds and index.csv columns; per chip the simulated and
    RGB products and label_rgba bitwise, mag1c within the maps' largest
    difference, labelbinary agreeing on >= 0.999 of the pixels, the chip's
    geotransform and CRS equal.
"""

import csv
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import cpu_share  # noqa: E402,F401

from starcop_tpu.cli import prepare_data as jprep  # noqa: E402
from starcop_tpu_torch.cli import prepare_data as prep  # noqa: E402
from starcop_tpu_torch.data.geotiff import read_geotiff  # noqa: E402
from starcop_tpu_torch.data.synthetic import aviris_swir_bands, synthetic_scene  # noqa: E402
from starcop_tpu_torch.ops.ch4_template import generate_template_from_bands  # noqa: E402

CLI_ARGS = ["--synthetic", "2", "--chip-size", "256", "--stats-overlap", "128",
            "--n-hard", "1", "--n-random", "1"]
FULL_WL = np.arange(380.0, 2511.0, 5.0)
GEO = dict(transform=(5.0, 0.0, 500000.0, 0.0, -5.0, 3540000.0), crs_epsg=32613)


def _assert_same_meta(a, b):
    assert (a.transform, a.crs_epsg, a.nodata, a.tags, a.descriptions) == \
        (b.transform, b.crs_epsg, b.nodata, b.tags, b.descriptions)


def _assert_detection_parity(mf, ref):
    a, b = np.asarray(mf, np.float64).ravel(), np.asarray(ref, np.float64).ravel()
    assert np.corrcoef(a, b)[0, 1] > 0.9999
    assert (b > 500).sum() > 0
    assert ((a > 500) == (b > 500)).mean() >= 0.999


def test_process_scene_matches_jax(tmp_path):
    """256 x 64 pixels over 380-2510 nm (427 bands, 73 kept for the filter:
    two column blocks of 32, 8,192 pixels each; on blocks of ~3k pixels
    JAX's own f32 filter parts from f64 by 1e-4 in correlation), a plume, a
    label: every product of both packages."""
    tpl = generate_template_from_bands(FULL_WL, np.full(len(FULL_WL), 5.5))[:, 1]
    s = synthetic_scene(np.random.default_rng(3), 256, 64, n_plumes=2, template=tpl)
    rgba = np.zeros((4, 256, 64), np.float32)
    rgba[3] = s["label"]
    args = ("scene", s["radiance"], FULL_WL, np.full(len(FULL_WL), 5.5), rgba)
    got = prep.process_scene(str(tmp_path / "port"), *args, device="cpu", **GEO)
    want = jprep.process_scene(str(tmp_path / "jax"), *args, **GEO)
    assert [os.path.relpath(p, tmp_path / "port") for p in got.values()] == \
        [os.path.relpath(p, tmp_path / "jax") for p in want.values()]
    files = sorted(os.listdir(tmp_path / "port"))
    assert files == sorted(os.listdir(tmp_path / "jax")) == [
        "albedo.tif", "label_rgba.tif", "mag1c.tif", "s2a.tif", "s2b.tif", "wv3.tif",
        "wv3_bands.json"]
    for f in files:
        if f.endswith(".json"):
            assert (tmp_path / "port" / f).read_text() == (tmp_path / "jax" / f).read_text()
            continue
        a, ma = read_geotiff(str(tmp_path / "port" / f))
        b, mb = read_geotiff(str(tmp_path / "jax" / f))
        _assert_same_meta(ma, mb)
        assert a.shape == b.shape and a.dtype == b.dtype
        if f == "mag1c.tif":
            _assert_detection_parity(a, b)
        elif f == "albedo.tif":
            np.testing.assert_allclose(a, b, rtol=1e-4)
        elif f == "label_rgba.tif":
            np.testing.assert_array_equal(a, b)
        else:
            assert np.abs(a.astype(np.float64) - b).max() <= 1e-6 * np.abs(b).max(), f
    assert read_geotiff(str(tmp_path / "port" / "s2a.tif"))[0].shape == (13, 205, 51)
    # A second call keeps the products already there.
    mtime = os.path.getmtime(tmp_path / "port" / "mag1c.tif")
    prep.process_scene(str(tmp_path / "port"), *args[:4], device="cpu", **GEO)
    assert os.path.getmtime(tmp_path / "port" / "mag1c.tif") == mtime


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """Both CLIs at --synthetic 2 (the JAX package's own CLI test setting)."""
    root = tmp_path_factory.mktemp("prepare")
    assert jprep.main(CLI_ARGS + ["--output", str(root / "jax")]) == 0
    assert prep.main(CLI_ARGS + ["--output", str(root / "port"), "--device", "cpu"]) == 0
    return root / "port", root / "jax"


def _maps_sup(port, jax_root):
    """The largest |port mag1c - JAX mag1c| over each scene."""
    out = {}
    for name in ("synth000", "synth001"):
        a = read_geotiff(str(port / "scenes" / name / "mag1c.tif"))[0].astype(np.float64)
        b = read_geotiff(str(jax_root / "scenes" / name / "mag1c.tif"))[0]
        out[name] = float(np.abs(a - b).max())
    return out


def test_cli_scene_products_match_jax(cli_runs):
    port, jax_root = cli_runs
    for name in ("synth000", "synth001"):
        files = sorted(os.listdir(port / "scenes" / name))
        assert files == sorted(os.listdir(jax_root / "scenes" / name))
        for f in files:
            if not f.endswith(".tif"):
                continue
            a, ma = read_geotiff(str(port / "scenes" / name / f))
            b, mb = read_geotiff(str(jax_root / "scenes" / name / f))
            _assert_same_meta(ma, mb)
            if f not in ("mag1c.tif", "albedo.tif"):
                np.testing.assert_array_equal(a, b, err_msg=f"{name}/{f}")
    # synth001 carries plumes: the filter's bar there.
    a = read_geotiff(str(port / "scenes" / "synth001" / "mag1c.tif"))[0]
    _assert_detection_parity(a, read_geotiff(str(jax_root / "scenes" / "synth001" / "mag1c.tif"))[0])


def test_cli_stats_match_jax(cli_runs):
    port, jax_root = cli_runs
    got = json.loads((port / "stats_mag1c.json").read_text())
    want = json.loads((jax_root / "stats_mag1c.json").read_text())
    sup = _maps_sup(port, jax_root)
    assert len(got) == len(want) == 56
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in ("name", "window_row_off", "window_col_off", "window_height", "window_width",
                  "percentage_valids"):
            assert g[k] == w[k], k
        d = sup[g["name"]]
        for k in ("max", "min", "mean", "p25", "p50", "p75", "p95", "p99"):
            assert abs(g[k] - w[k]) <= d + 1e-4 * abs(w[k]), (k, g[k], w[k], d)
        n = g["percentage_valids"] * g["window_height"] * g["window_width"]
        assert abs(g["sum"] - w["sum"]) <= n * d * (1 + 1e-4), ("sum", g["sum"], w["sum"])


def test_cli_chips_match_jax(cli_runs):
    port, jax_root = cli_runs
    with open(port / "chips" / "index.csv") as fh:
        rows = list(csv.DictReader(fh))
    with open(jax_root / "chips" / "index.csv") as fh:
        jrows = list(csv.DictReader(fh))
    assert list(rows[0]) == list(jrows[0])
    assert [(r["id"], r["kind"], r["difficulty"]) for r in rows] == \
        [(r["id"], r["kind"], r["difficulty"]) for r in jrows]
    kinds = {r["kind"] for r in rows}
    assert kinds == {"plume_candidate", "negative"}
    sup = _maps_sup(port, jax_root)
    for r in rows:
        folder, jfolder = port / "chips" / r["id"], jax_root / "chips" / r["id"]
        files = sorted(os.listdir(folder))
        assert files == sorted(os.listdir(jfolder))
        for f in files:
            a, ma = read_geotiff(str(folder / f))
            b, mb = read_geotiff(str(jfolder / f))
            assert a.shape == b.shape == (a.shape[0], 256, 256)
            assert (ma.transform, ma.crs_epsg) == (mb.transform, mb.crs_epsg)
            if f == "mag1c.tif":
                assert np.abs(a.astype(np.float64) - b).max() <= sup[r["name"]]
            elif f == "labelbinary.tif":
                assert (a == b).mean() >= 0.999
            elif f != "weight_mag1c.tif":
                np.testing.assert_array_equal(a, b, err_msg=f"{r['id']}/{f}")
        assert ma.crs_epsg == 32613 and ma.transform[0] == 5.0


def test_cli_folder_scenes(tmp_path):
    """--scenes-dir: a cube with its wavelength, FWHM, RGB, label and geo
    side files; only {name}.npy cubes are scenes (JAX's CLI also takes a
    {name}_rgb.npy file for a scene of its own)."""
    centers, fwhm = aviris_swir_bands()
    s = synthetic_scene(np.random.default_rng(1), 64, 64, n_plumes=1)
    d = tmp_path / "scenes"
    d.mkdir()
    np.save(d / "a.npy", s["radiance"])
    np.save(d / "a_wl.npy", centers)
    np.save(d / "a_fwhm.npy", fwhm)
    np.save(d / "a_rgb.npy", s["rgb"])
    rgba = np.zeros((4, 64, 64), np.float32)
    rgba[3] = s["label"]
    np.save(d / "a_label.npy", rgba)
    (d / "a_geo.json").write_text(json.dumps({"transform": list(GEO["transform"]),
                                              "crs_epsg": 32613}))
    scenes = prep._folder_scenes(str(d))
    assert [sc[0] for sc in scenes] == ["a"]
    out = tmp_path / "out"
    assert prep.main(["--scenes-dir", str(d), "--output", str(out), "--chip-size", "32",
                      "--stats-overlap", "0", "--device", "cpu"]) == 0
    assert sorted(os.listdir(out / "scenes")) == ["a"]
    _, meta = read_geotiff(str(out / "scenes" / "a" / "rgb.tif"))
    assert meta.crs_epsg == 32613 and meta.descriptions == ["640nm", "550nm", "460nm"]
    assert len(json.loads((out / "stats_mag1c.json").read_text())) == 4


def test_cli_device_refusals(tmp_path):
    with pytest.raises(SystemExit):
        prep.main(["--output", str(tmp_path / "x"), "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            prep.main(["--synthetic", "1", "--output", str(tmp_path / "y")])
        assert not (tmp_path / "y").exists()
