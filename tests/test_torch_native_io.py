"""The port's native IO library (starcop_tpu_torch.data.native_io) against its
numpy twins and the JAX package's native_io, on the cases of
tests/test_native_io.py: windowed reads (R2, BIP, BSQ, batched), the ranges
with NaN, fill values, prefix bands and skip, and the u12 / u10 packs with
out-of-range values, NaN, odd band counts and half grid steps. Every output
is held byte for byte; a failed build raises with the compiler's output."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import cpu_share  # noqa: E402,F401

from starcop_tpu.data import native_io as jnio  # noqa: E402
from starcop_tpu_torch.data import native_io as tnio  # noqa: E402
from starcop_tpu_torch.serve import pipeline as tserve  # noqa: E402

FILL = -9999.0


def _same(*arrays):
    first = arrays[0]
    return all(a.dtype == first.dtype and a.shape == first.shape
               and a.tobytes() == first.tobytes() for a in arrays[1:])


@pytest.fixture(scope="module")
def rasters(tmp_path_factory):
    d = tmp_path_factory.mktemp("rasters")
    rng = np.random.default_rng(0)
    paths = []
    for i in range(5):
        p = str(d / f"a{i}.npy")
        np.save(p, rng.normal(size=(256, 300)).astype(np.float32))
        paths.append(p)
    return paths


def test_npy_payload_info_and_r2_window(rasters):
    info = tnio.npy_payload_info(rasters[0])
    assert info == jnio.npy_payload_info(rasters[0])
    args = (rasters[0], info[1], info[2], (10, 20, 50, 60), tnio.LAYOUT_R2, info[0])
    got = tnio.read_window(*args)
    assert _same(got, tnio.read_window_plain(*args), jnio.read_window(*args),
                 np.load(rasters[0])[10:60, 20:80])


@pytest.mark.parametrize("n_threads", [0, 3])
def test_read_windows_batch(rasters, n_threads):
    wins = [(i, 2 * i, 32, 48) for i in range(5)]
    got = tnio.read_npy_windows_batch(rasters, wins, n_threads=n_threads)
    plain = tnio.read_npy_windows_batch_plain(rasters, wins)
    jax = jnio.read_npy_windows_batch(rasters, wins, n_threads=n_threads)
    for g, p, j in zip(got, plain, jax):
        assert _same(g, p, j)


@pytest.mark.parametrize("layout", ["bip", "bsq"])
def test_read_window_cubes(tmp_path, layout):
    rng = np.random.default_rng(1)
    if layout == "bip":
        cube = rng.normal(size=(40, 50, 7)).astype(np.float32)
        path = str(tmp_path / "cube.npy")
        np.save(path, cube)
        off = tnio.npy_payload_info(path)[0]
        args = (path, cube.shape, cube.dtype, (3, 4, 10, 12), tnio.LAYOUT_BIP, off)
        want = cube[3:13, 4:16, :]
    else:
        cube = rng.normal(size=(5, 40, 50))
        path = str(tmp_path / "cube.bin")
        cube.tofile(path)
        args = (path, cube.shape, np.float64, (8, 9, 16, 20), tnio.LAYOUT_BSQ, 0)
        want = cube[:, 8:24, 9:29]
    assert _same(tnio.read_window(*args), tnio.read_window_plain(*args),
                 jnio.read_window(*args), want)


def _cube():
    rng = np.random.default_rng(4)
    cube = rng.uniform(1, 8, size=(37, 29, 7)).astype(np.float32)  # 1,073 px: odd quads
    cube[2, 3, 0] = FILL
    cube[5, 5, :] = FILL
    cube[7, 1, 6] = FILL  # the fill only in the tail band
    cube[9, 9, 2] = np.nan  # neither invalidates nor enters the range
    cube[11, 4, 3] = np.inf
    return cube


@pytest.mark.parametrize("n_mm", [None, 0, 4, 6])
def test_valid_band_minmax_prefix_and_skip(n_mm):
    cube = _cube()
    got = tnio.valid_band_minmax(cube, FILL, n_minmax_bands=n_mm)
    for other in (tnio.valid_band_minmax_plain(cube, FILL, n_minmax_bands=n_mm),
                  jnio.valid_band_minmax(cube, FILL, n_minmax_bands=n_mm)):
        for a, b in zip(got, other):
            assert (a is None and b is None) or _same(a, b)
    assert not got[0][2, 3] and not got[0][7, 1] and got[0][9, 9]
    if n_mm == 0:
        assert got[1] is None and got[2] is None
    with pytest.raises(ValueError):
        tnio.valid_band_minmax(cube, FILL, n_minmax_bands=8)


def test_band_minmax_nan_inf_and_empty():
    cube = _cube()
    valid = ~(cube == np.float32(FILL)).any(-1)
    dead = cube.copy()
    dead[..., 5] = np.nan  # no contribution: (0, 1)
    dead[..., 6] = -np.inf  # only -inf: the library's (-inf, -3.4e38)
    for v in (None, valid, np.zeros_like(valid)):
        got = tnio.band_minmax(dead, v)
        for other in (tnio.band_minmax_plain(dead, v), jnio.band_minmax(dead, v)):
            assert all(_same(a, b) for a, b in zip(got, other))
    lo, hi = tnio.band_minmax(dead, valid)
    assert (lo[5], hi[5]) == (0.0, 1.0) and lo[6] == -np.inf
    lo0, hi0 = tnio.band_minmax(dead, np.zeros_like(valid))
    assert (lo0 == 0).all() and (hi0 == 1).all()


@pytest.mark.parametrize("codec", ["pack12", "pack10"])
@pytest.mark.parametrize("bands", [6, 7])
def test_packs_byte_identical(codec, bands):
    """Random grids, half grid steps (x - lo = k + 1/2 steps exactly), out of
    range values (the fill, +-1e9 at scale 1e-12) and NaN; u10 on an odd
    band count, u12 refusing one."""
    cube = _cube()[..., :bands].copy()
    cube[np.isinf(cube)] = 3.0
    valid, lo, hi = tnio.valid_band_minmax(cube, FILL)
    top = 4095.0 if codec == "pack12" else 1023.0
    scale = np.maximum((hi - lo) / top, 1e-12).astype(np.float32)
    halves = cube.copy()
    halves[:4] = (np.arange(4 * 29 * bands).reshape(4, 29, bands) % top + 0.5).astype(np.float32)
    ones = np.ones(bands, np.float32)
    spikes = np.full((4, 5, bands), 5.0, np.float32)
    spikes[0, 0, 0], spikes[1, 1, 1], spikes[2, 2, 0] = 1e9, -1e9, np.nan
    fn = "quantize_" + codec
    cases = [(cube, lo, scale), (halves, np.zeros(bands, np.float32), ones),
             (spikes, np.full(bands, 5.0, np.float32), np.full(bands, 1e-12, np.float32))]
    if codec == "pack12" and bands % 2:
        with pytest.raises(ValueError):
            getattr(tnio, fn)(cube, lo, scale)
        with pytest.raises(ValueError):
            getattr(tnio, fn + "_plain")(cube, lo, scale)
        return
    for x, lo_, scale_ in cases:
        got = getattr(tnio, fn)(x, lo_, scale_)
        assert _same(got, getattr(tnio, fn + "_plain")(x, lo_, scale_),
                     getattr(jnio, fn)(x, lo_, scale_))
    # A half step rounds up: 0.5 -> 1, 2.5 -> 3 (where numpy's rint gives 0, 2).
    got = getattr(tnio, fn)(np.full((1, 4, bands), 2.5, np.float32), np.zeros(bands, np.float32),
                            ones)
    assert got[0].max() == 3 and got[0].min() == 3
    with pytest.raises(ValueError):
        getattr(tnio, fn)(cube, lo[:3], scale[:3])


def test_serve_encoder_runs_the_library(monkeypatch):
    """``encode_payload`` encodes through the library: with it unloadable the
    u12 encode raises; loaded, its wire equals the numpy twins'."""
    rng = np.random.default_rng(5)
    cube = rng.uniform(1, 8, (16, 12, 5)).astype(np.float32)
    cube[2, 2, :] = FILL
    granule = {"cube": cube, "rgb": rng.uniform(0, 60, (16, 12, 3)).astype(np.float32),
               "fill_value": FILL, "wavelengths": None, "fwhm": None, "glt": None,
               "transform": None, "crs_epsg": None}
    wire = tserve.encode_payload(granule, "u12")["wire"]
    valid, lo, hi = tnio.valid_band_minmax_plain(cube, FILL, n_minmax_bands=4)
    scale = np.maximum((hi - lo) / 4095.0, 1e-12).astype(np.float32)
    assert _same(wire["cube"], tnio.quantize_pack12_plain(np.ascontiguousarray(cube[..., :4]),
                                                          lo, scale))

    def no_library():
        raise RuntimeError("native IO build failed")

    monkeypatch.setattr(tnio, "_load", no_library)
    with pytest.raises(RuntimeError, match="build failed"):
        tserve.encode_payload(granule, "u12")


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    """A broken source raises with g++'s errors; a compiler that cannot run
    (``CXX=false``) raises too. Neither falls back to the numpy twins."""
    broken = tmp_path / "broken.cpp"
    broken.write_text(open(tnio.SOURCE).read() + "\nint broken_line = ;\n")
    monkeypatch.setattr(tnio, "BUILD_ROOT", str(tmp_path / "build"))
    monkeypatch.setattr(tnio, "SOURCE", str(broken))
    with pytest.raises(RuntimeError, match="(?s)native IO build failed.*error"):
        tnio.build()
    assert not any(f.endswith(".so") for _, _, fs in os.walk(tmp_path / "build") for f in fs)
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="false"):
        tnio.build()


def test_build_key(tmp_path, monkeypatch):
    """The build directory moves with the source and the compiler; the
    library is renamed into place, no temporary file left."""
    base = tnio.build_dir("g++")
    src = tmp_path / "edited.cpp"
    src.write_text(open(tnio.SOURCE).read() + "\n// edited\n")
    monkeypatch.setattr(tnio, "SOURCE", str(src))
    assert tnio.build_dir("g++") != base
    monkeypatch.setattr(tnio, "BUILD_ROOT", str(tmp_path / "build"))
    lib = tnio.build()
    assert os.path.exists(lib) and os.listdir(os.path.dirname(lib)) == [tnio.LIB_NAME]
