"""Host-side native IO and upload codecs: ctypes bindings of this package's
``csrc/starcop_io.cpp`` (a byte-identical copy of the JAX package's
``cpp/starcop_io.cpp``), under the names of starcop_tpu/data/native_io.py.

  ``read_window`` / ``read_npy_windows_batch``  windowed reads of raw rasters
      (R2 (H, W), BIP (H, W, C), BSQ (C, H, W)) by pread(2), a batch in
      native threads;
  ``band_minmax`` / ``valid_band_minmax``  the per-band range of the valid
      pixels, fused with the fill-value scan, in one threaded pass;
  ``quantize_pack12`` / ``quantize_pack10``  the serving pipeline's 'u12'
      (band pairs, 2 values / 3 bytes) and 'u10' (pixel quads, 4 values /
      5 bytes) wires, in one threaded pass.

The library is built with ``g++`` (``$CXX`` if set) and the flags of
``cpp/Makefile`` at first use, into ``starcop_tpu_torch/_build/``, keyed by
a hash of the source, the flags, the compiler's version and what
``-march=native`` means on this host; the build is renamed into place, so a
concurrent process never loads a half-written file. A failed build raises
with the compiler's output: nothing falls back.

Each function has a numpy twin, ``<name>_plain``, byte-identical to the
library by construction (NaN never contributes to a range and never
invalidates a pixel; a range starts at +-3.4e38 and an empty one pins
(0, 1); quantization clamps in float, NaN to 0, and rounds half up). The
twins run only when a caller asks for them (tests, parity). They differ
from the JAX package's numpy fallback at exact-half grid points, where that
fallback rounds half to even, and at infinite values, where it pins (0, 1).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import subprocess
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "starcop_io.cpp")
BUILD_ROOT = os.path.join(_PKG, "_build")
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-Wextra", "-shared",
            "-pthread")
LIB_NAME = "libstarcop_io.so"

LAYOUT_R2 = 0  # (H, W)
LAYOUT_BIP = 1  # (H, W, C)
LAYOUT_BSQ = 2  # (C, H, W)

_RANGE_INIT = np.float32(3.4e38)  # the library's initial (lo, hi) = (+3.4e38, -3.4e38)
_BUILD_LOCK = threading.Lock()

_i32, _i64, _f32 = ctypes.c_int32, ctypes.c_int64, ctypes.c_float
_u8p, _f32p = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float)
_i64p = ctypes.POINTER(ctypes.c_int64)
_SIGNATURES = {
    "starcop_read_window": (ctypes.c_int, [ctypes.c_char_p, _i64, _i32, _i32, _i64p, _i64, _i64,
                                           _i64, _i64, _u8p]),
    "starcop_read_windows_batch": (ctypes.c_int, [ctypes.POINTER(ctypes.c_char_p), _i64p, _i32,
                                                  _i32, _i64p, _i64p, ctypes.POINTER(_u8p), _i32,
                                                  _i32]),
    "starcop_file_size": (_i64, [ctypes.c_char_p]),
    "starcop_band_minmax": (ctypes.c_int, [_f32p, _u8p, _i64, _i32, _f32p, _f32p, _i32]),
    "starcop_valid_band_minmax": (ctypes.c_int, [_f32p, _f32, _i64, _i32, _i32, _u8p, _f32p,
                                                 _f32p, _i32]),
    "starcop_quantize_pack12": (ctypes.c_int, [_f32p, _i64, _i32, _f32p, _f32p, _u8p, _i32]),
    "starcop_quantize_pack10": (ctypes.c_int, [_f32p, _i64, _i32, _f32p, _f32p, _u8p, _i32]),
}


def _cxx() -> str:
    return os.environ.get("CXX") or "g++"


def _query(cmd: Sequence[str]) -> str:
    """The output of a compiler query, raising with it when the query fails."""
    try:
        res = subprocess.run(list(cmd), capture_output=True, text=True, timeout=60)
    except OSError as err:
        raise RuntimeError(f"native IO build: cannot run {' '.join(cmd)}: {err}") from err
    if res.returncode != 0:
        raise RuntimeError(f"native IO build: {' '.join(cmd)} failed ({res.returncode}):\n"
                           f"{res.stdout}{res.stderr}")
    return res.stdout


def build_dir(cxx: str, source: Optional[str] = None, prefix: str = "io",
              libs: Sequence[str] = ()) -> str:
    """``_build/<prefix>-<hash>``: the hash covers the source (default
    ``SOURCE``), the flags and libraries, the compiler's version, the target
    that ``-march=native`` resolves to on this host and the host's machine
    type."""
    h = hashlib.sha256()
    with open(SOURCE if source is None else source, "rb") as fh:
        h.update(fh.read())
    for part in (" ".join((cxx, *CXXFLAGS, *libs)), _query([cxx, "--version"]),
                 _query([cxx, "-march=native", "-Q", "--help=target"]), platform.machine()):
        h.update(part.encode())
    return os.path.join(BUILD_ROOT, f"{prefix}-" + h.hexdigest()[:16])


def build(source: Optional[str] = None, lib_name: Optional[str] = None, prefix: str = "io",
          libs: Sequence[str] = ()) -> str:
    """Build a library (default: ``SOURCE`` as ``LIB_NAME``; ``libs``: the
    link flags after the source) for the current source and host unless it
    is on disk; returns its path. A failed compile raises with its output."""
    cxx = _cxx()
    source = SOURCE if source is None else source
    out_dir = build_dir(cxx, source, prefix, libs)
    lib = os.path.join(out_dir, LIB_NAME if lib_name is None else lib_name)
    if not os.path.exists(lib):
        os.makedirs(out_dir, exist_ok=True)
        tmp = f"{lib}.{os.getpid()}.tmp"
        cmd = [cxx, *CXXFLAGS, "-o", tmp, source, *libs]
        try:
            res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        except OSError as err:
            raise RuntimeError(f"native IO build: cannot run {' '.join(cmd)}: {err}") from err
        if res.returncode != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise RuntimeError(f"native IO build failed ({res.returncode}): {' '.join(cmd)}\n"
                               f"{res.stdout}{res.stderr}")
        os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=1)
def _load() -> ctypes.CDLL:
    """Build (once per key) and load the library, every function's
    ``argtypes`` and ``restype`` declared."""
    with _BUILD_LOCK:
        lib = ctypes.CDLL(build())
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def available() -> bool:
    """True once the library is built and loaded; a failed build raises."""
    return _load() is not None


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise OSError(f"{what} failed: {rc}")


def _ptr(a: np.ndarray, ptype=_u8p):
    return a.ctypes.data_as(ptype)


def npy_payload_info(path: str) -> Tuple[int, Tuple[int, ...], np.dtype]:
    """Header offset, shape and dtype of a .npy file (v1/v2 headers)."""
    with open(path, "rb") as fh:
        version = np.lib.format.read_magic(fh)
        shape, fortran, dtype = np.lib.format._read_array_header(fh, version)
        if fortran:
            raise ValueError("Fortran-ordered .npy not supported")
        return fh.tell(), shape, dtype


def _window_shape(shape, window, layout: int) -> Tuple[int, ...]:
    _, _, h, w = window
    if layout == LAYOUT_R2:
        return (h, w)
    if layout == LAYOUT_BIP:
        return (h, w, int(shape[2]))
    if layout == LAYOUT_BSQ:
        return (int(shape[0]), h, w)
    raise ValueError(f"layout must be LAYOUT_R2, LAYOUT_BIP or LAYOUT_BSQ, got {layout}")


def _shape3(shape) -> List[int]:
    return [int(v) for v in shape] + [1] * (3 - len(shape))


def read_window(path: str, shape: Sequence[int], dtype, window: Tuple[int, int, int, int],
                layout: int = LAYOUT_R2, offset_bytes: int = 0) -> np.ndarray:
    """Read the (row_off, col_off, h, w) window of a raw raster of ``shape``
    and ``dtype`` whose payload starts at ``offset_bytes``."""
    dtype = np.dtype(dtype)
    out = np.empty(_window_shape(shape, window, layout), dtype=dtype)
    row_off, col_off, h, w = window
    _check(_load().starcop_read_window(path.encode(), offset_bytes, dtype.itemsize, layout,
                                       (ctypes.c_int64 * 3)(*_shape3(shape)), row_off, col_off,
                                       h, w, _ptr(out)), f"starcop_read_window({path})")
    return out


def read_window_plain(path: str, shape: Sequence[int], dtype, window: Tuple[int, int, int, int],
                      layout: int = LAYOUT_R2, offset_bytes: int = 0) -> np.ndarray:
    """``read_window`` through a numpy memmap."""
    row_off, col_off, h, w = window
    _window_shape(shape, window, layout)
    mm = np.memmap(path, dtype=np.dtype(dtype), mode="r", offset=offset_bytes, shape=tuple(shape))
    rows, cols = slice(row_off, row_off + h), slice(col_off, col_off + w)
    if layout == LAYOUT_BSQ:
        return np.array(mm[:, rows, cols])
    return np.array(mm[rows, cols])


def read_npy_windows_batch(paths: Sequence[str], windows: Sequence[Tuple[int, int, int, int]],
                           n_threads: int = 0) -> List[np.ndarray]:
    """Windowed reads of single-band .npy rasters of one dtype, in native
    threads (0: one per core)."""
    infos = [npy_payload_info(p) for p in paths]
    n = len(paths)
    if n == 0:
        return []
    dtype = infos[0][2]
    if any(i[2] != dtype for i in infos):
        raise ValueError("Mixed dtypes in a batch are not supported")
    outs = [np.empty((w[2], w[3]), dtype=dtype) for w in windows]
    shapes = [v for i in infos for v in _shape3(i[1])]
    wins = [int(v) for w in windows for v in w]
    _check(_load().starcop_read_windows_batch(
        (ctypes.c_char_p * n)(*[p.encode() for p in paths]),
        (ctypes.c_int64 * n)(*[i[0] for i in infos]), dtype.itemsize, LAYOUT_R2,
        (ctypes.c_int64 * (3 * n))(*shapes), (ctypes.c_int64 * (4 * n))(*wins),
        (_u8p * n)(*[_ptr(o) for o in outs]), n, n_threads), "starcop_read_windows_batch")
    return outs


def read_npy_windows_batch_plain(paths: Sequence[str],
                                 windows: Sequence[Tuple[int, int, int, int]]) -> List[np.ndarray]:
    """``read_npy_windows_batch`` one memmap read at a time."""
    out = []
    for p, win in zip(paths, windows):
        off, shape, dtype = npy_payload_info(p)
        out.append(read_window_plain(p, shape, dtype, win, LAYOUT_R2, off))
    return out


def _cube_px(cube: np.ndarray):
    cube = np.ascontiguousarray(cube, np.float32)
    return cube, cube.shape[-1], int(np.prod(cube.shape[:-1]))


def band_minmax(cube: np.ndarray, valid: Optional[np.ndarray] = None,
                n_threads: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Per-band (lo, hi) over the valid pixels of a (..., S) float32 cube,
    one threaded pass. NaN never contributes; a band with no contribution
    pins (0, 1) so the downstream quantization scale stays finite."""
    cube, s, n_px = _cube_px(cube)
    valid_u8 = None if valid is None else np.ascontiguousarray(
        np.asarray(valid).reshape(n_px), np.uint8)
    lo, hi = np.empty(s, np.float32), np.empty(s, np.float32)
    _check(_load().starcop_band_minmax(_ptr(cube, _f32p),
                                       None if valid_u8 is None else _ptr(valid_u8), n_px, s,
                                       _ptr(lo, _f32p), _ptr(hi, _f32p), n_threads),
           "starcop_band_minmax")
    return lo, hi


def band_minmax_plain(cube: np.ndarray,
                      valid: Optional[np.ndarray] = None) -> Tuple[np.ndarray, np.ndarray]:
    """``band_minmax`` in numpy."""
    cube, s, n_px = _cube_px(cube)
    flat = cube.reshape(n_px, s)
    contrib = ~np.isnan(flat)
    if valid is not None:
        contrib &= np.asarray(valid).reshape(n_px).astype(bool)[:, None]
    lo = np.where(contrib, flat, _RANGE_INIT).min(axis=0, initial=_RANGE_INIT)
    hi = np.where(contrib, flat, -_RANGE_INIT).max(axis=0, initial=-_RANGE_INIT)
    ok = lo <= hi
    return np.where(ok, lo, 0.0).astype(np.float32), np.where(ok, hi, 1.0).astype(np.float32)


def _minmax_bands(s: int, n_minmax_bands: Optional[int]) -> int:
    s_mm = s if n_minmax_bands is None else int(n_minmax_bands)
    if not 0 <= s_mm <= s:
        raise ValueError(f"n_minmax_bands must be in [0, {s}], got {s_mm}")
    return s_mm


def valid_band_minmax(
    cube: np.ndarray, fill: float, n_minmax_bands: Optional[int] = None, n_threads: int = 0,
) -> Tuple[np.ndarray, Optional[np.ndarray], Optional[np.ndarray]]:
    """The fill-value scan fused with the per-band range, one threaded pass.

    ``valid[p]`` = no band of pixel p equals ``fill`` (the
    ``EMITRawScene.invalid_mask`` rule; NaN never invalidates and never
    contributes to the range). (lo, hi) cover the first ``n_minmax_bands``
    bands (default all; 0 skips them and returns ``(valid, None, None)``).

    Returns ``(valid bool cube.shape[:-1], lo (s_mm,) f32, hi (s_mm,) f32)``.
    """
    cube, s, n_px = _cube_px(cube)
    s_mm = _minmax_bands(s, n_minmax_bands)
    valid = np.empty(n_px, np.uint8)
    lo, hi = np.empty(max(s_mm, 1), np.float32), np.empty(max(s_mm, 1), np.float32)
    _check(_load().starcop_valid_band_minmax(_ptr(cube, _f32p), float(fill), n_px, s, s_mm,
                                             _ptr(valid), _ptr(lo, _f32p), _ptr(hi, _f32p),
                                             n_threads), "starcop_valid_band_minmax")
    valid_b = valid.view(bool).reshape(cube.shape[:-1])
    return (valid_b, None, None) if s_mm == 0 else (valid_b, lo, hi)


def valid_band_minmax_plain(
    cube: np.ndarray, fill: float, n_minmax_bands: Optional[int] = None,
) -> Tuple[np.ndarray, Optional[np.ndarray], Optional[np.ndarray]]:
    """``valid_band_minmax`` in numpy: the scan, then ``band_minmax_plain``."""
    cube, s, n_px = _cube_px(cube)
    s_mm = _minmax_bands(s, n_minmax_bands)
    valid = ~(cube.reshape(n_px, s) == np.float32(fill)).any(axis=-1)
    valid = valid.reshape(cube.shape[:-1])
    if s_mm == 0:
        return valid, None, None
    lo, hi = band_minmax_plain(cube[..., :s_mm], valid)
    return valid, lo, hi


def _lo_inv_scale(lo, scale, s: int):
    lo = np.ascontiguousarray(lo, np.float32)
    inv_scale = np.ascontiguousarray(1.0 / np.asarray(scale, np.float32))
    # The library indexes lo/scale per band with no bounds check.
    if lo.shape != (s,) or inv_scale.shape != (s,):
        raise ValueError(f"lo/scale must have shape ({s},); got {lo.shape}/{inv_scale.shape}")
    return lo, inv_scale


def _quantize(cube: np.ndarray, lo, inv_scale, top: float) -> np.ndarray:
    """The library's q = (int)(clamp((x - lo) * inv_scale, 0, top) + 0.5) in
    f32: the clamp in float (NaN -> 0), then round half up."""
    f = (cube - lo) * inv_scale
    f = np.where(f > 0, np.where(f < np.float32(top), f, np.float32(top)), np.float32(0.0))
    return (f + np.float32(0.5)).astype(np.int32).astype(np.uint16)


def quantize_pack12(cube: np.ndarray, lo: np.ndarray, scale: np.ndarray,
                    n_threads: int = 0) -> np.ndarray:
    """Per-band affine 12-bit quantization, band pairs packed 2 values / 3 bytes.

    cube: (..., S) float32 with S even; q = clamp((x - lo) / scale, 0, 4095)
    rounded half up, NaN -> 0. Returns a (3, ..., S/2) uint8 array of byte
    planes

        b0 = q0 & 0xff, b1 = (q0 >> 8) | ((q1 & 0xf) << 4), b2 = q1 >> 4

    for each band pair (2k, 2k+1): the 'u12' wire of the serving pipeline.
    """
    cube, s, n_px = _cube_px(cube)
    if s % 2:
        raise ValueError(f"quantize_pack12 needs an even band count, got {s}")
    lo, inv_scale = _lo_inv_scale(lo, scale, s)
    out = np.empty((3,) + cube.shape[:-1] + (s // 2,), np.uint8)
    _check(_load().starcop_quantize_pack12(_ptr(cube, _f32p), n_px, s, _ptr(lo, _f32p),
                                           _ptr(inv_scale, _f32p), _ptr(out), n_threads),
           "starcop_quantize_pack12")
    return out


def quantize_pack12_plain(cube: np.ndarray, lo: np.ndarray, scale: np.ndarray) -> np.ndarray:
    """``quantize_pack12`` in numpy."""
    cube, s, _ = _cube_px(cube)
    if s % 2:
        raise ValueError(f"quantize_pack12 needs an even band count, got {s}")
    lo, inv_scale = _lo_inv_scale(lo, scale, s)
    q = _quantize(cube, lo, inv_scale, 4095.0)
    q0, q1 = q[..., 0::2], q[..., 1::2]
    out = np.empty((3,) + cube.shape[:-1] + (s // 2,), np.uint8)
    out[0] = q0 & 0xFF
    out[1] = (q0 >> 8).astype(np.uint8) | ((q1 & 0xF) << 4).astype(np.uint8)
    out[2] = (q1 >> 4).astype(np.uint8)
    return out


def quantize_pack10(cube: np.ndarray, lo: np.ndarray, scale: np.ndarray,
                    n_threads: int = 0) -> np.ndarray:
    """Per-band affine 10-bit quantization, pixel quads packed 4 values / 5 bytes.

    cube: (..., S) float32, any S; q = clamp((x - lo) / scale, 0, 1023)
    rounded half up, NaN -> 0. Pixels are flattened and grouped in quads (a
    trailing partial quad is padded with q = 0). Returns a
    (5, ceil(n_px / 4), S) uint8 array of byte planes

        p0 = q0 & 0xff
        p1 = (q0 >> 8) | ((q1 & 0x3f) << 2)
        p2 = (q1 >> 6) | ((q2 & 0x0f) << 4)
        p3 = (q2 >> 4) | ((q3 & 0x03) << 6)
        p4 = q3 >> 2

    the 'u10' wire of the serving pipeline.
    """
    cube, s, n_px = _cube_px(cube)
    lo, inv_scale = _lo_inv_scale(lo, scale, s)
    out = np.empty((5, (n_px + 3) // 4, s), np.uint8)
    _check(_load().starcop_quantize_pack10(_ptr(cube, _f32p), n_px, s, _ptr(lo, _f32p),
                                           _ptr(inv_scale, _f32p), _ptr(out), n_threads),
           "starcop_quantize_pack10")
    return out


def quantize_pack10_plain(cube: np.ndarray, lo: np.ndarray, scale: np.ndarray) -> np.ndarray:
    """``quantize_pack10`` in numpy."""
    cube, s, n_px = _cube_px(cube)
    n_groups = (n_px + 3) // 4
    lo, inv_scale = _lo_inv_scale(lo, scale, s)
    q = _quantize(cube.reshape(n_px, s), lo, inv_scale, 1023.0)
    if n_px % 4:
        q = np.concatenate([q, np.zeros((4 * n_groups - n_px, s), np.uint16)], axis=0)
    q = q.reshape(n_groups, 4, s)
    q0, q1, q2, q3 = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    out = np.empty((5, n_groups, s), np.uint8)
    out[0] = q0 & 0xFF
    out[1] = (q0 >> 8).astype(np.uint8) | ((q1 & 0x3F) << 2).astype(np.uint8)
    out[2] = (q1 >> 6).astype(np.uint8) | ((q2 & 0x0F) << 4).astype(np.uint8)
    out[3] = (q2 >> 4).astype(np.uint8) | ((q3 & 0x03) << 6).astype(np.uint8)
    out[4] = (q3 >> 2).astype(np.uint8)
    return out
