"""Host-side upload codecs of the serving pipeline (the numpy paths of
starcop_tpu/data/native_io.py, under the same names).

``valid_band_minmax`` (the fill-value scan fused with the per-band range),
``band_minmax``, and the 12-bit band-pair and 10-bit pixel-quad packers
``quantize_pack12`` / ``quantize_pack10``. Their output is byte-identical to
the JAX package's numpy fallback. The JAX package also runs them as one
threaded native pass (``cpp/starcop_io.cpp`` through ctypes); that library
is not ported yet (ROADMAP, module item 5), so here they are numpy only.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def band_minmax(
    cube: np.ndarray, valid: Optional[np.ndarray] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-band (lo, hi) over valid pixels of a (..., S) float32 cube.

    NaN never contributes to the range; an all-invalid band pins (0, 1) so
    the downstream quantization scale stays finite.
    """
    cube = np.ascontiguousarray(cube, np.float32)
    s = cube.shape[-1]
    n_px = int(np.prod(cube.shape[:-1]))
    flat = cube.reshape(n_px, s)
    contrib = ~np.isnan(flat)
    if valid is not None:
        contrib &= np.asarray(valid).reshape(n_px).astype(bool)[:, None]
    lo = np.where(contrib, flat, np.inf).min(axis=0)
    hi = np.where(contrib, flat, -np.inf).max(axis=0)
    ok = np.isfinite(lo) & np.isfinite(hi)
    return (
        np.where(ok, lo, 0.0).astype(np.float32),
        np.where(ok, hi, 1.0).astype(np.float32),
    )


def valid_band_minmax(
    cube: np.ndarray,
    fill: float,
    n_minmax_bands: Optional[int] = None,
) -> Tuple[np.ndarray, Optional[np.ndarray], Optional[np.ndarray]]:
    """Nodata-validity scan plus the per-band (lo, hi) of the valid pixels.

    ``valid[p]`` = no band of pixel p equals ``fill`` (the
    ``EMITRawScene.invalid_mask`` rule; NaN never invalidates and never
    contributes to the range). (lo, hi) cover the first ``n_minmax_bands``
    bands (default all; 0 skips them and returns ``(valid, None, None)``).

    Returns ``(valid bool cube.shape[:-1], lo (s_mm,) f32, hi (s_mm,) f32)``.
    """
    cube = np.ascontiguousarray(cube, np.float32)
    s = cube.shape[-1]
    s_mm = s if n_minmax_bands is None else int(n_minmax_bands)
    if not 0 <= s_mm <= s:
        raise ValueError(f"n_minmax_bands must be in [0, {s}], got {s_mm}")
    n_px = int(np.prod(cube.shape[:-1]))
    valid = ~(cube.reshape(n_px, s) == np.float32(fill)).any(axis=-1)
    valid = valid.reshape(cube.shape[:-1])
    if s_mm == 0:
        return valid, None, None
    lo, hi = band_minmax(cube[..., :s_mm], valid)
    return valid, lo, hi


def _lo_inv_scale(lo, scale, s: int):
    lo = np.ascontiguousarray(lo, np.float32)
    inv_scale = np.ascontiguousarray(1.0 / np.asarray(scale, np.float32))
    if lo.shape != (s,) or inv_scale.shape != (s,):
        raise ValueError(f"lo/scale must have shape ({s},); got {lo.shape}/{inv_scale.shape}")
    return lo, inv_scale


def quantize_pack12(cube: np.ndarray, lo: np.ndarray, scale: np.ndarray) -> np.ndarray:
    """Per-band affine 12-bit quantization, band pairs packed 2 values/3 bytes.

    cube: (..., S) float32 with S even; q = clamp(rint((x - lo)/scale), 0,
    4095), NaN -> 0. Returns a (3, ..., S/2) uint8 array of byte planes

        b0 = q0 & 0xff, b1 = (q0 >> 8) | ((q1 & 0xf) << 4), b2 = q1 >> 4

    for each band pair (2k, 2k+1): the 'u12' wire of the serving pipeline.
    """
    cube = np.ascontiguousarray(cube, np.float32)
    s = cube.shape[-1]
    if s % 2:
        raise ValueError(f"quantize_pack12 needs an even band count, got {s}")
    lo, inv_scale = _lo_inv_scale(lo, scale, s)
    q = np.nan_to_num(np.clip(np.rint((cube - lo) * inv_scale), 0, 4095), nan=0.0).astype(np.uint16)
    q0, q1 = q[..., 0::2], q[..., 1::2]
    out = np.empty((3,) + cube.shape[:-1] + (s // 2,), np.uint8)
    out[0] = q0 & 0xFF
    out[1] = (q0 >> 8).astype(np.uint8) | ((q1 & 0xF) << 4).astype(np.uint8)
    out[2] = (q1 >> 4).astype(np.uint8)
    return out


def quantize_pack10(cube: np.ndarray, lo: np.ndarray, scale: np.ndarray) -> np.ndarray:
    """Per-band affine 10-bit quantization, pixel quads packed 4 values/5 bytes.

    cube: (..., S) float32, any S; q = clamp(rint((x - lo)/scale), 0, 1023),
    NaN -> 0. Pixels are flattened and grouped in quads (a trailing partial
    quad is padded with q = 0). Returns a (5, ceil(n_px / 4), S) uint8 array
    of byte planes

        p0 = q0 & 0xff
        p1 = (q0 >> 8) | ((q1 & 0x3f) << 2)
        p2 = (q1 >> 6) | ((q2 & 0x0f) << 4)
        p3 = (q2 >> 4) | ((q3 & 0x03) << 6)
        p4 = q3 >> 2

    the 'u10' wire of the serving pipeline.
    """
    cube = np.ascontiguousarray(cube, np.float32)
    s = cube.shape[-1]
    n_px = int(np.prod(cube.shape[:-1]))
    n_groups = (n_px + 3) // 4
    lo, inv_scale = _lo_inv_scale(lo, scale, s)
    q = np.nan_to_num(
        np.clip(np.rint((cube.reshape(n_px, s) - lo) * inv_scale), 0, 1023), nan=0.0
    ).astype(np.uint16)
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
