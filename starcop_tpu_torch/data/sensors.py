"""Sensor simulation and radiometric correction (counterpart of
starcop_tpu/data/sensors.py).

  * spectral response aggregation (``transform_to_srf``): the cube's bands
    are combined per target band by normalised SRF weights, one f32
    (H*W, K) x (K, B) product on the device with TF32 off (TF32 would cost
    ~1e-3 relative, the trap JAX's ``precision="highest"`` avoids);
  * anti-aliased resolution change: a per-band separable Gaussian blur
    (a reflect pad gathered as ``ops/padding.py`` does, so a pad wider than
    the band works, as ``jnp.pad``'s; two ``F.conv2d`` passes in f32), then
    ``jax.image.resize``'s bilinear resize with antialiasing, computed in
    f64 and cast back: torch's f32 antialiased resize loses ~1e-4 relative
    in its weights at large indices (819 x 512 from 1024 x 640), ~500x
    JAX's own f32 error, while at f64 it is the same function;
  * TOA reflectance: the earth-sun distance factor, the solar zenith (a
    NOAA-style solar position), per-sensor solar irradiance tables.

SRFs come from the tabulated tables of ``data/srf.py`` (``srf_source=
"table"``, a measured CSV through ``srf_csv``) or a plain Gaussian
(``srf_source="gaussian"``). The SRF weight matrices and the solar geometry are
numpy / math, copies of JAX's; the cube work runs on the device the caller
names (None: the CUDA card).
"""

from __future__ import annotations

import functools
import math
from datetime import datetime, timezone
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from starcop_tpu_torch.device import DeviceLike, float32_precision, resolve_device
from starcop_tpu_torch.ops.padding import reflect_pad

BANDS_S2_RESOLUTION = {
    "B1": 60, "B2": 10, "B3": 10, "B4": 10, "B5": 20, "B6": 20, "B7": 20,
    "B8": 10, "B8A": 20, "B9": 60, "B10": 60, "B11": 20, "B12": 20,
}

# Mean solar spectral irradiance per band, W/m^2/nm (ESA S2 L1C constants,
# Maxar WV3 SWIR constants / 1000).
SOLAR_IRRADIANCE_S2B = {
    "B01": 1.8743, "B02": 1.95977, "B03": 1.82493, "B04": 1.51279,
    "B05": 1.42578, "B06": 1.29113, "B07": 1.17557, "B08": 1.04128,
    "B8A": 0.95393, "B09": 0.81758, "B10": 0.36541, "B11": 0.24708, "B12": 0.08775,
}
SOLAR_IRRADIANCE_S2A = {
    "B01": 1.88469, "B02": 1.95972, "B03": 1.82324, "B04": 1.51206,
    "B05": 1.42464, "B06": 1.28761, "B07": 1.16208, "B08": 1.04163,
    "B8A": 0.95532, "B09": 0.81292, "B10": 0.36715, "B11": 0.24559, "B12": 0.08525,
}
SOLAR_IRRADIANCE_WV3 = {
    "SWIR1": 0.4778728, "SWIR2": 0.2632926, "SWIR3": 0.2249720, "SWIR4": 0.1973366,
    "SWIR5": 0.0903976, "SWIR6": 0.0850757, "SWIR7": 0.0769260, "SWIR8": 0.0680897,
}
SOLAR_IRRADIANCE = {"S2A": SOLAR_IRRADIANCE_S2A, "S2B": SOLAR_IRRADIANCE_S2B, "WV3": SOLAR_IRRADIANCE_WV3}

# Published band centers / FWHM (nm) for Gaussian SRF approximations.
S2_BAND_CENTERS_FWHM: Dict[str, Tuple[float, float]] = {
    "B1": (442.7, 21), "B2": (492.4, 66), "B3": (559.8, 36), "B4": (664.6, 31),
    "B5": (704.1, 15), "B6": (740.5, 15), "B7": (782.8, 20), "B8": (832.8, 106),
    "B8A": (864.7, 21), "B9": (945.1, 20), "B10": (1373.5, 31), "B11": (1613.7, 91),
    "B12": (2202.4, 175),
}
WV3_SWIR_CENTERS_FWHM: Dict[str, Tuple[float, float]] = {
    "SWIR1": (1210, 30), "SWIR2": (1570, 40), "SWIR3": (1660, 40), "SWIR4": (1730, 40),
    "SWIR5": (2165, 40), "SWIR6": (2205, 40), "SWIR7": (2260, 50), "SWIR8": (2330, 70),
}


# ------------------------------------------------------------------ solar
def earth_sun_distance_correction_factor(date_of_acquisition: datetime) -> float:
    """1 - 0.01673 cos(0.0172 (doy - 4))."""
    tm_yday = date_of_acquisition.timetuple().tm_yday
    return 1 - 0.01673 * math.cos(0.0172 * (tm_yday - 4))


def solar_zenith_angle(lat_deg: float, lon_deg: float, when: datetime) -> float:
    """Solar zenith angle in degrees (NOAA low-accuracy solar position,
    accurate to ~0.1 degree)."""
    if when.tzinfo is None:
        when = when.replace(tzinfo=timezone.utc)
    when = when.astimezone(timezone.utc)
    # Julian centuries since J2000.0
    y, m = when.year, when.month
    d = when.day + (when.hour + when.minute / 60 + when.second / 3600) / 24.0
    if m <= 2:
        y -= 1
        m += 12
    a = y // 100
    b = 2 - a + a // 4
    jd = int(365.25 * (y + 4716)) + int(30.6001 * (m + 1)) + d + b - 1524.5
    t = (jd - 2451545.0) / 36525.0
    # Sun geometry
    l0 = (280.46646 + t * (36000.76983 + 0.0003032 * t)) % 360
    m_anom = 357.52911 + t * (35999.05029 - 0.0001537 * t)
    mrad = math.radians(m_anom)
    c = (
        (1.914602 - t * (0.004817 + 0.000014 * t)) * math.sin(mrad)
        + (0.019993 - 0.000101 * t) * math.sin(2 * mrad)
        + 0.000289 * math.sin(3 * mrad)
    )
    true_long = l0 + c
    omega = 125.04 - 1934.136 * t
    app_long = true_long - 0.00569 - 0.00478 * math.sin(math.radians(omega))
    # Obliquity
    e0 = 23 + (26 + (21.448 - t * (46.815 + t * (0.00059 - t * 0.001813))) / 60) / 60
    e = e0 + 0.00256 * math.cos(math.radians(omega))
    # Declination
    decl = math.degrees(math.asin(math.sin(math.radians(e)) * math.sin(math.radians(app_long))))
    # Equation of time (minutes)
    var_y = math.tan(math.radians(e / 2)) ** 2
    ecc = 0.016708634 - t * (0.000042037 + 0.0000001267 * t)
    l0r = math.radians(l0)
    eot = 4 * math.degrees(
        var_y * math.sin(2 * l0r)
        - 2 * ecc * math.sin(mrad)
        + 4 * ecc * var_y * math.sin(mrad) * math.cos(2 * l0r)
        - 0.5 * var_y**2 * math.sin(4 * l0r)
        - 1.25 * ecc**2 * math.sin(2 * mrad)
    )
    minutes = when.hour * 60 + when.minute + when.second / 60
    tst = (minutes + eot + 4 * lon_deg) % 1440
    ha = tst / 4 - 180 if tst / 4 >= 0 else tst / 4 + 180
    latr, declr, har = map(math.radians, (lat_deg, decl, ha))
    cos_zenith = math.sin(latr) * math.sin(declr) + math.cos(latr) * math.cos(declr) * math.cos(har)
    return math.degrees(math.acos(max(-1.0, min(1.0, cos_zenith))))


def observation_date_correction_factor(
    center_coords: Tuple[float, float], date_of_acquisition: datetime
) -> float:
    """pi d^2 / cos(sza) (``center_coords`` lon / lat, EPSG:4326)."""
    lon, lat = center_coords
    sza = solar_zenith_angle(lat, lon, date_of_acquisition)
    d = earth_sun_distance_correction_factor(date_of_acquisition)
    return math.pi * d**2 / math.cos(math.radians(sza))


def radiance_to_reflectance(
    data: torch.Tensor,
    solar_irradiance: Sequence[float],
    correction_factor: float,
    fill_value: Optional[float] = None,
) -> torch.Tensor:
    """TOA reflectance of (B, H, W) AVIRIS-unit radiance (uW/nm/cm^2/sr):
    radiance * 1e-6 / 1e-4 * (pi d^2 / cos sza) / E_band, with
    ``correction_factor`` from ``observation_date_correction_factor``;
    ``fill_value`` stays where the radiance has it. On ``data``'s device."""
    si = torch.as_tensor(solar_irradiance, dtype=data.dtype, device=data.device)[:, None, None]
    radiances = data * (1e-6 / 1e-4)
    toa = radiances * correction_factor / si
    if fill_value is not None:
        toa = torch.where(data == fill_value, torch.as_tensor(fill_value, dtype=toa.dtype,
                                                              device=toa.device), toa)
    return toa


# -------------------------------------------------------------------- SRF
def gaussian_srf_weights(
    aviris_wavelengths: Sequence[float],
    band_centers_fwhm: Dict[str, Tuple[float, float]],
    bands: Optional[Sequence[str]] = None,
) -> Tuple[np.ndarray, List[str]]:
    """(K_aviris, B_out) normalized SRF weight matrix from Gaussian bands."""
    bands = list(bands or band_centers_fwhm.keys())
    wl = np.asarray(aviris_wavelengths, np.float64)
    cols = []
    for b in bands:
        center, fwhm = band_centers_fwhm[b]
        sigma = fwhm / (2 * math.sqrt(2 * math.log(2)))
        w = np.exp(-((wl - center) ** 2) / (2 * sigma**2))
        w[w < 1e-4 * w.max()] = 0.0
        total = w.sum()
        if total <= 0:
            raise ValueError(f"No AVIRIS coverage for band {b}")
        cols.append(w / total)
    return np.stack(cols, axis=1), bands


def covered_bands(
    aviris_wavelengths: Sequence[float],
    band_centers_fwhm: Dict[str, Tuple[float, float]],
    n_sigma: float = 2.0,
) -> List[str]:
    """Bands whose SRF support lies inside the cube's wavelength range
    (used when a cube covers only part of the spectrum, e.g. SWIR-only)."""
    wl = np.asarray(aviris_wavelengths, np.float64)
    lo, hi = wl.min(), wl.max()
    out = []
    for b, (center, fwhm) in band_centers_fwhm.items():
        sigma = fwhm / (2 * math.sqrt(2 * math.log(2)))
        if center - n_sigma * sigma >= lo and center + n_sigma * sigma <= hi:
            out.append(b)
    return out


def srf_from_table(
    aviris_wavelengths: Sequence[float],
    srf_wavelengths: Sequence[float],
    srf_values: np.ndarray,
    threshold: float = 1e-4,
) -> np.ndarray:
    """(K_aviris, B_out) weights from a measured SRF table.

    Nearest-band resampling and normalisation: each SRF wavelength maps to its nearest AVIRIS band;
    weights below ``threshold`` are dropped; each column normalized to sum 1
    before grouping by AVIRIS band.
    """
    wl = np.asarray(aviris_wavelengths, np.float64)
    srf_wl = np.asarray(srf_wavelengths, np.float64)
    srf_values = np.asarray(srf_values, np.float64)  # (len(srf_wl), B_out)
    nearest = np.argmin(np.abs(srf_wl[:, None] - wl[None, :]), axis=1)
    k, b_out = len(wl), srf_values.shape[1]
    weights = np.zeros((k, b_out))
    for j in range(b_out):
        col = srf_values[:, j].copy()
        col[col <= threshold] = 0.0
        total = col.sum()
        if total <= 0:
            raise ValueError(f"SRF column {j} has no support")
        col = col / total
        np.add.at(weights[:, j], nearest[col > 0], col[col > 0])
    return weights


def gaussian_blur(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of (..., H, W) in f32 (anti-aliasing before a
    resize) with normalised f32 taps of radius max(1, ceil(3 sigma)),
    borders reflect-padded so they keep the kernel's full mass."""
    if sigma <= 0:
        return x
    radius = max(1, int(math.ceil(3 * sigma)))
    grid = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-(grid**2) / (2 * sigma**2))
    k = torch.from_numpy(k / k.sum()).to(x.device)
    batch = x.shape[:-2]
    h, w = x.shape[-2:]
    xr = reflect_pad(x.reshape(-1, 1, h, w).float(), (radius, radius), (radius, radius))
    xr = F.conv2d(xr, k.reshape(1, 1, -1, 1))
    xr = F.conv2d(xr, k.reshape(1, 1, 1, -1))
    return xr.reshape(batch + (h, w))


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """``jax.image.resize(x, size, "bilinear")`` (antialiased) of (B, H, W):
    computed in f64 and returned in ``x``'s dtype."""
    out = F.interpolate(x[None].double(), size=size, mode="bilinear", align_corners=False,
                        antialias=True)
    return out[0].to(x.dtype)


def transform_to_srf(
    aviris_cube,
    weights: np.ndarray,
    scale: float = 1.0,
    sigma_bands: Optional[Sequence[float]] = None,
    fill_value: float = 0.0,
    valid_mask=None,
    device: DeviceLike = None,
) -> torch.Tensor:
    """Simulate a multispectral sensor from an AVIRIS cube.

    Args:
        aviris_cube: (H, W, K) radiance (array or tensor; a floating tensor
            keeps its dtype, as JAX keeps the array's).
        weights: (K, B_out) normalised SRF weight matrix.
        scale: output resolution change factor (> 1 downsamples), a
            per-band anti-aliased resize.
        sigma_bands: per-band anti-aliasing sigmas (default (scale - 1) / 2).
        valid_mask: (H, W) True where the cube is valid; invalid -> fill_value.
        device: where the work runs (None: the CUDA card).

    Returns (B_out, H', W') on the device, in the product's dtype without a
    blur and f32 after one (JAX's blur runs in f32).
    """
    dev = resolve_device(device)
    x = torch.as_tensor(aviris_cube, device=dev)
    if not x.is_floating_point():
        x = x.float()
    h, w, k = x.shape
    wts = torch.as_tensor(np.asarray(weights), dtype=x.dtype, device=dev)
    # (H W, K) @ (K, B), then the band axis first: on the CPU, einsum's own
    # layout of this product sums in another order on one thread than on
    # several; this one gave the same bits (JAX's) on 1-8 threads.
    with float32_precision():
        out = (x.reshape(h * w, k) @ wts).T.reshape(-1, h, w)
    if valid_mask is not None:
        valid = torch.as_tensor(valid_mask, dtype=torch.bool, device=dev)
        out = torch.where(valid[None], out, torch.as_tensor(fill_value, dtype=out.dtype,
                                                            device=dev))
    if scale != 1.0 or sigma_bands is not None:
        new_h, new_w = max(1, round(h / scale)), max(1, round(w / scale))
        with float32_precision():
            bands = [gaussian_blur(out[i], float(sigma_bands[i] if sigma_bands is not None
                                                 else max((scale - 1) / 2, 0)))
                     for i in range(out.shape[0])]
        # An unblurred band (sigma 0) keeps the product's dtype, so the stack
        # promotes as jnp.stack does.
        dtype = functools.reduce(torch.promote_types, [b.dtype for b in bands])
        out = torch.stack([b.to(dtype) for b in bands])
        if (new_h, new_w) != (h, w):
            out = resize_bilinear(out, (new_h, new_w))
    return out


def _resolve_srf_weights(
    aviris_wavelengths: Sequence[float],
    sensor: str,
    bands: List[str],
    gaussian_table: Dict[str, Tuple[float, float]],
    srf_source: str,
    srf_csv: Optional[str],
) -> np.ndarray:
    """The weight matrix of the requested SRF source: 'table' (the shipped
    tables or a measured CSV) or 'gaussian' (centre / FWHM)."""
    if srf_source == "gaussian":
        weights, _ = gaussian_srf_weights(aviris_wavelengths, gaussian_table, bands)
        return weights
    if srf_source != "table":
        raise ValueError(f"srf_source must be 'table' or 'gaussian', got {srf_source!r}")
    from starcop_tpu_torch.data.srf import srf_table_weights

    weights, _ = srf_table_weights(
        aviris_wavelengths, sensor, bands=bands, path_override=srf_csv
    )
    return weights


def transform_to_worldview_3(
    aviris_cube,
    aviris_wavelengths: Sequence[float],
    bands: Optional[Sequence[str]] = None,
    scale: float = 1.0,
    srf_weights: Optional[np.ndarray] = None,
    srf_source: str = "table",
    srf_csv: Optional[str] = None,
    **kwargs,
) -> Tuple[torch.Tensor, List[str]]:
    """AVIRIS -> WorldView-3 SWIR simulation: the shipped tabulated WV3 SRFs
    by default, a measured CSV through ``srf_csv``, or
    ``srf_source="gaussian"``. ``kwargs`` go to ``transform_to_srf``."""
    bands = list(bands or WV3_SWIR_CENTERS_FWHM.keys())
    if srf_weights is None:
        srf_weights = _resolve_srf_weights(
            aviris_wavelengths, "WV3", bands, WV3_SWIR_CENTERS_FWHM, srf_source, srf_csv
        )
    return transform_to_srf(aviris_cube, srf_weights, scale=scale, **kwargs), bands


def transform_to_sentinel_2(
    aviris_cube,
    aviris_wavelengths: Sequence[float],
    bands: Optional[Sequence[str]] = None,
    sensor: str = "S2A",
    resolution_src: float = 8.0,
    resolution_dst: float = 10.0,
    srf_weights: Optional[np.ndarray] = None,
    srf_source: str = "table",
    srf_csv: Optional[str] = None,
    **kwargs,
) -> Tuple[torch.Tensor, List[str]]:
    """AVIRIS -> Sentinel-2 simulation with per-band anti-aliasing sigmas
    from the native band resolutions, (resolution / resolution_src - 1) / 2,
    and the resize resolution_dst / resolution_src. Per-unit tables (S2A and
    S2B differ); ``srf_source`` / ``srf_csv`` as in
    ``transform_to_worldview_3``."""
    bands = list(bands or S2_BAND_CENTERS_FWHM.keys())
    if srf_weights is None:
        srf_weights = _resolve_srf_weights(
            aviris_wavelengths, sensor.upper(), bands, S2_BAND_CENTERS_FWHM,
            srf_source, srf_csv,
        )
    sigma_bands = [
        max((BANDS_S2_RESOLUTION[b] / resolution_src - 1) / 2, 0) for b in bands
    ]
    scale = resolution_dst / resolution_src
    return (
        transform_to_srf(aviris_cube, srf_weights, scale=scale, sigma_bands=sigma_bands, **kwargs),
        bands,
    )
