"""Tabulated spectral response functions for the sensor simulations (a copy
of starcop_tpu/data/srf.py; numpy).

``assets/srf_tables.npz`` (a byte-identical copy of the JAX package's asset,
see ``assets/README.md``) holds 1-nm sampled tables per sensor (S2A, S2B,
WV3), built from the published per-unit band centres / FWHM with
flat-topped super-Gaussian band shapes. A measured table in the CSV schema
(an ``SR_WL`` column and one column per band, all-zero rows dropped) takes
precedence: ``path_override``, or ``srf_{s2a,s2b,wv3}.csv`` dropped next to
the asset. A table is consumed by ``sensors.srf_from_table`` (nearest-band
resample, threshold, normalise), the same for shipped and measured tables.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_ASSET_PATH = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "assets", "srf_tables.npz"
)

# Published per-sensor band centers / FWHM [nm].
# S2A/S2B: ESA Sentinel-2 spectral response release (per-unit values differ
# slightly between the A and B units, e.g. B12 2202.4 vs 2185.7 nm).
S2A_BANDS: Dict[str, Tuple[float, float]] = {
    "B1": (442.7, 21), "B2": (492.4, 66), "B3": (559.8, 36), "B4": (664.6, 31),
    "B5": (704.1, 15), "B6": (740.5, 15), "B7": (782.8, 20), "B8": (832.8, 106),
    "B8A": (864.7, 21), "B9": (945.1, 20), "B10": (1373.5, 31),
    "B11": (1613.7, 91), "B12": (2202.4, 175),
}
S2B_BANDS: Dict[str, Tuple[float, float]] = {
    "B1": (442.2, 21), "B2": (492.1, 66), "B3": (559.0, 36), "B4": (664.9, 31),
    "B5": (703.8, 16), "B6": (739.1, 15), "B7": (779.7, 20), "B8": (832.9, 106),
    "B8A": (864.0, 22), "B9": (943.2, 21), "B10": (1376.9, 30),
    "B11": (1610.4, 94), "B12": (2185.7, 185),
}
# Maxar WorldView-3 SWIR effective bandpasses.
WV3_BANDS: Dict[str, Tuple[float, float]] = {
    "SWIR1": (1209.1, 30), "SWIR2": (1571.6, 40), "SWIR3": (1661.1, 40),
    "SWIR4": (1729.5, 40), "SWIR5": (2163.7, 40), "SWIR6": (2202.2, 40),
    "SWIR7": (2259.3, 50), "SWIR8": (2329.2, 70),
}

# Super-Gaussian order per sensor family: WV3 SWIR interference filters are
# sharper-edged than the broad S2 MSI responses.
_ORDER = {"S2A": 4, "S2B": 4, "WV3": 6}
_BANDS = {"S2A": S2A_BANDS, "S2B": S2B_BANDS, "WV3": WV3_BANDS}

_CACHE: Dict[str, Tuple[np.ndarray, np.ndarray, List[str]]] = {}


def super_gaussian(wl: np.ndarray, center: float, fwhm: float, order: int) -> np.ndarray:
    """Flat-topped band shape with value 0.5 at center +- fwhm/2."""
    return np.exp(-np.log(2.0) * (2.0 * (wl - center) / fwhm) ** (2 * order))


def build_srf_table(sensor: str, step_nm: float = 1.0):
    """1-nm tabulated SRF for a sensor: (wavelengths, values (W, B), bands)."""
    bands = _BANDS[sensor]
    order = _ORDER[sensor]
    names = list(bands)
    lo = min(c - 1.2 * f for c, f in bands.values())
    hi = max(c + 1.2 * f for c, f in bands.values())
    wl = np.arange(np.floor(lo), np.ceil(hi) + step_nm, step_nm)
    values = np.stack(
        [super_gaussian(wl, c, f, order) for c, f in bands.values()], axis=1
    )
    values[values < 1e-6] = 0.0
    keep = values.any(axis=1)  # all-zero rows dropped, as a measured table's
    return wl[keep], values[keep], names


def write_srf_asset(path: str = _ASSET_PATH) -> str:
    """Materialize the shipped SRF tables asset (run by the build, committed)."""
    payload = {}
    for sensor in ("S2A", "S2B", "WV3"):
        wl, values, names = build_srf_table(sensor)
        payload[f"{sensor}_wavelengths"] = wl
        payload[f"{sensor}_values"] = values
        payload[f"{sensor}_bands"] = np.array(names)
    np.savez_compressed(path, **payload)
    return path


def load_srf_csv(path: str) -> Tuple[np.ndarray, np.ndarray, List[str]]:
    """Measured-SRF CSV: an ``SR_WL`` column plus one column per band.
    All-zero rows are dropped."""
    with open(path, newline="") as fh:
        rows = list(csv.DictReader(fh))
    if not rows or "SR_WL" not in rows[0]:
        raise ValueError(f"{path}: expected an SR_WL column (reference SRF schema)")
    names = [c for c in rows[0] if c != "SR_WL"]
    wl = np.array([float(r["SR_WL"]) for r in rows])
    values = np.array([[float(r[c] or 0.0) for c in names] for r in rows])
    keep = (values > 1e-6).any(axis=1)
    return wl[keep], values[keep], names


def get_srf(
    sensor: str, path_override: Optional[str] = None, cache: bool = True
) -> Tuple[np.ndarray, np.ndarray, List[str]]:
    """SRF table for ``sensor`` in ('S2A', 'S2B', 'WV3').

    Resolution order: explicit CSV override > measured CSV dropped next to
    the asset (srf_{s2a,s2b,wv3}.csv) > the shipped tabulated asset >
    rebuilt in-process if the asset file is absent.
    """
    key = sensor.upper()
    if path_override is None and cache and key in _CACHE:
        return _CACHE[key]
    if path_override is not None:
        out = load_srf_csv(path_override)
    else:
        csv_candidate = os.path.join(
            os.path.dirname(_ASSET_PATH), f"srf_{key.lower()}.csv"
        )
        if os.path.exists(csv_candidate):
            out = load_srf_csv(csv_candidate)
        elif os.path.exists(_ASSET_PATH):
            with np.load(_ASSET_PATH, allow_pickle=False) as z:
                out = (
                    z[f"{key}_wavelengths"],
                    z[f"{key}_values"],
                    [str(b) for b in z[f"{key}_bands"]],
                )
        else:
            out = build_srf_table(key)
    if cache and path_override is None:
        _CACHE[key] = out
    return out


def srf_table_weights(
    aviris_wavelengths: Sequence[float],
    sensor: str,
    bands: Optional[Sequence[str]] = None,
    path_override: Optional[str] = None,
) -> Tuple[np.ndarray, List[str]]:
    """(K_aviris, B_out) weight matrix for ``bands`` from the sensor's table."""
    from starcop_tpu_torch.data.sensors import srf_from_table

    wl, values, names = get_srf(sensor, path_override=path_override)
    bands = list(bands or names)
    idx = [names.index(b) for b in bands]
    return srf_from_table(aviris_wavelengths, wl, values[:, idx]), bands
