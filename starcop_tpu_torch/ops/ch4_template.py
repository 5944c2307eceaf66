"""CH4 unit-absorption template generation (host numpy, float64).

Counterpart of ``starcop_tpu/ops/ch4_template.py``: convolves the CH4 radiance
look-up table (7 concentrations x 31800 wavelengths, 1399.6-2522 nm) with
per-band Gaussian spectral response functions and fits the log-radiance slope
against concentration, giving the per-band unit absorption spectrum that the
matched filter searches for. It is a one-time set-up computation per band
set, so it stays in numpy. The LUT is this package's own byte-identical copy,
``assets/ch4_lut.npz`` (provenance in ``assets/README.md``).
"""

from __future__ import annotations

import functools
import os
from typing import List, Tuple, Union

import numpy as np

SCALING = 1e5

_ASSET_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets", "ch4_lut.npz"
)


@functools.lru_cache(maxsize=1)
def load_ch4_lut() -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(wavelengths_nm (31800,), radiances (7, 31800), concentrations_ppmm (7,)),
    all float64."""
    with np.load(_ASSET_PATH) as f:
        return (
            f["wavelengths_nm"].copy(),
            f["radiances"].copy(),
            f["concentrations_ppmm"].copy(),
        )


def generate_template_from_bands(
    centers: Union[np.ndarray, List[float]],
    fwhm: Union[np.ndarray, List[float]],
) -> np.ndarray:
    """Methane unit absorption spectrum for a band set.

    Args:
        centers: (K,) band center wavelengths in nanometers.
        fwhm: (K,) full width at half maximum of each band's Gaussian SRF.

    Returns:
        (K, 2): column 0 the band centers, column 1 the unit absorption
        spectrum (log-radiance slope vs concentration, scaled by 1e5).
    """
    centers = np.asarray(centers, dtype=np.float64)
    fwhm = np.asarray(fwhm, dtype=np.float64)
    if np.any(~np.isfinite(centers)) or np.any(~np.isfinite(fwhm)):
        raise ValueError("Band centers/FWHM contain non-finite data (NaN or Inf).")
    if centers.shape[0] != fwhm.shape[0]:
        raise ValueError("centers and fwhm must have equal length.")

    wave, rads, concentrations = load_ch4_lut()

    # Gaussian SRF per band, normalised to unit sum over the LUT grid. A band
    # with no overlap (column sum 0) gets a zero response, not garbage.
    var = (fwhm / (2.0 * np.sqrt(2.0 * np.log(2.0)))) ** 2
    response = np.exp(-((wave[:, None] - centers[None, :]) ** 2) / (2.0 * var))
    response = response / np.sqrt(2.0 * np.pi * var)
    colsum = response.sum(axis=0)
    response = np.divide(response, colsum, out=np.zeros_like(response), where=colsum > 0)

    # Resample the LUT onto the bands, then fit
    # log(radiance) = a + slope * concentration per band by least squares.
    resampled = rads @ response  # (7, K)
    lograd = np.log(resampled, out=np.zeros_like(resampled), where=resampled > 0)
    lsqmat = np.stack((np.ones_like(concentrations), concentrations)).T  # (7, 2)
    slope, _, _, _ = np.linalg.lstsq(lsqmat, lograd, rcond=None)  # (2, K)
    return np.stack((centers, slope[1, :] * SCALING)).T
