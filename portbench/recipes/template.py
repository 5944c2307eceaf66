"""The CH4 unit-absorption template for a band set (frozen copy of
``starcop_tpu_torch/ops/ch4_template.py:generate_template_from_bands``).

``ch4_lut.npz`` beside this file is a byte-identical copy of the program's
asset: simulated at-sensor radiance for 7 methane concentrations on a
31,800-point grid, 1399.6-2522 nm, converted from the ENVI LUT of the
BSD-3-Clause mag1c project (github.com/markusfoote/mag1c).
"""

from __future__ import annotations

import os

import numpy as np

LUT_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "ch4_lut.npz")


def band_centers(wavelength_range, spacing_nm: float) -> np.ndarray:
    """Band centres from the range's start at a fixed spacing, inside the range."""
    return np.arange(float(wavelength_range[0]), float(wavelength_range[1]), float(spacing_nm))


def ch4_template(centers, fwhm) -> np.ndarray:
    """(K,) unit absorption spectrum (log-radiance slope against
    concentration, scaled by 1e5) of Gaussian bands at ``centers`` with
    ``fwhm``, float64."""
    centers = np.asarray(centers, np.float64)
    fwhm = np.asarray(fwhm, np.float64)
    with np.load(LUT_PATH) as f:
        wave, rads, conc = f["wavelengths_nm"], f["radiances"], f["concentrations_ppmm"]
    var = (fwhm / (2.0 * np.sqrt(2.0 * np.log(2.0)))) ** 2
    response = np.exp(-((wave[:, None] - centers[None, :]) ** 2) / (2.0 * var))
    response = response / np.sqrt(2.0 * np.pi * var)
    colsum = response.sum(axis=0)
    response = np.divide(response, colsum, out=np.zeros_like(response), where=colsum > 0)
    resampled = rads @ response
    lograd = np.log(resampled, out=np.zeros_like(resampled), where=resampled > 0)
    lsq = np.stack((np.ones_like(conc), conc)).T
    slope = np.linalg.lstsq(lsq, lograd, rcond=None)[0]
    return slope[1] * 1e5


def emit_template(config) -> np.ndarray:
    """The template of a configuration's ``granule`` band window, checked
    against the number of bands it states."""
    g = config["granule"]
    centers = band_centers(g["wavelength_range"], g["band_spacing_nm"])
    if len(centers) != g["bands"]:
        raise ValueError(f"{len(centers)} bands in the window, the configuration states "
                         f"{g['bands']}")
    return ch4_template(centers, np.full_like(centers, g["fwhm_nm"]))
