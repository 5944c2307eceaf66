"""EMIT sensor support (counterpart of starcop_tpu/data/emit.py): the EMIT ->
AVIRIS renormalisation, the raw granule reader ``EMITRawScene`` and the GLT
gather ``glt_gather``.

The constants are load-bearing for zero-shot transfer of AVIRIS-trained
models: mag1c / 240, clip (0, 2), x 1750 and rgb / 20, clip (0, 2), x 60 map
EMIT products into the AVIRIS normaliser domain.
"""

from __future__ import annotations

import re
from typing import List, Optional, Tuple

import numpy as np
import torch

MAGIC_DIV_BY = 240.0
RGB_DIV_BY = 20.0
MAGIC_MULT_BY = 1750.0
RGB_MULT_BY = 60.0
EMIT_RGB_WAVELENGTHS = (640.0, 550.0, 460.0)
DEFAULT_WAVELENGTH_RANGE = (2122.0, 2488.0)


def renormalize_emit_to_aviris(
    mag1c: torch.Tensor, rgb: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Map EMIT-domain mag1c (H, W) and RGB (3, H, W) into the AVIRIS domain."""
    m = torch.clamp(mag1c / MAGIC_DIV_BY, 0, 2) * MAGIC_MULT_BY
    r = torch.clamp(rgb / RGB_DIV_BY, 0, 2) * RGB_MULT_BY
    return m, r


def glt_gather(glt_x: np.ndarray, glt_y: np.ndarray, raster: np.ndarray, fill: float) -> np.ndarray:
    """Orthorectification gather: 1-based GLT indices (0 = nodata) -> grid."""
    valid = (glt_x > 0) & (glt_y > 0)
    out = np.full(glt_x.shape, fill, dtype=raster.dtype)
    yy = np.clip(glt_y - 1, 0, raster.shape[0] - 1)
    xx = np.clip(glt_x - 1, 0, raster.shape[1] - 1)
    out[valid] = raster[yy[valid], xx[valid]]
    return out


class EMITRawScene:
    """Raw EMIT L1B radiance granule reader (h5py over the .nc container;
    the port's copy of starcop_tpu/data/emit.py:EMITRawScene).

    Exposes the fields the matched-filter pipeline needs: radiance (rows,
    cols, bands), wavelengths/fwhm (bands,), the fill-value mask, and the GLT
    lookup arrays for georeferencing (orthorectification is a gather, see
    ``georeference``). ``h5py`` is imported when a granule is opened, so the
    module imports without it.
    """

    def __init__(self, path: str):
        import h5py

        self._f = h5py.File(path, "r")
        self.radiance = self._f["radiance"]  # lazy (rows, cols, bands)
        sensor_band = self._f["sensor_band_parameters"]
        self.wavelengths = np.asarray(sensor_band["wavelengths"][:], np.float64)
        self.fwhm = np.asarray(sensor_band["fwhm"][:], np.float64)
        self.fill_value = float(self.radiance.attrs.get("_FillValue", [-9999.0])[0])
        loc = self._f.get("location")
        self.glt_x = np.asarray(loc["glt_x"][:]) if loc is not None and "glt_x" in loc else None
        self.glt_y = np.asarray(loc["glt_y"][:]) if loc is not None and "glt_y" in loc else None
        self.transform, self.crs_epsg = _parse_geo_attrs(self._f)
        self._full: Optional[np.ndarray] = None
        self._full_bands: Optional[np.ndarray] = None

    def _rgb_band_indices(self) -> List[int]:
        return [int(np.argmin(np.abs(self.wavelengths - w))) for w in EMIT_RGB_WAVELENGTHS]

    def _cube_bands(self, idx: np.ndarray) -> Optional[np.ndarray]:
        """Band-capped cache for chunked datasets: (rows, cols, len(idx)).

        Real EMIT granules are chunked with every band in each chunk and
        zlib-compressed, so any band-subset read decompresses the whole file.
        The first read decompresses once and caches only the bands the
        pipeline consumes: the requested ones, the RGB picks and the default
        matched-filter window. A later read outside the cached set pays one
        more full read and re-caps to the union. Contiguous datasets read
        hyperslabs cheaply, so no cache is kept (returns None)."""
        if self.radiance.chunks is None:
            return None
        idx = np.asarray(idx, np.int64)
        if self._full is None or not np.isin(idx, self._full_bands).all():
            keep = [idx, np.asarray(self._rgb_band_indices(), np.int64)]
            default_sel = (self.wavelengths >= DEFAULT_WAVELENGTH_RANGE[0]) & (
                self.wavelengths <= DEFAULT_WAVELENGTH_RANGE[1]
            )
            keep.append(np.where(default_sel)[0])
            if self._full_bands is not None:
                keep.append(self._full_bands)
            bands = np.unique(np.concatenate(keep))
            data = np.asarray(self.radiance[...], np.float32)  # the one full read
            self._full = np.ascontiguousarray(data[:, :, bands])
            self._full_bands = bands
            del data
        pos = np.searchsorted(self._full_bands, idx)
        return self._full[:, :, pos]

    def band_slice(self, wavelength_range: Tuple[float, float] = DEFAULT_WAVELENGTH_RANGE):
        sel = (self.wavelengths >= wavelength_range[0]) & (self.wavelengths <= wavelength_range[1])
        if not sel.any():
            raise ValueError("No bands in the selected wavelength range")
        return sel

    def read_bands(self, selection: np.ndarray) -> np.ndarray:
        selection = np.asarray(selection)
        idx = np.where(selection)[0] if selection.dtype == bool else selection
        cached = self._cube_bands(idx)
        if cached is not None:
            return np.ascontiguousarray(cached)
        return np.asarray(self.radiance[:, :, selection], np.float32)

    def read_rgb(self) -> np.ndarray:
        """(rows, cols, 3) at the nearest bands to 640/550/460 nm."""
        idx = self._rgb_band_indices()
        cached = self._cube_bands(np.asarray(idx, np.int64))
        if cached is not None:
            return np.ascontiguousarray(cached)
        return np.stack([np.asarray(self.radiance[:, :, i], np.float32) for i in idx], axis=-1)

    def invalid_mask(self, data: np.ndarray) -> np.ndarray:
        return np.any(data == self.fill_value, axis=-1)

    def georeference(self, raster: np.ndarray, fill_value: Optional[float] = None) -> np.ndarray:
        """Orthorectify via the GLT (1-based indices; 0 = nodata): a gather."""
        if self.glt_x is None:
            raise ValueError("Granule has no GLT arrays")
        fill = self.fill_value if fill_value is None else fill_value
        return glt_gather(self.glt_x, self.glt_y, raster, fill)

    def close(self):
        self._full = None
        self._full_bands = None
        self._f.close()


def _parse_geo_attrs(f) -> Tuple[Optional[Tuple[float, ...]], Optional[int]]:
    """EMIT granule geo attributes -> (Affine, EPSG).

    EMIT L1B granules carry a GDAL-order ``geotransform`` (xoff, a, b, yoff,
    d, e) and a ``spatial_ref`` WKT as root (or location-group) attributes.
    The GLT-mapped (ortho) outputs live on this grid."""
    attrs = dict(f.attrs)
    loc = f.get("location")
    if loc is not None:
        for k, v in loc.attrs.items():
            attrs.setdefault(k, v)
    transform = None
    gt = attrs.get("geotransform")
    if gt is not None and len(np.atleast_1d(gt)) == 6:
        xoff, a, b, yoff, d, e = [float(v) for v in np.atleast_1d(gt)]
        transform = (a, b, xoff, d, e, yoff)
    epsg = None
    wkt = attrs.get("spatial_ref", attrs.get("crs", None))
    if wkt is not None:
        if isinstance(wkt, bytes):
            wkt = wkt.decode("utf-8", "replace")
        m = re.findall(r'AUTHORITY\["EPSG",\s*"?(\d+)"?\]', str(wkt))
        if m:
            epsg = int(m[-1])  # the last AUTHORITY entry is the CRS itself
        elif "EPSG:" in str(wkt):
            epsg = int(str(wkt).rsplit("EPSG:", 1)[1].split()[0])
    return transform, epsg
