"""EMIT sensor support (counterpart of starcop_tpu/data/emit.py): the EMIT ->
AVIRIS renormalisation, the raw granule reader ``EMITRawScene``, the GLT
gather ``glt_gather``, and the EMIT evaluation set (``EMITEvalDataset``,
``EMITDataModule``, ``load_emit_folder_dataset`` over the npy and the
ENVI-pair folder layouts).

The constants are load-bearing for zero-shot transfer of AVIRIS-trained
models: mag1c / 240, clip (0, 2), x 1750 and rgb / 20, clip (0, 2), x 60 map
EMIT products into the AVIRIS normaliser domain.
"""

from __future__ import annotations

import os
import re
from typing import List, Optional, Sequence, Tuple

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


def crop_to_multiple(arrays: Sequence[np.ndarray], multiple: int = 32) -> List[np.ndarray]:
    """Crop the trailing H, W of every array to multiples of ``multiple``
    (the first array's H, W decide)."""
    h, w = arrays[0].shape[-2:]
    h2, w2 = (h // multiple) * multiple, (w // multiple) * multiple
    return [a[..., :h2, :w2] for a in arrays]


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


class EMITEvalDataset:
    """List-of-arrays EMIT evaluation set (no index CSV): each scene cropped
    to x32, renormalised into the AVIRIS domain, label / 255 where it is in
    0-255, has_plume = any(label), unit weight_loss. Items follow the batch
    protocol in numpy (``input`` (4, H, W): mag1c and RGB)."""

    def __init__(
        self,
        mag1c_list: Sequence[np.ndarray],
        rgb_list: Sequence[np.ndarray],
        label_list: Sequence[np.ndarray],
        ids: Optional[Sequence[str]] = None,
        nodata_masks: Optional[Sequence[np.ndarray]] = None,
    ):
        if not len(mag1c_list) == len(rgb_list) == len(label_list):
            raise ValueError("mag1c_list, rgb_list and label_list differ in length")
        self.items = []
        for i in range(len(mag1c_list)):
            m, rgb, label = mag1c_list[i], rgb_list[i], np.asarray(label_list[i], np.float32)
            if label.max() > 1.5:
                label = label / 255.0
            m_c, rgb_c, label_c = crop_to_multiple(
                [np.asarray(m)[None], np.moveaxis(np.asarray(rgb), -1, 0), label[None]])
            m_n, rgb_n = renormalize_emit_to_aviris(torch.from_numpy(np.ascontiguousarray(m_c[0])),
                                                    torch.from_numpy(np.ascontiguousarray(rgb_c)))
            item = {
                "input": np.concatenate([m_n.numpy().astype(np.float32)[None],
                                         rgb_n.numpy().astype(np.float32)]),
                "output": label_c.astype(np.float32),
                "weight_loss": np.ones_like(label_c, np.float32),
                "has_plume": float(label_c.sum() > 0),
                "id": (ids[i] if ids else f"emit_{i}"),
            }
            if nodata_masks is not None:
                item["nodata_mask"] = crop_to_multiple([np.asarray(nodata_masks[i])[None]])[0]
            self.items.append(item)

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx):
        return self.items[idx]


class EMITDataModule:
    """Evaluation-only data module over the EMIT folder layout (scenes under
    ``plume_events/`` and ``confounders/``): a test loader at batch size 1
    by default."""

    def __init__(self, root: str, batch_size: int = 1):
        self.root = root
        self.batch_size = batch_size
        self._dataset: Optional[EMITEvalDataset] = None

    def setup(self) -> "EMITDataModule":
        if self._dataset is None:
            self._dataset = load_emit_folder_dataset(self.root)
        return self

    @property
    def dataset(self) -> EMITEvalDataset:
        self.setup()
        return self._dataset

    def test_loader(self):
        from starcop_tpu_torch.data.datamodule import BatchLoader

        return BatchLoader(self.dataset, batch_size=self.batch_size)


def load_emit_folder_dataset(root: str) -> EMITEvalDataset:
    """Scan ``plume_events/`` and ``confounders/`` for per-scene products:
    the npy layout (mag1c.npy, rgb.npy, label.npy) or the ENVI-pair layout
    (``*_magic`` and ``*_RGB`` raw files with .hdr headers, a label in
    label[_released].npy or label[_released].tif). Scenes in neither layout
    are skipped; a scene without a label gets zeros."""
    mags, rgbs, labels, ids = [], [], [], []
    for sub in ("plume_events", "confounders"):
        folder = os.path.join(root, sub)
        if not os.path.isdir(folder):
            continue
        for name in sorted(os.listdir(folder)):
            scene_dir = os.path.join(folder, name)
            if not os.path.isdir(scene_dir):
                continue
            loaded = _load_scene_products(scene_dir)
            if loaded is None:
                continue
            mag, rgb, label = loaded
            mags.append(mag)
            rgbs.append(rgb)
            labels.append(label if label is not None else np.zeros(mag.shape, np.float32))
            ids.append(f"{sub}/{name}")
    return EMITEvalDataset(mags, rgbs, labels, ids)


def _load_scene_products(scene_dir: str):
    """One scene's (mag1c, rgb (H, W, 3), label or None) from npy files or
    ENVI pairs; None when the folder holds neither."""
    mag_p = os.path.join(scene_dir, "mag1c.npy")
    rgb_p = os.path.join(scene_dir, "rgb.npy")
    if os.path.exists(mag_p) and os.path.exists(rgb_p):
        label_p = os.path.join(scene_dir, "label.npy")
        label = np.load(label_p) if os.path.exists(label_p) else None
        return np.load(mag_p), np.load(rgb_p), label

    names = os.listdir(scene_dir)
    magic = [n for n in names if n.endswith("_magic")]
    rgb = [n for n in names if n.endswith("_RGB")]
    if not (magic and rgb):
        return None
    from starcop_tpu_torch.data.ingest import ENVIReader

    mag = ENVIReader(os.path.join(scene_dir, magic[0])).read_all()[..., 0]
    rgb_arr = ENVIReader(os.path.join(scene_dir, rgb[0])).read_all()
    label = None
    for cand in ("label.npy", "label_released.npy"):
        p = os.path.join(scene_dir, cand)
        if os.path.exists(p):
            label = np.load(p)
            break
    if label is None:
        for cand in ("label.tif", "label_released.tif"):
            p = os.path.join(scene_dir, cand)
            if os.path.exists(p):
                from starcop_tpu_torch.data.geotiff import read_geotiff

                label = read_geotiff(p, band=0)[0]
                break
    return mag, rgb_arr, label
