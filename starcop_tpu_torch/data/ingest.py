"""Raw-scene ingestion: AVIRIS flight-line download, ENVI readers, column
windows, PNG masks and per-band GeoTIFFs (counterpart of
starcop_tpu/data/ingest.py; host numpy).

``ENVIReader`` reads BIP and BSQ cubes through the port's native threaded
reader (``data/native_io.read_window``, ``LAYOUT_BIP`` / ``LAYOUT_BSQ``).
The downloads need network access: a failed fetch raises ``RuntimeError``.
"""

from __future__ import annotations

import os
import re
import tarfile
from typing import Dict, List, Optional, Tuple

import numpy as np

from starcop_tpu_torch.data import native_io

AVIRIS_FTP_INDEX_COLUMNS = ("Name", "link_ftp")
_ENVI_DTYPE = {1: np.uint8, 2: np.int16, 3: np.int32, 4: np.float32, 5: np.float64,
               12: np.uint16, 13: np.uint32}


def parse_envi_header(path: str) -> Dict:
    """Minimal ENVI .hdr parser: samples/lines/bands/data type/interleave/
    byte order/header offset/wavelength/fwhm."""
    text = open(path, "r", errors="ignore").read()

    def scalar(key, cast=int, default=None):
        m = re.search(rf"^{key}\s*=\s*([^\n{{]+)", text, re.M | re.I)
        return cast(m.group(1).strip()) if m else default

    def vector(key):
        m = re.search(rf"{key}\s*=\s*\{{(.*?)\}}", text, re.S | re.I)
        if not m:
            return None
        return np.array([float(t) for t in m.group(1).replace("\n", " ").split(",") if t.strip()])

    return {
        "samples": scalar("samples"),
        "lines": scalar("lines"),
        "bands": scalar("bands"),
        "dtype": _ENVI_DTYPE[scalar("data type")],
        "interleave": scalar("interleave", cast=lambda s: s.strip().lower(), default="bip"),
        "byte_order": scalar("byte order", default=0),
        "header_offset": scalar("header offset", default=0),
        "wavelengths": vector("wavelength"),
        "fwhm": vector("fwhm"),
    }


class ENVIReader:
    """Windowed reader over an ENVI cube (BIP or BSQ) via native threaded IO.

    Replaces the reference's spectral/np.memmap access (process_aviris.py:184)
    at the ingest boundary; exposes (H, W, C) windows regardless of the
    on-disk interleave.
    """

    def __init__(self, img_path: str, hdr_path: Optional[str] = None):
        hdr_path = hdr_path or _matching_header(img_path)
        self.meta = parse_envi_header(hdr_path)
        if self.meta["byte_order"] not in (0, None):
            raise NotImplementedError("big-endian ENVI not supported")
        self.path = img_path
        self.shape = (self.meta["lines"], self.meta["samples"], self.meta["bands"])
        self.wavelengths = self.meta["wavelengths"]
        self.fwhm = self.meta["fwhm"]

    def read_window(self, row_off: int, col_off: int, h: int, w: int) -> np.ndarray:
        lines, samples, bands = self.shape
        meta = self.meta
        if meta["interleave"] == "bip":
            out = native_io.read_window(
                self.path, (lines, samples, bands), meta["dtype"],
                (row_off, col_off, h, w), native_io.LAYOUT_BIP, meta["header_offset"],
            )
            return out
        if meta["interleave"] == "bsq":
            out = native_io.read_window(
                self.path, (bands, lines, samples), meta["dtype"],
                (row_off, col_off, h, w), native_io.LAYOUT_BSQ, meta["header_offset"],
            )
            return np.moveaxis(out, 0, -1)
        raise NotImplementedError(f"interleave {meta['interleave']}")

    def read_all(self) -> np.ndarray:
        return self.read_window(0, 0, self.shape[0], self.shape[1])


def _matching_header(img_path: str) -> str:
    for cand in (img_path + ".hdr", os.path.splitext(img_path)[0] + ".hdr"):
        if os.path.exists(cand):
            return cand
    raise FileNotFoundError(f"No ENVI header for {img_path}")


def column_windows(width: int, height: int, columns_read: int = 50) -> List[Tuple[int, int, int, int]]:
    """Column-stripe windows (reference read_aviris(..., return_windows=True),
    aviris.py:389-393): (row_off, col_off, h, w) stripes of columns_read."""
    return [
        (0, c, height, min(columns_read, width - c)) for c in range(0, width, columns_read)
    ]


def download_product(link: str, dest_dir: str, timeout: int = 3600) -> str:
    """Atomic download (tmp + rename; reference starcop/utils.py:29-56) —
    requires network access (gated)."""
    import urllib.request

    os.makedirs(dest_dir, exist_ok=True)
    name = link.rstrip("/").split("/")[-1]
    dest = os.path.join(dest_dir, name)
    if os.path.exists(dest):
        return dest
    tmp = dest + ".tmp"
    try:
        urllib.request.urlretrieve(link, tmp)
    except OSError as e:
        raise RuntimeError(
            f"Download failed (network may be unavailable in this environment): {e}"
        ) from e
    os.replace(tmp, dest)
    return dest


def download_aviris(name: str, index_csv: str, dest_dir: str) -> str:
    """Resolve an AVIRIS flight-line name to its FTP link via the index CSV,
    download the tar.gz, and extract it (reference process_aviris.py:244-312)."""
    import csv

    link = None
    with open(index_csv, newline="") as fh:
        for row in csv.DictReader(fh):
            if row.get("Name", "").strip() == name:
                link = row.get("link_ftp", "").strip()
                break
    if not link:
        raise KeyError(f"Flight line {name} not found in {index_csv}")
    tar_path = download_product(link, dest_dir)
    out_dir = os.path.join(dest_dir, name)
    if not os.path.isdir(out_dir):
        with tarfile.open(tar_path) as tf:
            tf.extractall(dest_dir, filter="data")
    return out_dir


def png_mask_to_binary(png_path: str, threshold: int = 0) -> np.ndarray:
    """PNG annotation mask -> (H, W) binary array.

    Reference 4-Corners ingestion converts PNG masks to COGs
    (process_data_jpl_4corners.py:19-136); here the mask becomes the binary
    label array directly (any channel > threshold counts as annotated; RGBA
    alpha is used when present).
    """
    from PIL import Image

    img = np.asarray(Image.open(png_path))
    if img.ndim == 3 and img.shape[-1] == 4:
        values = img[..., 3]
    elif img.ndim == 3:
        values = img.max(axis=-1)
    else:
        values = img
    return (values > threshold).astype(np.float32)


def save_scene_bands(cube: np.ndarray, wavelengths: np.ndarray, fwhm: np.ndarray,
                     out_dir: str, transform=None, crs_epsg: Optional[int] = None,
                     skip_existing: bool = True) -> str:
    """Per-band COG materialization + metadata.json (reference save_aviris_cog,
    process_aviris.py:93-133): one tiled GeoTIFF per band ({i}.tif) carrying
    the geotransform/CRS and a wavelength description, via the framework's own
    GeoTIFF codec (no GDAL)."""
    import json

    from starcop_tpu_torch.data.geotiff import write_geotiff

    os.makedirs(out_dir, exist_ok=True)
    for i in range(cube.shape[-1]):
        path = os.path.join(out_dir, f"{i}.tif")
        if skip_existing and os.path.exists(path):
            continue  # idempotent re-runs (reference process_aviris.py:118-120)
        write_geotiff(
            path,
            cube[..., i].astype(np.float32),
            transform=transform,
            crs_epsg=crs_epsg,
            tags={"wavelength": f"{float(wavelengths[i]):.2f}",
                  "fwhm": f"{float(fwhm[i]):.2f}"},
            descriptions=[f"{float(wavelengths[i]):.2f} nm"],
        )
    meta = {"wavelengths": list(map(float, wavelengths)), "bandwidths": list(map(float, fwhm))}
    path = os.path.join(out_dir, "metadata.json")
    with open(path, "w") as fh:
        json.dump(meta, fh)
    return path
