"""Chip-cache materialisation: full scenes -> training-ready 512 x 512 chips
(counterpart of starcop_tpu/data/chip_cache.py; the same files and index
CSV, byte for byte).

For each index row (a window into a scene): read every product window,
apply the per-acquisition TOA correction to radiance products, clamp mag1c
to [0, 10000], refine the labels with ``data.labels.proposed_mask``,
compute ``weight_mag1c``, pad the windows to the output size, and write one
file per product per tile (the port's ``data/geotiff.py``) plus the index
CSV. Host-side numpy (offline data production); the writes fan out on a
thread pool.
"""

from __future__ import annotations

import concurrent.futures
import csv
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

MAG1C_CLAMP = (0.0, 10000.0)


def pad_to_size(arr: np.ndarray, size: Tuple[int, int], fill: float = 0.0) -> np.ndarray:
    """Pad trailing (H, W) up to ``size`` (top-left anchored)."""
    h, w = arr.shape[-2:]
    th, tw = size
    if h >= th and w >= tw:
        return arr[..., :th, :tw]
    pad = [(0, 0)] * (arr.ndim - 2) + [(0, max(th - h, 0)), (0, max(tw - w, 0))]
    return np.pad(arr, pad, constant_values=fill)[..., :th, :tw]


def cache_chip(
    folder: str,
    products: Dict[str, np.ndarray],
    label_rgba: Optional[np.ndarray] = None,
    output_size: Tuple[int, int] = (512, 512),
    toa_correction_factor: Optional[float] = None,
    toa_products: Sequence[str] = (),
    solar_irradiance: Optional[Dict[str, float]] = None,
    fmt: str = "tif",
    transform=None,
    crs_epsg: Optional[int] = None,
) -> Dict[str, float]:
    """Materialize one chip folder from raw product windows.

    Args:
        folder: output tile folder ({folder}/{product}.{fmt} per product).
        products: product name -> (H, W) array (raw units).
        label_rgba: (4, H, W) human annotation for label refinement; when
            given and 'mag1c' is present, writes 'labelbinary' + 'label_rgba'.
        toa_correction_factor: pi d^2 / cos(sza) for the acquisition; applied
            to ``toa_products`` with their per-band solar irradiance.
        fmt: 'tif' (the reference's per-tile COG layout, BLOCKSIZE 128 —
            sampling_dataset.py:358-394; geo metadata preserved) or 'npy'.
        transform: chip-level affine (already window-offset; see
            ``geo.window_transform``); written into each .tif.
        crs_epsg: CRS EPSG code for the .tif outputs.

    Returns per-tile summary stats (has_plume, qplume, label_pixels).
    """
    os.makedirs(folder, exist_ok=True)
    out: Dict[str, np.ndarray] = {}

    for name, arr in products.items():
        arr = np.asarray(arr, np.float32)
        if name == "mag1c":
            arr = np.clip(arr, *MAG1C_CLAMP)
        if (
            toa_correction_factor is not None
            and name in toa_products
            and solar_irradiance is not None
            and name in solar_irradiance
        ):
            arr = arr * (1e-6 / 1e-4) * toa_correction_factor / solar_irradiance[name]
        out[name] = arr

    summary = {"has_plume": False, "qplume": 0.0, "label_pixels": 0}
    if label_rgba is not None and "mag1c" in out:
        from starcop_tpu_torch.data.labels import proposed_mask

        label = proposed_mask(label_rgba, out["mag1c"][None]).astype(np.float32)
        out["labelbinary"] = label
        out["label_rgba"] = np.asarray(label_rgba, np.float32)
        summary["label_pixels"] = int(label.sum())
        summary["has_plume"] = bool(label.sum() > 0)
        summary["qplume"] = float((out["mag1c"] * label).sum())
    elif "labelbinary" not in out and out:
        # Unlabeled chips (mined negatives) still need a label product so the
        # training dataset can read them: all-background.
        first = next(iter(out.values()))
        out["labelbinary"] = np.zeros(first.shape[-2:], np.float32)
    if "mag1c" in out and "weight_mag1c" not in out:
        from starcop_tpu_torch.ops.ratios import weight_mag1c as _weight_mag1c

        out["weight_mag1c"] = _weight_mag1c(out["mag1c"]).numpy().astype(np.float32)

    from starcop_tpu_torch.data.geotiff import save_raster

    for name, arr in out.items():
        geo_kwargs = {}
        if fmt == "tif":
            geo_kwargs = {
                "transform": transform,
                "crs_epsg": crs_epsg,
                "descriptions": ["r", "g", "b", "a"] if name == "label_rgba" else [name],
            }
        save_raster(
            os.path.join(folder, f"{name}.{fmt}"), pad_to_size(arr, output_size), **geo_kwargs
        )
    return summary


def cache_dataset(
    root: str,
    rows: Sequence[Dict],
    read_products: "callable",
    output_size: Tuple[int, int] = (512, 512),
    num_workers: int = 4,
    index_name: str = "index.csv",
    skip_existing: bool = True,
) -> str:
    """Cache many chips in parallel and write the index CSV.

    Args:
        rows: index rows with at least id + window columns; passed to
            ``read_products(row) -> (products dict, label_rgba or None,
            toa kwargs dict)``.
        read_products: host-side scene reader callback (rasterio/native IO).
        skip_existing: tiles whose folder already holds a ``labelbinary``
            product are not recomputed (idempotent re-runs, the reference's
            skip-if-exists pattern); their index row is rebuilt from disk.

    Returns the index CSV path.
    """
    os.makedirs(root, exist_ok=True)

    from starcop_tpu_torch.data.geotiff import find_raster, load_raster

    def work(row: Dict) -> Dict:
        folder = os.path.join(root, str(row["id"]))
        label_path = find_raster(folder, "labelbinary")
        if skip_existing and label_path is not None:
            label = np.asarray(load_raster(label_path))
            summary = {
                "has_plume": bool(label.sum() > 0),
                "qplume": float(row.get("qplume", 0.0)),
                "label_pixels": int(label.sum()),
            }
        else:
            products, label_rgba, toa_kwargs = read_products(row)
            summary = cache_chip(
                folder, products, label_rgba, output_size=output_size, **(toa_kwargs or {})
            )
        entry = dict(row)
        entry.update(summary)
        entry["folder"] = folder
        # Chips are materialized pre-cropped: index windows are chip-relative
        # from here on (scene-relative offsets would make readers re-crop
        # inside the chip).
        entry["window_col_off"] = 0
        entry["window_row_off"] = 0
        entry["window_width"] = output_size[1]
        entry["window_height"] = output_size[0]
        return entry

    with concurrent.futures.ThreadPoolExecutor(max(num_workers, 1)) as pool:
        entries = list(pool.map(work, rows))

    index_path = os.path.join(root, index_name)
    keys = sorted({k for e in entries for k in e}, key=lambda k: (k != "id", k))
    with open(index_path, "w", newline="") as fh:
        writer = csv.DictWriter(fh, fieldnames=keys)
        writer.writeheader()
        writer.writerows(entries)
    return index_path
