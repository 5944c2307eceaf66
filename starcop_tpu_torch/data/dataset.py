"""Chip dataset: windowed per-product reads from the chip-folder layout (a
copy of starcop_tpu/data/dataset.py: numpy, the same seed gives the same
samples).

Each index row points at a tile folder holding one file per product; a
sample stacks the requested input/output/weight products into (C, H, W)
float arrays, optionally random-crops to the training window, and applies
joint geometric augmentation. Products are ``.npy`` files or GeoTIFFs read
by the port's own codec (``starcop_tpu_torch.data.geotiff``), with the same
window semantics.

The reader is host-side numpy: chips feed ``datamodule.prefetch_to_device``,
and all math after batching runs on the device.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def read_index_csv(path: str) -> List[Dict]:
    with open(path, newline="") as fh:
        rows = list(csv.DictReader(fh))
    for r in rows:
        for k in ("window_col_off", "window_row_off", "window_width", "window_height"):
            if k in r and r[k] != "":
                r[k] = int(float(r[k]))
        if "has_plume" in r:
            r["has_plume"] = str(r["has_plume"]).lower() in ("true", "1", "yes")
        if "qplume" in r and r["qplume"] != "":
            r["qplume"] = float(r["qplume"])
    return rows


def _read_product(folder: str, product: str, window: Optional[Tuple[int, int, int, int]]) -> np.ndarray:
    """Read one product raster, optionally windowed (col_off, row_off, w, h)."""
    from starcop_tpu_torch.data.geotiff import find_raster, load_raster

    path = find_raster(folder, product)
    if path is None:
        raise FileNotFoundError(f"No {product}.tif/.npy in {folder}")
    return np.asarray(load_raster(path, window=window), np.float32)


class ChipDataset:
    """Index-row-driven chip dataset with the reference batch protocol.

    Returns dict samples: input (C, H, W), output (1, H, W), weight_loss
    (1, H, W) if configured, id, has_plume. RGB-AVIRIS convenience (/50 like
    the reference dataset.py:91) applies when ``add_rgb_aviris``.
    """

    RGB_AVIRIS = ("TOA_AVIRIS_640nm", "TOA_AVIRIS_550nm", "TOA_AVIRIS_460nm")

    def __init__(
        self,
        rows: Sequence[Dict],
        input_products: Sequence[str],
        output_products: Sequence[str] = ("labelbinary",),
        weight_loss_product: Optional[str] = "weight_mag1c",
        window_size_sample: Optional[Tuple[int, int]] = None,
        augment: bool = False,
        augment_rotation: str = "continuous",
        extra_products: Sequence[str] = (),
        add_rgb_aviris: bool = False,
        seed: int = 0,
    ):
        self.rows = list(rows)
        self.input_products = list(input_products)
        self.output_products = list(output_products)
        self.weight_loss_product = weight_loss_product
        self.window_size_sample = window_size_sample
        self.augment = augment
        self.augment_rotation = augment_rotation
        self.extra_products = list(extra_products)
        self.add_rgb_aviris = add_rgb_aviris
        # BatchLoader reads samples from a thread pool; numpy Generators are
        # not thread-safe, so each thread gets its own child generator.
        self._seed_seq = np.random.SeedSequence(seed)
        self._local = None

    @property
    def _rng(self) -> np.random.Generator:
        import threading

        if self._local is None:
            self._local = threading.local()
        if not hasattr(self._local, "rng"):
            self._local.rng = np.random.default_rng(self._seed_seq.spawn(1)[0])
        return self._local.rng

    def add_extra_products(self, products: Sequence[str]):
        for p in products:
            if p not in self.extra_products:
                self.extra_products.append(p)

    def __len__(self) -> int:
        return len(self.rows)

    def _window(self, row: Dict) -> Optional[Tuple[int, int, int, int]]:
        if "window_col_off" in row:
            return (
                row["window_col_off"],
                row["window_row_off"],
                row["window_width"],
                row["window_height"],
            )
        return None

    def __getitem__(self, idx: int) -> Dict:
        row = self.rows[idx]
        folder = row["folder"]
        window = self._window(row)

        def stack(products: Sequence[str]) -> np.ndarray:
            return np.stack([_read_product(folder, p, window) for p in products])

        x = stack(self.input_products)
        y = stack(self.output_products)
        sample: Dict = {"id": row.get("id", str(idx)), "has_plume": float(row.get("has_plume", y.sum() > 0))}
        arrays = {"input": x, "output": y}
        if self.weight_loss_product:
            arrays["weight_loss"] = stack([self.weight_loss_product])
        for p in self.extra_products:
            arrays[p] = stack([p])
        if self.add_rgb_aviris:
            arrays["rgb_aviris"] = stack(list(self.RGB_AVIRIS)) / 50.0

        if self.window_size_sample is not None:
            th, tw = self.window_size_sample
            _, h, w = arrays["input"].shape
            if h > th or w > tw:
                r0 = int(self._rng.integers(0, h - th + 1))
                c0 = int(self._rng.integers(0, w - tw + 1))
                arrays = {k: v[:, r0 : r0 + th, c0 : c0 + tw] for k, v in arrays.items()}

        if self.augment:
            arrays = joint_augment(arrays, self._rng, rotation=self.augment_rotation)

        sample.update(arrays)
        return sample


def rotate_chw(arr: np.ndarray, angle_deg: float, order: int = 1) -> np.ndarray:
    """Rotate a (C, H, W) array by ``angle_deg`` about the image center.

    Matches the cv2/kornia convention the reference's augmentation uses
    (``K.RandomRotation`` -> ``warp_affine`` with a ``getRotationMatrix2D``
    matrix): positive angle is a counter-clockwise visual rotation, center at
    ((W-1)/2, (H-1)/2), same output size, zeros outside the source. ``order``
    1 is bilinear (image/weight keys), 0 nearest (mask keys). Pinned against
    ``cv2.warpAffine`` in tests.
    """
    _, h, w = arr.shape
    t = np.deg2rad(angle_deg)
    ct, st = float(np.cos(t)), float(np.sin(t))
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    dy, dx = np.mgrid[0:h, 0:w]
    # Inverse map (output pixel -> source coords): rotate by -angle about the
    # center, in y-down image coordinates.
    xs = ct * (dx - cx) - st * (dy - cy) + cx
    ys = st * (dx - cx) + ct * (dy - cy) + cy
    if order == 0:
        xi = np.rint(xs).astype(np.intp)
        yi = np.rint(ys).astype(np.intp)
        valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        res = arr[:, np.clip(yi, 0, h - 1), np.clip(xi, 0, w - 1)].copy()
        res[:, ~valid] = 0
        return res
    x0 = np.floor(xs).astype(np.intp)
    y0 = np.floor(ys).astype(np.intp)
    fx = (xs - x0).astype(np.float32)
    fy = (ys - y0).astype(np.float32)

    def tap(yy, xx):
        # Out-of-range taps contribute 0 (cv2 BORDER_CONSTANT, value 0).
        valid = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
        return arr[:, np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)] * valid

    res = (
        tap(y0, x0) * ((1 - fx) * (1 - fy))
        + tap(y0, x0 + 1) * (fx * (1 - fy))
        + tap(y0 + 1, x0) * ((1 - fx) * fy)
        + tap(y0 + 1, x0 + 1) * (fx * fy)
    )
    return res.astype(arr.dtype)


#: Sample keys resampled with nearest-neighbor under continuous rotation: the
#: reference declares the segmentation label a kornia "mask" data key
#: (datamodule.py:133 ``data_keys=["input", model_output_type]``), which
#: kornia warps with nearest; inputs and loss weights are "input" keys
#: (bilinear).
MASK_KEYS = ("output",)


def joint_augment(
    arrays: Dict[str, np.ndarray],
    rng: np.random.Generator,
    rotation: str = "continuous",
) -> Dict[str, np.ndarray]:
    """Joint geometric augmentation of all (C, H, W) arrays in the sample.

    Reference recipe (datamodule.py:128-134): ``K.RandomRotation(p=0.5,
    degrees=90)`` — a CONTINUOUS angle uniform in [-90, +90] with bilinear
    resampling for image keys and nearest for the mask — then horizontal flip
    p=0.5 and vertical flip p=0.5, the same draw applied to every key.

    ``rotation`` selects the rotation family: ``"continuous"`` (the reference
    recipe, default), ``"rot90"`` (lossless right-angle rot90 — cheaper, no
    resampling blur, but a narrower augmentation distribution), ``"none"``.
    """
    out = dict(arrays)
    if rotation == "continuous":
        if rng.uniform() < 0.5:
            angle = float(rng.uniform(-90.0, 90.0))
            out = {
                key: rotate_chw(v, angle, order=0 if key in MASK_KEYS else 1)
                for key, v in out.items()
            }
    elif rotation == "rot90":
        if rng.uniform() < 0.5:
            k = int(rng.integers(1, 4))
            out = {key: np.rot90(v, k, axes=(-2, -1)) for key, v in out.items()}
    elif rotation != "none":
        raise ValueError(f"unknown rotation mode {rotation!r}")
    if rng.uniform() < 0.5:
        out = {key: v[..., ::-1] for key, v in out.items()}
    if rng.uniform() < 0.5:
        out = {key: v[..., ::-1, :] for key, v in out.items()}
    return {key: np.ascontiguousarray(v) for key, v in out.items()}
