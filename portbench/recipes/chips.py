"""A seeded AVIRIS-NG chip dataset on disk, in the chip cache's layout.

``data/chip_cache.py`` of the program writes one GeoTIFF per product per
512 x 512 tile in ``{root}/{tile}/{product}.tif`` and an index CSV with the
tile's folder, window and plume statistics. This writer makes the same
layout without the program: the chips are drawn on the device from the seed
in a few batched calls (``synthetic_chip_batch``'s recipe of
``starcop_tpu_torch/data/synthetic.py``, frozen: mag1c as plume
concentration plus noise, clipped to [0, 10000], no filter run; RGB from a
smooth albedo field), and each product is written as an uncompressed,
128 x 128-tiled, single-band float32 TIFF, synced to disk in set-up.
"""

from __future__ import annotations

import csv
import math
import os
import struct
from typing import Dict, List

import numpy as np
import torch

PRODUCTS = ("mag1c", "TOA_AVIRIS_640nm", "TOA_AVIRIS_550nm", "TOA_AVIRIS_460nm",
            "labelbinary", "weight_mag1c")
_SHORT, _LONG = 3, 4


def write_tiff(path: str, arr: np.ndarray, tile: int = 128) -> None:
    """An uncompressed, tiled, single-band float32 little-endian TIFF."""
    arr = np.ascontiguousarray(arr, dtype="<f4")
    h, w = arr.shape
    th, tw = -(-h // tile), -(-w // tile)
    padded = np.zeros((th * tile, tw * tile), "<f4")
    padded[:h, :w] = arr
    tiles = [padded[r * tile:(r + 1) * tile, c * tile:(c + 1) * tile].tobytes()
             for r in range(th) for c in range(tw)]
    n = len(tiles)
    entries = [(256, _LONG, 1, w), (257, _LONG, 1, h), (258, _SHORT, 1, 32),
               (259, _SHORT, 1, 1), (262, _SHORT, 1, 1), (277, _SHORT, 1, 1),
               (284, _SHORT, 1, 1), (322, _LONG, 1, tile), (323, _LONG, 1, tile),
               (324, _LONG, n, None), (325, _LONG, n, None), (339, _SHORT, 1, 3)]
    ifd_len = 2 + 12 * len(entries) + 4
    arrays_at = 8 + ifd_len
    data_at = arrays_at + (8 * n if n > 1 else 0)
    offsets = [data_at + i * len(tiles[0]) for i in range(n)]
    out = [b"II", struct.pack("<HI", 42, 8), struct.pack("<H", len(entries))]
    for tag, typ, count, value in entries:
        if tag == 324:
            value = arrays_at if n > 1 else offsets[0]
        elif tag == 325:
            value = arrays_at + 4 * n if n > 1 else len(tiles[0])
        packed = struct.pack("<HI", value, 0)[:4] if typ == _SHORT else struct.pack("<I", value)
        out.append(struct.pack("<HHI", tag, typ, count) + packed)
    out.append(struct.pack("<I", 0))
    if n > 1:
        out.append(struct.pack(f"<{n}I", *offsets))
        out.append(struct.pack(f"<{n}I", *[len(t) for t in tiles]))
    with open(path, "wb") as fh:
        fh.write(b"".join(out))
        for t in tiles:
            fh.write(t)
        # On disk before the window opens: the kernel's write-back of dirty
        # pages would otherwise run during it (some 30 s after the write).
        fh.flush()
        os.fsync(fh.fileno())


def make_chips(seed: int, p: Dict, device) -> Dict[str, torch.Tensor]:
    """(N, H, W) float32 products of ``p["chips"]`` chips of ``p["chip_size"]``
    on ``device``: 0 to ``max_plumes`` Gaussian plumes a chip."""
    n, size = int(p["chips"]), int(p["chip_size"])
    gen = torch.Generator(device=device).manual_seed((int(seed) * 104729 + 17) % (2**63))
    f64 = dict(device=device, dtype=torch.float64)
    yy = torch.arange(size, **f64)[None, :, None]
    xx = torch.arange(size, **f64)[None, None, :]
    k = int(p["max_plumes"])
    u = torch.rand((n, k, 7), generator=gen, **f64)
    present = (torch.arange(k, device=device)[None, :] < torch.floor(
        u[..., 6] * (k + 1))).to(torch.float64)
    cy, cx = ((0.15 + 0.7 * u[..., 0]) * size)[..., None, None], ((0.15 + 0.7 * u[..., 1]) * size)[..., None, None]
    sy, sx = (8 + 20 * u[..., 2])[..., None, None], (16 + 44 * u[..., 3])[..., None, None]
    ang = (math.pi * u[..., 4])[..., None, None]
    dy, dx = yy[:, None] - cy, xx[:, None] - cx
    ry = dy * torch.cos(ang) + dx * torch.sin(ang)
    rx = -dy * torch.sin(ang) + dx * torch.cos(ang)
    amp = ((0.3 + 0.7 * u[..., 5]) * float(p["max_concentration"]) * present)[..., None, None]
    conc = (amp * torch.exp(-(ry**2 / (2 * sy**2) + rx**2 / (2 * sx**2)))).sum(1)

    coarse = torch.rand((n, size // 16 + 2, size // 16 + 2), generator=gen, **f64) * 1.5 + 0.5
    albedo = torch.nn.functional.interpolate(coarse[:, None], size=(size, size), mode="bilinear",
                                             align_corners=False)[:, 0]
    mag1c = torch.clamp(conc + torch.randn(conc.shape, generator=gen, **f64) * float(p["mag1c_noise"]),
                        0.0, 10000.0)
    out = {"mag1c": mag1c}
    for name, f in zip(PRODUCTS[1:4], (55.0, 60.0, 50.0)):
        out[name] = torch.clamp(albedo * f + torch.randn(albedo.shape, generator=gen, **f64) * 0.5,
                                min=0.0)
    out["labelbinary"] = (conc > float(p["label_threshold"])).to(torch.float64)
    out["weight_mag1c"] = torch.clamp(mag1c / float(p["weight_div"]), 0.1, 1.0)
    return {k: v.float() for k, v in out.items()}


def write_dataset(root: str, chips: Dict[str, np.ndarray], prefix: str) -> str:
    """Write every chip's products and the index CSV; returns its path."""
    n = next(iter(chips.values())).shape[0]
    rows: List[Dict] = []
    for i in range(n):
        tile = f"{prefix}{i:04d}"
        folder = os.path.join(root, tile)
        os.makedirs(folder, exist_ok=True)
        for name in PRODUCTS:
            write_tiff(os.path.join(folder, f"{name}.tif"), chips[name][i])
        label = chips["labelbinary"][i]
        h, w = label.shape
        rows.append({"id": tile, "folder": folder, "has_plume": bool(label.sum() > 0),
                     "qplume": float((chips["mag1c"][i] * label).sum()),
                     "window_col_off": 0, "window_row_off": 0,
                     "window_width": w, "window_height": h})
    path = os.path.join(root, f"{prefix}index.csv")
    with open(path, "w", newline="") as fh:
        writer = csv.DictWriter(fh, fieldnames=list(rows[0]))
        writer.writeheader()
        writer.writerows(rows)
    return path
