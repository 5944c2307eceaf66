"""Affine geotransforms and window alignment (a copy of
starcop_tpu/data/geo.py; pure numpy).

rasterio's convention: x = a col + b row + xoff, y = d col + e row + yoff,
stored as (a, b, xoff, d, e, yoff). A labelled plume raster's extent maps
into the pixel window of its parent flight-line product, so labels and
products align on one grid.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

Affine = Tuple[float, float, float, float, float, float]


def pixel_to_world(transform: Affine, col, row):
    a, b, xoff, d, e, yoff = transform
    return a * col + b * row + xoff, d * col + e * row + yoff


def world_to_pixel(transform: Affine, x, y):
    a, b, xoff, d, e, yoff = transform
    det = a * e - b * d
    if abs(det) < 1e-18:
        raise ValueError("Singular affine transform")
    col = (e * (x - xoff) - b * (y - yoff)) / det
    row = (-d * (x - xoff) + a * (y - yoff)) / det
    return col, row


def window_transform(transform: Affine, col_off: int, row_off: int) -> Affine:
    """Affine of a (col_off, row_off)-anchored window on the same grid (the
    geotransform a chip carries)."""
    a, b, xoff, d, e, yoff = transform
    x0, y0 = pixel_to_world(transform, col_off, row_off)
    return (a, b, x0, d, e, y0)


def transforms_compatible(t1: Affine, t2: Affine, tol: float = 1e-6) -> bool:
    """Same rotation and scale terms (the grids are the same up to an offset)."""
    return all(abs(t1[i] - t2[i]) < tol for i in (0, 1, 3, 4))


def window_from_product(
    plume_transform: Affine,
    plume_shape: Tuple[int, int],
    product_transform: Affine,
    round_out: bool = True,
) -> Dict[str, int]:
    """Pixel window of a plume raster inside its parent product's grid:
    {window_col_off, window_row_off, window_width, window_height}. Offsets
    are negative where the plume extends beyond the product."""
    if not transforms_compatible(plume_transform, product_transform):
        raise ValueError("Plume and product transforms have different grids")
    h, w = plume_shape
    corners = [(0, 0), (w, 0), (0, h), (w, h)]
    world = [pixel_to_world(plume_transform, c, r) for c, r in corners]
    pix = [world_to_pixel(product_transform, x, y) for x, y in world]
    cols = [p[0] for p in pix]
    rows = [p[1] for p in pix]
    c0, r0 = min(cols), min(rows)
    c1, r1 = max(cols), max(rows)
    if round_out:
        c0, r0 = int(np.floor(c0 + 1e-9)), int(np.floor(r0 + 1e-9))
        c1, r1 = int(np.ceil(c1 - 1e-9)), int(np.ceil(r1 - 1e-9))
    return {
        "window_col_off": int(c0),
        "window_row_off": int(r0),
        "window_width": int(c1 - c0),
        "window_height": int(r1 - r0),
    }


def process_plume_windows(
    plumes: Sequence[Dict],
    products: Dict[str, Dict],
) -> Sequence[Dict]:
    """Align each plume row ('name', 'transform', 'shape') with its flight
    line's product ('transform') grid: the rows extended with the window
    columns, window_col_off = -1 where the flight line has no product."""
    out = []
    for row in plumes:
        new_row = dict(row)
        product = products.get(row["name"])
        if product is None:
            new_row.update(window_col_off=-1, window_row_off=-1, window_width=0, window_height=0)
        else:
            new_row.update(
                window_from_product(row["transform"], row["shape"], product["transform"])
            )
        out.append(new_row)
    return out
