"""Affine geotransforms (the part of starcop_tpu/data/geo.py that the GeoTIFF
codec needs).

rasterio's convention: x = a col + b row + xoff, y = d col + e row + yoff,
stored as (a, b, xoff, d, e, yoff).
"""

from __future__ import annotations

from typing import Tuple

Affine = Tuple[float, float, float, float, float, float]
