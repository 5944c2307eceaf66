"""EMIT -> AVIRIS renormalisation (counterpart of starcop_tpu/data/emit.py:22-34).

The constants are load-bearing for zero-shot transfer of AVIRIS-trained
models: mag1c / 240, clip (0, 2), x 1750 and rgb / 20, clip (0, 2), x 60 map
EMIT products into the AVIRIS normaliser domain.
"""

from __future__ import annotations

from typing import Tuple

import torch

MAGIC_DIV_BY = 240.0
RGB_DIV_BY = 20.0
MAGIC_MULT_BY = 1750.0
RGB_MULT_BY = 60.0
DEFAULT_WAVELENGTH_RANGE = (2122.0, 2488.0)


def renormalize_emit_to_aviris(
    mag1c: torch.Tensor, rgb: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Map EMIT-domain mag1c (H, W) and RGB (3, H, W) into the AVIRIS domain."""
    m = torch.clamp(mag1c / MAGIC_DIV_BY, 0, 2) * MAGIC_MULT_BY
    r = torch.clamp(rgb / RGB_DIV_BY, 0, 2) * RGB_MULT_BY
    return m, r
