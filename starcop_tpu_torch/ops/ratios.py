"""Band-ratio products (counterpart of starcop_tpu/ops/ratios.py).

Only ``weight_mag1c``, the loss-weight product the chip cache writes, is
ported so far; the Varon and Sanchez-Garcia ratios are ROADMAP queue 1,
item 6.
"""

from __future__ import annotations

import torch


def weight_mag1c(mag1c: torch.Tensor) -> torch.Tensor:
    """Per-pixel loss weight from the matched filter: clip(mag1c / 400, 0.1,
    1), down-weighting pixels the filter already marks ambiguous
    (ratios.py:23-30)."""
    return torch.clamp(torch.as_tensor(mag1c) / 400.0, 0.1, 1.0)
