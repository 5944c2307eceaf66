"""Reflect-padded full-scene inference (counterpart of starcop_tpu/ops/padding.py).

Pad a (C, H, W) scene by reflection (numpy's "reflect": the edge is not
repeated) to the next multiple of ``divisor`` (32 for the U-Net's five
downsamplings), run one whole-scene forward, and crop back to the input
extent.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch


def find_padding(v: int, divisor: int = 8) -> Tuple[int, int]:
    """Split the padding needed to reach the next multiple of divisor."""
    v_divisible = max(divisor, divisor * (-(-v // divisor)))
    total_pad = v_divisible - v
    pad_1 = total_pad // 2
    return pad_1, total_pad - pad_1


def _reflect_index(n: int, before: int, after: int, device) -> torch.Tensor:
    """Source indices of a reflect pad (edge not repeated), periodic with
    period 2 (n - 1) as numpy's, so pads wider than the axis work too."""
    i = torch.arange(-before, n + after, device=device)
    if n == 1:
        return torch.zeros_like(i)
    m = torch.remainder(i, 2 * (n - 1))
    return torch.where(m < n, m, 2 * (n - 1) - m)


def padded_apply(tensor: torch.Tensor, fn: Callable, divisor: int = 32) -> torch.Tensor:
    """Apply ``fn`` to a (C, H, W) tensor reflect-padded to a multiple of
    ``divisor``. ``fn`` gets a (1, C, H', W') batch and returns (1, K, H', W')
    or (1, H', W'); the result is cropped back to (K, H, W) or (H, W)."""
    if tensor.ndim != 3:
        raise ValueError(f"Expected 3D (C, H, W) tensor, found {tensor.ndim}D")
    pad_r = find_padding(tensor.shape[-2], divisor)
    pad_c = find_padding(tensor.shape[-1], divisor)
    # A gather rather than F.pad(mode="reflect"), which refuses pads wider
    # than the axis (a scene under 17 pixels).
    rows = _reflect_index(tensor.shape[-2], *pad_r, tensor.device)
    cols = _reflect_index(tensor.shape[-1], *pad_c, tensor.device)
    out = fn(tensor[:, rows][:, :, cols][None])[0]
    rows = slice(pad_r[0], None if pad_r[1] <= 0 else -pad_r[1])
    cols = slice(pad_c[0], None if pad_c[1] <= 0 else -pad_c[1])
    if out.ndim == 3:
        return out[:, rows, cols]
    if out.ndim == 2:
        return out[rows, cols]
    raise NotImplementedError(f"Cannot crop output of shape {tuple(out.shape)}")
