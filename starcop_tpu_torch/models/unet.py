"""Classic U-Net and its dropout variant, NCHW (counterpart of
starcop_tpu/models/unet.py).

A 4-level encoder (64 -> 128 -> 256 -> 512) of double 3x3 conv + ReLU with
2x2 max-pool downsampling, then bilinear x2 upsampling with skip
concatenation and a 1x1 logits head. Submodules carry the Flax module
names (``down{i}``, ``bottleneck``, ``up{i}``, ``head``; ``Conv_0`` /
``Conv_1`` inside a double conv).

``UNetDropout`` drops the bottleneck's output at rate 0.5 in training. Its
masks come from the ``generator`` passed to ``forward`` (the trainer seeds
one from its seed and the step); JAX folds the step into ``PRNGKey(0)``
(starcop_tpu/train/loop.py:114), which torch cannot reproduce, so the
train-mode masks are an intended deviation. In eval mode nothing is dropped.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from starcop_tpu_torch.models.layers import dropout


class DoubleConv(nn.Module):
    def __init__(self, in_channels: int, features: int):
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_channels, features, 3, padding=1)
        self.Conv_1 = nn.Conv2d(features, features, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.Conv_1(torch.relu(self.Conv_0(x))))


def upsample2(x: torch.Tensor) -> torch.Tensor:
    """Bilinear x2, half-pixel centres, edges clamped: ``jax.image.resize(...,
    "bilinear")`` when upsampling (unet.py:34)."""
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)


class UNet(nn.Module):
    """4-level U-Net: (B, in_channels, H, W) -> (B, out_channels, H, W)
    logits; H and W multiples of 8."""

    def __init__(self, in_channels: int, out_channels: int = 1,
                 widths: Sequence[int] = (64, 128, 256, 512), dropout_rate: float = 0.0):
        super().__init__()
        self.widths = tuple(widths)
        self.dropout_rate = dropout_rate
        self.batch_shard = None  # (rank, size) under ``layers.set_data_parallel``
        cin = in_channels
        for i, w in enumerate(self.widths[:-1]):
            setattr(self, f"down{i}", DoubleConv(cin, w))
            cin = w
        self.bottleneck = DoubleConv(cin, self.widths[-1])
        up_in = self.widths[-1]
        for i, w in reversed(list(enumerate(self.widths[:-1]))):
            setattr(self, f"up{i}", DoubleConv(up_in + w, w))
            up_in = w
        self.head = nn.Conv2d(self.widths[0], out_channels, 1)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        skips = []
        for i in range(len(self.widths) - 1):
            x = getattr(self, f"down{i}")(x)
            skips.append(x)
            x = F.max_pool2d(x, 2)
        x = self.bottleneck(x)
        if self.dropout_rate > 0 and self.training:
            if generator is None:
                raise ValueError("a training forward with dropout needs a generator")
            x = dropout(x, self.dropout_rate, generator, self.batch_shard)
        for i in reversed(range(len(self.widths) - 1)):
            x = torch.cat([upsample2(x), skips[i]], dim=1)
            x = getattr(self, f"up{i}")(x)
        return self.head(x)


class UNetDropout(UNet):
    def __init__(self, in_channels: int, out_channels: int = 1, **kw):
        super().__init__(in_channels, out_channels, dropout_rate=0.5, **kw)
