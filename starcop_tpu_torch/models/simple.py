"""Tiny CNN baselines, NCHW (counterpart of starcop_tpu/models/simple.py).

A 1x1-conv probe (``SingleConv``), a 5-layer 3x3 CNN (``SimpleCNN``) and the
1x1-conv regression stack (``SimpleCNNRegression``). Submodules carry the
Flax module names (``Conv_0``, ``conv{i}``, ``head``), so a torch key
``a.b.weight`` is the Flax parameter ``a/b/kernel``
(``models.weights.torch_to_flax_variables``).
"""

from __future__ import annotations

import torch
from torch import nn


class SingleConv(nn.Module):
    """One 1x1 conv: a per-pixel linear probe over the input products."""

    def __init__(self, in_channels: int, out_channels: int = 1):
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_channels, out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Conv_0(x)


class SimpleCNN(nn.Module):
    """4 x (3x3 conv + ReLU) at ``width`` channels, then a 3x3 logits head."""

    def __init__(self, in_channels: int, out_channels: int = 1, width: int = 64):
        super().__init__()
        for i in range(4):
            setattr(self, f"conv{i}", nn.Conv2d(in_channels if i == 0 else width, width, 3,
                                                padding=1))
        self.head = nn.Conv2d(width, out_channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(4):
            x = torch.relu(getattr(self, f"conv{i}")(x))
        return self.head(x)


class SimpleCNNRegression(nn.Module):
    """``depth`` x (1x1 conv + ReLU) at ``width`` channels, then a 1x1 head."""

    def __init__(self, in_channels: int, out_channels: int = 1, width: int = 128,
                 depth: int = 3):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            setattr(self, f"conv{i}", nn.Conv2d(in_channels if i == 0 else width, width, 1))
        self.head = nn.Conv2d(width, out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.depth):
            x = torch.relu(getattr(self, f"conv{i}")(x))
        return self.head(x)
