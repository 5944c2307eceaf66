"""Segmentation model for inference (counterpart of the forward of
starcop_tpu/models/segmenter.py:SegmentationModel.apply, :191-208).

``forward`` normalises the (B, C, H, W) input with the frozen per-product
constants and runs the network, returning (B, K, H, W) logits. Training,
the loss and the prediction protocol wait for a later slice.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from starcop_tpu_torch.data.normalizer import DataNormalizer
from starcop_tpu_torch.models.mobilenet_unet import MobileNetV2UNet

EMIT_INPUT_PRODUCTS = ("mag1c", "TOA_AVIRIS_640nm", "TOA_AVIRIS_550nm", "TOA_AVIRIS_460nm")


class SegmentationModel(nn.Module):
    """Normaliser + MobileNetV2 U-Net (the ``unet_semseg`` architecture).
    Its state_dict holds ``network.*`` only, as a Lightning checkpoint does
    once its normaliser buffers are dropped."""

    def __init__(self, input_products: Sequence[str] = EMIT_INPUT_PRODUCTS,
                 num_classes: int = 1):
        super().__init__()
        self.input_products = list(input_products)
        self.normalizer = DataNormalizer(self.input_products)
        self.network = MobileNetV2UNet(len(self.input_products), num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.network(self.normalizer.normalize_x(x))
