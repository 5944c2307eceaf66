"""Segmentation model for inference (counterpart of the forward of
starcop_tpu/models/segmenter.py:SegmentationModel.apply, :191-208).

``forward`` normalises the (B, C, H, W) input with the frozen per-product
constants and runs the network, returning (B, K, H, W) logits. Training,
the loss and the prediction protocol wait for a later slice.

bf16-resident inference (the serving CLI's default, as in the JAX package):
call ``cast_for_inference`` on the model once. The input is normalised in
f32, cast to the network's parameter dtype, runs through bf16 weights and
batch-norm statistics (cuDNN on the card), and the logits come back f32.
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
    once its normaliser buffers are dropped.

    The network computes in the dtype of its parameters (f32, or bf16 after
    ``cast_for_inference``); the logits are at least f32 either way
    (starcop_tpu/models/mobilenet_unet.py:175-185)."""

    def __init__(self, input_products: Sequence[str] = EMIT_INPUT_PRODUCTS,
                 num_classes: int = 1):
        super().__init__()
        self.input_products = list(input_products)
        self.normalizer = DataNormalizer(self.input_products)
        self.network = MobileNetV2UNet(len(self.input_products), num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xn = self.normalizer.normalize_x(x)
        out = self.network(xn.to(next(self.network.parameters()).dtype))
        return out.to(torch.promote_types(out.dtype, torch.float32))


def cast_for_inference(model: SegmentationModel,
                       dtype: torch.dtype = torch.bfloat16) -> SegmentationModel:
    """Cast the network's float parameters and batch-norm buffers to
    ``dtype`` once, in place (``cast_variables_for_inference`` of
    starcop_tpu/models/segmenter.py:91-108): the weights then cross from
    device memory once per layer at half the bytes. The input normaliser
    stays f32, and ``forward`` casts its output to the new dtype."""
    model.network.to(dtype)
    return model
