"""Segmentation model: network + normaliser + loss + prediction protocol
(counterpart of starcop_tpu/models/segmenter.py).

``forward`` normalises the (B, C, H, W) input with the frozen per-product
constants and runs the network, returning (B, K, H, W) logits.
``batch_with_preds`` enriches a batch dict with the predictions the
validation harness reads (eval/validation.py), and ``loss_fn`` is the
weighted BCE of training.

Batch protocol: a dict with input (B, C, H, W), output (B, 1, H, W),
optionally weight_loss (B, 1, H, W), has_plume (B,) and id (list of str).

bf16-resident inference (the serving CLI's default, as in the JAX package):
call ``cast_for_inference`` on the model once. The input is normalised in
f32, cast to the network's parameter dtype, runs through bf16 weights and
batch-norm statistics (cuDNN on the card), and the logits come back f32.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from starcop_tpu_torch.data.normalizer import DataNormalizer
from starcop_tpu_torch.models.mobilenet_unet import MobileNetV2UNet

EMIT_INPUT_PRODUCTS = ("mag1c", "TOA_AVIRIS_640nm", "TOA_AVIRIS_550nm", "TOA_AVIRIS_460nm")


def pred_classification(pred_binary: torch.Tensor) -> torch.Tensor:
    """A tile counts as "plume detected" if its positive pixels exceed
    10 * H * W / 64^2, the resolution-scaled 10-pixel rule that the
    published tile-classification numbers rest on. int32, the last two axes
    summed."""
    n_pixels = (10 * np.prod(pred_binary.shape[-2:])) / (64**2)
    return (pred_binary.sum(dim=(-1, -2)) > n_pixels).to(torch.int32)


def differences(y_pred_binary: torch.Tensor, y_gt: torch.Tensor) -> torch.Tensor:
    """2 * pred + (gt == 1): the categorical {0 TN, 1 FN, 2 FP, 3 TP} map."""
    return 2 * y_pred_binary.to(torch.int32) + (y_gt == 1).to(torch.int32)


def weighted_bce_with_logits(logits: torch.Tensor, targets: torch.Tensor,
                             pos_weight: float = 1.0) -> torch.Tensor:
    """Per-element binary cross-entropy with logits and a positive-class
    weight, ``BCEWithLogitsLoss(pos_weight=w, reduction='none')``, by log
    sigmoids (stable at large |logits|)."""
    return -(pos_weight * targets * F.logsigmoid(logits)
             + (1.0 - targets) * F.logsigmoid(-logits))


class SegmentationModel(nn.Module):
    """Normaliser + MobileNetV2 U-Net (the ``unet_semseg`` architecture) +
    weighted BCE. Its state_dict holds ``network.*`` only, as a Lightning
    checkpoint does once its normaliser buffers are dropped.

    The network computes in the dtype of its parameters (f32, or bf16 after
    ``cast_for_inference``); the logits are at least f32 either way
    (starcop_tpu/models/mobilenet_unet.py:175-185). The JAX package's other
    architectures are not ported yet (ROADMAP queue 1, item 9)."""

    def __init__(self, input_products: Sequence[str] = EMIT_INPUT_PRODUCTS,
                 output_products: Sequence[str] = ("labelbinary",),
                 model_type: str = "unet_semseg", num_classes: int = 1,
                 pos_weight: float = 1.0, use_weight_loss: bool = True,
                 loss_name: str = "BCEWithLogitsLoss"):
        super().__init__()
        if model_type != "unet_semseg":
            raise ValueError(f"model_type {model_type!r} is not ported: only 'unet_semseg' "
                             "is (the other networks are ROADMAP queue 1, item 9)")
        self.input_products = list(input_products)
        self.output_products = list(output_products)
        self.model_type = model_type
        self.num_classes = num_classes
        self.pos_weight = float(pos_weight)
        self.use_weight_loss = bool(use_weight_loss)
        self.loss_name = loss_name
        self.normalizer = DataNormalizer(self.input_products, self.output_products)
        self.network = MobileNetV2UNet(len(self.input_products), num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xn = self.normalizer.normalize_x(x)
        out = self.network(xn.to(next(self.network.parameters()).dtype))
        return out.to(torch.promote_types(out.dtype, torch.float32))

    def loss_fn(self, logits: torch.Tensor, y: torch.Tensor,
                weight_loss: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Weighted BCE: the per-pixel loss times ``weight_loss``, then the
        mean; plain means for the 'l1' and 'mse' regression losses."""
        y_norm = self.normalizer.normalize_y(y)
        if self.loss_name == "l1":
            return (logits - y_norm).abs().mean()
        if self.loss_name == "mse":
            return ((logits - y_norm) ** 2).mean()
        per_pixel = weighted_bce_with_logits(logits, y_norm, self.pos_weight)
        if self.use_weight_loss and weight_loss is not None:
            return (per_pixel * weight_loss).mean()
        return per_pixel.mean()

    def batch_with_preds(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """The batch with input_norm, output_norm, logits, prediction
        (sigmoid), pred_binary (> 0.5, int32), differences,
        pred_classification and the per-pixel losses added, computed on the
        model's device (numpy arrays are moved there). Run it under
        ``torch.inference_mode()``."""
        dev = self.normalizer.offsets.device
        x, y = (torch.as_tensor(batch[k], device=dev) for k in ("input", "output"))
        logits = self(x)
        pred = torch.sigmoid(logits)
        out = dict(batch)
        out.update(input_norm=self.normalizer.normalize_x(x),
                   output_norm=self.normalizer.normalize_y(y),
                   logits=logits, prediction=pred, pred_binary=(pred > 0.5).to(torch.int32))
        if self.use_weight_loss and self.loss_name == "BCEWithLogitsLoss":
            per_pixel = weighted_bce_with_logits(logits, out["output_norm"], self.pos_weight)
            out["loss_per_pixel"] = per_pixel
            if "weight_loss" in batch:
                out["loss_per_pixel_weighted"] = (
                    torch.as_tensor(batch["weight_loss"], device=dev) * per_pixel)
        out["differences"] = differences(out["pred_binary"],
                                         out["output_norm"].to(torch.int32))
        out["pred_classification"] = pred_classification(out["pred_binary"])
        return out


def cast_for_inference(model: SegmentationModel,
                       dtype: torch.dtype = torch.bfloat16) -> SegmentationModel:
    """Cast the network's float parameters and batch-norm buffers to
    ``dtype`` once, in place (``cast_variables_for_inference`` of
    starcop_tpu/models/segmenter.py:91-108): the weights then cross from
    device memory once per layer at half the bytes. The input normaliser
    stays f32, and ``forward`` casts its output to the new dtype."""
    model.network.to(dtype)
    return model
