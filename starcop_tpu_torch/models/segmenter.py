"""Segmentation model: network + normaliser + loss + prediction protocol
(counterpart of starcop_tpu/models/segmenter.py).

``forward`` normalises the (B, C, H, W) input with the frozen per-product
constants and runs the network, returning (B, K, H, W) logits.
``batch_with_preds`` enriches a batch dict with the predictions the
validation harness reads (eval/validation.py), and ``loss_fn`` is the
weighted BCE of training. Every segmentation ``model_type`` of the JAX
package builds (``ARCHITECTURES``), and the port's own ``segformer_b5``
(models/segformer.py) and ``swinv2_b_upernet`` (models/swin.py).

Batch protocol: a dict with input (B, C, H, W), output (B, 1, H, W),
optionally weight_loss (B, 1, H, W), has_plume (B,) and id (list of str).

Precision, two routes:

  * mixed-precision training (``model_dtype=torch.bfloat16``, the config's
    ``model.dtype=bfloat16``; ``unet_semseg``, as in JAX, and the SegFormers):
    the network computes under ``torch.autocast`` in bf16 while its
    parameters, the batch-norm statistics and the loss stay f32, and the
    logits come back f32 (starcop_tpu/models/mobilenet_unet.py:171-185);
  * bf16-resident inference (the serving CLI's default): call
    ``cast_for_inference`` once. The input is normalised in f32, cast to
    the network's parameter dtype, runs through bf16 weights and batch-norm
    statistics (cuDNN on the card), and the logits come back f32.
"""

from __future__ import annotations

import warnings
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from starcop_tpu_torch.data.normalizer import DataNormalizer
from starcop_tpu_torch.models.layers import init_like_flax
from starcop_tpu_torch.models.mobilenet_unet import MobileNetV2UNet
from starcop_tpu_torch.models.segformer import ARCHITECTURES as SEGFORMERS
from starcop_tpu_torch.models.simple import SimpleCNN, SimpleCNNRegression, SingleConv
from starcop_tpu_torch.models.swin import ARCHITECTURES as SWINS
from starcop_tpu_torch.models.unet import UNet, UNetDropout

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


# model_type -> network class, each built as cls(in_channels, num_classes).
ARCHITECTURES: Dict[str, Callable[[int, int], nn.Module]] = {
    "unet_semseg": MobileNetV2UNet,
    "unet": UNet,
    "unet_dropout": UNetDropout,
    "cnn": SimpleCNN,
    "single": SingleConv,
    "cnn_regression": SimpleCNNRegression,
    **SEGFORMERS,
    **SWINS,
}
# The networks that compute under bf16 autocast for ``model_dtype=torch.bfloat16``.
AUTOCAST_TYPES = ("unet_semseg", *SEGFORMERS, *SWINS)


def configure_architecture(architecture: str, in_channels: int, num_classes: int) -> nn.Module:
    """The network of ``architecture`` (segmenter.py:59-90): 'unet_semseg'
    is the flagship MobileNetV2-encoder U-Net."""
    if architecture not in ARCHITECTURES:
        raise ValueError(f"No model implemented for model_type: {architecture}")
    return ARCHITECTURES[architecture](in_channels, num_classes)


def find_imagenet_mobilenet_v2() -> Optional[str]:
    """A torchvision mobilenet_v2 ImageNet checkpoint on disk:
    ``$STARCOP_TPU_IMAGENET_MOBILENETV2``, then the torch hub cache
    (``$TORCH_HOME`` or ~/.cache/torch). None when absent: nothing is
    downloaded (a copy of starcop_tpu/models/torch_port.py:181)."""
    import glob
    import os

    explicit = os.environ.get("STARCOP_TPU_IMAGENET_MOBILENETV2")
    if explicit and os.path.exists(explicit):
        return explicit
    hub = os.environ.get("TORCH_HOME", os.path.join(os.path.expanduser("~"), ".cache", "torch"))
    hits = sorted(glob.glob(os.path.join(hub, "hub", "checkpoints", "mobilenet_v2*.pth")))
    return hits[0] if hits else None


class SegmentationModel(nn.Module):
    """Normaliser + network + weighted BCE. Its state_dict holds
    ``network.*`` only, as a Lightning checkpoint does once its normaliser
    buffers are dropped.

    Construction builds the network with torch's default initialisation;
    ``init`` re-draws it as Flax would (training from scratch). The network
    computes in the dtype of its parameters (f32, or bf16 after
    ``cast_for_inference``), under bf16 autocast when ``model_dtype`` is
    ``torch.bfloat16``; the logits are at least f32 either way."""

    def __init__(self, input_products: Sequence[str] = EMIT_INPUT_PRODUCTS,
                 output_products: Sequence[str] = ("labelbinary",),
                 model_type: str = "unet_semseg", num_classes: int = 1,
                 pos_weight: float = 1.0, use_weight_loss: bool = True,
                 loss_name: str = "BCEWithLogitsLoss",
                 model_dtype: Optional[torch.dtype] = None,
                 encoder_weights: Optional[str] = "auto"):
        super().__init__()
        if model_dtype not in (None, torch.float32, torch.bfloat16):
            raise ValueError(f"model_dtype must be None, float32 or bfloat16, got {model_dtype}")
        if model_dtype == torch.bfloat16 and model_type not in AUTOCAST_TYPES:
            warnings.warn(f"model dtype={model_dtype} is only plumbed through "
                          f"{', '.join(AUTOCAST_TYPES)}; '{model_type}' will compute in float32")
            model_dtype = None
        self.input_products = list(input_products)
        self.output_products = list(output_products)
        self.model_type = model_type
        self.num_classes = num_classes
        self.pos_weight = float(pos_weight)
        self.use_weight_loss = bool(use_weight_loss)
        self.loss_name = loss_name
        self.model_dtype = None if model_dtype == torch.float32 else model_dtype
        self.encoder_weights = encoder_weights
        self.normalizer = DataNormalizer(self.input_products, self.output_products)
        self.network = configure_architecture(model_type, len(self.input_products), num_classes)

    def init(self, generator: Optional[torch.Generator] = None) -> "SegmentationModel":
        """Re-initialise the network as Flax does (``init_like_flax``, drawn
        from ``generator``; a network with its own ``init_weights``, as the
        SegFormers' NVlabs rule and the SwinV2 UperNets' rule, draws by that), then the ImageNet encoder
        rule of segmenter.py:144-177: with ``encoder_weights='auto'`` a 3-product
        ``unet_semseg`` takes its encoder from a torchvision mobilenet_v2
        checkpoint when ``find_imagenet_mobilenet_v2`` finds one;
        ``'imagenet'`` makes a missing checkpoint an error; None or 'none'
        never loads one."""
        own = getattr(self.network, "init_weights", None)
        if own is not None:
            own(generator)
        else:
            init_like_flax(self.network, generator)
        if (self.encoder_weights in ("auto", "imagenet") and self.model_type == "unet_semseg"
                and len(self.input_products) == 3):
            ckpt = find_imagenet_mobilenet_v2()
            if ckpt is not None:
                from starcop_tpu_torch.models.weights import load_torchvision_encoder

                load_torchvision_encoder(self.network, torch.load(
                    ckpt, map_location="cpu", weights_only=True))
            elif self.encoder_weights == "imagenet":
                raise FileNotFoundError(
                    "encoder_weights='imagenet' but no torchvision mobilenet_v2 checkpoint "
                    "found (set $STARCOP_TPU_IMAGENET_MOBILENETV2 or populate the torch hub "
                    "cache)")
        return self

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Normalised input -> network -> logits (f32 at least). ``generator``
        draws the dropout masks of a training forward (``unet_dropout``, the
        SegFormers, the SwinV2 UperNets)."""
        xn = self.normalizer.normalize_x(x)
        kw = {} if generator is None else {"generator": generator}
        if self.model_dtype is not None:
            with torch.autocast(xn.device.type, dtype=self.model_dtype):
                out = self.network(xn, **kw)
        else:
            out = self.network(xn.to(next(self.network.parameters()).dtype), **kw)
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
