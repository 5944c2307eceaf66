"""Sentinel-2 cloud detection model (counterpart of starcop_tpu/models/cloud.py).

A CloudSEN12-style MobileNetV2 U-Net (the port's ``MobileNetV2UNet``) over
13 Sentinel-2 bands with 4 classes {clear, thick cloud, thin cloud, shadow};
the prediction is the argmax over classes, and a whole scene is predicted
through a reflect pad to a multiple of 32 (``ops.padding.padded_apply``).
The network's weights carry from Flax as the U-Net's do
(``models.weights.flax_to_torch_state_dict``).
"""

from __future__ import annotations

import torch
from torch import nn

from starcop_tpu_torch.device import float32_precision
from starcop_tpu_torch.models.mobilenet_unet import MobileNetV2UNet
from starcop_tpu_torch.ops.padding import padded_apply

CLOUD_CLASSES = ("clear", "thick_cloud", "thin_cloud", "cloud_shadow")


class CloudDetector(nn.Module):
    """13-band S2 input -> 4-class cloud mask. Inference runs in eval mode
    in full f32 on the device of the network's parameters."""

    def __init__(self, num_bands: int = 13, num_classes: int = 4):
        super().__init__()
        self.num_bands = num_bands
        self.network = MobileNetV2UNet(num_bands, num_classes)

    def logits(self, x_nchw: torch.Tensor) -> torch.Tensor:
        """(B, 13, H, W) -> (B, 4, H, W) logits."""
        with float32_precision():
            return self.network(x_nchw)

    forward = logits

    def _input(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32,
                               device=next(self.network.parameters()).device)

    @torch.inference_mode()
    def predict(self, x_nchw) -> torch.Tensor:
        """(B, 13, H, W) -> (B, H, W) int64 class map (argmax over classes)."""
        self.eval()
        return torch.argmax(self.logits(self._input(x_nchw)), dim=1)

    @torch.inference_mode()
    def predict_scene(self, scene_chw) -> torch.Tensor:
        """Whole-scene (13, H, W) -> (H, W) class map, reflect-padded to a
        multiple of 32 for one forward pass."""
        self.eval()
        return torch.argmax(padded_apply(self._input(scene_chw), self.logits, divisor=32), dim=0)
