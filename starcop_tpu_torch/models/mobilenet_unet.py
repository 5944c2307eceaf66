"""MobileNetV2-encoder U-Net, NCHW (counterpart of starcop_tpu/models/mobilenet_unet.py).

The architecture of ``smp.Unet(encoder_name='mobilenet_v2', classes=1,
activation=None)``:

  * encoder: the torchvision MobileNetV2 ``features`` with the stage split at
    feature indices [2, 4, 7, 14] -- skips of 16, 24, 32, 96 channels at
    strides 2, 4, 8, 16 and a 1280-channel head at stride 32;
  * decoder: 5 blocks of [nearest x2 upsample -> concat skip -> (conv3x3 +
    BN + ReLU) x 2] with 256, 128, 64, 32, 16 channels, the last without skip;
  * head: conv3x3 -> ``num_classes`` logits.

Module names follow smp's state_dict (``encoder.features.*``,
``decoder.blocks.*``, ``segmentation_head.0``), so a released Lightning
checkpoint loads after ``models.weights.load_lightning_state_dict``.
H and W must be multiples of 32 (``ops.padding.padded_apply``). Batch norm
is ``models.layers.BatchNorm2d``: torch's normalisation, Flax's update of
the running statistics in training.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from starcop_tpu_torch.models.layers import BatchNorm2d

# (expansion t, out channels c, repeats n, stride s): MobileNetV2's table.
INVERTED_RESIDUAL_CFG = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)
STAGE_SPLITS = (2, 4, 7, 14)
ENCODER_CHANNELS = (16, 24, 32, 96, 1280)
DECODER_CHANNELS = (256, 128, 64, 32, 16)


def conv_bn_relu6(cin: int, cout: int, kernel: int, stride: int = 1, groups: int = 1):
    return nn.Sequential(
        nn.Conv2d(cin, cout, kernel, stride, kernel // 2, groups=groups, bias=False),
        BatchNorm2d(cout, eps=1e-5),
        nn.ReLU6(inplace=True),
    )


class InvertedResidual(nn.Module):
    """Bottleneck: [expand 1x1] -> depthwise 3x3 -> project 1x1 (+ residual)."""

    def __init__(self, cin: int, cout: int, stride: int, expand_ratio: int):
        super().__init__()
        hidden = cin * expand_ratio
        self.use_res = stride == 1 and cin == cout
        layers = [] if expand_ratio == 1 else [conv_bn_relu6(cin, hidden, 1)]
        layers += [
            conv_bn_relu6(hidden, hidden, 3, stride, groups=hidden),
            nn.Conv2d(hidden, cout, 1, bias=False),
            BatchNorm2d(cout, eps=1e-5),
        ]
        self.conv = nn.Sequential(*layers)

    def forward(self, x):
        return x + self.conv(x) if self.use_res else self.conv(x)


class MobileNetV2Encoder(nn.Module):
    """``features`` of torchvision's MobileNetV2; returns the five U-Net
    features [16@s2, 24@s4, 32@s8, 96@s16, 1280@s32]."""

    def __init__(self, in_channels: int):
        super().__init__()
        feats: List[nn.Module] = [conv_bn_relu6(in_channels, 32, 3, stride=2)]
        cin = 32
        for t, c, n, s in INVERTED_RESIDUAL_CFG:
            for i in range(n):
                feats.append(InvertedResidual(cin, c, s if i == 0 else 1, t))
                cin = c
        feats.append(conv_bn_relu6(cin, 1280, 1))
        self.features = nn.Sequential(*feats)

    def forward(self, x) -> List[torch.Tensor]:
        outs = []
        for i, layer in enumerate(self.features):
            if i in STAGE_SPLITS:
                outs.append(x)
            x = layer(x)
        outs.append(x)
        return outs


def conv_bn_relu(cin: int, cout: int):
    return nn.Sequential(
        nn.Conv2d(cin, cout, 3, padding=1, bias=False),
        BatchNorm2d(cout, eps=1e-5),
        nn.ReLU(inplace=True),
    )


class DecoderBlock(nn.Module):
    def __init__(self, cin: int, skip: int, cout: int):
        super().__init__()
        self.conv1 = conv_bn_relu(cin + skip, cout)
        self.conv2 = conv_bn_relu(cout, cout)

    def forward(self, x, skip: Optional[torch.Tensor] = None):
        x = F.interpolate(x, scale_factor=2, mode="nearest")
        if skip is not None:
            x = torch.cat([x, skip], dim=1)
        return self.conv2(self.conv1(x))


class UnetDecoder(nn.Module):
    def __init__(self, decoder_channels: Sequence[int] = DECODER_CHANNELS):
        super().__init__()
        ins = [ENCODER_CHANNELS[-1], *decoder_channels[:-1]]
        skips = [*ENCODER_CHANNELS[-2::-1], 0]
        self.blocks = nn.ModuleList(
            DecoderBlock(i, s, o) for i, s, o in zip(ins, skips, decoder_channels)
        )

    def forward(self, feats: List[torch.Tensor]):
        skips = feats[:-1][::-1]
        x = feats[-1]
        for i, block in enumerate(self.blocks):
            x = block(x, skips[i] if i < len(skips) else None)
        return x


class MobileNetV2UNet(nn.Module):
    """(B, in_channels, H, W) normalised input -> (B, num_classes, H, W) logits."""

    def __init__(self, in_channels: int = 4, num_classes: int = 1,
                 decoder_channels: Sequence[int] = DECODER_CHANNELS):
        super().__init__()
        self.encoder = MobileNetV2Encoder(in_channels)
        self.decoder = UnetDecoder(decoder_channels)
        self.segmentation_head = nn.Sequential(
            nn.Conv2d(decoder_channels[-1], num_classes, 3, padding=1)
        )

    def forward(self, x):
        return self.segmentation_head(self.decoder(self.encoder(x)))
