"""Plain MobileNetV2-encoder U-Net (``smp.Unet(encoder_name="mobilenet_v2")``)
as a function of a parameter dict, in any float dtype.

The architecture follows the published description (Sandler et al., 2018,
table 2; segmentation_models_pytorch's ``Unet``): MobileNetV2 ``features``
split at indices 2, 4, 7 and 14 for the skips (16, 24, 32, 96 channels) and
a 1280-channel head at stride 32; five decoder blocks of [nearest x2
upsample, concatenate the skip, (3x3 conv, batch norm, ReLU) x 2] with 256,
128, 64, 32 and 16 channels, the last without a skip; a 3x3 convolution to
the logits. Parameter names are smp's state_dict names, the public layout a
released checkpoint carries.

Nothing here is imported from the program: this is the yardstick that the
program's outputs are held to.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

import torch
import torch.nn.functional as F

# MobileNetV2's table: (expansion t, out channels c, repeats n, stride s).
INVERTED_RESIDUAL_CFG = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
                         (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1))
STAGE_SPLITS = (2, 4, 7, 14)
ENCODER_CHANNELS = (16, 24, 32, 96, 1280)
DECODER_CHANNELS = (256, 128, 64, 32, 16)
BN_EPS = 1e-5


def conv_specs(in_channels: int = 4, num_classes: int = 1) -> Iterator[Tuple[str, int, int, int, int]]:
    """Every convolution as (parameter prefix, c_in, c_out, kernel, groups),
    in forward order: the shapes that ``make_params`` draws and that
    ``counts.unet_forward_flops`` counts."""
    yield "encoder.features.0.0", in_channels, 32, 3, 1
    cin, idx = 32, 1
    for t, c, n, _ in INVERTED_RESIDUAL_CFG:
        for _ in range(n):
            hidden = cin * t
            base = f"encoder.features.{idx}.conv"
            if t == 1:
                yield f"{base}.0.0", hidden, hidden, 3, hidden
                yield f"{base}.1", hidden, c, 1, 1
            else:
                yield f"{base}.0.0", cin, hidden, 1, 1
                yield f"{base}.1.0", hidden, hidden, 3, hidden
                yield f"{base}.2", hidden, c, 1, 1
            cin, idx = c, idx + 1
    yield f"encoder.features.{idx}.0", cin, 1280, 1, 1
    ins = [ENCODER_CHANNELS[-1], *DECODER_CHANNELS[:-1]]
    skips = [*ENCODER_CHANNELS[-2::-1], 0]
    for i, (ci, s, co) in enumerate(zip(ins, skips, DECODER_CHANNELS)):
        yield f"decoder.blocks.{i}.conv1.0", ci + s, co, 3, 1
        yield f"decoder.blocks.{i}.conv2.0", co, co, 3, 1
    yield "segmentation_head.0", DECODER_CHANNELS[-1], num_classes, 3, 1


def bn_prefix(conv: str) -> str:
    """The batch norm that follows a convolution: ``a.b.0`` -> ``a.b.1``;
    a bare projection ``...conv.k`` -> ``...conv.{k+1}``."""
    head, last = conv.rsplit(".", 1)
    return f"{head}.{int(last) + 1}"


def _bn(x, p: Dict[str, torch.Tensor], name: str, train: bool):
    if train:
        # Training: the batch's mean and biased variance.
        var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0, keepdim=True)
    else:
        mean = p[f"{name}.running_mean"].view(1, -1, 1, 1)
        var = p[f"{name}.running_var"].view(1, -1, 1, 1)
    scale = p[f"{name}.weight"].view(1, -1, 1, 1) / torch.sqrt(var + BN_EPS)
    return (x - mean) * scale + p[f"{name}.bias"].view(1, -1, 1, 1)


def _conv(x, p, name, stride=1, groups=1):
    w = p[f"{name}.weight"]
    rounding = p.get("rounding")
    if rounding is not None:
        x, w = rounding(x), rounding(w)
    return F.conv2d(x, w, p.get(f"{name}.bias"), stride, w.shape[-1] // 2, 1, groups)


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale a tensor (its largest
    magnitude to e4m3's 448), back in ``t``'s dtype: the operands of an fp8
    convolution that accumulates in higher precision."""
    scale = t.detach().abs().amax().clamp_min(1e-30) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale



def _cbr6(x, p, name, stride=1, groups=1, train=False):
    return torch.clamp(_bn(_conv(x, p, f"{name}.0", stride, groups), p, f"{name}.1", train), 0, 6)


def _encoder(x, p, train) -> List[torch.Tensor]:
    feats = []
    x = _cbr6(x, p, "encoder.features.0", 2, train=train)
    cin, idx = 32, 1
    for t, c, n, s in INVERTED_RESIDUAL_CFG:
        for i in range(n):
            if idx in STAGE_SPLITS:
                feats.append(x)
            stride = s if i == 0 else 1
            hidden = cin * t
            base = f"encoder.features.{idx}.conv"
            y = x
            if t != 1:
                y = _cbr6(y, p, f"{base}.0", train=train)
                y = _cbr6(y, p, f"{base}.1", stride, hidden, train)
                y = _bn(_conv(y, p, f"{base}.2"), p, f"{base}.3", train)
            else:
                y = _cbr6(y, p, f"{base}.0", stride, hidden, train)
                y = _bn(_conv(y, p, f"{base}.1"), p, f"{base}.2", train)
            x = x + y if stride == 1 and cin == c else y
            cin, idx = c, idx + 1
    x = _cbr6(x, p, f"encoder.features.{idx}", train=train)
    feats.append(x)
    return feats


def unet_logits(x: torch.Tensor, p: Dict[str, torch.Tensor], train: bool = False,
                rounding=None) -> torch.Tensor:
    """(B, C, H, W) normalised input -> (B, K, H, W) logits; H and W
    multiples of 32. ``train`` normalises with the batch's statistics;
    ``rounding`` (e.g. ``fp8_round``) is applied to every convolution's
    input and weights."""
    p = {**p, "rounding": rounding}
    feats = _encoder(x, p, train)
    skips = feats[:-1][::-1]
    y = feats[-1]
    for i in range(len(DECODER_CHANNELS)):
        y = F.interpolate(y, scale_factor=2, mode="nearest")
        if i < len(skips):
            y = torch.cat([y, skips[i]], dim=1)
        for conv in ("conv1", "conv2"):
            name = f"decoder.blocks.{i}.{conv}"
            y = torch.relu(_bn(_conv(y, p, f"{name}.0"), p, f"{name}.1", train))
    return _conv(y, p, "segmentation_head.0")


def normalize_input(x: torch.Tensor, factors) -> torch.Tensor:
    """The published per-product normalisation, ``clip(x / factor, 0, 2)``,
    over the channel axis of (B, C, H, W)."""
    f = torch.as_tensor(factors, dtype=x.dtype, device=x.device).view(1, -1, 1, 1)
    return torch.clamp(x / f, 0.0, 2.0)
