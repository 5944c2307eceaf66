"""Seeded SwinV2 + UperNet parameters, made on the device from the seed.

The recipe is the sources' initialisation drawn in a few large calls, with
changes that let each mechanism show in the mask:

  * linear weights normal with std 0.02 (torchvision's trunc-normal cuts at
    +-2, a hundred standard deviations out), the head's convolutions and
    the stem normal with std sqrt(2 / fan_out), fan_out = k * k * out
    (mmseg's ConvModule rule; torchvision leaves the stem at torch's
    default): one normal draw for every weight;
  * the continuous position bias MLP (``cpb_mlp``) at torch's default
    ``nn.Linear`` initialisation, uniform within +-1 / sqrt(fan_in) for
    weights and the first layer's bias: one uniform draw. Under
    torchvision's trunc-normal(0.02) its output is nearly the same at every
    offset, a constant that the softmax cancels; at this scale the bias
    varies over the window by about a logit;
  * ``logit_scale`` at ln 10 in every head (torchvision's start, below the
    ln 100 cap);
  * biases normal with std ``BIAS_STD`` (qkv's k third 0, as the forward
    holds it), layer-norm scales 1 + N(0, ``NORM_STD``) and shifts N(0,
    ``NORM_STD``) (the sources: 0, 1 and 0), so that every term of the
    equations is exercised: one normal draw;
  * the batch norms at scale 1 and shift 0 with running means N(0, 0.05)
    and running variances U(0.8, 1.2), as ``recipes/weights.py`` seeds the
    U-Net's: one normal and one uniform draw;
  * the stem's weights on the mag1c channel scaled by ``MF_GAIN``, as
    ``recipes/weights.MF_GAIN`` does for the U-Net;
  * ``conv_seg`` (mmseg: normal with std 0.01) at the ConvModule rule's
    sqrt(2) times ``PRED_GAIN``, std 0.014: at the full widths the logits
    then lie within a few units of 0 (at ``PRED_GAIN`` 0.25, as the
    SegFormer recipe has it, their mean is near -29 and the sigmoid 0);
  * the buffers ``relative_coords_table`` and ``relative_position_index``
    as the reference computes them.

With this recipe the mask spreads over (0, 1), follows mf, and each planted
fault of ``controls/faults_swin.py`` moves it far beyond the f32 rounding
(PERF.md gives the readings).
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from portbench.reference.swin import coords_table, param_specs, position_index

MF_GAIN = 8.0
PRED_GAIN = 0.01
BIAS_STD = 0.02
NORM_STD = 0.1


def weight_std(shape, kind: str) -> float:
    if kind == "linear":
        return 0.02
    out, _, kh, kw = shape
    return math.sqrt(2.0 / (kh * kw * out))


def make_params(seed: int, device, model: Dict, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """torchvision- and mmseg-named SwinV2 + UperNet parameters, buffers and
    batch-norm statistics of the configuration's model section ``model``
    from ``seed``, drawn with a generator on ``device``; floating entries
    in ``dtype``."""
    specs = list(param_specs(model))
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2**63))
    weights = [(n, s, k) for n, s, k in specs if k in ("linear", "conv")]
    vectors = [(n, s, k) for n, s, k in specs
               if k in ("bias", "qkv_bias", "norm_weight", "norm_bias")]
    cpb = [(n, s, k) for n, s, k in specs if k in ("cpb_weight", "cpb_bias")]
    bns = [(n, s[0]) for n, s, k in specs if k == "bn"]
    flat = torch.randn(sum(math.prod(s) for _, s, _ in weights), generator=gen, device=device)
    small = torch.randn(sum(s[0] for _, s, _ in vectors), generator=gen, device=device)
    spread = torch.rand(sum(math.prod(s) for _, s, _ in cpb), generator=gen, device=device) * 2 - 1
    n_bn = sum(c for _, c in bns)
    means = torch.randn(n_bn, generator=gen, device=device) * 0.05
    variances = torch.rand(n_bn, generator=gen, device=device) * 0.4 + 0.8

    params: Dict[str, torch.Tensor] = {}
    off = 0
    for name, shape, kind in weights:
        size = math.prod(shape)
        params[name] = flat[off:off + size].view(shape) * weight_std(shape, kind)
        off += size
    off = 0
    for name, (c,), kind in vectors:
        draw = small[off:off + c]
        off += c
        if kind == "norm_weight":
            params[name] = 1.0 + NORM_STD * draw
        elif kind == "norm_bias":
            params[name] = NORM_STD * draw
        else:
            params[name] = BIAS_STD * draw
            if kind == "qkv_bias":
                params[name][c // 3:2 * c // 3] = 0.0
    off = 0
    for name, shape, kind in cpb:
        size = math.prod(shape)
        fan_in = 2 if kind == "cpb_bias" else shape[1]
        params[name] = spread[off:off + size].view(shape) / math.sqrt(fan_in)
        off += size
    off = 0
    for name, c in bns:
        params[f"{name}.weight"] = torch.ones(c, device=device)
        params[f"{name}.bias"] = torch.zeros(c, device=device)
        params[f"{name}.running_mean"] = means[off:off + c]
        params[f"{name}.running_var"] = variances[off:off + c]
        off += c
    window = model["window"]
    table = coords_table(window, torch.float64, device)[None]
    index = position_index(window, device).flatten()
    for name, shape, kind in specs:
        if kind == "logit_scale":
            params[name] = torch.full(shape, math.log(10.0), device=device)
        elif kind == "coords_table":
            params[name] = table
        elif kind == "position_index":
            params[name] = index
    params["features.0.0.weight"][:, 0] *= MF_GAIN
    params["decode_head.conv_seg.weight"] *= PRED_GAIN
    return {k: (v.to(dtype) if v.is_floating_point() else v).contiguous()
            for k, v in params.items()}
