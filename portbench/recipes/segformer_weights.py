"""Seeded SegFormer parameters, made on the device from the seed.

The recipe is NVlabs' ``_init_weights`` drawn in three large calls, with two
changes that make the mask depend on mf:

  * linear weights normal with std 0.02 (NVlabs' trunc-normal cuts at +-2,
    a hundred standard deviations out), convolutions normal with std
    sqrt(2 / fan_out), fan_out = k * k * out / groups: one normal draw for
    every weight;
  * biases normal with std ``BIAS_STD``, layer-norm scales 1 + N(0,
    ``NORM_STD``) and shifts N(0, ``NORM_STD``) (NVlabs: 0, 1 and 0), so
    that every term of the equations is exercised: one normal draw;
  * the head's batch norm at scale 1 and shift 0 with running means N(0,
    0.05) and running variances U(0.8, 1.2), as ``recipes/weights.py``
    seeds the U-Net's: one normal and one uniform draw;
  * the first patch embedding's weights on the mag1c channel scaled by
    ``MF_GAIN``, as ``recipes/weights.MF_GAIN`` does for the U-Net;
  * the last 1x1 convolution (``linear_pred``, fan_out 1, std sqrt(2))
    scaled by ``PRED_GAIN``.

At NVlabs' initialisation the logits reach tens, so the sigmoid is 0 or 1
nearly everywhere, and the mask barely depends on the mag1c channel; with
this recipe the mask spreads over (0, 1), follows mf, and taking the
attention out of one stage-3 block moves it far beyond the f32 rounding
(PERF.md gives the readings).
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from portbench.reference.segformer import param_specs

MF_GAIN = 8.0
PRED_GAIN = 0.25
BIAS_STD = 0.02
NORM_STD = 0.1


def weight_std(shape, kind: str) -> float:
    if kind == "linear":
        return 0.02
    out, _, kh, kw = shape
    return math.sqrt(2.0 / (kh * kw * (1 if kind == "dwconv" else out)))


def make_params(seed: int, device, model: Dict, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """NVlabs-named SegFormer parameters and batch-norm statistics of the
    configuration's model section ``model`` from ``seed``, drawn with a
    generator on ``device``."""
    specs = list(param_specs(model))
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2**63))
    weights = [(n, s, k) for n, s, k in specs if k in ("linear", "conv", "dwconv")]
    vectors = [(n, s, k) for n, s, k in specs if k in ("bias", "norm_weight", "norm_bias")]
    bns = [(n, s[0]) for n, s, k in specs if k == "bn"]
    flat = torch.randn(sum(math.prod(s) for _, s, _ in weights), generator=gen, device=device)
    small = torch.randn(sum(s[0] for _, s, _ in vectors), generator=gen, device=device)
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
        params[name] = (1.0 + NORM_STD * draw if kind == "norm_weight"
                        else draw * (NORM_STD if kind == "norm_bias" else BIAS_STD))
    off = 0
    for name, c in bns:
        params[f"{name}.weight"] = torch.ones(c, device=device)
        params[f"{name}.bias"] = torch.zeros(c, device=device)
        params[f"{name}.running_mean"] = means[off:off + c]
        params[f"{name}.running_var"] = variances[off:off + c]
        off += c
    params["backbone.patch_embed1.proj.weight"][:, 0] *= MF_GAIN
    params["decode_head.linear_pred.weight"] *= PRED_GAIN
    return {k: v.to(dtype).contiguous() for k, v in params.items()}
