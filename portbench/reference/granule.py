"""Plain EMIT granule -> (plume probability, mf): the column-blocked matched
filter (``reference/mag1c.py``), the EMIT -> AVIRIS renormalisation of the
STARCOP zero-shot recipe (``clip(mf / 240, 0, 2) * 1750``, ``clip(rgb / 20,
0, 2) * 60``; NODATA enters as 0), a reflect pad to a multiple of 32, the
input normalisation, the U-Net (``reference/unet.py``), a sigmoid and the
crop back. Every step runs in ``dtype``.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from portbench.reference.mag1c import NODATA, column_blocks
from portbench.reference.unet import normalize_input, unet_logits


def find_padding(v: int, divisor: int = 32):
    total = max(divisor, divisor * (-(-v // divisor))) - v
    return total // 2, total - total // 2


def plume_probability(mf, rgb, params: Dict[str, torch.Tensor], model: Dict,
                      rounding=None) -> torch.Tensor:
    """mf (H, W) and rgb (3, H, W) -> sigmoid mask (H, W) in mf's dtype;
    ``rounding`` as ``unet_logits`` takes it."""
    dtype = mf.dtype
    ren = model["emit_to_aviris"]
    m = torch.where(mf == NODATA, torch.zeros((), dtype=dtype, device=mf.device), mf)
    m = torch.clamp(m / ren["mag1c_div"], 0, 2) * ren["mag1c_mult"]
    r = torch.clamp(rgb.to(dtype) / ren["rgb_div"], 0, 2) * ren["rgb_mult"]
    x = torch.cat([m[None], r])[None]
    h, w = mf.shape
    pr, pc = find_padding(h), find_padding(w)
    x = F.pad(x, (pc[0], pc[1], pr[0], pr[1]), mode="reflect")
    x = normalize_input(x, model["input_factors"])
    p = {k: v.to(dtype) for k, v in params.items()}
    out = torch.sigmoid(unet_logits(x, p, rounding=rounding))[0, 0]
    return out[pr[0]:pr[0] + h, pc[0]:pc[0] + w]


def granule_to_mask(cube, rgb, valid, template, params, config: Dict, dtype=torch.float64,
                    rounding=None):
    """The reference's (prediction, mf) for one granule, in ``dtype``."""
    filt = config["filter"]
    mf, _ = column_blocks(cube, template, valid, column_step=filt["column_step"],
                          num_iter=filt["num_iter"], alpha=filt["alpha"], dtype=dtype)
    return plume_probability(mf, rgb, params, config["model"], rounding), mf
