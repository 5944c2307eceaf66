"""Synthetic EMIT granules, made on the device from a seed.

The radiance model is a frozen copy of ``starcop_tpu_torch/data/synthetic.py:
synthetic_scene`` (x = albedo * base spectrum * exp(conc * template / 1e5)
plus Gaussian noise, clipped at 1e-3; a bilinear albedo field on a 16-pixel
grid; Gaussian-ellipse plumes), drawn with a torch generator on the card
instead of numpy. The fill pattern is ``chip_smoke.masked_granule``'s: the
sensor's fill value in every band over a partial-granule corner (rows 0-127
of columns 0-319), over one whole column block (``fill_block``), and in one
band of a scattered share of pixels; ``valid`` is the serving reader's rule,
no band at the fill value.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

FILL = -9999.0


def _uniform(gen, shape, lo, hi, device):
    return torch.rand(shape, generator=gen, device=device, dtype=torch.float64) * (hi - lo) + lo


def make_granule(seed: int, index: int, template, p: Dict, device) -> Dict[str, torch.Tensor]:
    """One granule of ``p``'s geometry on ``device``: cube (H, W, S) f32,
    rgb (3, H, W) f32, valid (H, W) bool."""
    h, w = int(p["lines"]), int(p["samples"])
    tpl = torch.as_tensor(template, dtype=torch.float64, device=device)
    s = tpl.numel()
    gen = torch.Generator(device=device).manual_seed((int(seed) * 7919 + index) % (2**63))

    coarse = _uniform(gen, (h // 16 + 2, w // 16 + 2), 0.5, 2.0, device)
    fy = torch.arange(h, device=device, dtype=torch.float64)[:, None] / 16.0
    fx = torch.arange(w, device=device, dtype=torch.float64)[None, :] / 16.0
    i0, j0 = fy.long(), fx.long()
    dy, dx = fy - i0, fx - j0
    albedo = (coarse[i0, j0] * (1 - dy) * (1 - dx) + coarse[i0 + 1, j0] * dy * (1 - dx)
              + coarse[i0, j0 + 1] * (1 - dy) * dx + coarse[i0 + 1, j0 + 1] * dy * dx)
    base = _uniform(gen, (s,), 2.0, 6.0, device) + 0.3 * torch.sin(
        torch.linspace(0, 2, s, device=device, dtype=torch.float64))

    yy = torch.arange(h, device=device, dtype=torch.float64)[:, None]
    xx = torch.arange(w, device=device, dtype=torch.float64)[None, :]
    conc = torch.zeros((h, w), device=device, dtype=torch.float64)
    draws = _uniform(gen, (int(p["plumes"]), 6), 0.0, 1.0, device).tolist()
    for u_cy, u_cx, u_sy, u_sx, u_angle, u_amp in draws:
        cy, cx = (0.15 + 0.7 * u_cy) * h, (0.15 + 0.7 * u_cx) * w
        sy, sx = 4 + 10 * u_sy, 8 + 22 * u_sx
        angle = math.pi * u_angle
        ry = (yy - cy) * math.cos(angle) + (xx - cx) * math.sin(angle)
        rx = -(yy - cy) * math.sin(angle) + (xx - cx) * math.cos(angle)
        conc += (0.3 + 0.7 * u_amp) * float(p["max_concentration"]) * torch.exp(
            -(ry**2 / (2 * sy**2) + rx**2 / (2 * sx**2)))

    cube = torch.empty((h, w, s), device=device, dtype=torch.float32)
    for b in range(s):  # one band at a time keeps the f64 temporaries small
        band = albedo * base[b] * torch.exp(conc * tpl[b] / 1e5)
        band = band + torch.randn((h, w), generator=gen, device=device,
                                  dtype=torch.float64) * float(p["noise"])
        cube[..., b] = torch.clamp(band, min=1e-3).float()
    rgb = torch.stack([albedo * f for f in (55.0, 60.0, 50.0)])
    rgb = torch.clamp(rgb + torch.randn(rgb.shape, generator=gen, device=device,
                                        dtype=torch.float64) * 0.5, min=0).float()

    corner_rows, corner_cols = p["fill_corner"]
    cube[:corner_rows, :corner_cols, :] = FILL
    step, blk = int(p["column_step"]), int(p["fill_block"])
    cube[:, blk * step:(blk + 1) * step, :] = FILL
    scattered = torch.rand((h, w), generator=gen, device=device) < float(p["fill_share"])
    rows, cols = torch.nonzero(scattered, as_tuple=True)
    bands = torch.randint(0, s, (rows.numel(),), generator=gen, device=device)
    cube[rows, cols, bands] = FILL
    valid = ~(cube == FILL).any(-1)
    return {"cube": cube, "rgb": rgb, "valid": valid}


def make_pool(seed: int, template, p: Dict, device):
    """``p["pool"]`` granules made on ``device`` and held in host memory:
    [{cube (H, W, S), rgb (3, H, W), valid (H, W), valid_pixels}] as numpy."""
    pool = []
    for i in range(int(p["pool"])):
        g = make_granule(seed, i, template, p, device)
        host = {k: g[k].cpu().numpy() for k in ("cube", "rgb", "valid")}
        host["valid_pixels"] = int(host["valid"].sum())
        pool.append(host)
        del g
    return pool
