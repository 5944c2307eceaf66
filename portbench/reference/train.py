"""Plain HyperSTARCOP training steps and a judge of the loader's rows.

A step: the U-Net (``reference/unet.py``) in training mode on the batch's
normalised input, the weighted binary cross-entropy with logits (``pos_weight``
on the positive term, times the per-pixel loss weight, then the mean), its
gradients by autograd, and one Adam step as torch's ``Adam`` defines it
(bias-corrected moments, no weight decay). Batch norm normalises with the
batch's statistics; its running statistics do not enter a training step.

The loader's rows are judged against the raw chips: a row's id names its
chip and window; the reference cuts that window and finds the augmentation
that the row carries (a continuous rotation about the centre with bilinear
resampling for inputs and loss weights and nearest for the label, then
horizontal and vertical flips, the published recipe) by searching the angle.
"""

from __future__ import annotations

import math
import re
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from portbench.reference.unet import normalize_input, unet_logits


def weighted_bce(logits, target, weight, pos_weight: float):
    per_pixel = -(pos_weight * target * F.logsigmoid(logits)
                  + (1.0 - target) * F.logsigmoid(-logits))
    return (per_pixel * weight).mean()


def adam_steps(params: Dict[str, torch.Tensor], batches: Sequence[Dict], model_cfg: Dict,
               train_cfg: Dict, dtype=torch.float64):
    """Run ``len(batches)`` steps from ``params``; returns (losses, the first
    step's gradients, the parameters after the last step), all in ``dtype``.
    Batch-norm running statistics are carried unchanged."""
    names = [k for k in params if not k.endswith(("running_mean", "running_var"))]
    p = {k: v.to(dtype).clone() for k, v in params.items()}
    m = {k: torch.zeros_like(p[k]) for k in names}
    v = {k: torch.zeros_like(p[k]) for k in names}
    b1, b2, eps, lr = (train_cfg["adam_b1"], train_cfg["adam_b2"], train_cfg["adam_eps"],
                       train_cfg["lr"])
    losses, first_grads = [], None
    for t, batch in enumerate(batches, start=1):
        leaves = {k: p[k].detach().requires_grad_(True) for k in names}
        full = {**p, **leaves}
        x = normalize_input(batch["input"].to(dtype), model_cfg["input_factors"])
        logits = unet_logits(x, full, train=True)
        loss = weighted_bce(logits, batch["output"].to(dtype), batch["weight_loss"].to(dtype),
                            train_cfg["pos_weight"])
        grads = torch.autograd.grad(loss, [leaves[k] for k in names])
        losses.append(float(loss.detach()))
        if first_grads is None:
            first_grads = {k: g.detach() for k, g in zip(names, grads)}
        with torch.no_grad():
            for k, g in zip(names, grads):
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                step = lr / (1 - b1**t)
                denom = (v[k] / (1 - b2**t)).sqrt() + eps
                p[k] = p[k] - step * m[k] / denom
    return losses, first_grads, p


def leaf_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
             keep: Sequence[str]) -> Tuple[float, str]:
    """The worst leaf's gap between the program's norm and the reference's,
    over the larger of that leaf's reference norm and the median leaf's."""
    ref_n = {k: float(ref[k].double().norm()) for k in keep}
    median = sorted(ref_n.values())[len(ref_n) // 2]
    worst, at = 0.0, ""
    for k in keep:
        gap = abs(float(prog[k].double().norm()) - ref_n[k]) / max(ref_n[k], median)
        if gap > worst:
            worst, at = gap, k
    return worst, at


# -- the loader's rows ---------------------------------------------------
ID_RE = re.compile(r"^(?P<tile>.+)_r(?P<r>\d+)_c(?P<c>\d+)$")


def rotate(arr: torch.Tensor, angle_deg: torch.Tensor, nearest: bool) -> torch.Tensor:
    """(C, H, W) -> (A, C, H, W): rotated by each angle about ((W-1)/2,
    (H-1)/2), counter-clockwise for a positive angle, zeros outside."""
    c, h, w = arr.shape
    t = torch.deg2rad(angle_deg.to(torch.float64))[:, None, None]
    ct, st = torch.cos(t), torch.sin(t)
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    dy = torch.arange(h, dtype=torch.float64, device=arr.device)[None, :, None] - cy
    dx = torch.arange(w, dtype=torch.float64, device=arr.device)[None, None, :] - cx
    xs = ct * dx - st * dy + cx
    ys = st * dx + ct * dy + cy
    src = arr.to(torch.float64)

    def tap(yy, xx):
        ok = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
        vals = src[:, yy.clamp(0, h - 1), xx.clamp(0, w - 1)]  # (C, A, H, W)
        return (vals * ok).permute(1, 0, 2, 3)

    if nearest:
        return tap(torch.round(ys).long(), torch.round(xs).long())
    x0, y0 = torch.floor(xs).long(), torch.floor(ys).long()
    fx, fy = (xs - x0)[:, None], (ys - y0)[:, None]
    return (tap(y0, x0) * (1 - fx) * (1 - fy) + tap(y0, x0 + 1) * fx * (1 - fy)
            + tap(y0 + 1, x0) * (1 - fx) * fy + tap(y0 + 1, x0 + 1) * fx * fy)


def judge_row(row: Dict[str, torch.Tensor], window: Dict[str, torch.Tensor]):
    """(gap, the reference's row): the largest gap, relative to each
    channel's largest value in the window, between the loader's row and the
    window under the augmentation that fits it best, and that augmentation
    of the window computed by the reference. Where no rotation was drawn the
    row must equal a flip of the window exactly, label included."""
    keys = ("input", "weight_loss")
    allk = (*keys, "output")
    scale = {k: window[k].abs().amax(dim=(-2, -1), keepdim=True).clamp_min(1e-30) for k in keys}
    dev = row["input"].device
    flips = [lambda t: t, lambda t: t.flip(-1), lambda t: t.flip(-2),
             lambda t: t.flip(-1).flip(-2)]
    best = (math.inf, None)
    for flip in flips:  # a flip is its own inverse: undo it, then find the angle
        row_f = {k: flip(row[k].to(torch.float64)) for k in allk}
        if all(torch.equal(row_f[k], window[k].to(torch.float64)) for k in allk):
            return 0.0, {k: flip(window[k].to(torch.float64)) for k in allk}

        def err(angles):
            got = rotate(window["input"], angles, False)
            return ((got - row_f["input"]) / scale["input"]).abs().amax(dim=(-3, -2, -1))

        grid = torch.linspace(-90.0, 90.0, 721, dtype=torch.float64, device=dev)
        e = torch.cat([err(g) for g in grid.split(121)])
        i = int(torch.argmin(e))
        lo, hi = float(grid[max(i - 1, 0)]), float(grid[min(i + 1, len(grid) - 1)])
        phi = (math.sqrt(5) - 1) / 2
        for _ in range(56):  # golden-section search on the bracket
            a, b = hi - phi * (hi - lo), lo + phi * (hi - lo)
            ea, eb = err(torch.tensor([a, b], dtype=torch.float64, device=dev)).tolist()
            if ea < eb:
                hi = b
            else:
                lo = a
        angle = torch.tensor([(lo + hi) / 2], dtype=torch.float64, device=dev)
        cands = {k: rotate(window[k], angle, k == "output")[0] for k in allk}
        gap = max(float(((cands[k] - row_f[k]) / scale[k]).abs().max()) for k in keys)
        if gap < best[0]:
            best = (gap, {k: flip(cands[k]) for k in allk})
        if gap < 1e-4:
            break
    return best


def window_of(row_id: str, chips: Dict[str, Dict[str, torch.Tensor]], size: int,
              products: Dict[str, Sequence[str]]) -> Dict[str, torch.Tensor]:
    """The raw (C, size, size) window that a loader row's id names."""
    m = ID_RE.match(row_id)
    tile, r, c = m["tile"], int(m["r"]), int(m["c"])
    chip = chips[tile]
    cut = lambda names: torch.stack([chip[n][r:r + size, c:c + size] for n in names])  # noqa: E731
    return {k: cut(names) for k, names in products.items()}
