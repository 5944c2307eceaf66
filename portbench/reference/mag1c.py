"""Plain albedo-corrected reweighted-L1 matched filter (mag1c; Foote et al.,
IEEE TGRS 2020) over column blocks of a scene, in any float dtype.

A frozen restatement of the filter's float64 math as the reference code
states it (statistics weighted by a 0/1 validity mask, covariance shrinkage
``C <- (1 - alpha) C + alpha diag(C)``, the albedo computed once, the
normaliser clamped to >= 1 inside the loop, the regulariser
``1 / (R (mf + 1e-9))``, a ReLU each iteration, the result scaled by 1e5).
A column block of a pushbroom scene keeps its own statistics; a ragged last
block is padded and its padding weighted 0. Nothing here is imported from the
program.
"""

from __future__ import annotations

import torch

NODATA = -9999.0
SCALING = 1e5
EPSILON = 1e-9


def _mean(x, w, n):
    """x (B, P, S), w (B, P), n (B, 1) -> (B, 1, S)."""
    return torch.einsum("bp,bps->bs", w, x)[:, None, :] / n[..., None]


def _cov(xm, w, n, alpha):
    c = torch.einsum("bps,bpt->bst", xm * w[..., None], xm) / n[..., None]
    diag = torch.diag_embed(torch.diagonal(c, dim1=-2, dim2=-1))
    return c + alpha * (diag - c)


def _solve(c, b):
    """C z = b for SPD C (B, S, S), b (B, S) -> (B, S); NaN for a block
    whose C is singular (no valid pixel: its pixels all come out NODATA)."""
    z, info = torch.linalg.solve_ex(c, b[..., None])
    return torch.where((info == 0)[:, None], z[..., 0], torch.nan)


def acrwl1mf(x, template, w, *, num_iter: int = 30, alpha: float = 1e-4):
    """x (B, P, S) radiance, template (S,), w (B, P) 0/1 weights ->
    (mf scaled by 1e5, albedo), each (B, P)."""
    n = torch.clamp(w.sum(1, keepdim=True), min=1.0)
    tpl = template.to(x.dtype)[None, None, :]
    mu = _mean(x, w, n)
    xm = x - mu
    target = tpl * mu
    cit = _solve(_cov(xm, w, n, alpha), target[:, 0])
    normalizer = (target[:, 0] * cit).sum(-1)[:, None]
    r = torch.einsum("bps,bs->bp", x, mu[:, 0]) / (mu[:, 0] * mu[:, 0]).sum(-1)[:, None]
    mf = torch.relu(torch.einsum("bps,bs->bp", xm, cit) / (r * normalizer))
    valid = w > 0
    r = torch.where(valid, r, torch.ones_like(r))
    mf = torch.where(valid, mf, torch.zeros_like(mf))
    for _ in range(num_iter):
        modx = x - (r * mf)[..., None] * target
        mu = _mean(modx, w, n)
        target = tpl * mu
        cit = _solve(_cov(modx - mu, w, n, alpha), target[:, 0])
        normalizer = torch.clamp((target[:, 0] * cit).sum(-1)[:, None], min=1.0)
        regularizer = 1.0 / (r * (mf + EPSILON))
        mf = torch.relu((torch.einsum("bps,bs->bp", x - mu, cit) - regularizer) / (r * normalizer))
        mf = mf * w
    return mf * SCALING, r


def column_blocks(cube, template, valid, *, column_step: int, num_iter: int = 30,
                  alpha: float = 1e-4, dtype=torch.float64):
    """(H, W, S) cube, (S,) template, (H, W) bool valid -> (mf, albedo), each
    (H, W) of ``dtype`` with NODATA at invalid pixels. Blocks of
    ``column_step`` columns, pixel order h-major within a block."""
    h, wd, s = cube.shape
    nb = -(-wd // column_step)
    pad = nb * column_step - wd
    x = torch.nn.functional.pad(cube.to(dtype), (0, 0, 0, pad))
    keep = torch.nn.functional.pad(valid, (0, pad))
    blocks = lambda t: t.reshape(h, nb, column_step, *t.shape[2:]).transpose(0, 1).reshape(  # noqa: E731
        nb, h * column_step, *t.shape[2:])
    xb, wb = blocks(x), blocks(keep).to(dtype)
    xb = torch.where(wb[..., None] > 0, xb, torch.zeros((), dtype=dtype, device=xb.device))
    mf, r = acrwl1mf(xb, torch.as_tensor(template, device=xb.device), wb,
                     num_iter=num_iter, alpha=alpha)
    grid = lambda v: v.reshape(nb, h, column_step).transpose(0, 1).reshape(  # noqa: E731
        h, nb * column_step)[:, :wd]
    fill = torch.tensor(NODATA, dtype=dtype, device=xb.device)
    return torch.where(valid, grid(mf), fill), torch.where(valid, grid(r), fill)
