"""Albedo-corrected reweighted-L1 matched filter (mag1c) in PyTorch.

Counterpart of ``starcop_tpu/ops/mag1c.py``. The plain torch functions here
(``rmf``, ``acrwl1mf``, the SPD-inverse helpers) restate the JAX math on any
device; ``mag1c_column_blocks`` runs a whole scene through the hand-written
CUDA kernels (``ops/mag1c_kernels.py``), with or without a valid mask.

Semantics (pinned against the JAX package and the float64 oracle by
tests/test_torch_mag1c.py):
  * statistics are weighted by a 0/1 validity mask; the covariance
    normaliser is the number of valid pixels;
  * covariance shrinkage ``C <- (1 - alpha) C + alpha diag(C)``;
  * albedo ``R = (x . mu) / (mu . mu)`` computed once; the normaliser is
    clamped to >= 1 inside the iteration loop only;
  * regulariser ``1 / (R (mf + EPSILON))``; ReLU each iteration; final
    scaling by 1e5.
  * the cube is centred once by its initial mean, so every statistic
    accumulates small-magnitude values (f32 stays well-conditioned).

Column blocks: ``block_columns`` cuts an (H, W, S) scene into
(nb, H * step, S) blocks with the pixel order ``p = h * step + j`` (h-major;
the JAX resident route is j-major, ``p = j * H + h``); ``unblock_columns``
inverts it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from starcop_tpu_torch.device import DeviceLike, resolve_device

NODATA = -9999.0
SCALING = 1e5
EPSILON = 1e-9


def block_columns(x: torch.Tensor, nb: int, step: int) -> torch.Tensor:
    """(H, nb * step, S) -> (nb, H * step, S), pixel p = h * step + j."""
    h, w, s = x.shape
    return x.reshape(h, nb, step, s).permute(1, 0, 2, 3).reshape(nb, h * step, s)


def unblock_columns(v: torch.Tensor, h: int, step: int) -> torch.Tensor:
    """(nb, H * step) -> (H, nb * step): the inverse of ``block_columns``."""
    nb = v.shape[0]
    return v.reshape(nb, h, step).permute(1, 0, 2).reshape(h, nb * step)


def _weighted_stats(x: torch.Tensor, weights: Optional[torch.Tensor]):
    """(w, n): w is None when every pixel is valid."""
    if weights is None:
        return None, torch.full((x.shape[0], 1), float(x.shape[1]), dtype=x.dtype,
                                device=x.device)
    w = weights.to(x.dtype)
    return w, torch.clamp(w.sum(1, keepdim=True), min=1.0)


def _weighted_mean(x: torch.Tensor, w, n: torch.Tensor) -> torch.Tensor:
    """x (B, P, S), w (B, P) or None, n (B, 1) -> (B, 1, S)."""
    if w is None:
        return x.mean(1, keepdim=True)
    return torch.einsum("bp,bps->bs", w, x)[:, None, :] / n[..., None]


def _weighted_cov(xm: torch.Tensor, w, n: torch.Tensor) -> torch.Tensor:
    """Second moment of centred data: sum_p w_p xm_p xm_p^T / n, (B, S, S)."""
    xw = xm if w is None else xm * w[..., None]
    return torch.einsum("bps,bpt->bst", xw, xm) / n[..., None]


def _shrink_diag(c: torch.Tensor, alpha: float) -> torch.Tensor:
    """C <- (1 - alpha) C + alpha diag(C)."""
    if alpha == 0.0:
        return c
    return c + alpha * (torch.diag_embed(torch.diagonal(c, dim1=-2, dim2=-1)) - c)


def _cho_solve_vec(c: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve C z = b for SPD C. c (B, S, S), b (B, S) -> (B, S)."""
    return torch.cholesky_solve(b[..., None], torch.linalg.cholesky(c))[..., 0]


def _chol_inv_rec(a: torch.Tensor) -> torch.Tensor:
    """Inverse Cholesky factor L^-1 of SPD ``a`` (n a power of two) by
    Schur-complement recursion: L = [[L1, 0], [W, L2]] with W = A21 L1^-T and
    L2 L2^T = A22 - W W^T, so L^-1 = [[L1^-1, 0], [-L2^-1 W L1^-1, L2^-1]]."""
    n = a.shape[-1]
    if n == 1:
        return 1.0 / torch.sqrt(a)
    if n == 2:
        l11 = torch.sqrt(a[..., 0:1, 0:1])
        l21 = a[..., 1:2, 0:1] / l11
        l22 = torch.sqrt(a[..., 1:2, 1:2] - l21 * l21)
        zero = torch.zeros_like(l11)
        top = torch.cat([1.0 / l11, zero], dim=-1)
        bot = torch.cat([-l21 / (l11 * l22), 1.0 / l22], dim=-1)
        return torch.cat([top, bot], dim=-2)
    h = n // 2
    l1i = _chol_inv_rec(a[..., :h, :h])
    w = a[..., h:, :h] @ l1i.transpose(-1, -2)
    l2i = _chol_inv_rec(a[..., h:, h:] - w @ w.transpose(-1, -2))
    bl = -(l2i @ (w @ l1i))
    top = torch.cat([l1i, torch.zeros_like(w).transpose(-1, -2)], dim=-1)
    bot = torch.cat([bl, l2i], dim=-1)
    return torch.cat([top, bot], dim=-2)


def spd_inverse_recursive(c: torch.Tensor) -> torch.Tensor:
    """SPD inverse by recursive block Cholesky (matmuls only, backward
    stable): embed in the next power-of-two size with an identity pad, take
    L^-1 by ``_chol_inv_rec``, and K = L^-T L^-1, symmetrised.
    c: (..., S, S) -> (..., S, S). Matmuls run at full f32 (TF32 off under
    ``float32_precision``)."""
    s = c.shape[-1]
    n = 1 << (s - 1).bit_length()
    if n != s:
        pad_eye = torch.diag(torch.cat([c.new_zeros(s), c.new_ones(n - s)]))
        c = F.pad(c, (0, n - s, 0, n - s)) + pad_eye
    li = _chol_inv_rec(c)
    k = li.transpose(-1, -2) @ li
    k = 0.5 * (k + k.transpose(-1, -2))
    return k[..., :s, :s]


def rmf(
    x: torch.Tensor,
    template: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
    *,
    alpha: float = 0.0,
    zero_override: bool = False,
    albedo_override: bool = False,
    apply_scaling: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-pass matched filter. x (B, P, S), template (S,), weights
    (B, P) 0/1 or None -> (mf, R), each (B, P, 1)."""
    w, n = _weighted_stats(x, weights)
    mu0 = _weighted_mean(x, w, n)
    mf, r = _rmf_core(x - mu0, mu0, template.to(x.dtype), w, n, alpha=alpha,
                      zero_override=zero_override, albedo_override=albedo_override)
    return (mf * SCALING if apply_scaling else mf), r


def _rmf_core(xc, mu0, template, w, n, *, alpha, zero_override, albedo_override):
    """Single-pass matched filter on the cube centred by ``mu0``."""
    tpl = template[None, None, :]
    delta = _weighted_mean(xc, w, n)  # residual mean of xc (~0)
    mu = mu0 + delta
    target = tpl * mu
    x_minus_mu = xc - delta

    c = _shrink_diag(_weighted_cov(x_minus_mu, w, n), alpha)
    cit = _cho_solve_vec(c, target[:, 0, :])[:, :, None]  # (B, S, 1)
    normalizer = torch.einsum("bs,bso->bo", target[:, 0, :], cit)[:, None, :]

    if albedo_override:
        r = torch.ones(xc.shape[:2] + (1,), dtype=xc.dtype, device=xc.device)
    else:
        # R = (x . mu) / (mu . mu) with x = xc + mu0.
        num = torch.einsum("bps,bs->bp", xc, mu[:, 0, :]) + torch.einsum(
            "bs,bs->b", mu0[:, 0, :], mu[:, 0, :])[:, None]
        r = num[..., None] / torch.einsum("bs,bs->b", mu[:, 0, :], mu[:, 0, :])[:, None, None]

    mf = torch.einsum("bps,bso->bpo", x_minus_mu, cit) / (r * normalizer)
    if not zero_override:
        mf = torch.relu(mf)
    return mf, r


def acrwl1mf(
    x: torch.Tensor,
    template: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
    *,
    num_iter: int = 30,
    albedo_override: bool = False,
    zero_override: bool = False,
    sparse_override: bool = False,
    covariance_update_scaling: float = 1.0,
    alpha: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Albedo-corrected reweighted-L1 matched filter, plain torch.

    x (B, P, S) radiance, template (S,), weights (B, P) 0/1 or None.
    Returns (mf scaled by 1e5, R), each (B, P, 1).
    """
    w, n = _weighted_stats(x, weights)
    template = template.to(x.dtype)
    tpl = template[None, None, :]
    w3 = None if w is None else w[..., None]

    mu0 = _weighted_mean(x, w, n)
    xc = x - mu0
    mf, r = _rmf_core(xc, mu0, template, w, n, alpha=alpha,
                      zero_override=zero_override, albedo_override=albedo_override)
    if w3 is not None:
        # Invalid pixels may carry R == 0 (zero-filled padding): pin R = 1 and
        # mf = 0 there so 1/R never injects inf/NaN into the statistics.
        r = torch.where(w3 > 0, r, torch.ones_like(r))
        mf = torch.where(w3 > 0, mf, torch.zeros_like(mf)) * w3

    target = tpl * (mu0 + _weighted_mean(xc, w, n))
    for _ in range(num_iter):
        # Remove current detections from the background estimate (centred
        # coordinates: modx - mu == (xc - corr) - dmu with mu = mu0 + dmu).
        modxc = xc - covariance_update_scaling * r * mf * target
        dmu = _weighted_mean(modxc, w, n)
        target = tpl * (mu0 + dmu)
        c = _shrink_diag(_weighted_cov(modxc - dmu, w, n), alpha)
        cit = _cho_solve_vec(c, target[:, 0, :])[:, :, None]
        if sparse_override:
            regularizer = torch.zeros_like(mf)
        else:
            regularizer = 1.0 / (r * (mf + EPSILON))
        normalizer = torch.clamp(
            torch.einsum("bs,bso->bo", target[:, 0, :], cit)[:, None, :], min=1.0)
        mf = (torch.einsum("bps,bso->bpo", xc - dmu, cit) - regularizer) / (r * normalizer)
        if not zero_override:
            mf = torch.relu(mf)
        if w3 is not None:
            mf = mf * w3
    return mf * SCALING, r


def mag1c_column_blocks(
    scene,
    template,
    valid_mask=None,
    *,
    column_step: int = 2,
    num_iter: int = 30,
    alpha: float = 1e-4,
    fill_value: float = NODATA,
    device: DeviceLike = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Matched filter over an (H, W, S) scene in ``column_step``-wide blocks.

    Each block of columns keeps its own statistics (a pushbroom sensor's
    detector columns differ), so the batch axis is columns, not tiles.

    Routes (the hand-written CUDA kernels on the card, their plain twins on
    the CPU, the same sequence on both):
      * no mask and ``W % column_step == 0``: the resident route,
        ``acrwl1mf_resident``;
      * a mask or a ragged last block (every served granule): the weighted
        route, ``acrwl1mf_masked``. The mask goes to the kernels as it is;
        no padded or zeroed copy of the cube is made.

    Returns (mf, albedo) as (H, W) float32 tensors on the device, with
    ``fill_value`` at invalid pixels.
    """
    from starcop_tpu_torch.ops.mag1c_kernels import acrwl1mf_masked, acrwl1mf_resident

    dev = resolve_device(device)
    h, w_dim, s = scene.shape
    step = int(column_step) if column_step else w_dim
    nb = -(-w_dim // step)
    x = torch.as_tensor(scene, dtype=torch.float32, device=dev)
    tpl = torch.as_tensor(template, dtype=torch.float32, device=dev)

    if valid_mask is None and nb * step == w_dim:
        mf, albedo = acrwl1mf_resident(x, tpl, nb, step, num_iter=num_iter, alpha=alpha,
                                       device=dev)
        return unblock_columns(mf, h, step), unblock_columns(albedo, h, step)

    valid = (torch.ones((h, w_dim), dtype=torch.bool, device=dev) if valid_mask is None
             else torch.as_tensor(valid_mask, dtype=torch.bool, device=dev))
    mf, albedo = acrwl1mf_masked(x, tpl, valid, nb, step, num_iter=num_iter, alpha=alpha,
                                 device=dev)
    mf2 = unblock_columns(mf, h, step)[:, :w_dim]
    albedo2 = unblock_columns(albedo, h, step)[:, :w_dim]
    return torch.where(valid, mf2, fill_value), torch.where(valid, albedo2, fill_value)


def reference_oracle_acrwl1mf(
    x: np.ndarray,
    template: np.ndarray,
    num_iter: int = 30,
    covariance_update_scaling: float = 1.0,
    alpha: float = 0.0,
):
    """Float64 numpy restatement of the reference matched-filter math (Foote
    et al., IEEE TGRS 2020): the judge for every route. x (B, P, S) ->
    (mf scaled by 1e5, R), each (B, P, 1)."""
    x = np.asarray(x, dtype=np.float64)
    template = np.asarray(template, dtype=np.float64)
    b, p, s = x.shape
    tpl = template[None, None, :]

    def stats(v):
        mu = v.mean(axis=1, keepdims=True)
        vm = v - mu
        c = np.einsum("bps,bpt->bst", vm, vm) / p
        c = (1 - alpha) * c + alpha * np.eye(s)[None] * np.diagonal(c, axis1=1, axis2=2)[:, None, :]
        return mu, c

    mu, c = stats(x)
    target = tpl * mu
    cit = np.linalg.solve(c, target[:, 0, :, None])
    normalizer = np.einsum("bs,bso->bo", target[:, 0, :], cit)[:, None, :]
    r = np.einsum("bps,bs->bp", x, mu[:, 0, :])[..., None] / np.einsum(
        "bs,bs->b", mu[:, 0, :], mu[:, 0, :])[:, None, None]
    mf = np.maximum(np.einsum("bps,bso->bpo", x - mu, cit) / (r * normalizer), 0.0)

    target = tpl * x.mean(axis=1, keepdims=True)
    for _ in range(num_iter):
        modx = x - covariance_update_scaling * r * mf * target
        mu, c = stats(modx)
        target = tpl * mu
        cit = np.linalg.solve(c, target[:, 0, :, None])
        regularizer = 1.0 / (r * (mf + EPSILON))
        normalizer = np.maximum(np.einsum("bs,bso->bo", target[:, 0, :], cit)[:, None, :], 1.0)
        mf = np.maximum(
            (np.einsum("bps,bso->bpo", x - mu, cit) - regularizer) / (r * normalizer), 0.0)
    return mf * SCALING, r
