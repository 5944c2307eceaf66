"""The matched filter's hand-written CUDA kernels and their plain twins.

Counterpart of ``starcop_tpu/ops/mag1c_pallas.py`` for two routes.

The unmasked route, ``acrwl1mf_resident_swh`` (:1413), whose two Pallas
kernels become three CUDA kernels in ``csrc/mag1c.cu``:

  ``init_stats``    <- ``_init_stats_swh_kernel`` (:1332): per column block
                       the mean m0 and the centred covariance C0.
  ``filter_round``  <- the streaming part of ``_resident_swh_kernel`` (:1361)
                       / ``_resident_filter_body`` (:1103): one pass over
                       the cube per iteration.
  ``filter_glue``   <- the Woodbury glue ``_glue_math`` (:776) that the TPU
                       kernel runs in VMEM between iterations.

The masked route, every served granule: ``acrwl1mf_fused(glue="fused")``
with a weight row (:1885-1921, kernels built by ``_make_round_calls``
:1543). Its pixels are those of a valid mask, and its last column block may
be ragged (W not a multiple of step):

  ``init_stats_masked``    <- the XLA einsum of the weighted statistics
                              (:1790-1824), n = the block's valid count
                              clamped to >= 1.
  ``filter_round_masked``  <- ``_first_round_kernel`` (:594) in mode FIRST,
                              ``_loop_round_kernel`` (:664) in LOOP / FINAL.
  ``filter_glue``          <- their last-tile ``_glue_body``, with n per block.

A pixel that does not count (invalid, or a column past W) contributes
xc = 0 by a select, never a multiply (the fill value -9999 and NaN must
never reach a sum), and ends with mf = 0 and R = 1 (:2039-2040).

The TPU kernels hold a column block in VMEM; an SM has 228 KB of shared
memory, so here each iteration streams the cube once (see csrc/mag1c.cu for
the design). One filter is 1 ``init_stats[_masked]``, ``num_iter + 1``
``filter_round[_masked]`` passes and ``num_iter`` ``filter_glue`` launches.

Each wrapper runs its plain torch twin for CPU tensors and otherwise
launches its kernel (counted in ``LAUNCH_COUNTS``); the op refuses anything
but CUDA tensors, and there is no fallback from a failed launch.
``_woodbury_base`` and the per-block valid counts are plain torch on both
routes (they were XLA in JAX), one definition each, so the routes cannot
drift. The twins compute in the dtype they are given, so the same code runs
as a float64 judge.

Layouts: the scene is the (H, W, S) cube and the valid mask (H, W); per-pixel
rows mf and R are (nb, P), P = H * step, with ``p = h * step + j``
(``ops.mag1c.block_columns``); the carry is (nb, 4, S) = [mu | target | cit |
norm in every entry of row 3].
"""

from __future__ import annotations

import functools
import threading
from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F

from starcop_tpu_torch.device import DeviceLike, float32_precision, resolve_device
from starcop_tpu_torch.ops.mag1c import (
    EPSILON,
    SCALING,
    _shrink_diag,
    block_columns,
    spd_inverse_recursive,
)

FIRST, LOOP, FINAL = 0, 1, 2
INIT_CHUNK = 2048   # pixels of one block per init_stats CTA
ROUND_CHUNK = 1024  # pixels of one block per filter_round CTA

# filter_round_masked counts its FIRST launches (row 5 of the TPU kernel
# table) apart from its LOOP and FINAL ones (row 6).
LAUNCH_COUNTS: Dict[str, int] = {
    "init_stats": 0, "filter_round": 0, "filter_glue": 0,
    "init_stats_masked": 0, "filter_round_masked_first": 0, "filter_round_masked_loop": 0,
}
_COUNT_LOCK = threading.Lock()


def reset_launch_counts() -> None:
    with _COUNT_LOCK:
        for name in LAUNCH_COUNTS:
            LAUNCH_COUNTS[name] = 0


def _count(name: str) -> None:
    with _COUNT_LOCK:
        LAUNCH_COUNTS[name] += 1


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _kernels():
    from starcop_tpu_torch.ops import _build

    return _build.load()


def _mask_u8(valid: torch.Tensor) -> torch.Tensor:
    """The (H, W) valid mask as the kernels take it: uint8, contiguous (a
    bool mask is viewed, not copied)."""
    valid = valid.contiguous()
    return valid.view(torch.uint8) if valid.dtype == torch.bool else valid.to(torch.uint8)


# ---------------------------------------------------------------------------
# Glue that JAX leaves to XLA: plain torch on both routes
# ---------------------------------------------------------------------------


def _k0_solve_refined(k0, c0, tgt0):
    """cit0 = C0^-1 tgt0 via the inverse K0 plus one step of iterative
    refinement, cit += K0 (tgt0 - C0 cit)."""
    cit = torch.einsum("bst,bt->bs", k0, tgt0)
    resid = tgt0 - torch.einsum("bst,bt->bs", c0, cit)
    return cit + torch.einsum("bst,bt->bs", k0, resid)


def _woodbury_base(c0, m0, template, alpha):
    """Once per filter: shrink C0's diagonal, invert it (``spd_inverse_recursive``)
    and derive the initial target, cit and the unclamped norm.
    c0 (nb, S, S), m0 (nb, S) -> (k0, tgt0, cit0, norm0). A block with no
    valid pixel (C0 = 0) gets NaN here; its pixels never read it."""
    c0s = _shrink_diag(c0, alpha)
    k0 = spd_inverse_recursive(c0s)
    tgt0 = template[None, :] * m0
    cit0 = _k0_solve_refined(k0, c0s, tgt0)
    norm0 = torch.einsum("bs,bs->b", tgt0, cit0)
    return k0, tgt0, cit0, norm0


def block_valid_counts(valid: torch.Tensor, nb: int, step: int) -> torch.Tensor:
    """Valid pixels per column block of an (H, W) mask, (nb,) int64; the
    ragged last block counts only its columns below W."""
    cols = valid.to(torch.int64).sum(0)
    return F.pad(cols, (0, nb * step - cols.shape[0])).reshape(nb, step).sum(1)


def pack_carry(tgt0, cit0, norm0):
    """The first round's carry: mu = 0, target0, cit0, norm0 (unclamped)."""
    nb, s = tgt0.shape
    carry = tgt0.new_zeros((nb, 4, s))
    carry[:, 1] = tgt0
    carry[:, 2] = cit0
    carry[:, 3] = norm0[:, None]
    return carry


# ---------------------------------------------------------------------------
# Plain twins: step-by-step torch restatements of the kernels
# ---------------------------------------------------------------------------


def init_stats_plain(x: torch.Tensor, nb: int, step: int):
    """Per-block mean and centred covariance. x (H, W, S) -> m0 (nb, S),
    c0 (nb, S, S) = xc^T xc / n."""
    xb = block_columns(x, nb, step)
    m0 = xb.mean(1)
    xc = xb - m0[:, None, :]
    return m0, torch.einsum("bps,bpt->bst", xc, xc) / xb.shape[1]


def _masked_blocks(x: torch.Tensor, valid: torch.Tensor, nb: int, step: int):
    """The cube as (nb, P, S) blocks with 0 selected at the pixels that do
    not count, and the (nb, P) bool rows of those that do (the valid mask,
    False past W). Pads a copy of the cube to nb * step columns: twins only."""
    pad = nb * step - x.shape[1]
    keep = F.pad(valid.to(torch.uint8), (0, pad)).bool()
    keep = block_columns(keep[..., None], nb, step)[..., 0]
    xb = block_columns(F.pad(x, (0, 0, 0, pad)), nb, step)
    return torch.where(keep[..., None], xb, 0.0), keep


def init_stats_masked_plain(x: torch.Tensor, valid: torch.Tensor, nb: int, step: int):
    """The weighted statistics (mag1c_pallas.py:1790-1824) over the valid
    pixels of each block: m0 = sum x / n, c0 = xc^T xc / n with xc = x - m0
    selected to 0 elsewhere, n = the valid count clamped to >= 1 (a block
    with none gets m0 = 0, c0 = 0). x (H, W, S), valid (H, W)."""
    xb, keep = _masked_blocks(x, valid, nb, step)
    n = keep.sum(1, keepdim=True).clamp(min=1).to(x.dtype)
    m0 = xb.sum(1) / n
    xc = torch.where(keep[..., None], xb - m0[:, None, :], 0.0)
    return m0, torch.einsum("bps,bpt->bst", xc, xc) / n[..., None]


def _round_math(xc, m0, carry, r, mf_prev, *, mode, cov_scale, keep=None):
    """One pass on the centred blocks xc (nb, P, S); ``keep`` (nb, P) bool
    selects mf = 0 and R = 1 at the pixels that do not count."""
    mu, cit, norm = carry[:, 0], carry[:, 2], carry[:, 3, :1]
    proj = torch.einsum("bps,bs->bp", xc, cit) - (cit * mu).sum(1, keepdim=True)
    if mode == FIRST:
        q = torch.einsum("bps,bs->bp", xc, m0)
        r = q / (m0 * m0).sum(1, keepdim=True) + 1.0
        if keep is not None:
            r = torch.where(keep, r, 1.0)
        mf = torch.clamp(proj / (r * norm), min=0.0)
    else:
        regularizer = 1.0 / (r * (mf_prev + EPSILON))
        mf = torch.clamp((proj - regularizer) / (r * norm), min=0.0)
    if keep is not None:
        mf = torch.where(keep, mf, 0.0)
    if mode == FINAL:
        return mf * SCALING, r, None
    g = cov_scale * (r * mf)
    u = torch.einsum("bps,bp->bs", xc, g)
    stats = torch.cat([u, g.sum(1, keepdim=True), (g * g).sum(1, keepdim=True)], dim=1)
    return mf, r, stats[:, None, :]


def filter_round_plain(x, nb, step, m0, carry, r, mf_prev, *, mode, cov_scale=1.0):
    """One pass of ``_resident_filter_body``: the mf update for every pixel,
    and the statistics of g = cov_scale R mf for the glue.

    FIRST is the rmf init (R from the cube, mu = 0, unclamped norm0, no
    regulariser); LOOP applies the regulariser and the carry's clamped norm;
    FINAL is the mf-only pass, scaled by 1e5. Returns (mf, R, stats) with
    stats (nb, 1, S + 2) = [u = sum xc g | sum g | sum g^2] (None in FINAL).
    """
    xc = block_columns(x, nb, step) - m0[:, None, :]
    return _round_math(xc, m0, carry, r, mf_prev, mode=mode, cov_scale=cov_scale)


def filter_round_masked_plain(x, valid, nb, step, m0, carry, r, mf_prev, *, mode,
                              cov_scale=1.0):
    """One pass of the weighted filter: FIRST <- ``_first_round_kernel``
    (R = q/(m0.m0) + 1, mf0 times the weight), LOOP / FINAL <-
    ``_loop_round_kernel`` (the regulariser, mf times the weight), as
    ``filter_round_plain`` with xc = x - m0 selected to 0, mf to 0 and R to
    1 at the pixels that do not count. x (H, W, S), valid (H, W)."""
    xb, keep = _masked_blocks(x, valid, nb, step)
    xc = torch.where(keep[..., None], xb - m0[:, None, :], 0.0)
    return _round_math(xc, m0, carry, r, mf_prev, mode=mode, cov_scale=cov_scale, keep=keep)


def _k0_matvec(k0, v):
    """Row sums of K0 * v (exact in the working dtype, no TF32)."""
    return (k0 * v[:, None, :]).sum(-1)


def filter_glue_plain(stats, carry, m0, template, k0, *, n, alpha):
    """``_glue_math``: the rank-2 Woodbury update of (mu, target, cit, norm)
    from the round's statistics, summed over their chunk axis. ``n`` is the
    pixel count of every block (a number) or of each block ((nb,))."""
    s = m0.shape[1]
    tot = stats.sum(1)
    nin = (1.0 / torch.as_tensor(n, dtype=stats.dtype, device=stats.device)).reshape(-1, 1)
    u = tot[:, :s] * nin
    gbar = tot[:, s:s + 1] * nin
    beta = tot[:, s + 1:s + 2] * nin - gbar * gbar
    target = carry[:, 1]
    mu_new = -target * gbar
    target_new = template[None, :] * (m0 + mu_new)
    w_t = _k0_matvec(k0, target)
    w_u = _k0_matvec(k0, u)
    dot = lambda a, b: (a * b).sum(1, keepdim=True)  # noqa: E731
    sa = 1.0 - alpha
    i00 = dot(target, w_t)
    i01 = dot(target, w_u) - 1.0 / sa
    i10 = dot(u, w_t) - 1.0 / sa
    i11 = dot(u, w_u) - beta / sa
    det = i00 * i11 - i01 * i10

    def a0inv(v):
        y0, y1 = dot(w_t, v), dot(w_u, v)
        x0 = (i11 * y0 - i01 * y1) / det
        x1 = (-i10 * y0 + i00 * y1) / det
        return _k0_matvec(k0, v) - w_t * x0 - w_u * x1

    z = a0inv(target_new)
    if alpha:
        d = beta * target * target - 2.0 * target * u
        z = z - a0inv(alpha * d * z)
    norm_new = torch.clamp(dot(target_new, z), min=1.0)
    return torch.stack([mu_new, target_new, z, norm_new.expand(-1, s)], dim=1)


# ---------------------------------------------------------------------------
# Kernel wrappers: CPU tensors run the twin, anything else launches the kernel
# ---------------------------------------------------------------------------


def _launch_init(op, args, x, nb, step):
    h, _, s = x.shape
    nchunks = -(-h * step // INIT_CHUNK)
    partial = torch.empty((nb, nchunks, 1 + s + s * s), dtype=torch.float32, device=x.device)
    m0 = torch.empty((nb, s), dtype=torch.float32, device=x.device)
    c0 = torch.empty((nb, s, s), dtype=torch.float32, device=x.device)
    op(*args, partial, m0, c0, nb, step, INIT_CHUNK, _stream(x))
    return m0, c0


def init_stats(x: torch.Tensor, nb: int, step: int):
    """m0 (nb, S), c0 (nb, S, S) of the (H, W, S) cube's column blocks."""
    if x.device.type == "cpu":
        return init_stats_plain(x, nb, step)
    out = _launch_init(_kernels().init_stats, (x,), x, nb, step)
    _count("init_stats")
    return out


def init_stats_masked(x: torch.Tensor, valid: torch.Tensor, nb: int, step: int):
    """m0 (nb, S), c0 (nb, S, S) over the valid pixels of each column block
    of the (H, W, S) cube; see ``init_stats_masked_plain``."""
    if x.device.type == "cpu":
        return init_stats_masked_plain(x, valid, nb, step)
    out = _launch_init(_kernels().init_stats_masked, (x, _mask_u8(valid)), x, nb, step)
    _count("init_stats_masked")
    return out


def _launch_round(op, args, x, nb, step, m0, carry, r, mf_prev, mode, cov_scale):
    h, _, s = x.shape
    p = h * step
    nchunks = -(-p // ROUND_CHUNK)
    mf = torch.empty((nb, p), dtype=torch.float32, device=x.device)
    if mode == FIRST:
        r = torch.empty_like(mf)
        mf_prev = mf  # not read in the first round
    stats = torch.empty((nb, nchunks, s + 2), dtype=torch.float32, device=x.device)
    op(mode, *args, m0, carry, r, mf_prev, mf, stats, nb, step, ROUND_CHUNK, float(cov_scale),
       _stream(x))
    return mf, r, (None if mode == FINAL else stats)


def filter_round(x, nb, step, m0, carry, r, mf_prev, *, mode, cov_scale=1.0):
    """One streaming pass; see ``filter_round_plain``. On CUDA the stats
    come back per pixel chunk, (nb, nchunks, S + 2)."""
    if x.device.type == "cpu":
        return filter_round_plain(x, nb, step, m0, carry, r, mf_prev, mode=mode,
                                  cov_scale=cov_scale)
    out = _launch_round(_kernels().filter_round, (x,), x, nb, step, m0, carry, r, mf_prev,
                        mode, cov_scale)
    _count("filter_round")
    return out


def filter_round_masked(x, valid, nb, step, m0, carry, r, mf_prev, *, mode, cov_scale=1.0):
    """One streaming pass of the weighted filter; see
    ``filter_round_masked_plain``. On CUDA the stats come back per pixel
    chunk, (nb, nchunks, S + 2)."""
    if x.device.type == "cpu":
        return filter_round_masked_plain(x, valid, nb, step, m0, carry, r, mf_prev, mode=mode,
                                         cov_scale=cov_scale)
    out = _launch_round(_kernels().filter_round_masked, (x, _mask_u8(valid)), x, nb, step, m0,
                        carry, r, mf_prev, mode, cov_scale)
    _count("filter_round_masked_first" if mode == FIRST else "filter_round_masked_loop")
    return out


def filter_glue(stats, carry, m0, template, k0, *, n, alpha):
    """The next carry from a round's statistics; see ``filter_glue_plain``."""
    if stats.device.type == "cpu":
        return filter_glue_plain(stats, carry, m0, template, k0, n=n, alpha=alpha)
    # 1/n made on the device (a host scalar copied in would sync the stream).
    nin = (1.0 / n.float() if torch.is_tensor(n)
           else torch.full((m0.shape[0],), 1.0 / n, dtype=torch.float32, device=stats.device))
    out = torch.empty_like(carry)
    _kernels().filter_glue(stats, carry, out, m0, template, k0, nin.contiguous(), float(alpha),
                           _stream(stats))
    _count("filter_glue")
    return out


# ---------------------------------------------------------------------------
# The filter
# ---------------------------------------------------------------------------


def _filter_sequence(rnd: Callable, glue_fn: Callable, m0, k0, tgt0, cit0, norm0, template,
                     n, *, num_iter, alpha):
    """rmf init + num_iter - 1 reweighting rounds, each followed by the glue,
    then the final mf-only pass (the reference's order: stats then mf,
    num_iter times). ``rnd(carry, r, mf_prev, mode=...)`` is one pass (kernel
    wrapper or plain twin, bound to its cube); ``glue_fn`` is
    ``filter_glue`` or its twin; ``n`` the pixel count per block."""
    glue = functools.partial(glue_fn, m0=m0, template=template, k0=k0, n=n, alpha=alpha)
    carry = pack_carry(tgt0, cit0, norm0)
    mf, r, stats = rnd(carry, None, None, mode=FIRST)
    carry = glue(stats, carry)
    for _ in range(num_iter - 1):
        mf, _, stats = rnd(carry, r, mf, mode=LOOP)
        carry = glue(stats, carry)
    mf, _, _ = rnd(carry, r, mf, mode=FINAL)
    return mf, r


def _check_num_iter(num_iter: int) -> None:
    if num_iter < 1:
        # The kernel route always ends with one mf pass after the statistics.
        raise ValueError("num_iter must be >= 1 (use ops.mag1c.acrwl1mf for "
                         "the num_iter=0 rmf-only result)")


def resident_filter_plain(x, nb, step, m0, k0, tgt0, cit0, norm0, template, *,
                          num_iter: int = 30, alpha: float = 0.0, cov_scale: float = 1.0):
    """The whole filter from the Woodbury base with the plain twins, on any
    device and in the dtype of its inputs. Returns (mf scaled by 1e5, R),
    each (nb, P)."""
    _check_num_iter(num_iter)
    rnd = functools.partial(filter_round_plain, x, nb, step, m0, cov_scale=cov_scale)
    return _filter_sequence(rnd, filter_glue_plain, m0, k0, tgt0, cit0, norm0, template,
                            x.shape[0] * step, num_iter=num_iter, alpha=alpha)


def masked_filter_plain(x, valid, nb, step, m0, k0, tgt0, cit0, norm0, template, *,
                        num_iter: int = 30, alpha: float = 0.0, cov_scale: float = 1.0):
    """The whole weighted filter from the Woodbury base with the plain
    twins, on any device and in the dtype of its inputs. Returns (mf scaled
    by 1e5, R), each (nb, P)."""
    _check_num_iter(num_iter)
    rnd = functools.partial(filter_round_masked_plain, x, valid, nb, step, m0,
                            cov_scale=cov_scale)
    n = block_valid_counts(valid, nb, step).clamp(min=1).to(x.dtype)
    return _filter_sequence(rnd, filter_glue_plain, m0, k0, tgt0, cit0, norm0, template, n,
                            num_iter=num_iter, alpha=alpha)


def acrwl1mf_resident(
    scene_hws,
    template,
    nb: int,
    step: int,
    *,
    num_iter: int = 30,
    alpha: float = 0.0,
    covariance_update_scaling: float = 1.0,
    device: DeviceLike = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full matched filter over the (H, nb * step, S) cube, every pixel valid.

    On CUDA every step is a hand-written kernel (plus the plain-torch
    Woodbury base); on the CPU the plain twins run the same sequence.
    Returns (mf scaled by 1e5, R) as (nb, H * step) rows in the order
    p = h * step + j (``ops.mag1c.unblock_columns`` maps them to (H, W)).
    """
    _check_num_iter(num_iter)
    dev = resolve_device(device)
    x = torch.as_tensor(scene_hws, dtype=torch.float32, device=dev).contiguous()
    tpl = torch.as_tensor(template, dtype=torch.float32, device=dev)
    if x.shape[1] != nb * step:
        raise ValueError("scene width must equal nb*step")
    with float32_precision():
        m0, c0 = init_stats(x, nb, step)
        k0, tgt0, cit0, norm0 = _woodbury_base(c0, m0, tpl, alpha)
        rnd = functools.partial(filter_round, x, nb, step, m0,
                                cov_scale=covariance_update_scaling)
        return _filter_sequence(rnd, filter_glue, m0, k0.contiguous(), tgt0, cit0, norm0, tpl,
                                x.shape[0] * step, num_iter=num_iter, alpha=alpha)


def acrwl1mf_masked(
    scene_hws,
    template,
    valid_mask,
    nb: int,
    step: int,
    *,
    num_iter: int = 30,
    alpha: float = 0.0,
    covariance_update_scaling: float = 1.0,
    device: DeviceLike = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full weighted matched filter over the (H, W, S) cube and its (H, W)
    valid mask, in ``nb`` blocks of ``step`` columns, the last one ragged
    when W < nb * step (``acrwl1mf_fused(glue="fused")`` with a weight row).

    On CUDA: ``init_stats_masked``, then ``filter_round_masked`` and
    ``filter_glue`` with the per-block valid counts (plus the plain-torch
    Woodbury base); on the CPU the plain twins run the same sequence.
    Neither pads nor zeroes a copy of the cube. Returns (mf scaled by 1e5,
    R) as (nb, H * step) rows, with mf = 0 and R = 1 at the pixels that do
    not count; a block with no valid pixel never raises.
    """
    _check_num_iter(num_iter)
    dev = resolve_device(device)
    x = torch.as_tensor(scene_hws, dtype=torch.float32, device=dev).contiguous()
    tpl = torch.as_tensor(template, dtype=torch.float32, device=dev)
    valid = _mask_u8(torch.as_tensor(valid_mask, device=dev))
    if valid.shape != x.shape[:2] or not (nb - 1) * step < x.shape[1] <= nb * step:
        raise ValueError(f"valid mask {tuple(valid.shape)} and {nb} blocks of {step} columns "
                         f"do not fit the cube {tuple(x.shape)}")
    with float32_precision():
        n = block_valid_counts(valid, nb, step).clamp(min=1).to(torch.float32)
        m0, c0 = init_stats_masked(x, valid, nb, step)
        k0, tgt0, cit0, norm0 = _woodbury_base(c0, m0, tpl, alpha)
        rnd = functools.partial(filter_round_masked, x, valid, nb, step, m0,
                                cov_scale=covariance_update_scaling)
        return _filter_sequence(rnd, filter_glue, m0, k0.contiguous(), tgt0, cit0, norm0, tpl,
                                n, num_iter=num_iter, alpha=alpha)
