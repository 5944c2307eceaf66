"""``acrwl1mf_fused``: the matched filter with every glue and both layouts.

Counterpart of ``starcop_tpu/ops/mag1c_pallas.py:acrwl1mf_fused`` (:1613):
the same (B, P, S) or (B, S, P) contract, the same returns, one route per
``glue``. On the card each route launches the kernels of
``ops/mag1c_kernels.py`` (``csrc/mag1c.cu``, ``csrc/mag1c_fused.cu``); on the
CPU the same call sequence runs their plain twins.

  glue       kernels (TPU rows of mag1c_pallas.py)
  fused      ``filter_round_bsp`` + ``filter_glue`` (rows 5-6); a (B, P)
             weight row is the kernels' (H, W) mask with H = 1, W = B * P
  resident   ``filter_round_bsp`` + ``filter_glue`` (row 9)
  mono       ``filter_round_mono`` (rows 7-8): the glue inside the round
  woodbury   ``fused_iter`` WOODBURY (row 4) + ``filter_glue``
  cholesky   ``fused_iter`` CHOLESKY (row 4) + the Cholesky glue in torch

A (B, S, P) stream (``x_layout="bsp"``) takes m0 and C0 from
``init_stats_stream`` (row 10) for every glue. A raw f32 stream is centred
in the kernels (JAX's centered=False); a bf16 stream is centred once on the
card, as JAX's XLA does (:1706, :1754). What JAX leaves to XLA is plain
torch here, under ``float32_precision``: the centre-select-transpose of a
(B, P, S) input and its m0 and c0 (summed in f64, :1792-1798, :1814-1826),
R and mf0 (:1923-1927), the Woodbury base, and the Cholesky glue
(:1965-1971) with the normaliser clamp (:2017-2020).

Intended deviations: ``tile_p`` is accepted and unused (the TPU's
lane-aligned tile refusals, :1718-1720, :1738-1743, :1848-1850, are not
copied); pixels that a weight excludes are selected out, never multiplied
(:1789, :1796); an unknown ``glue`` or ``x_layout`` raises.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from starcop_tpu_torch.device import DeviceLike, float32_precision, resolve_device
from starcop_tpu_torch.ops.mag1c import SCALING, _shrink_diag, is_bf16_stream
from starcop_tpu_torch.ops.mag1c_kernels import (
    FINAL,
    FIRST,
    LOOP,
    _check_num_iter,
    _filter_sequence,
    _woodbury_base,
    filter_glue,
    filter_round_bsp,
    filter_round_mono,
    fused_iter,
    init_stats_stream,
    mono_counters,
    mono_geometry,
    pack_carry,
    stream_geometry,
    stream_stats_geometry_for,
    stream_rows,
)

GLUES = ("fused", "resident", "mono", "woodbury", "cholesky")
DEFAULT_TILE_P = 13824  # JAX's default pixel tile (mag1c_pallas.py:64); unused here
RMF_SLAB = 8192  # pixels per slab of the rmf init's product


def _cho_solve(c: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C^-1 b for SPD C (B, S, S), b (B, S), by a Cholesky factor that does
    not wait for the device (``cholesky_ex``: no error check)."""
    factor = torch.linalg.cholesky_ex(c).L
    return torch.cholesky_solve(b[..., None], factor)[..., 0]


def _second_moment(xc, n):
    """c0 = xc xc^T / n (B, S, S) of the centred stream xc (B, S, P), summed in
    f64 and rounded to f32: a plain f32 sum over a 69,120-pixel block drifts
    the 30-iteration filter to correlation 0.99935 with its f64 twin (see
    PERF.md)."""
    x64 = xc.double()
    return (torch.einsum("bsp,btp->bst", x64, x64) / n[:, None, None]).float()


def _rmf_init(xs, m0, cit0, norm0, center):
    """R and mf0 of the fused_iter glues (:1923-1927) from one product of the
    rows [cit0; m0] with the centred stream: R = (x - m0).m0 / m0.m0 + 1,
    mf0 = relu(cit0.(x - m0) / (R norm0)). It runs RMF_SLAB pixels at a
    time, each slab widened to m0's dtype and centred (``center``: a raw
    stream) on its own, so no centred or widened copy of the whole stream
    is made. (The product with the raw stream, less [cit0; m0].m0, would
    cancel in f32.)"""
    s = m0.shape[1]
    a2 = torch.stack([cit0, m0], dim=1)
    slabs = []
    for a in range(0, xs.shape[2], RMF_SLAB):
        xc = xs[:, :s, a:a + RMF_SLAB].to(m0.dtype)
        if center:
            xc = xc - m0[..., None]
        slabs.append(torch.einsum("bks,bsp->bkp", a2, xc))
    p2 = torch.cat(slabs, dim=2)
    r = p2[:, 1] / (m0 * m0).sum(1, keepdim=True) + 1.0
    return torch.clamp(p2[:, 0] / (r * norm0[:, None]), min=0.0), r


def _cholesky_glue(mean, cov, m0, template, alpha):
    """JAX's ``glue_cholesky`` (:1965-1971) and the normaliser clamp
    (:2017-2020) from the mean and centred covariance of modx: the next carry
    [mu | target | cit | norm]."""
    target = template[None, :] * (mean + m0)
    cit = _cho_solve(_shrink_diag(cov, alpha), target)
    norm = torch.clamp((target * cit).sum(1, keepdim=True), min=1.0)
    return torch.stack([mean, target, cit, norm.expand(-1, m0.shape[1])], dim=1)


def _mono_filter(xs, m0, k0, tgt0, cit0, norm0, template, n, *, num_iter, alpha, cov_scale,
                 center):
    """glue="mono": num_iter + 1 ``filter_round_mono`` launches, FIRST, LOOP
    ... and FINAL, each (FINAL aside) with its glue, sharing one set of
    block counters. Returns (mf * 1e5, R)."""
    rnd = functools.partial(filter_round_mono, xs, m0, template=template, k0=k0, n=n,
                            alpha=alpha, cov_scale=cov_scale, center=center,
                            counter=mono_counters(xs), geom=mono_geometry(xs, m0.shape[1]))
    mf, r, carry = rnd(pack_carry(tgt0, cit0, norm0), None, None, mode=FIRST)
    for _ in range(num_iter - 1):
        mf, _, carry = rnd(carry, r, mf, mode=LOOP)
    mf, _, _ = rnd(carry, r, mf, mode=FINAL)
    return mf, r


def _fused_iter_filter(xs, valid, m0, k0, tgt0, cit0, norm0, template, n, *, woodbury,
                       num_iter, alpha, cov_scale, center):
    """glue="woodbury" / "cholesky" (:1923-2041): R and mf0 from
    ``_rmf_init``, then num_iter + 1 ``fused_iter`` passes (the first passes
    mf0 through), each but the last followed by the glue: ``filter_glue`` or
    the Cholesky glue in torch. Returns (mf * 1e5, R), R = 1 where ``valid``
    is False."""
    mf, r = _rmf_init(xs, m0, cit0, norm0, center)
    # The first pass reads only the target: mu = 0, cit = 0, norm = 1 as JAX.
    carry = pack_carry(tgt0, torch.zeros_like(cit0), torch.ones_like(norm0))
    s = m0.shape[1]
    geom = (stream_geometry(xs, s) if woodbury
            else stream_stats_geometry_for(xs, s, pixel_rows=True))
    rnd = functools.partial(fused_iter, xs, valid, m0, r=r, woodbury=woodbury,
                            cov_scale=cov_scale, center=center, geom=geom)
    if woodbury:
        glue = functools.partial(filter_glue, m0=m0, template=template, k0=k0, n=n, alpha=alpha)
    else:
        glue = lambda stats, _: _cholesky_glue(*stats, m0, template, alpha)  # noqa: E731
    mf, stats = rnd(carry=carry, mf_prev=mf, first=True)
    carry = glue(stats, carry)
    for _ in range(num_iter - 1):
        mf, stats = rnd(carry=carry, mf_prev=mf, first=False)
        carry = glue(stats, carry)
    mf, _ = rnd(carry=carry, mf_prev=mf, first=False)
    if valid is not None:
        r = torch.where(valid, r, 1.0)
    return mf * SCALING, r


def acrwl1mf_fused(
    x,
    template,
    weights=None,
    *,
    num_iter: int = 30,
    alpha: float = 0.0,
    covariance_update_scaling: float = 1.0,
    tile_p: int = DEFAULT_TILE_P,
    stream_dtype=torch.float32,
    x_layout: str = "bps",
    glue: str = "fused",
    device: DeviceLike = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The albedo-corrected reweighted-L1 matched filter over column blocks.

    ``x`` is (B, P, S) radiance (``x_layout="bps"``, with optional 0/1
    ``weights`` (B, P)) or the (B, S, P) stream (``"bsp"``, every pixel
    valid; S may be padded to a multiple of 8 with zero rows for
    ``glue="mono"`` or ``"resident"``); ``template`` (S,). ``stream_dtype``
    ``torch.bfloat16`` streams a centred bf16 copy. ``glue`` picks the route
    (see the module docstring). ``tile_p`` is JAX's pixel tile, accepted and
    unused. Returns (mf scaled by 1e5, R), each (B, P, 1); mf = 0 and R = 1
    where a weight is 0.
    """
    _check_num_iter(num_iter)
    if glue not in GLUES:
        raise ValueError(f"glue must be one of {GLUES}, got {glue!r}")
    if x_layout not in ("bps", "bsp"):
        raise ValueError(f"x_layout must be 'bps' or 'bsp', got {x_layout!r}")
    bf16 = is_bf16_stream(stream_dtype)
    dev = resolve_device(device)
    x = torch.as_tensor(x, dtype=torch.float32, device=dev).contiguous()
    tpl = torch.as_tensor(template, dtype=torch.float32, device=dev)
    s = tpl.shape[0]
    kw = dict(num_iter=num_iter, alpha=alpha, cov_scale=covariance_update_scaling)
    with float32_precision():
        if x_layout == "bsp":
            if weights is not None:
                raise ValueError("x_layout='bsp' requires weights=None")
            b, rows, p = x.shape
            if rows not in (s, stream_rows(s)):
                raise ValueError("x_layout='bsp' band dim must be S or S padded to the next "
                                 "multiple of 8 (zero rows)")
            if rows != s and glue not in ("mono", "resident"):
                raise ValueError("pre-padded bsp input requires glue='mono' or 'resident'")
            valid = None
            n = torch.full((b,), float(p), dtype=torch.float32, device=dev)
            m0, c0 = init_stats_stream(x, s)
            if bf16:
                # The raw radiance's range is too wide for bf16: centre first.
                xs, center = (x - F.pad(m0, (0, rows - s))[..., None]).to(torch.bfloat16), False
            else:
                xs, center = x, True  # streamed raw, centred in the kernels
        else:
            b, p, s_in = x.shape
            if s_in != s:
                raise ValueError(f"x has {s_in} bands for a template of {s}")
            valid = None if weights is None else torch.as_tensor(weights, device=dev) > 0
            if valid is None:
                n = torch.full((b,), float(p), dtype=torch.float32, device=dev)
                m0 = x.mean(1, dtype=torch.float64).float()
                xc = x - m0[:, None, :]
            else:
                n = valid.sum(1).clamp(min=1).to(torch.float32)
                m0 = (torch.where(valid[..., None], x, 0.0).sum(1, dtype=torch.float64)
                      / n[:, None]).float()
                xc = torch.where(valid[..., None], x - m0[:, None, :], 0.0)
            xs = xc.transpose(1, 2).contiguous()
            if bf16:
                xs = xs.to(torch.bfloat16)
            center = False
            c0 = _second_moment(xs, n)
        if glue == "cholesky":
            tgt0 = tpl[None, :] * m0
            k0, cit0 = None, _cho_solve(_shrink_diag(c0, alpha), tgt0)
            norm0 = (tgt0 * cit0).sum(1)
        else:
            k0, tgt0, cit0, norm0 = _woodbury_base(c0, m0, tpl, alpha)
            k0 = k0.contiguous()
        base = (m0, k0, tgt0, cit0, norm0, tpl, n)
        if glue == "mono":
            mf, r = _mono_filter(xs, *base, center=center, **kw)
        elif glue in ("resident", "fused"):
            # A weight row is the rounds' (H, W) mask with H = 1, step = P.
            mask = None if glue == "resident" or valid is None else valid.reshape(1, -1)
            rnd = functools.partial(filter_round_bsp, xs, mask, p, m0, cov_scale=kw["cov_scale"],
                                    bf16_dots=bf16 and glue == "fused", center=center,
                                    geom=stream_geometry(xs, s))
            mf, r = _filter_sequence(rnd, filter_glue, *base, num_iter=num_iter, alpha=alpha)
        else:
            mf, r = _fused_iter_filter(xs, valid, *base, woodbury=glue == "woodbury",
                                       center=center, **kw)
        return mf[..., None], r[..., None]
