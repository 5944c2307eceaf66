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

The bf16 stream (``stream_dtype=bf16``) runs on the blocked (nb, R, P)
layout, R = the band count rounded up to a multiple of 8 (zero rows):

  ``blocked_transpose``  <- ``_blocked_transpose_kernel`` (:92) and
                            ``_blocked_transpose_swh_kernel`` (:170) with
                            the XLA centre-and-cast after them (:1706,
                            :1796-1798): the cube to the centred bf16
                            stream, optionally masked.
  ``init_stats``         <- ``_init_stats_kernel`` (:1164) too: the
                            unmasked route's m0 and C0, from the cube.
  ``init_stats_bsp``     <- the XLA second moment of the masked bf16 stream
                            (:1814-1824).
  ``filter_round_bsp``   <- ``_resident_kernel`` (:1048) on the unmasked
                            route (bf16 storage, f32 products), and
                            ``_first_round_kernel`` / ``_loop_round_kernel``
                            with ``bf16_dots`` on the masked route.

``acrwl1mf_resident_bsp`` (every pixel valid) and ``acrwl1mf_masked_bf16``
(a valid mask) are the two bf16 filters; the glue is ``filter_glue``.

The remaining routes of ``acrwl1mf_fused`` (``ops/mag1c_fused.py``, which
builds on this module) and the band-major cube, on the blocked stream
stored f32 or bf16 (kernels in ``csrc/mag1c_fused.cu`` unless noted):

  ``blocked_transpose_shw``  <- ``_blocked_transpose_shw_kernel`` (:295):
                                the (S, H, W) cube to the f32 stream.
  ``init_stats_stream``      <- ``_init_stats_kernel`` (:1164) on the raw
                                f32 stream (``csrc/mag1c.cu``).
  ``filter_round_bsp``       <- ``_resident_kernel`` at f32 as well: the raw
                                stream centred in the kernel (``center``).
  ``fused_iter``             <- ``_fused_iter_kernel`` (:386), WOODBURY
                                (then ``filter_glue``) or CHOLESKY (then
                                the Cholesky glue in torch).
  ``filter_round_mono``      <- ``_mono_first_kernel`` (:880) and
                                ``_mono_loop_kernel`` (:927): the round and
                                the Woodbury glue in one launch.

The TPU kernels hold a column block in VMEM; an SM has 228 KB of shared
memory, so here each iteration streams the cube once (see csrc/mag1c.cu for
the design). One filter is 1 ``init_stats[_masked]``, 1 ``woodbury_base``,
``num_iter + 1`` ``filter_round[_masked]`` passes and ``num_iter``
``filter_glue`` launches.

  ``woodbury_base``  <- no Pallas kernel: XLA's work between the kernels
                        (``_woodbury_base`` :826), the inverse of C0 and the
                        initial carry once per filter, in one launch
                        (``csrc/woodbury_base.cu``), on every route but
                        ``acrwl1mf_fused``'s cholesky glue.

Each wrapper runs its plain torch twin for CPU tensors and otherwise
launches its kernel (counted in ``LAUNCH_COUNTS``); the op refuses anything
but CUDA tensors, and there is no fallback from a failed launch. The
per-block valid counts are plain torch on both routes (XLA in JAX), one
definition, so the routes cannot drift. The twins compute in the dtype they
are given, so the same code runs as a float64 judge.

Layouts: the scene is the (H, W, S) cube and the valid mask (H, W); per-pixel
rows mf and R are (nb, P), P = H * step, with ``p = h * step + j``
(``ops.mag1c.block_columns``); the carry is (nb, 4, S) = [mu | target | cit |
norm in every entry of row 3].
"""

from __future__ import annotations

import functools
import math
import threading
from typing import Callable, Dict, NamedTuple, Tuple

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
from starcop_tpu_torch.utils.profiling import count, span

FIRST, LOOP, FINAL = 0, 1, 2

# The streaming rounds' launch geometry (csrc/mag1c_common.cuh, "The
# streaming rounds"): a CTA of ROUND_THREADS threads, one pixel each per tile,
# a ring of 2..MAX_STAGES tiles in shared memory.
ROUND_THREADS = 128
MAX_BANDS = 128
MAX_STAGES = 4
# The ring a CTA aims at, so that four share an SM: at S = 50 an f32 tile
# ring holds 2 stages, a bf16 one 3.
RING_BYTES = 48 * 1024
SMEM_PER_SM = 228 * 1024       # H100: shared memory of an SM
CTA_RESERVED_SMEM = 1024       # what the runtime keeps per CTA
ROUND_CTAS_PER_SM = 4          # __launch_bounds__(128, 4): <= 128 registers a thread
PIX_STAGE_BYTES = 3 * 4 * ROUND_THREADS + ROUND_THREADS  # R, mf_prev, mask word, mask position
ROUND_FIXED_BYTES = 4 * (2 * ROUND_THREADS + 2 * MAX_BANDS + 16)
BF16_ROW_PITCH = ROUND_THREADS + 8  # staged bf16 stream row, 272 bytes
MONO_STATIC_SMEM = 16          # filter_round_mono's static flag (its glue reuses the ring)
DEFAULT_SM_COUNT = 132         # H100 SXM; a CUDA device reports its own

# The cube statistics (init_stats[_masked], csrc/mag1c.cu): a CTA of
# STATS_THREADS threads, __launch_bounds__(256, 2), the rounds' tiles in a
# ring of 2..MAX_STAGES, the centred tile restaged beside it.
STATS_THREADS = 256
STATS_CTAS_PER_SM = 2
# StatsScratch: the sweep's sums (two a thread), delta / mean, the pixels'
# offsets and columns.
STATS_STATIC_SMEM = 4 * (2 * STATS_THREADS + 2 * MAX_BANDS + 2 * ROUND_THREADS)
# The stream statistics (init_stats_bsp, init_stats_stream, fused_iter
# CHOLESKY: stream_stats_chunk in csrc/mag1c_common.cuh): the same CTA, the
# rounds' stream tiles in a ring of 2..MAX_STAGES; StreamStatsScratch holds
# the band sums, delta, mean, CHOLESKY's m0, target and cit rows, g of a
# tile and 4 scalars.
STREAM_STATS_STATIC_SMEM = 4 * (6 * MAX_BANDS + ROUND_THREADS + 4)
# CHOLESKY's per-pixel rows in each stage: R, mf_prev and the words that
# cover the tile's valid bytes.
STATS_PIX_BYTES = 2 * 4 * ROUND_THREADS + ROUND_THREADS + 16
# filter_glue / mono's glue: GlueSmem, then K0 staged at glue_k0_pitch(S).
GLUE_FIXED_BYTES = 6272
# blocked_transpose (csrc/mag1c.cu): the statistics' CTA shape,
# __launch_bounds__(256, 2), tiles of whole block rows of at least
# TRANSPOSE_MIN_PIXELS pixels where two ring stages leave two CTAs on an SM
# (at S = 50: 216 pixels at step 54, 128 at step 32), m0 of the block in
# static shared memory.
TRANSPOSE_MIN_PIXELS = 128
TRANSPOSE_STATIC_SMEM = 4 * MAX_BANDS


class RoundGeometry(NamedTuple):
    """The launch geometry of one round kernel; ``op_args`` is what the ops
    take (the kernels check it against the shapes).

    A tile is ``tile_rows`` x ``tile_cols`` pixels (on the cube: image rows x
    columns of a block; on the stream: 1 x ROUND_THREADS contiguous pixels),
    a chunk ``tiles_per_chunk`` consecutive tiles, one CTA per (chunk,
    block), ``nchunks`` per block. ``aligned`` selects 16-byte copies of the
    tile values (every tile row starts and ends on 16 bytes), else 4-byte
    ones."""

    tile_rows: int
    tile_cols: int
    tiles_per_block: int
    tiles_per_chunk: int
    nchunks: int
    stages: int
    aligned: bool
    smem_bytes: int      # dynamic shared memory of a CTA
    static_smem: int     # its static shared memory
    ctas_per_sm: int

    def op_args(self):
        return [self.tile_rows, self.tile_cols, self.tiles_per_chunk, self.stages,
                int(self.aligned), self.smem_bytes]


def stats_record_len(s: int) -> int:
    """Floats of one statistics record: [n | mean(s) | the lower triangle of
    the s x s centred scatter, row by row]."""
    return 1 + s + s * (s + 1) // 2


def stats_microtiles(s: int) -> int:
    """The 8 x 8 register micro-tiles that cover the s x s lower triangle."""
    n = -(-s // 8)
    return n * (n + 1) // 2


def stats_smem_bytes(stages: int, tile_bytes: int, s: int) -> int:
    """Dynamic shared memory of an ``init_stats[_masked]`` CTA (the
    kernel's ``stats_smem_bytes``): the ring (tile, mask word and position
    per pixel slot) and the centred tile at 8 ceil(s / 8) floats a pixel, or
    the scatter groups' sums where those need more."""
    ring = stages * (tile_bytes + 5 * ROUND_THREADS) + 4 * ROUND_THREADS * (-(-s // 8) * 8)
    return max(ring, _stats_group_bytes(s))


def _stats_group_bytes(s: int) -> int:
    """Bytes of the scatter groups' sums that a statistics CTA adds at a
    chunk's end (the kernels' ``stats_group_bytes``)."""
    tiles = stats_microtiles(s)
    return 256 * tiles * (STATS_THREADS // tiles - 1)


def stream_stats_pitch(s: int) -> int:
    """Floats of one restaged pixel of the stream statistics: 8 ceil(s / 8)
    and one float4 more (an odd number of float4: no bank conflicts in the
    sweep's stores)."""
    return -(-s // 8) * 8 + 4


def stream_stats_smem_bytes(stages: int, tile_bytes: int, s: int, pixel_rows: bool = False) -> int:
    """Dynamic shared memory of a stream statistics CTA (the kernel's
    ``stream_stats_smem_bytes``): the ring (the tile and, with ``pixel_rows``,
    CHOLESKY's R, mf_prev and valid words per stage) and the centred tile, or
    the scatter groups' sums where those need more."""
    stage = tile_bytes + (STATS_PIX_BYTES if pixel_rows else 0)
    ring = stages * stage + 4 * ROUND_THREADS * stream_stats_pitch(s)
    return max(ring, _stats_group_bytes(s))


def glue_k0_pitch(s: int) -> int:
    """Row pitch (floats) of K0 staged by the glue: s rounded up to 4, plus
    4 where that is a multiple of 8 (no bank conflicts)."""
    p = -(-s // 4) * 4
    return p + 4 if p % 8 == 0 else p


def glue_smem_bytes(s: int) -> int:
    """Shared memory of the glue (``filter_glue``, mono's last CTA)."""
    return GLUE_FIXED_BYTES + 4 * s * glue_k0_pitch(s)


def _cube_tile(step: int, s: int):
    """The cube tile: (rows, columns, segments per block row, bytes). Whole
    rows of a block, or segments of a row wider than ROUND_THREADS pixels."""
    tile_cols = min(step, ROUND_THREADS)
    tile_rows = max(1, ROUND_THREADS // step) if step <= ROUND_THREADS else 1
    return tile_rows, tile_cols, -(-step // tile_cols), 4 * tile_rows * (-(-tile_cols * s // 4) * 4)


def _chunk_tiles(nb: int, tiles: int, unit: int, slots: int, stages: int) -> int:
    """Tiles per chunk, a multiple of ``unit``: the fewest waves of ``slots``
    resident CTAs times a CTA's work (its tiles plus the ring's fill), so the
    last wave runs (nearly) full. Every chunk holds at least one tile."""
    best = None
    for k in range(unit, -(-tiles // unit) * unit + 1, unit):
        n = -(-tiles // k)
        cost = -(-nb * n // slots) * (k + stages)
        if best is None or cost < best[0]:
            best = (cost, k)
    return best[1]


@functools.lru_cache(maxsize=256)
def round_geometry(layout: str, nb: int, p: int, s: int, *, step: int = 0, width: int = 0,
                   elem_bytes: int = 4, aligned_ptr: bool = True,
                   sm_count: int = DEFAULT_SM_COUNT, static_smem: int = 0) -> RoundGeometry:
    """The geometry of ``filter_round[_masked]`` (``layout="hws"``: the
    (H, width, s) cube, P = H * step) or of a round on the blocked stream
    (``"bsp"``: ``filter_round_bsp``, ``fused_iter`` WOODBURY,
    ``filter_round_mono``; elements of ``elem_bytes``) for ``nb`` blocks of
    ``p`` pixels. ``aligned_ptr``: the cube or stream starts on 16 bytes.
    ``static_smem``: the kernel's static shared memory (mono's glue)."""
    if not 1 <= s <= MAX_BANDS:
        raise ValueError(f"band count {s} outside [1, {MAX_BANDS}]")
    if layout == "hws":
        tile_rows, tile_cols, nseg, tile_bytes = _cube_tile(step, s)
        tiles, unit = -(-(p // step) // tile_rows) * nseg, nseg
        aligned = aligned_ptr and (width * s) % 4 == 0 and (step * s) % 4 == 0
    elif layout == "bsp":
        tile_rows, tile_cols = 1, ROUND_THREADS
        tiles, unit = -(-p // ROUND_THREADS), 1
        tile_bytes = _stream_tile_bytes(s, elem_bytes)
        aligned = aligned_ptr and (p * elem_bytes) % 16 == 0
    else:
        raise ValueError(f"layout must be 'hws' or 'bsp', got {layout!r}")
    stage = tile_bytes + PIX_STAGE_BYTES
    stages = max(2, min(MAX_STAGES, RING_BYTES // stage))
    smem = stages * stage + ROUND_FIXED_BYTES
    ctas = min(ROUND_CTAS_PER_SM, SMEM_PER_SM // (smem + static_smem + CTA_RESERVED_SMEM))
    k = _chunk_tiles(nb, tiles, unit, max(1, ctas) * sm_count, stages)
    return RoundGeometry(tile_rows, tile_cols, tiles, k, -(-tiles // k), stages, aligned, smem,
                         static_smem, ctas)


def _stats_ring(smem_of: Callable[[int], int], static_smem: int):
    """(stages, dynamic shared memory, CTAs per SM) of a statistics CTA (or
    of ``blocked_transpose``'s, the same CTA shape): the most ring stages
    whose shared memory ``smem_of(stages)`` leaves STATS_CTAS_PER_SM CTAs on
    an SM, at least 2."""
    per_cta = SMEM_PER_SM // STATS_CTAS_PER_SM - CTA_RESERVED_SMEM - static_smem
    stages = max([2] + [k for k in range(2, MAX_STAGES + 1) if smem_of(k) <= per_cta])
    smem = smem_of(stages)
    return stages, smem, min(STATS_CTAS_PER_SM,
                             SMEM_PER_SM // (smem + static_smem + CTA_RESERVED_SMEM))


@functools.lru_cache(maxsize=256)
def stats_geometry(nb: int, h: int, step: int, s: int, *, width: int, aligned_ptr: bool = True,
                   sm_count: int = DEFAULT_SM_COUNT) -> RoundGeometry:
    """The geometry of ``init_stats[_masked]`` on the (h, width, s) cube in
    ``nb`` blocks of ``step`` columns: the rounds' cube tiles, the most ring
    stages that leave STATS_CTAS_PER_SM CTAs on an SM (at least 2), and the
    tiles per chunk that fill the last wave."""
    if not 1 <= s <= MAX_BANDS:
        raise ValueError(f"band count {s} outside [1, {MAX_BANDS}]")
    tile_rows, tile_cols, nseg, tile_bytes = _cube_tile(step, s)
    tiles = -(-h // tile_rows) * nseg
    stages, smem, ctas = _stats_ring(lambda k: stats_smem_bytes(k, tile_bytes, s),
                                     STATS_STATIC_SMEM)
    k = _chunk_tiles(nb, tiles, nseg, max(1, ctas) * sm_count, stages)
    aligned = aligned_ptr and (width * s) % 4 == 0 and (step * s) % 4 == 0
    return RoundGeometry(tile_rows, tile_cols, tiles, k, -(-tiles // k), stages, aligned, smem,
                         STATS_STATIC_SMEM, ctas)


def _stream_tile_bytes(s: int, elem_bytes: int) -> int:
    """Bytes of one staged stream tile: ROUND_THREADS pixels of s band rows
    (a bf16 row padded to BF16_ROW_PITCH)."""
    return s * (BF16_ROW_PITCH * 2 if elem_bytes == 2 else ROUND_THREADS * 4)


@functools.lru_cache(maxsize=256)
def stream_stats_geometry(nb: int, p: int, s: int, elem_bytes: int, *, pixel_rows: bool = False,
                          aligned_ptr: bool = True,
                          sm_count: int = DEFAULT_SM_COUNT) -> RoundGeometry:
    """The geometry of the statistics of the blocked stream, ``nb`` blocks
    of ``p`` pixels and ``s`` live band rows of ``elem_bytes`` bytes
    (``init_stats_bsp``, ``init_stats_stream``; ``fused_iter`` CHOLESKY with
    ``pixel_rows``): the rounds' stream tiles (one row of ROUND_THREADS
    pixels), the most ring stages that leave STATS_CTAS_PER_SM CTAs on an SM
    (at least 2), and the tiles per chunk that fill the last wave.
    ``aligned_ptr``: the stream starts on 16 bytes."""
    if not 1 <= s <= MAX_BANDS:
        raise ValueError(f"band count {s} outside [1, {MAX_BANDS}]")
    tile_bytes = _stream_tile_bytes(s, elem_bytes)
    tiles = -(-p // ROUND_THREADS)
    stages, smem, ctas = _stats_ring(
        lambda k: stream_stats_smem_bytes(k, tile_bytes, s, pixel_rows), STREAM_STATS_STATIC_SMEM)
    k = _chunk_tiles(nb, tiles, 1, max(1, ctas) * sm_count, stages)
    aligned = aligned_ptr and (p * elem_bytes) % 16 == 0
    return RoundGeometry(1, ROUND_THREADS, tiles, k, -(-tiles // k), stages, aligned, smem,
                         STREAM_STATS_STATIC_SMEM, ctas)


def transpose_stage_bytes(pixels: int, s: int) -> int:
    """Dynamic shared memory of one ``blocked_transpose`` ring stage (the
    kernel's ``transpose_stage_bytes``): the staged tile, 16-byte rounded,
    then each pixel's mask word and the byte's position in it."""
    return -(-pixels * s // 4) * 16 + -(-5 * pixels // 16) * 16


def _transpose_tile(h: int, step: int, s: int):
    """The ``blocked_transpose`` tile: (rows, columns, segments per block
    row), each shape such that two ring stages leave STATS_CTAS_PER_SM CTAs
    on an SM. Whole block rows, at least TRANSPOSE_MIN_PIXELS pixels where
    they fit, in a multiple of the rows that make the pixel span a multiple
    of 16 (each band row of a tile on whole 32-byte sectors of the output)
    where such a unit fits, else of 8 (16 bytes); else segments of a row
    wider than a tile, a multiple of 16 columns where one fits."""
    per_cta = SMEM_PER_SM // STATS_CTAS_PER_SM - CTA_RESERVED_SMEM - TRANSPOSE_STATIC_SMEM
    fits = lambda px: 2 * transpose_stage_bytes(px, s) <= per_cta  # noqa: E731
    if fits(step):
        unit = next(u for u in (16 // math.gcd(step, 16), 8 // math.gcd(step, 8), 1)
                    if fits(u * step))
        rows = -(-TRANSPOSE_MIN_PIXELS // (unit * step)) * unit
        while not fits(rows * step):
            rows -= unit
        return min(rows, -(-h // unit) * unit), step, 1
    cols = max(c for c in range(1, step) if fits(c))
    cols = cols // 16 * 16 or cols
    return 1, cols, -(-step // cols)


@functools.lru_cache(maxsize=256)
def transpose_geometry(nb: int, h: int, step: int, s: int, *, width: int,
                       aligned_ptr: bool = True,
                       sm_count: int = DEFAULT_SM_COUNT) -> RoundGeometry:
    """The geometry of ``blocked_transpose`` on the (h, width, s) cube in
    ``nb`` blocks of ``step`` columns: ``_transpose_tile``'s tiles, the most
    ring stages that leave STATS_CTAS_PER_SM CTAs on an SM (at least 2), and
    the tiles per chunk that fill the last wave. ``aligned``: 16-byte copies
    (every tile row starts and ends on 16 bytes of the cube)."""
    if not 1 <= s <= MAX_BANDS:
        raise ValueError(f"band count {s} outside [1, {MAX_BANDS}]")
    rows, cols, nseg = _transpose_tile(h, step, s)
    tiles = -(-h // rows) * nseg
    stages, smem, ctas = _stats_ring(lambda k: k * transpose_stage_bytes(rows * cols, s),
                                     TRANSPOSE_STATIC_SMEM)
    k = _chunk_tiles(nb, tiles, nseg, max(1, ctas) * sm_count, stages)
    aligned = (aligned_ptr and (width * s) % 4 == 0 and (step * s) % 4 == 0
               and (cols * s) % 4 == 0)
    return RoundGeometry(rows, cols, tiles, k, -(-tiles // k), stages, aligned, smem,
                         TRANSPOSE_STATIC_SMEM, ctas)


def _sm_count(dev: torch.device) -> int:
    if dev.type == "cuda":
        return torch.cuda.get_device_properties(dev).multi_processor_count
    return DEFAULT_SM_COUNT


def _aligned16(t: torch.Tensor) -> bool:
    return t.data_ptr() % 16 == 0


def stream_geometry(xs: torch.Tensor, s: int, *, static_smem: int = 0) -> RoundGeometry:
    """``round_geometry`` of a round over the blocked stream xs (nb, R, P)
    with s live bands."""
    nb, _, p = xs.shape
    return round_geometry("bsp", nb, p, s, elem_bytes=xs.element_size(),
                          aligned_ptr=_aligned16(xs), sm_count=_sm_count(xs.device),
                          static_smem=static_smem)


def stream_stats_geometry_for(xs: torch.Tensor, s: int, *,
                              pixel_rows: bool = False) -> RoundGeometry:
    """``stream_stats_geometry`` of the statistics of the blocked stream xs
    (nb, R, P) over its first s rows (``pixel_rows``: fused_iter CHOLESKY)."""
    nb, _, p = xs.shape
    return stream_stats_geometry(nb, p, s, xs.element_size(), pixel_rows=pixel_rows,
                                 aligned_ptr=_aligned16(xs), sm_count=_sm_count(xs.device))


def cube_geometry(x: torch.Tensor, nb: int, step: int) -> RoundGeometry:
    """``round_geometry`` of ``filter_round[_masked]`` on the (H, W, S) cube x."""
    h, w, s = x.shape
    return round_geometry("hws", nb, h * step, s, step=step, width=w, aligned_ptr=_aligned16(x),
                          sm_count=_sm_count(x.device))


def cube_stats_geometry(x: torch.Tensor, nb: int, step: int) -> RoundGeometry:
    """``stats_geometry`` of ``init_stats[_masked]`` on the (H, W, S) cube x."""
    h, w, s = x.shape
    return stats_geometry(nb, h, step, s, width=w, aligned_ptr=_aligned16(x),
                          sm_count=_sm_count(x.device))


def cube_transpose_geometry(x: torch.Tensor, nb: int, step: int) -> RoundGeometry:
    """``transpose_geometry`` of ``blocked_transpose`` on the (H, W, S) cube x."""
    h, w, s = x.shape
    return transpose_geometry(nb, h, step, s, width=w, aligned_ptr=_aligned16(x),
                              sm_count=_sm_count(x.device))


# The masked rounds count their FIRST launches (row 5 of the TPU kernel
# table) apart from their LOOP and FINAL ones (row 6), the mono rounds their
# FIRST (row 7) apart from their LOOP and FINAL ones (row 8); the masked
# stream rounds count a bf16 stream apart from an f32 one (acrwl1mf_fused's
# (B, P, S) input with a weight row).
LAUNCH_COUNTS: Dict[str, int] = {
    "init_stats": 0, "filter_round": 0, "filter_glue": 0,
    "init_stats_masked": 0, "filter_round_masked_first": 0, "filter_round_masked_loop": 0,
    "blocked_transpose": 0, "init_stats_bsp": 0, "filter_round_bsp": 0,
    "filter_round_bsp_masked_first": 0, "filter_round_bsp_masked_loop": 0,
    "filter_round_bsp_f32_masked_first": 0, "filter_round_bsp_f32_masked_loop": 0,
    "blocked_transpose_shw": 0, "init_stats_stream": 0, "filter_round_bsp_f32": 0,
    "fused_iter_woodbury": 0, "fused_iter_cholesky": 0,
    "filter_round_mono_first": 0, "filter_round_mono_loop": 0, "woodbury_base": 0,
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
# Glue that JAX leaves to XLA
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
    valid pixel (C0 = 0) gets NaN in k0, cit0 and norm0; its pixels never
    read them. The twin of ``woodbury_base``."""
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


def _keep_rows(valid: torch.Tensor, nb: int, step: int) -> torch.Tensor:
    """The (nb, P) bool rows of the pixels that count: the (H, W) valid
    mask, False past W."""
    keep = F.pad(valid.to(torch.uint8), (0, nb * step - valid.shape[1])).bool()
    return block_columns(keep[..., None], nb, step)[..., 0]


def _masked_blocks(x: torch.Tensor, valid: torch.Tensor, nb: int, step: int):
    """The cube as (nb, P, S) blocks with 0 selected at the pixels that do
    not count, and the (nb, P) bool rows of those that do (the valid mask,
    False past W). Pads a copy of the cube to nb * step columns: twins only."""
    keep = _keep_rows(valid, nb, step)
    xb = block_columns(F.pad(x, (0, 0, 0, nb * step - x.shape[1])), nb, step)
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


def _bf16_rounded(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16 (nearest even) and back to its own dtype."""
    return t.to(torch.bfloat16).to(t.dtype)


def _round_math(xc, m0, carry, r, mf_prev, *, mode, cov_scale, keep=None, bf16_dots=False):
    """One pass on the centred blocks xc (nb, P, S); ``keep`` (nb, P) bool
    selects mf = 0 and R = 1 at the pixels that do not count. ``bf16_dots``
    rounds cit, m0 and g to bf16 before their products with xc, as JAX's
    bf16 dots do (mag1c_pallas.py:633-636, :693-701, :555-574)."""
    dot = _bf16_rounded if bf16_dots else (lambda t: t)
    mu, cit, norm = carry[:, 0], carry[:, 2], carry[:, 3, :1]
    proj = torch.einsum("bps,bs->bp", xc, dot(cit)) - (cit * mu).sum(1, keepdim=True)
    if mode == FIRST:
        q = torch.einsum("bps,bs->bp", xc, dot(m0))
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
    u = torch.einsum("bps,bp->bs", xc, dot(g))
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


def stream_rows(s: int) -> int:
    """Band rows R of the blocked layout: ``s`` rounded up to a multiple of 8."""
    return -(-s // 8) * 8


def blocked_transpose_plain(x, nb, step, rows, m0, *, valid=None):
    """The (H, W, S) f32 cube -> the centred bf16 stream (nb, rows, P):
    out[b, s, h * step + j] = x[h, b * step + j, s] - m0[b, s] rounded to
    bf16 (nearest even), rows S..rows-1 zero, and 0 where the (H, W)
    ``valid`` mask is unset or the column is past W. Without a mask W must
    be nb * step."""
    if valid is None:
        xc = block_columns(x, nb, step) - m0[:, None, :]
    else:
        xb, keep = _masked_blocks(x, valid, nb, step)
        xc = torch.where(keep[..., None], xb - m0[:, None, :], 0.0)
    out = F.pad(xc.transpose(1, 2), (0, 0, 0, rows - x.shape[2]))
    return out.to(torch.bfloat16).contiguous()


def init_stats_bsp_plain(xs: torch.Tensor, n, s: int):
    """C0 = x x^T / n (nb, s, s) of the first s rows x of the centred stream
    xs (nb, R, P), not re-centred; ``n`` (nb,) the valid counts. In f32 for
    a bf16 stream, else in the stream's dtype."""
    x = xs[:, :s].float() if xs.dtype == torch.bfloat16 else xs[:, :s]
    n = torch.as_tensor(n, dtype=x.dtype, device=x.device)
    return torch.einsum("bsp,btp->bst", x, x) / n[:, None, None]


def filter_round_bsp_plain(xs, valid, step, m0, carry, r, mf_prev, *, mode, cov_scale=1.0,
                           bf16_dots=False, center=False):
    """One pass over the stream xs (nb, R, P), in the dtype of m0:
    ``filter_round_plain``'s math on its first S = m0.shape[1] rows, with
    the bf16 rounding of ``bf16_dots`` and, given the (H, W) ``valid`` mask,
    ``filter_round_masked_plain``'s selects. The stream is centred, or raw
    and centred by m0 here (``center``)."""
    s = m0.shape[1]
    xc = xs[:, :s].transpose(1, 2).to(m0.dtype)
    if center:
        xc = xc - m0[:, None, :]
    keep = None
    if valid is not None:
        keep = _keep_rows(valid, xs.shape[0], step)
        xc = torch.where(keep[..., None], xc, 0.0)
    return _round_math(xc, m0, carry, r, mf_prev, mode=mode, cov_scale=cov_scale, keep=keep,
                       bf16_dots=bf16_dots)


def blocked_transpose_shw_plain(x, nb, step, rows):
    """The (S, H, nb * step) band-major cube -> the f32 blocked stream
    (nb, rows, P): out[b, s, h * step + j] = x[s, h, b * step + j], rows
    S..rows-1 zero (``blocked_transpose_shw`` :309 with ``pad_s=rows``)."""
    s, h, w = x.shape
    if w != nb * step:
        raise ValueError("scene width must equal nb*step")
    out = x.reshape(s, h, nb, step).permute(2, 0, 1, 3).reshape(nb, s, h * step)
    return F.pad(out, (0, 0, 0, rows - s))


def init_stats_stream_plain(xs, s: int):
    """m0 (nb, s) and the centred covariance C0 (nb, s, s) of the first s rows
    of the raw stream xs (nb, R, P), every pixel valid (``_init_stats_kernel``
    :1164)."""
    x = xs[:, :s]
    m0 = x.mean(2)
    xc = x - m0[..., None]
    return m0, torch.einsum("bsp,btp->bst", xc, xc) / x.shape[2]


def fused_iter_plain(xs, valid, m0, carry, r, mf_prev, *, first, woodbury, cov_scale=1.0,
                     center=False):
    """One pass of ``_fused_iter_kernel`` (:386) over the stream xs (nb, R, P)
    in the dtype of m0 (the stream centred, or raw and centred by m0 here):
    mf_new = relu((cit.(x - mu) - 1/(R (mf_prev + eps))) / (R norm)), or
    mf_prev on the ``first`` call, 0 where the (nb, P) bool rows ``valid``
    are False (such pixels do not count). Returns (mf_new, stats):
    WOODBURY stats (nb, 1, S + 2) = [u = sum x g | sum g | sum g^2] with g =
    cov_scale R mf_new; CHOLESKY stats (mean (nb, S), cov (nb, S, S)): the
    mean and the centred covariance of modx = x - cov_scale target R mf_new
    over the pixels that count (n clamped to >= 1), i.e. JAX's s1 / n and
    s2 / n - mu mu^T (:1966-1967)."""
    s = m0.shape[1]
    xc = xs[:, :s].transpose(1, 2).to(m0.dtype)
    if center:
        xc = xc - m0[:, None, :]
    if valid is not None:
        xc = torch.where(valid[..., None], xc, 0.0)
    mu, target, cit, norm = carry[:, 0], carry[:, 1], carry[:, 2], carry[:, 3, :1]
    if first:
        mf = mf_prev
    else:
        proj = torch.einsum("bps,bs->bp", xc, cit) - (cit * mu).sum(1, keepdim=True)
        mf = torch.clamp((proj - 1.0 / (r * (mf_prev + EPSILON))) / (r * norm), min=0.0)
    if valid is not None:
        mf = torch.where(valid, mf, 0.0)
    g = cov_scale * (r * mf)
    if woodbury:
        u = torch.einsum("bps,bp->bs", xc, g)
        return mf, torch.cat([u, g.sum(1, keepdim=True), (g * g).sum(1, keepdim=True)],
                             dim=1)[:, None, :]
    modx = xc - target[:, None, :] * g[..., None]
    if valid is None:
        n = torch.full_like(mf[:, :1], xc.shape[1])
    else:
        n = valid.sum(1, keepdim=True).clamp(min=1).to(xc.dtype)
        modx = torch.where(valid[..., None], modx, 0.0)
    mean = modx.sum(1) / n
    d = modx - mean[:, None, :]
    if valid is not None:
        d = torch.where(valid[..., None], d, 0.0)
    return mf, (mean, torch.einsum("bps,bpt->bst", d, d) / n[..., None])


def filter_round_mono_plain(xs, m0, carry, r, mf_prev, template, k0, n, *, mode, alpha,
                            cov_scale=1.0, center=False):
    """One mono round (``_mono_first_kernel`` :880 in FIRST,
    ``_mono_loop_kernel`` :927 in LOOP / FINAL): ``filter_round_bsp_plain``
    on the stream xs (nb, R, P), with bf16 dots on a bf16 stream, then unless
    FINAL ``filter_glue_plain``. Returns (mf, R, the next carry or None)."""
    mf, r, stats = filter_round_bsp_plain(xs, None, 1, m0, carry, r, mf_prev, mode=mode,
                                          cov_scale=cov_scale,
                                          bf16_dots=xs.dtype == torch.bfloat16, center=center)
    if mode == FINAL:
        return mf, r, None
    return mf, r, filter_glue_plain(stats, carry, m0, template, k0, n=n, alpha=alpha)


MEAN_ROWS = 64  # rows of the cube per select in masked_block_means


def masked_block_means(x: torch.Tensor, valid: torch.Tensor, nb: int, step: int, n):
    """The mean of each column block's valid pixels, (nb, S) in x's dtype
    (JAX's f32 ``_weighted_mean``, mag1c_pallas.py:1795); ``n`` (nb,) the
    valid counts clamped to >= 1. Invalid pixels are selected out, MEAN_ROWS
    rows at a time, so no zeroed copy of the whole cube is made. The sums
    run in f64, so the mean is rounded once, whatever the device's or the
    chunks' summation order."""
    keep = valid.bool()[..., None]
    cols = x.new_zeros(x.shape[1:], dtype=torch.float64)  # (W, S)
    for h in range(0, x.shape[0], MEAN_ROWS):
        cols += torch.where(keep[h:h + MEAN_ROWS], x[h:h + MEAN_ROWS], 0.0).sum(
            0, dtype=torch.float64)
    cols = F.pad(cols, (0, 0, 0, nb * step - x.shape[1]))
    return (cols.reshape(nb, step, -1).sum(1) / n[:, None]).to(x.dtype)


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
    s = x.shape[2]
    geom = cube_stats_geometry(x, nb, step)
    partial = torch.empty((nb, geom.nchunks, stats_record_len(s)), dtype=torch.float32,
                          device=x.device)
    m0 = torch.empty((nb, s), dtype=torch.float32, device=x.device)
    c0 = torch.empty((nb, s, s), dtype=torch.float32, device=x.device)
    op(*args, partial, m0, c0, nb, step, geom.op_args(), _stream(x))
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


def _launch_round(op, args, x, nb, step, m0, carry, r, mf_prev, mode, cov_scale, geom):
    h, _, s = x.shape
    p = h * step
    if geom is None:
        geom = cube_geometry(x, nb, step)
    mf = torch.empty((nb, p), dtype=torch.float32, device=x.device)
    if mode == FIRST:
        r = torch.empty_like(mf)
        mf_prev = mf  # not read in the first round
    stats = torch.empty((nb, geom.nchunks, s + 2), dtype=torch.float32, device=x.device)
    op(mode, *args, m0, carry, r, mf_prev, mf, stats, nb, step, geom.op_args(), float(cov_scale),
       _stream(x))
    return mf, r, (None if mode == FINAL else stats)


def filter_round(x, nb, step, m0, carry, r, mf_prev, *, mode, cov_scale=1.0, geom=None):
    """One streaming pass; see ``filter_round_plain``. On CUDA the stats
    come back per pixel chunk, (nb, nchunks, S + 2). ``geom``:
    ``cube_geometry(x, nb, step)``, which a filter works out once for all
    its rounds; made here when None."""
    if x.device.type == "cpu":
        return filter_round_plain(x, nb, step, m0, carry, r, mf_prev, mode=mode,
                                  cov_scale=cov_scale)
    out = _launch_round(_kernels().filter_round, (x,), x, nb, step, m0, carry, r, mf_prev,
                        mode, cov_scale, geom)
    _count("filter_round")
    return out


def filter_round_masked(x, valid, nb, step, m0, carry, r, mf_prev, *, mode, cov_scale=1.0,
                        geom=None):
    """One streaming pass of the weighted filter; see
    ``filter_round_masked_plain``. On CUDA the stats come back per pixel
    chunk, (nb, nchunks, S + 2). ``geom`` as ``filter_round``'s."""
    if x.device.type == "cpu":
        return filter_round_masked_plain(x, valid, nb, step, m0, carry, r, mf_prev, mode=mode,
                                         cov_scale=cov_scale)
    out = _launch_round(_kernels().filter_round_masked, (x, _mask_u8(valid)), x, nb, step, m0,
                        carry, r, mf_prev, mode, cov_scale, geom)
    _count("filter_round_masked_first" if mode == FIRST else "filter_round_masked_loop")
    return out


def _inverse_counts(n, m0):
    """1/n per block, (nb,) f32 on m0's device, from a number or an (nb,)
    tensor: made on the device (a host scalar copied in would sync the
    stream)."""
    if torch.is_tensor(n):
        return (1.0 / n.float()).contiguous()
    return torch.full((m0.shape[0],), 1.0 / n, dtype=torch.float32, device=m0.device)


def woodbury_base(c0, m0, template, alpha):
    """The Woodbury base (k0, tgt0, cit0, norm0) of c0 (nb, S, S), m0
    (nb, S) and the template (S,); see ``_woodbury_base``. On the card one
    ``woodbury_base`` launch (f32 in and out, the factor and the inverse in
    f64; k0 contiguous and exactly symmetric), on the CPU the twin. Traced,
    span ``mag1c.base`` with counters ``blocks`` (nb) and ``kernel`` (1 when
    the kernel ran, 0 for the twin)."""
    on_cpu = c0.device.type == "cpu"
    with span("mag1c.base") as traced:
        if on_cpu:
            out = _woodbury_base(c0, m0, template, alpha)
        else:
            if not all(t.dtype == torch.float32 for t in (c0, m0, template)):
                raise TypeError(f"woodbury_base takes float32 tensors on the card, got "
                                f"{c0.dtype}, {m0.dtype}, {template.dtype}")
            nb, s = m0.shape
            out = (torch.empty((nb, s, s), dtype=torch.float32, device=c0.device),
                   torch.empty_like(m0), torch.empty_like(m0),
                   torch.empty((nb,), dtype=torch.float32, device=c0.device))
            _kernels().woodbury_base(c0.contiguous(), m0.contiguous(), template.contiguous(),
                                     *out, float(alpha), _stream(c0))
            _count("woodbury_base")
        if traced is not None:
            count("blocks", c0.shape[0])
            count("kernel", int(not on_cpu))
    return out


def filter_glue(stats, carry, m0, template, k0, *, n, alpha):
    """The next carry from a round's statistics; see ``filter_glue_plain``."""
    if stats.device.type == "cpu":
        return filter_glue_plain(stats, carry, m0, template, k0, n=n, alpha=alpha)
    out = torch.empty_like(carry)
    _kernels().filter_glue(stats, carry, out, m0, template, k0, _inverse_counts(n, m0),
                           float(alpha), _stream(stats))
    _count("filter_glue")
    return out


def blocked_transpose(x, nb, step, rows, m0, *, valid=None):
    """The (H, W, S) f32 cube -> the bf16 stream (nb, rows, P) centred by m0
    (nb, S), masked by ``valid`` when given; see ``blocked_transpose_plain``."""
    if x.device.type == "cpu":
        return blocked_transpose_plain(x, nb, step, rows, m0, valid=valid)
    out = torch.empty((nb, rows, x.shape[0] * step), dtype=torch.bfloat16, device=x.device)
    _kernels().blocked_transpose(x, m0, None if valid is None else _mask_u8(valid), out, nb,
                                 step, cube_transpose_geometry(x, nb, step).op_args(),
                                 _stream(x))
    _count("blocked_transpose")
    return out


def init_stats_bsp(xs: torch.Tensor, n: torch.Tensor, s: int):
    """C0 (nb, s, s) of the first s rows of the centred bf16 stream over the
    (nb,) f32 valid counts ``n``; see ``init_stats_bsp_plain``. One call is
    two launches, as ``init_stats``."""
    if xs.device.type == "cpu":
        return init_stats_bsp_plain(xs, n, s)
    nb = xs.shape[0]
    geom = stream_stats_geometry_for(xs, s)
    partial = torch.empty((nb, geom.nchunks, stats_record_len(s)), dtype=torch.float32,
                          device=xs.device)
    c0 = torch.empty((nb, s, s), dtype=torch.float32, device=xs.device)
    _kernels().init_stats_bsp(xs, n.contiguous(), partial, c0, geom.op_args(), _stream(xs))
    _count("init_stats_bsp")
    return c0


def filter_round_bsp(xs, valid, step, m0, carry, r, mf_prev, *, mode, cov_scale=1.0,
                     bf16_dots=False, center=False, geom=None):
    """One streaming pass over the blocked stream, bf16 or f32; see
    ``filter_round_bsp_plain``. On CUDA the stats come back per pixel chunk,
    (nb, nchunks, S + 2). ``geom``: ``stream_geometry(xs, S)``, which a
    filter works out once for all its rounds; made here when None."""
    if xs.device.type == "cpu":
        return filter_round_bsp_plain(xs, valid, step, m0, carry, r, mf_prev, mode=mode,
                                      cov_scale=cov_scale, bf16_dots=bf16_dots, center=center)
    nb, _, p = xs.shape
    if geom is None:
        geom = stream_geometry(xs, m0.shape[1])
    mf = torch.empty((nb, p), dtype=torch.float32, device=xs.device)
    if mode == FIRST:
        r = torch.empty_like(mf)
        mf_prev = mf  # not read in the first round
    stats = torch.empty((nb, geom.nchunks, m0.shape[1] + 2), dtype=torch.float32,
                        device=xs.device)
    _kernels().filter_round_bsp(mode, xs, None if valid is None else _mask_u8(valid), bf16_dots,
                                center, m0, carry, r, mf_prev, mf, stats, step, geom.op_args(),
                                float(cov_scale), _stream(xs))
    if valid is None:
        _count("filter_round_bsp_f32" if xs.dtype == torch.float32 else "filter_round_bsp")
    else:
        stored = "f32_masked" if xs.dtype == torch.float32 else "masked"
        _count(f"filter_round_bsp_{stored}_{'first' if mode == FIRST else 'loop'}")
    return mf, r, (None if mode == FINAL else stats)


def blocked_transpose_shw(x, nb, step, rows):
    """The (S, H, nb * step) f32 cube -> the f32 blocked stream (nb, rows,
    H * step); see ``blocked_transpose_shw_plain``."""
    if x.device.type == "cpu":
        return blocked_transpose_shw_plain(x, nb, step, rows)
    out = torch.empty((nb, rows, x.shape[1] * step), dtype=torch.float32, device=x.device)
    _kernels().blocked_transpose_shw(x, out, nb, step, _stream(x))
    _count("blocked_transpose_shw")
    return out


def init_stats_stream(xs: torch.Tensor, s: int):
    """m0 (nb, s), C0 (nb, s, s) of the raw f32 stream xs (nb, R, P); see
    ``init_stats_stream_plain``. One call is two launches, as ``init_stats``."""
    if xs.device.type == "cpu":
        return init_stats_stream_plain(xs, s)
    nb = xs.shape[0]
    geom = stream_stats_geometry_for(xs, s)
    partial = torch.empty((nb, geom.nchunks, stats_record_len(s)), dtype=torch.float32,
                          device=xs.device)
    m0 = torch.empty((nb, s), dtype=torch.float32, device=xs.device)
    c0 = torch.empty((nb, s, s), dtype=torch.float32, device=xs.device)
    _kernels().init_stats_stream(xs, partial, m0, c0, geom.op_args(), _stream(xs))
    _count("init_stats_stream")
    return m0, c0


def fused_iter(xs, valid, m0, carry, r, mf_prev, *, first, woodbury, cov_scale=1.0,
               center=False, geom=None):
    """One ``_fused_iter_kernel`` pass over the stream xs (nb, R, P), f32 or
    bf16; see ``fused_iter_plain``. On CUDA the WOODBURY stats come back per
    pixel chunk, (nb, nchunks, S + 2), with ``geom`` as ``filter_round_bsp``'s;
    a CHOLESKY call is two launches (the chunk records, then their f64
    combine), as ``init_stats``, with ``geom`` ``stream_stats_geometry_for(xs,
    S, pixel_rows=True)``. A filter works ``geom`` out once for all its
    passes; it is made here when None."""
    if xs.device.type == "cpu":
        return fused_iter_plain(xs, valid, m0, carry, r, mf_prev, first=first, woodbury=woodbury,
                                cov_scale=cov_scale, center=center)
    nb, _, p = xs.shape
    s = m0.shape[1]
    dev = xs.device
    mf = torch.empty((nb, p), dtype=torch.float32, device=dev)
    args = (bool(first), xs, None if valid is None else _mask_u8(valid), center, m0, carry, r,
            mf_prev, mf)
    if woodbury:
        if geom is None:
            geom = stream_geometry(xs, s)
        stats = torch.empty((nb, geom.nchunks, s + 2), dtype=torch.float32, device=dev)
        _kernels().fused_iter_woodbury(*args, stats, geom.op_args(), float(cov_scale),
                                       _stream(xs))
        _count("fused_iter_woodbury")
        return mf, stats
    if geom is None:
        geom = stream_stats_geometry_for(xs, s, pixel_rows=True)
    partial = torch.empty((nb, geom.nchunks, stats_record_len(s)), dtype=torch.float32,
                          device=dev)
    mean = torch.empty((nb, s), dtype=torch.float32, device=dev)
    cov = torch.empty((nb, s, s), dtype=torch.float32, device=dev)
    _kernels().fused_iter_cholesky(*args, partial, mean, cov, geom.op_args(), float(cov_scale),
                                   _stream(xs))
    _count("fused_iter_cholesky")
    return mf, (mean, cov)


def mono_counters(xs: torch.Tensor) -> torch.Tensor:
    """The (nb,) per-block counters of ``filter_round_mono``'s last-CTA glue,
    zeroed in stream order. Make them once per filter: each launch leaves
    them at 0 again."""
    return torch.zeros((xs.shape[0],), dtype=torch.int32, device=xs.device)


def mono_geometry(xs: torch.Tensor, s: int) -> RoundGeometry:
    """``stream_geometry`` of ``filter_round_mono`` (its static flag beside
    the ring)."""
    return stream_geometry(xs, s, static_smem=MONO_STATIC_SMEM)


def filter_round_mono(xs, m0, carry, r, mf_prev, template, k0, n, *, mode, alpha,
                      counter, cov_scale=1.0, center=False, geom=None):
    """One mono round and, unless FINAL, the glue of every block in the same
    launch; see ``filter_round_mono_plain``. Returns (mf, R, the next carry
    or None). ``counter`` is ``mono_counters(xs)``, shared by the rounds of
    one filter (the twin does not read it); ``geom`` is ``mono_geometry(xs,
    S)``, made here when None."""
    if xs.device.type == "cpu":
        return filter_round_mono_plain(xs, m0, carry, r, mf_prev, template, k0, n, mode=mode,
                                       alpha=alpha, cov_scale=cov_scale, center=center)
    nb, _, p = xs.shape
    dev = xs.device
    mf = torch.empty((nb, p), dtype=torch.float32, device=dev)
    if mode == FIRST:
        r = torch.empty_like(mf)
        mf_prev = mf  # not read in the first round
    if geom is None:
        geom = mono_geometry(xs, m0.shape[1])
    partial = torch.empty((nb, geom.nchunks, m0.shape[1] + 2), dtype=torch.float32, device=dev)
    carry_out = torch.empty_like(carry)
    _kernels().filter_round_mono(mode, xs, center, m0, carry, r, mf_prev, mf, partial, carry_out,
                                 counter, k0, template, _inverse_counts(n, m0), geom.op_args(),
                                 float(cov_scale), float(alpha), _stream(xs))
    _count("filter_round_mono_first" if mode == FIRST else "filter_round_mono_loop")
    return mf, r, (None if mode == FINAL else carry_out)


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

    On CUDA every step is a hand-written kernel; on the CPU the plain twins
    run the same sequence.
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
        k0, tgt0, cit0, norm0 = woodbury_base(c0, m0, tpl, alpha)
        rnd = functools.partial(filter_round, x, nb, step, m0,
                                cov_scale=covariance_update_scaling,
                                geom=cube_geometry(x, nb, step))
        return _filter_sequence(rnd, filter_glue, m0, k0, tgt0, cit0, norm0, tpl,
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

    On CUDA: ``init_stats_masked``, ``woodbury_base``, then
    ``filter_round_masked`` and ``filter_glue`` with the per-block valid
    counts; on the CPU the plain twins run the same sequence.
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
        k0, tgt0, cit0, norm0 = woodbury_base(c0, m0, tpl, alpha)
        rnd = functools.partial(filter_round_masked, x, valid, nb, step, m0,
                                cov_scale=covariance_update_scaling,
                                geom=cube_geometry(x, nb, step))
        return _filter_sequence(rnd, filter_glue, m0, k0, tgt0, cit0, norm0, tpl,
                                n, num_iter=num_iter, alpha=alpha)


def bsp_filter_plain(xs, valid, step, m0, k0, tgt0, cit0, norm0, template, n, *,
                     bf16_dots: bool = False, num_iter: int = 30, alpha: float = 0.0,
                     cov_scale: float = 1.0):
    """The whole filter over the blocked stream xs (nb, R, P) from the
    Woodbury base with the plain twins, in the dtype of its inputs; ``n``
    the pixel count of every block (a number) or of each block ((nb,)).
    Both bf16 routes: ``valid`` None and no ``bf16_dots`` (every pixel
    valid), or the (H, W) mask with ``bf16_dots``. Returns (mf scaled by
    1e5, R), each (nb, P)."""
    _check_num_iter(num_iter)
    rnd = functools.partial(filter_round_bsp_plain, xs, valid, step, m0, cov_scale=cov_scale,
                            bf16_dots=bf16_dots)
    return _filter_sequence(rnd, filter_glue_plain, m0, k0, tgt0, cit0, norm0, template, n,
                            num_iter=num_iter, alpha=alpha)


def acrwl1mf_resident_bsp(
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
    """The filter over the (H, nb * step, S) cube with a bf16 stream, every
    pixel valid (``acrwl1mf_fused(x_layout="bsp", glue="resident")`` at
    bf16): ``init_stats`` on the cube (JAX reads a blocked f32 copy for the
    same m0 and C0), the Woodbury base, ``blocked_transpose`` into the bf16
    stream centred by m0, then ``filter_round_bsp`` (bf16 storage, f32
    products) and ``filter_glue``. Returns (mf scaled by 1e5, R) as
    (nb, H * step) rows, p = h * step + j.
    """
    _check_num_iter(num_iter)
    dev = resolve_device(device)
    x = torch.as_tensor(scene_hws, dtype=torch.float32, device=dev).contiguous()
    tpl = torch.as_tensor(template, dtype=torch.float32, device=dev)
    if x.shape[1] != nb * step:
        raise ValueError("scene width must equal nb*step")
    with float32_precision():
        m0, c0 = init_stats(x, nb, step)
        k0, tgt0, cit0, norm0 = woodbury_base(c0, m0, tpl, alpha)
        xs = blocked_transpose(x, nb, step, stream_rows(x.shape[2]), m0)
        rnd = functools.partial(filter_round_bsp, xs, None, step, m0,
                                cov_scale=covariance_update_scaling,
                                geom=stream_geometry(xs, m0.shape[1]))
        return _filter_sequence(rnd, filter_glue, m0, k0, tgt0, cit0, norm0, tpl,
                                x.shape[0] * step, num_iter=num_iter, alpha=alpha)


def acrwl1mf_masked_bf16(
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
    """The weighted filter of ``acrwl1mf_masked`` with a bf16 stream
    (``acrwl1mf_fused(glue="fused", stream_dtype=bf16)`` with a weight row):
    the f32 mean of each block's valid pixels, ``blocked_transpose`` into the
    centred, masked bf16 stream, its second moment by ``init_stats_bsp``
    (not re-centred, as :1814-1824), the Woodbury base, then
    ``filter_round_bsp`` with the mask and bf16 dots, and ``filter_glue``
    with the per-block valid counts. Returns (mf scaled by 1e5, R) as
    (nb, H * step) rows, mf = 0 and R = 1 at the pixels that do not count.
    """
    _check_num_iter(num_iter)
    dev = resolve_device(device)
    x = torch.as_tensor(scene_hws, dtype=torch.float32, device=dev).contiguous()
    tpl = torch.as_tensor(template, dtype=torch.float32, device=dev)
    valid = _mask_u8(torch.as_tensor(valid_mask, device=dev))
    if valid.shape != x.shape[:2] or not (nb - 1) * step < x.shape[1] <= nb * step:
        raise ValueError(f"valid mask {tuple(valid.shape)} and {nb} blocks of {step} columns "
                         f"do not fit the cube {tuple(x.shape)}")
    s = x.shape[2]
    with float32_precision():
        n = block_valid_counts(valid, nb, step).clamp(min=1).to(torch.float32)
        m0 = masked_block_means(x, valid, nb, step, n)
        xs = blocked_transpose(x, nb, step, stream_rows(s), m0, valid=valid)
        c0 = init_stats_bsp(xs, n, s)
        k0, tgt0, cit0, norm0 = woodbury_base(c0, m0, tpl, alpha)
        rnd = functools.partial(filter_round_bsp, xs, valid, step, m0,
                                cov_scale=covariance_update_scaling, bf16_dots=True,
                                geom=stream_geometry(xs, s))
        return _filter_sequence(rnd, filter_glue, m0, k0, tgt0, cit0, norm0, tpl,
                                n, num_iter=num_iter, alpha=alpha)
