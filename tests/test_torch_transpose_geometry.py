"""The launch geometry and tile walk of blocked_transpose (starcop_tpu_torch.
ops.mag1c_kernels.transpose_geometry; blocked_transpose_kernel in csrc/
mag1c.cu): tiles of whole block rows (or row segments) that cover every
(block, pixel) once in the order the CTA walks them, shared memory within an
SM, a grid that fills its waves, the copy width and the 16-byte output spans
the shapes allow, and the kernel's walk (gather a tile, centre, select,
round, scatter by band row) restated in torch and held bitwise against
blocked_transpose_plain. Runs on the CPU; the kernel itself is held against
its twin on the card by chip_smoke.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from starcop_tpu_torch.ops import mag1c_kernels as tk  # noqa: E402

SMEM_LIMIT = 227 * 1024  # H100: shared memory one CTA may use

# (nb, H, step, S, W): the bench cube, the served granule (ragged last
# block), 99 x 45 x 37 and 99 x 47 x 37 at step 15 (odd P = 1,485), 60 x 50 x
# 128 at step 25, and steps wider than one tile (row segments), one with a
# ragged last block, and a step wider than the shortest scene.
SHAPES = [(23, 1280, 54, 50, 1242), (39, 1280, 32, 50, 1242), (3, 99, 15, 37, 45),
          (4, 99, 15, 37, 47), (2, 60, 25, 128, 50), (2, 8, 176, 128, 290),
          (2, 8, 176, 128, 352), (2, 9, 300, 50, 599), (2, 6, 145, 4, 290)]


def _geometry(nb, h, step, s, w, sm_count=tk.DEFAULT_SM_COUNT):
    return tk.transpose_geometry(nb, h, step, s, width=w, sm_count=sm_count)


def _tiles(geom, h, step, w, b, masked):
    """The tiles of block b in the order its CTAs walk them, chunk by chunk:
    (chunk, first row, rows, first column, columns, columns read), as the
    kernel's tile_at states them."""
    nseg = -(-step // geom.tile_cols)
    ncols_b = min(step, w - b * step) if masked else step
    out = []
    for c in range(geom.nchunks):
        for tile in range(c * geom.tiles_per_chunk,
                          min(geom.tiles_per_block, (c + 1) * geom.tiles_per_chunk)):
            grp, seg = divmod(tile, nseg)
            h0, col0 = grp * geom.tile_rows, seg * geom.tile_cols
            ncols = min(geom.tile_cols, step - col0)
            out.append((c, h0, min(geom.tile_rows, h - h0), col0, ncols,
                        max(0, min(ncols, ncols_b - col0))))
    return out


@pytest.mark.parametrize("nb, h, step, s, w", SHAPES)
def test_tiles_cover_every_pixel_once_in_order(nb, h, step, s, w):
    """Each tile is one contiguous p-range p0 .. p0 + npx of the output (its
    rows whole block rows, or one segment of a row); walked chunk by chunk
    they give p = 0 .. P - 1 in order, and no chunk is empty."""
    geom = _geometry(nb, h, step, s, w)
    assert geom.tile_rows == 1 or geom.tile_cols == step
    # Two stages of the tile leave two CTAs on an SM; whole rows span at
    # least TRANSPOSE_MIN_PIXELS pixels where that fits.
    per_cta = tk.SMEM_PER_SM // tk.STATS_CTAS_PER_SM - tk.CTA_RESERVED_SMEM - \
        tk.TRANSPOSE_STATIC_SMEM
    fits = lambda px: 2 * tk.transpose_stage_bytes(px, s) <= per_cta  # noqa: E731
    tp = geom.tile_rows * geom.tile_cols
    assert fits(tp)
    assert geom.tile_cols < step or tp >= min(tk.TRANSPOSE_MIN_PIXELS, h * step) or \
        not fits(tp + step)
    assert geom.tile_cols == step or not fits(step)
    flat, chunks = [], set()
    for c, h0, nrows, col0, ncols, _ in _tiles(geom, h, step, w, 0, False):
        pix = [(h0 + rr) * step + col0 + j for rr in range(nrows) for j in range(ncols)]
        assert pix == list(range(h0 * step + col0, h0 * step + col0 + nrows * ncols))
        flat += pix
        chunks.add(c)
    assert flat == list(range(h * step))
    assert chunks == set(range(geom.nchunks))
    assert (geom.nchunks - 1) * geom.tiles_per_chunk < geom.tiles_per_block


@pytest.mark.parametrize("nb, h, step, s, w", SHAPES)
def test_shared_memory_within_budget(nb, h, step, s, w):
    geom = _geometry(nb, h, step, s, w)
    assert 2 <= geom.stages <= tk.MAX_STAGES and geom.ctas_per_sm >= 1
    assert geom.static_smem == tk.TRANSPOSE_STATIC_SMEM
    assert geom.smem_bytes + geom.static_smem <= SMEM_LIMIT
    per_cta = geom.smem_bytes + geom.static_smem + tk.CTA_RESERVED_SMEM
    assert geom.ctas_per_sm * per_cta <= tk.SMEM_PER_SM
    # The kernel's own formula (csrc/mag1c.cu: transpose_stage_bytes): the
    # tile on 16 bytes, then a mask word and a position byte per pixel.
    tp = geom.tile_rows * geom.tile_cols
    stage = tk.transpose_stage_bytes(tp, s)
    assert stage % 16 == 0 and stage >= 4 * tp * s + 5 * tp
    assert geom.smem_bytes == geom.stages * stage
    # One more stage would not leave STATS_CTAS_PER_SM CTAs on an SM.
    if geom.stages < tk.MAX_STAGES:
        more = (geom.stages + 1) * stage + geom.static_smem + tk.CTA_RESERVED_SMEM
        assert tk.STATS_CTAS_PER_SM * more > tk.SMEM_PER_SM


@pytest.mark.parametrize("nb, h, step, s, w", SHAPES)
def test_grid_fills_its_waves(nb, h, step, s, w):
    """Every wave but the last is full, and the last leaves fewer slots idle
    than there are blocks (one more chunk per block would not fit), unless
    every chunk is already the smallest unit: the tiles of one block row."""
    geom = _geometry(nb, h, step, s, w)
    slots = geom.ctas_per_sm * tk.DEFAULT_SM_COUNT
    ctas = nb * geom.nchunks
    waves = -(-ctas // slots)
    unit = -(-step // geom.tile_cols)
    assert geom.tiles_per_chunk % unit == 0
    assert geom.tiles_per_chunk == unit or ctas > waves * slots - nb, (ctas, slots)
    if s == 50 and step in (32, 54):  # the EMIT shapes: 2 CTAs per SM, waves >= 90 % full
        assert geom.ctas_per_sm == tk.STATS_CTAS_PER_SM and ctas >= 0.9 * waves * slots


@pytest.mark.parametrize("step, w, s, aligned", [
    (54, 1242, 50, True), (32, 1242, 50, True), (15, 45, 37, False), (15, 47, 37, False),
    (25, 50, 128, True), (176, 290, 128, True), (300, 599, 50, False)])
def test_copy_width_follows_the_shapes(step, w, s, aligned):
    """16-byte copies only where every tile row starts and ends on 16 bytes
    of the cube (W S, step S and the segment's columns S multiples of 4, the
    cube on 16 bytes)."""
    nb = -(-w // step)
    assert tk.transpose_geometry(nb, 99, step, s, width=w).aligned == aligned
    assert not tk.transpose_geometry(nb, 99, step, s, width=w, aligned_ptr=False).aligned


@pytest.mark.parametrize("nb, h, step, s, w, align", [
    (23, 1280, 54, 50, 1242, 8), (39, 1280, 32, 50, 1242, 16), (2, 96, 15, 37, 30, 16),
    (3, 99, 15, 37, 45, 0), (2, 60, 25, 128, 50, 0), (2, 8, 176, 128, 290, 16)])
def test_output_spans_on_whole_sectors(nb, h, step, s, w, align):
    """Every tile's band rows start and end (but for a ragged last tile) on
    ``align`` pixels of the bf16 output: 16 (32-byte sectors) where the rows
    of such a unit fit a tile, 8 (16 bytes) at step 54, where 8 rows (86 KB)
    would not; the kernel's 16-byte stores cover them, each warp store whole
    sectors where 16. At odd P (1,485; 1,500 with 100-pixel tiles) they do
    not, and the kernel stores element-wise or in 4-byte pairs."""
    geom = _geometry(nb, h, step, s, w)
    tiles = _tiles(geom, h, step, w, 0, False)
    starts = [h0 * step + col0 for _, h0, _, col0, _, _ in tiles]
    ends = [p0 + nrows * ncols for p0, (_, _, nrows, _, ncols, _) in zip(starts, tiles)]
    got = max([a for a in (16, 8) if (h * step) % a == 0 and all(p0 % a == 0 for p0 in starts)],
              default=0)
    assert got == align
    if align:
        assert all(e % align == 0 for e in ends[:-1])
    if (nb, step) in ((23, 54), (39, 32)):
        assert all(e % align == 0 for e in ends)


# ---------------------------------------------------------------------------
# The kernel's walk, restated
# ---------------------------------------------------------------------------


def _kernel_walk(x, m0, valid, nb, step, rows, geom):
    """The stream as the kernel writes it, tile by tile: the tile's rows
    gathered as staged (columns past the ones read never copied: NaN), each
    value x - m0 in f32 selected to +0 where the pixel does not count, rounded
    to bf16 and scattered to band rows p0 .. p0 + npx, rows S.. +0. Entries
    no tile writes stay NaN."""
    h, w, s = x.shape
    out = torch.full((nb, rows, h * step), float("nan"), dtype=torch.bfloat16)
    for b in range(nb):
        for _, h0, nrows, col0, ncols, nload in _tiles(geom, h, step, w, b, valid is not None):
            c0 = b * step + col0
            staged = torch.full((nrows, ncols, s), float("nan"), dtype=x.dtype)
            staged[:, :nload] = x[h0:h0 + nrows, c0:c0 + nload]
            keep = torch.zeros((nrows, ncols), dtype=torch.bool)
            keep[:, :nload] = True if valid is None else valid[h0:h0 + nrows, c0:c0 + nload]
            v = torch.where(keep[..., None], staged - m0[b], 0.0)
            p0, npx = h0 * step + col0, nrows * ncols
            out[b, :s, p0:p0 + npx] = v.reshape(npx, s).T.to(torch.bfloat16)
            out[b, s:, p0:p0 + npx] = 0.0
    return out


def _cube(h, w, s, seed):
    rng = np.random.default_rng(seed)
    base = rng.uniform(2.0, 6.0, (1, 1, s))
    x = rng.uniform(0.5, 2.0, (h, w, 1)) * base * (1 + 0.05 * rng.normal(size=(h, w, s)))
    return torch.from_numpy(x.astype(np.float32))


def _bits(t):
    return t.view(torch.int16)


@pytest.mark.parametrize("sm_count", [tk.DEFAULT_SM_COUNT, 1])  # 1: many tiles per chunk
@pytest.mark.parametrize("h, w, s, step, mask", [
    (99, 45, 37, 15, None), (99, 45, 37, 15, "scattered"), (99, 47, 37, 15, "ragged"),
    (20, 50, 128, 25, None), (20, 50, 128, 25, "empty_block"), (8, 352, 128, 176, None),
    (8, 290, 128, 176, "ragged"), (16, 162, 50, 54, None), (15, 90, 50, 32, "ragged")])
def test_tile_walk_equals_the_twin_bitwise(sm_count, h, w, s, step, mask):
    """The kernel's tile walk gives blocked_transpose_plain bit for bit, pad
    rows included: unmasked, masked with a ragged last block, with a wholly
    invalid block, and with the fill -9999 and NaN at invalid pixels (they
    never reach the stream)."""
    x = _cube(h, w, s, seed=s + step)
    nb = -(-w // step)
    rows = tk.stream_rows(s)
    valid = None
    if mask is not None:
        rng = np.random.default_rng(step)
        valid = torch.from_numpy(rng.random((h, w)) > 0.1)
        if mask == "empty_block":
            valid[:, step:2 * step] = False
        fill = np.where(rng.random((h, w, s)) > 0.5, np.nan, -9999.0).astype(np.float32)
        x = torch.where(valid[..., None], x, torch.from_numpy(fill))
        m0 = tk.masked_block_means(x, valid, nb, step,
                                   tk.block_valid_counts(valid, nb, step).clamp(min=1).float())
    else:
        m0 = x.reshape(h, nb, step, s).mean((0, 2))
    geom = _geometry(nb, h, step, s, w, sm_count)
    if sm_count == 1:
        assert geom.tiles_per_chunk > -(-step // geom.tile_cols) or geom.nchunks == 1
    got = _kernel_walk(x, m0, valid, nb, step, rows, geom)
    want = tk.blocked_transpose_plain(x, nb, step, rows, m0, valid=valid)
    assert bool(torch.isfinite(want.float()).all())
    assert torch.equal(_bits(got), _bits(want))
    if mask == "empty_block":
        assert not bool(want[1].float().any())


# ---------------------------------------------------------------------------
# The wrapper hands the geometry on
# ---------------------------------------------------------------------------


class _RecordingKernels:
    """Stands in for torch.ops.starcop_mag1c and records each op's arguments."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return lambda *args: self.calls.append((name, args))


@pytest.mark.parametrize("masked", [False, True])
def test_wrapper_hands_the_geometry_to_the_op(monkeypatch, masked):
    fake = _RecordingKernels()
    monkeypatch.setattr(tk, "_kernels", lambda: fake)
    monkeypatch.setattr(tk, "_stream", lambda x: 0)
    w, nb, step, s = (47, 4, 15, 37) if masked else (45, 3, 15, 37)
    x = torch.empty((99, w, s), device="meta")
    m0 = torch.empty((nb, s), device="meta")
    valid = torch.empty((99, w), dtype=torch.bool, device="meta") if masked else None
    out = tk.blocked_transpose(x, nb, step, 40, m0, valid=valid)
    name, args = fake.calls[-1]
    geom = tk.cube_transpose_geometry(x, nb, step)
    assert geom == tk.transpose_geometry(nb, 99, step, s, width=w)
    assert name == "blocked_transpose" and args[6] == geom.op_args()
    assert args[4:6] == (nb, step) and args[3] is out
    assert (args[2] is not None) == masked
    assert out.shape == (nb, 40, 99 * step) and out.dtype == torch.bfloat16
