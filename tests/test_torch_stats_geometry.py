"""The cube statistics' launch geometry and record (starcop_tpu_torch.ops.
mag1c_kernels.stats_geometry, the kernel init_stats_partial_kernel): chunks
that cover every pixel once, a grid that fills its waves, shared memory within
an SM, and the kernel's per-chunk Chan fold and lower-triangle record,
restated in torch, combined in f64 to the plain twins' m0 and C0. Runs on the
CPU; the kernel itself is held against its twins on the card by
chip_smoke.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from starcop_tpu_torch.ops import mag1c_kernels as tk  # noqa: E402

SMEM_LIMIT = 227 * 1024  # H100: shared memory one CTA may use

# (nb, H, step, S, W): the bench cube, the served granule (ragged last block),
# odd S and step, a step wider than a tile, and S = 128.
SHAPES = [(23, 1280, 54, 50, 1242), (39, 1280, 32, 50, 1242), (3, 99, 15, 37, 45),
          (4, 99, 15, 37, 47), (2, 60, 25, 128, 47), (23, 1280, 54, 128, 1242),
          (2, 6, 145, 4, 290)]


def _chunk_pixels(geom, h, step):
    """Pixel indices (p = h * step + j) of each chunk, in the order the CTA
    walks its tiles (the kernel's tile -> rows, columns map)."""
    nseg = -(-step // geom.tile_cols)
    chunks = []
    for c in range(geom.nchunks):
        pix = []
        for tile in range(c * geom.tiles_per_chunk,
                          min(geom.tiles_per_block, (c + 1) * geom.tiles_per_chunk)):
            grp, seg = divmod(tile, nseg)
            rows = range(grp * geom.tile_rows, min(h, (grp + 1) * geom.tile_rows))
            cols = range(seg * geom.tile_cols, min(step, (seg + 1) * geom.tile_cols))
            pix.append([r * step + j for r in rows for j in cols])
        chunks.append(pix)
    return chunks


@pytest.mark.parametrize("nb, h, step, s, w", SHAPES)
def test_chunks_cover_every_pixel_once(nb, h, step, s, w):
    geom = tk.stats_geometry(nb, h, step, s, width=w)
    assert geom.tile_rows * geom.tile_cols <= tk.ROUND_THREADS
    flat = [q for ch in _chunk_pixels(geom, h, step) for tile in ch for q in tile]
    assert sorted(flat) == list(range(h * step)) and len(flat) == h * step
    assert all(_chunk_pixels(geom, h, step))  # no empty chunk
    assert (geom.nchunks - 1) * geom.tiles_per_chunk < geom.tiles_per_block


@pytest.mark.parametrize("nb, h, step, s, w", SHAPES)
def test_grid_fills_its_waves(nb, h, step, s, w):
    """Every wave but the last is full, and the last leaves fewer slots idle
    than there are blocks (one more chunk per block would not fit), unless
    every chunk is already the smallest unit: the tiles of one block row."""
    geom = tk.stats_geometry(nb, h, step, s, width=w)
    slots = geom.ctas_per_sm * tk.DEFAULT_SM_COUNT
    ctas = nb * geom.nchunks
    waves = -(-ctas // slots)
    unit = -(-step // geom.tile_cols)
    assert geom.tiles_per_chunk == unit or ctas > waves * slots - nb, (ctas, slots)
    if (nb, h, step, s) == (23, 1280, 54, 50):  # the bench cube: one wave at 2 CTAs per SM
        assert geom.ctas_per_sm == tk.STATS_CTAS_PER_SM and waves == 1


@pytest.mark.parametrize("nb, h, step, s, w", SHAPES)
def test_shared_memory_within_budget(nb, h, step, s, w):
    geom = tk.stats_geometry(nb, h, step, s, width=w)
    assert 2 <= geom.stages <= tk.MAX_STAGES and geom.ctas_per_sm >= 1
    assert geom.static_smem == tk.STATS_STATIC_SMEM
    assert geom.smem_bytes + geom.static_smem <= SMEM_LIMIT
    per_cta = geom.smem_bytes + geom.static_smem + tk.CTA_RESERVED_SMEM
    assert geom.ctas_per_sm * per_cta <= tk.SMEM_PER_SM
    # The kernel's own formula (csrc/mag1c.cu: stats_smem_bytes): the ring,
    # the centred tile at 8 ceil(S / 8) floats a pixel, the groups' sums.
    tile = 4 * geom.tile_rows * (-(-geom.tile_cols * s // 4) * 4)
    ring = geom.stages * (tile + 5 * tk.ROUND_THREADS) + 4 * tk.ROUND_THREADS * (-(-s // 8) * 8)
    assert geom.smem_bytes >= ring and geom.smem_bytes == tk.stats_smem_bytes(geom.stages, tile, s)


@pytest.mark.parametrize("step, w, aligned", [(54, 1242, True), (32, 1242, True), (15, 45, False),
                                              (15, 47, False)])
def test_copy_width_follows_the_shapes(step, w, aligned):
    s = 50 if step in (32, 54) else 37
    nb = -(-w // step)
    assert tk.stats_geometry(nb, 99, step, s, width=w).aligned == aligned
    assert not tk.stats_geometry(nb, 99, step, s, width=w, aligned_ptr=False).aligned


def _tri(s):
    return tuple(torch.tril_indices(s, s))  # row by row: (a, bb), bb <= a


def _kernel_records(x, valid, nb, step, geom):
    """The kernel's records in f64: per (block, chunk) the valid count, the
    running mean and the lower triangle of the centred scatter, folded tile
    by tile by Chan's rule as the kernel states it: the tile centred on the
    running mean, then the rank-1 term -(n_t^2 / n') d d^T; the first tile
    with valid pixels centred on its own mean; a tile with no valid pixel
    skipped."""
    h, w, s = x.shape
    a, bb = _tri(s)
    recs = torch.zeros((nb, geom.nchunks, tk.stats_record_len(s)), dtype=torch.float64)
    for b in range(nb):
        ncols = min(step, w - b * step)
        for c, chunk in enumerate(_chunk_pixels(geom, h, step)):
            n_run, mean = 0, torch.zeros(s, dtype=torch.float64)
            scat = torch.zeros((s, s), dtype=torch.float64)
            for tile in chunk:
                rows, cols = [p // step for p in tile], [p % step for p in tile]
                keep = [j < ncols and (valid is None or bool(valid[r, b * step + j]))
                        for r, j in zip(rows, cols)]
                px = [x[r, b * step + j] for r, j, k in zip(rows, cols, keep) if k]
                if not px:
                    continue
                xt = torch.stack(px).double()
                n_t = xt.shape[0]
                if n_run == 0:
                    mean = xt.mean(0)
                xc = xt - mean
                d = xc.mean(0)
                n_new = n_run + n_t
                scat += xc.T @ xc - (n_t * n_t / n_new) * torch.outer(d, d)
                mean = mean + d * (n_t / n_new)
                n_run = n_new
            recs[b, c, 0] = n_run
            recs[b, c, 1:1 + s] = mean
            recs[b, c, 1 + s:] = scat[a, bb]
    return recs


def _combine(recs, s):
    """init_stats_reduce_kernel: the chunk records of each block combined in
    f64, n clamped to >= 1, the triangle mirrored into the full C0."""
    a, bb = _tri(s)
    n_c, mean_c, tri_c = recs[..., 0], recs[..., 1:1 + s], recs[..., 1 + s:]
    n = n_c.sum(1).clamp(min=1)
    m = (n_c[..., None] * mean_c).sum(1) / n[:, None]
    d = mean_c - m[:, None, :]
    tri = (tri_c + n_c[..., None] * d[..., a] * d[..., bb]).sum(1) / n[:, None]
    c0 = torch.zeros((recs.shape[0], s, s), dtype=torch.float64)
    c0[:, a, bb] = tri
    c0[:, bb, a] = tri
    return m, c0


def _odd_cube(h, w, s, seed):
    rng = np.random.default_rng(seed)
    base = rng.uniform(2.0, 6.0, (1, 1, s))
    x = rng.uniform(0.5, 2.0, (h, w, 1)) * base * (1 + 0.05 * rng.normal(size=(h, w, s)))
    return torch.from_numpy(x)


@pytest.mark.parametrize("sm_count", [tk.DEFAULT_SM_COUNT, 1])  # 1: many tiles per chunk
@pytest.mark.parametrize("h, w, s, step, masked", [
    (20, 45, 37, 15, False), (20, 47, 37, 15, True), (9, 23, 5, 6, True), (6, 290, 4, 145, False),
    (5, 47, 128, 25, True)])
def test_chunk_records_combine_to_the_twins(sm_count, h, w, s, step, masked):
    """The kernel's per-chunk fold and triangle record, combined in f64, give
    init_stats_plain's (or init_stats_masked_plain's) m0 and C0 to 1e-12;
    masked, block 1 has no valid pixel and gets m0 = 0, C0 = 0."""
    x = _odd_cube(h, w, s, seed=s)
    nb = -(-w // step)
    valid = None
    if masked:
        valid = torch.from_numpy(np.random.default_rng(7).random((h, w)) > 0.2)
        valid[:, step:2 * step] = False  # block 1 wholly invalid
        x = torch.where(valid[..., None], x, torch.tensor(-9999.0, dtype=x.dtype))
    geom = tk.stats_geometry(nb, h, step, s, width=w, sm_count=sm_count)
    if sm_count == 1:
        assert geom.tiles_per_chunk > 1 or geom.nchunks == 1
    m0, c0 = _combine(_kernel_records(x, valid, nb, step, geom), s)
    if masked:
        m0_p, c0_p = tk.init_stats_masked_plain(x, valid, nb, step)
        assert bool((m0[1] == 0).all() and (c0[1] == 0).all())
    else:
        m0_p, c0_p = tk.init_stats_plain(x, nb, step)
    torch.testing.assert_close(m0, m0_p, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(c0, c0_p, rtol=1e-12, atol=1e-12)


class _RecordingKernels:
    """Stands in for torch.ops.starcop_mag1c and records each op's arguments."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return lambda *args: self.calls.append((name, args))


@pytest.mark.parametrize("masked", [False, True])
def test_wrappers_hand_the_geometry_to_the_op(monkeypatch, masked):
    fake = _RecordingKernels()
    monkeypatch.setattr(tk, "_kernels", lambda: fake)
    monkeypatch.setattr(tk, "_stream", lambda x: 0)
    x = torch.empty((99, 47 if masked else 45, 37), device="meta")
    nb, step = (4, 15) if masked else (3, 15)
    if masked:
        valid = torch.empty((99, 47), dtype=torch.bool, device="meta")
        m0, c0 = tk.init_stats_masked(x, valid, nb, step)
    else:
        m0, c0 = tk.init_stats(x, nb, step)
    geom = tk.cube_stats_geometry(x, nb, step)
    name, args = fake.calls[-1]
    partial = args[-7]
    assert name == ("init_stats_masked" if masked else "init_stats")
    assert args[-2] == geom.op_args() and args[-4:-2] == (nb, step)
    assert partial.shape == (nb, geom.nchunks, tk.stats_record_len(37))
    assert m0.shape == (nb, 37) and c0.shape == (nb, 37, 37)


@pytest.mark.parametrize("op", ["bsp", "stream", "cholesky"])
def test_other_statistics_take_the_triangle_record(monkeypatch, op):
    """init_stats_bsp, init_stats_stream and fused_iter CHOLESKY write the
    same record format over S live rows, one record per chunk of
    stream_stats_geometry, which the wrapper hands to the op."""
    fake = _RecordingKernels()
    monkeypatch.setattr(tk, "_kernels", lambda: fake)
    monkeypatch.setattr(tk, "_stream", lambda x: 0)
    p, rows, s = 1485, 40, 37
    dtype = torch.bfloat16 if op == "bsp" else torch.float32
    xs = torch.empty((3, rows, p), dtype=dtype, device="meta")
    if op == "bsp":
        c0 = tk.init_stats_bsp(xs, torch.empty(3, device="meta"), s)
        partial, geom_arg = fake.calls[-1][1][2], fake.calls[-1][1][4]
        assert c0.shape == (3, s, s)  # the live rows only
    elif op == "stream":
        tk.init_stats_stream(xs, s)
        partial, geom_arg = fake.calls[-1][1][1], fake.calls[-1][1][4]
    else:
        m0, carry = torch.empty((3, s), device="meta"), torch.empty((3, 4, s), device="meta")
        r = torch.empty((3, p), device="meta")
        tk.fused_iter(xs, None, m0, carry, r, r, first=False, woodbury=False)
        partial, geom_arg = fake.calls[-1][1][9], fake.calls[-1][1][12]
    geom = tk.stream_stats_geometry_for(xs, s, pixel_rows=op == "cholesky")
    assert geom_arg == geom.op_args()
    assert partial.shape == (3, geom.nchunks, tk.stats_record_len(s))
