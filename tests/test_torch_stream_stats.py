"""The stream statistics' launch geometry and record (starcop_tpu_torch.ops.
mag1c_kernels.stream_stats_geometry; stream_stats_chunk in csrc/
mag1c_common.cuh behind init_stats_bsp, init_stats_stream and fused_iter
CHOLESKY): chunks that cover every pixel once, a grid that fills its waves,
shared memory within an SM, and the kernel's per-chunk record (the raw second
moment, or the running-mean Chan fold of x or of modx), restated in torch and
combined in f64 to the plain twins. Runs on the CPU; the kernels themselves
are held against their twins on the card by chip_smoke.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import cpu_share  # noqa: E402,F401

from starcop_tpu_torch.ops import mag1c_kernels as tk  # noqa: E402

SMEM_LIMIT = 227 * 1024  # H100: shared memory one CTA may use

# (nb, P, S, element bytes, CHOLESKY's pixel rows): the bench f32 stream, the
# served bf16 stream, CHOLESKY's live rows, S = 37 at an odd P (4-byte and
# word copies), and S = 128.
SHAPES = [(23, 69120, 50, 4, False), (39, 40960, 50, 2, False), (23, 69120, 50, 4, True),
          (3, 1485, 37, 4, False), (3, 1485, 37, 2, False), (3, 1485, 37, 4, True),
          (3, 1485, 37, 2, True), (2, 1500, 128, 4, False), (2, 1500, 128, 2, False),
          (2, 1500, 128, 4, True), (23, 69120, 128, 4, True)]


def _geometry(nb, p, s, eb, rows, sm_count=tk.DEFAULT_SM_COUNT):
    return tk.stream_stats_geometry(nb, p, s, eb, pixel_rows=rows, sm_count=sm_count)


def _chunk_tiles(geom, p):
    """Pixel indices of each tile of each chunk, in the order the CTA walks
    them: tile t is pixels t * 128 .. of the block."""
    tp = geom.tile_cols
    return [[list(range(t * tp, min(p, (t + 1) * tp)))
             for t in range(c * geom.tiles_per_chunk,
                            min(geom.tiles_per_block, (c + 1) * geom.tiles_per_chunk))]
            for c in range(geom.nchunks)]


@pytest.mark.parametrize("nb, p, s, eb, rows", SHAPES)
def test_chunks_cover_every_pixel_once(nb, p, s, eb, rows):
    geom = _geometry(nb, p, s, eb, rows)
    assert (geom.tile_rows, geom.tile_cols) == (1, tk.ROUND_THREADS)
    chunks = _chunk_tiles(geom, p)
    flat = [q for ch in chunks for tile in ch for q in tile]
    assert flat == list(range(p))
    assert all(chunks)  # no empty chunk
    assert (geom.nchunks - 1) * geom.tiles_per_chunk < geom.tiles_per_block


@pytest.mark.parametrize("nb, p, s, eb, rows", SHAPES)
def test_grid_fills_its_waves(nb, p, s, eb, rows):
    """Every wave but the last is full, and the last leaves fewer slots idle
    than there are blocks (one more chunk per block would not fit), unless
    every chunk is already one tile."""
    geom = _geometry(nb, p, s, eb, rows)
    slots = geom.ctas_per_sm * tk.DEFAULT_SM_COUNT
    ctas = nb * geom.nchunks
    waves = -(-ctas // slots)
    assert geom.tiles_per_chunk == 1 or ctas > waves * slots - nb, (ctas, slots)
    if s <= 50:  # the EMIT band counts: two CTAs of 256 threads per SM
        assert geom.ctas_per_sm == tk.STATS_CTAS_PER_SM
    if (nb, p, s) == (23, 69120, 50):  # the bench stream: one wave
        assert waves == 1


@pytest.mark.parametrize("nb, p, s, eb, rows", SHAPES)
def test_shared_memory_within_budget(nb, p, s, eb, rows):
    geom = _geometry(nb, p, s, eb, rows)
    assert 2 <= geom.stages <= tk.MAX_STAGES and geom.ctas_per_sm >= 1
    assert geom.static_smem == tk.STREAM_STATS_STATIC_SMEM
    assert geom.smem_bytes + geom.static_smem <= SMEM_LIMIT
    per_cta = geom.smem_bytes + geom.static_smem + tk.CTA_RESERVED_SMEM
    assert geom.ctas_per_sm * per_cta <= tk.SMEM_PER_SM
    # The kernel's own formula (csrc/mag1c_common.cuh: stream_stats_smem_bytes):
    # the ring of tiles (a bf16 row padded to 136 values) and CHOLESKY's pixel
    # rows, the centred tile at an odd number of float4 a pixel, the groups' sums.
    tile = s * (272 if eb == 2 else 512)
    pitch = -(-s // 8) * 8 + 4
    assert pitch % 8 == 4
    ring = geom.stages * (tile + (tk.STATS_PIX_BYTES if rows else 0)) + 4 * 128 * pitch
    assert geom.smem_bytes >= ring
    assert geom.smem_bytes == tk.stream_stats_smem_bytes(geom.stages, tile, s, rows)
    assert tk.STATS_PIX_BYTES % 16 == 0 and tk.STATS_PIX_BYTES >= 8 * 128 + 4 * (128 // 4 + 1)
    # One more stage would not leave STATS_CTAS_PER_SM CTAs on an SM.
    if geom.stages < tk.MAX_STAGES and geom.ctas_per_sm == tk.STATS_CTAS_PER_SM:
        more = tk.stream_stats_smem_bytes(geom.stages + 1, tile, s, rows)
        assert tk.STATS_CTAS_PER_SM * (more + geom.static_smem + tk.CTA_RESERVED_SMEM) > \
            tk.SMEM_PER_SM


@pytest.mark.parametrize("p, eb, aligned", [
    (69120, 4, True), (40960, 2, True), (1485, 4, False), (1485, 2, False), (1486, 2, False),
    (1484, 4, True), (1484, 2, False), (1480, 2, True)])
def test_copy_width_follows_the_shapes(p, eb, aligned):
    """16-byte copies only where every band row starts on 16 bytes."""
    assert tk.stream_stats_geometry(3, p, 37, eb).aligned == aligned
    assert not tk.stream_stats_geometry(3, p, 37, eb, aligned_ptr=False).aligned


# ---------------------------------------------------------------------------
# The kernel's record, restated
# ---------------------------------------------------------------------------


def _tri(s):
    return tuple(torch.tril_indices(s, s))  # row by row: (a, bb), bb <= a


def _fold(tiles, s, mean_fold):
    """One chunk's record in f64 from its tiles (each the (n_t, s) rows of
    the pixels that count) as the kernel forms it. kMeanFold / kCholesky: the
    first tile with pixels centred on its own mean, every later one on the
    running mean, then the rank-1 term -(n_t^2 / n') d d^T; a tile with none
    skipped. kSecondMoment: the raw scatter, the mean 0."""
    n_run, mean = 0, torch.zeros(s, dtype=torch.float64)
    scat = torch.zeros((s, s), dtype=torch.float64)
    for xt in tiles:
        n_t = xt.shape[0]
        if not mean_fold:
            scat += xt.T @ xt
            n_run += n_t
            continue
        if n_t == 0:
            continue
        if n_run == 0:
            mean = xt.mean(0)
        xc = xt - mean
        d = xc.mean(0)
        n_new = n_run + n_t
        scat += xc.T @ xc - (n_t * n_t / n_new) * torch.outer(d, d)
        mean = mean + d * (n_t / n_new)
        n_run = n_new
    a, bb = _tri(s)
    return torch.cat([torch.tensor([float(n_run)], dtype=torch.float64), mean, scat[a, bb]])


def _records(pix, keep, geom, mean_fold):
    """The (nb, nchunks, record) records of the per-pixel rows pix (nb, P, s)
    over the pixels ``keep`` (nb, P) marks."""
    nb, p, s = pix.shape
    chunks = _chunk_tiles(geom, p)
    return torch.stack([torch.stack([
        _fold([pix[b, tile][keep[b, tile]] for tile in ch], s, mean_fold) for ch in chunks])
        for b in range(nb)])


def _combine(recs, s, n_given=None):
    """init_stats_reduce_kernel: the chunk records of each block combined in
    f64, n clamped to >= 1 (or the given counts), the triangle mirrored."""
    a, bb = _tri(s)
    n_c, mean_c, tri_c = recs[..., 0], recs[..., 1:1 + s], recs[..., 1 + s:]
    n = n_c.sum(1).clamp(min=1) if n_given is None else n_given.double()
    m = (n_c[..., None] * mean_c).sum(1) / n[:, None]
    d = mean_c - m[:, None, :]
    tri = (tri_c + n_c[..., None] * d[..., a] * d[..., bb]).sum(1) / n[:, None]
    c0 = torch.zeros((recs.shape[0], s, s), dtype=torch.float64)
    c0[:, a, bb] = tri
    c0[:, bb, a] = tri
    return m, c0


def _stream(nb, rows, p, s, seed):
    """A raw EMIT-like stream (nb, rows, p) in f64, rows s.. zero."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(2.0, 6.0, (1, s, 1))
    x = rng.uniform(0.5, 2.0, (nb, 1, p)) * base * (1 + 0.05 * rng.normal(size=(nb, s, p)))
    return torch.nn.functional.pad(torch.from_numpy(x), (0, 0, 0, rows - s))


CASES = [(3, 40, 1485, 37, tk.DEFAULT_SM_COUNT), (3, 40, 1485, 37, 1), (2, 8, 700, 5, 1),
         (2, 128, 400, 128, 1)]  # sm_count 1: many tiles per chunk


@pytest.mark.parametrize("nb, rows, p, s, sm_count", CASES)
def test_stream_records_combine_to_init_stats_stream(nb, rows, p, s, sm_count):
    """kMeanFold's records of the raw stream combine to init_stats_stream_plain's
    m0 and C0."""
    xs = _stream(nb, rows, p, s, seed=s)
    geom = _geometry(nb, p, s, 4, False, sm_count)
    if sm_count == 1:
        assert geom.tiles_per_chunk > 1 or geom.nchunks == 1
    pix = xs[:, :s].transpose(1, 2)
    m0, c0 = _combine(_records(pix, torch.ones((nb, p), dtype=torch.bool), geom, True), s)
    m0_p, c0_p = tk.init_stats_stream_plain(xs, s)
    torch.testing.assert_close(m0, m0_p, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(c0, c0_p, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("nb, rows, p, s, sm_count", CASES)
def test_second_moment_records_combine_to_init_stats_bsp(nb, rows, p, s, sm_count):
    """kSecondMoment's records of the centred, masked stream (zero where a
    pixel does not count; rows past s never summed) combine over the given
    valid counts to init_stats_bsp_plain's (nb, s, s) C0; block 1 empty."""
    xs = _stream(nb, rows, p, s, seed=s + 1)
    keep = torch.from_numpy(np.random.default_rng(8).random((nb, p)) > 0.2)
    keep[1] = False
    xs = torch.where(keep[:, None, :], xs - xs[:, :, :1], 0.0)
    xs[:, s:] = 7.0  # rows past s are never read
    n = keep.sum(1).clamp(min=1).double()
    geom = _geometry(nb, p, s, 2, False, sm_count)
    recs = _records(xs[:, :s].transpose(1, 2), torch.ones((nb, p), dtype=torch.bool), geom,
                    False)
    assert bool((recs[..., 1:1 + s] == 0).all())  # no mean
    m, c0 = _combine(recs, s, n_given=n)
    c0_p = tk.init_stats_bsp_plain(xs, n, s)
    assert c0_p.shape == (nb, s, s) and bool((m == 0).all())
    torch.testing.assert_close(c0, c0_p, rtol=1e-12, atol=1e-12)
    assert bool((c0[1] == 0).all())


def _cholesky_inputs(nb, p, s, seed):
    rng = np.random.default_rng(seed)
    f64 = lambda a: torch.from_numpy(np.asarray(a, np.float64))  # noqa: E731
    carry = f64(np.stack([rng.normal(0, 0.01, (nb, s)), rng.uniform(-3, -1, (nb, s)),
                          rng.normal(0, 0.05, (nb, s)), np.full((nb, s), 40.0)], axis=1))
    r = f64(rng.uniform(0.8, 1.2, (nb, p)))
    mf_prev = f64(np.maximum(rng.normal(0.01, 0.02, (nb, p)), 0.0))
    return carry, r, mf_prev


@pytest.mark.parametrize("first", [True, False])
@pytest.mark.parametrize("nb, rows, p, s, sm_count", CASES)
def test_cholesky_records_combine_to_fused_iter(nb, rows, p, s, sm_count, first):
    """kCholesky's records of modx = x - m0c - cov_scale target R mf over the
    pixels of a (B, P) valid row combine to fused_iter_plain's CHOLESKY mean
    and covariance; block 1 has no valid pixel and gets mean 0, cov 0."""
    xs = _stream(nb, rows, p, s, seed=s + 2)
    m0 = xs[:, :s].mean(2)
    valid = torch.from_numpy(np.random.default_rng(9).random((nb, p)) > 0.1)
    valid[1] = False
    carry, r, mf_prev = _cholesky_inputs(nb, p, s, seed=s)
    kw = dict(first=first, woodbury=False, cov_scale=0.7, center=True)
    mf, (mean_p, cov_p) = tk.fused_iter_plain(xs, valid, m0, carry, r, mf_prev, **kw)
    # The pixel stage: mf (0 where the valid byte is 0), then modx.
    xc = xs[:, :s].transpose(1, 2) - m0[:, None, :]
    mu, target, cit, norm = carry[:, 0], carry[:, 1], carry[:, 2], carry[:, 3, :1]
    if first:
        mf_k = mf_prev
    else:
        proj = torch.einsum("bps,bs->bp", xc, cit) - (cit * mu).sum(1, keepdim=True)
        mf_k = torch.clamp((proj - 1.0 / (r * (mf_prev + tk.EPSILON))) / (r * norm), min=0.0)
    mf_k = torch.where(valid, mf_k, 0.0)
    torch.testing.assert_close(mf_k, mf, rtol=1e-12, atol=1e-12)
    modx = xc - target[:, None, :] * (0.7 * r * mf_k)[..., None]
    geom = _geometry(nb, p, s, 4, True, sm_count)
    recs = _records(modx, valid, geom, True)
    assert bool((recs[:, :, 0].sum(1) == valid.sum(1)).all())  # n counts the valid pixels
    mean, cov = _combine(recs, s)
    torch.testing.assert_close(mean, mean_p, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(cov, cov_p, rtol=1e-12, atol=1e-12)
    assert bool((mean[1] == 0).all() and (cov[1] == 0).all())


# ---------------------------------------------------------------------------
# The wrappers and the filter hand the geometry on
# ---------------------------------------------------------------------------


class _RecordingKernels:
    """Stands in for torch.ops.starcop_mag1c and records each op's arguments."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return lambda *args: self.calls.append((name, args))


def _refuse_geometry(*args, **kwargs):
    raise AssertionError("the wrapper worked out a geometry it was given")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cholesky_takes_the_filters_geometry(monkeypatch, dtype):
    """fused_iter CHOLESKY given ``geom`` passes it to the op and works out
    none of its own; its records are one per chunk of that geometry."""
    fake = _RecordingKernels()
    monkeypatch.setattr(tk, "_kernels", lambda: fake)
    monkeypatch.setattr(tk, "_stream", lambda x: 0)
    xs = torch.empty((3, 37, 1485), dtype=dtype, device="meta")
    geom = tk.stream_stats_geometry_for(xs, 37, pixel_rows=True)
    assert geom == tk.stream_stats_geometry(3, 1485, 37, xs.element_size(), pixel_rows=True)
    for name in ("stream_stats_geometry_for", "stream_stats_geometry", "stream_geometry"):
        monkeypatch.setattr(tk, name, _refuse_geometry)
    m0, carry = torch.empty((3, 37), device="meta"), torch.empty((3, 4, 37), device="meta")
    rows = torch.empty((3, 1485), device="meta")
    mf, (mean, cov) = tk.fused_iter(xs, None, m0, carry, rows, rows, first=False,
                                    woodbury=False, geom=geom)
    name, args = fake.calls[-1]
    assert name == "fused_iter_cholesky" and args[12] == geom.op_args()
    assert args[9].shape == (3, geom.nchunks, tk.stats_record_len(37))
    assert mf.shape == (3, 1485) and mean.shape == (3, 37) and cov.shape == (3, 37, 37)


def test_cholesky_filter_works_out_its_geometry_once(monkeypatch):
    """acrwl1mf_fused(glue="cholesky") works out the statistics' geometry once
    for all its fused_iter passes."""
    from starcop_tpu_torch.ops import mag1c_fused as tf

    calls = []
    fn = tk.stream_stats_geometry

    def counted(*args, **kwargs):
        calls.append(kwargs.get("pixel_rows"))
        return fn(*args, **kwargs)

    monkeypatch.setattr(tk, "stream_stats_geometry", counted)
    rng = np.random.default_rng(5)
    xb = rng.uniform(1.0, 3.0, (2, 120, 7)).astype(np.float32)
    tpl = -rng.uniform(0.1, 1.0, 7).astype(np.float32)
    tf.acrwl1mf_fused(xb, tpl, glue="cholesky", num_iter=3, alpha=1e-4, device="cpu")
    assert calls == [True]
