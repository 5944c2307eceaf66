"""The streaming rounds' launch geometry (starcop_tpu_torch.ops.mag1c_kernels.
round_geometry), which the CUDA kernels take as it is: tiles and chunks that
cover every pixel once, a tile ring that fits an SM's shared memory, the copy
width chosen from the shapes, and chunk records that the glue sums to the
same carry as one record per block. Runs on the CPU; the kernels themselves
are held against their twins on the card by chip_smoke.py."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from starcop_tpu_torch.ops import mag1c as tm  # noqa: E402
from starcop_tpu_torch.ops import mag1c_kernels as tk  # noqa: E402

SMEM_LIMIT = 227 * 1024  # H100: shared memory one CTA may use


def _cube_chunks(geom, h, step):
    """Pixel indices (p = h * step + j) of each chunk of a cube round, in the
    order the CTA walks its tiles (the kernel's tile -> rows, columns map)."""
    nseg = -(-step // geom.tile_cols)
    chunks = []
    for c in range(geom.nchunks):
        pix = []
        for tile in range(c * geom.tiles_per_chunk,
                          min(geom.tiles_per_block, (c + 1) * geom.tiles_per_chunk)):
            grp, seg = divmod(tile, nseg)
            rows = range(grp * geom.tile_rows, min(h, (grp + 1) * geom.tile_rows))
            cols = range(seg * geom.tile_cols, min(step, (seg + 1) * geom.tile_cols))
            pix += [r * step + j for r in rows for j in cols]
        chunks.append(pix)
    return chunks


def _stream_chunks(geom, p):
    span = geom.tiles_per_chunk * geom.tile_cols
    return [list(range(c * span, min(p, (c + 1) * span))) for c in range(geom.nchunks)]


@pytest.mark.parametrize("h, step, nb", [(1280, 54, 23), (1280, 32, 39), (99, 15, 3),
                                         (64, 256, 5), (7, 300, 2)])
def test_cube_chunks_cover_block_from_row_starts(h, step, nb):
    geom = tk.round_geometry("hws", nb, h * step, 50, step=step, width=nb * step)
    assert geom.tile_rows * geom.tile_cols <= tk.ROUND_THREADS
    chunks = _cube_chunks(geom, h, step)
    flat = [q for ch in chunks for q in ch]
    assert sorted(flat) == list(range(h * step)) and len(flat) == h * step
    assert all(ch and ch[0] % step == 0 for ch in chunks)  # every chunk starts a row
    assert (geom.nchunks - 1) * geom.tiles_per_chunk < geom.tiles_per_block


@pytest.mark.parametrize("step", [15, 32, 54, 256])
@pytest.mark.parametrize("elem_bytes", [4, 2])
def test_stream_chunks_tile_the_block(step, elem_bytes):
    p = 1280 * step
    geom = tk.round_geometry("bsp", 23, p, 50, elem_bytes=elem_bytes)
    chunks = _stream_chunks(geom, p)
    assert all(chunks) and [q for ch in chunks for q in ch] == list(range(p))
    assert all(ch[0] % tk.ROUND_THREADS == 0 for ch in chunks)


@pytest.mark.parametrize("s", [1, 12, 37, 50, 56, 74, 128])
@pytest.mark.parametrize("layout, elem_bytes, step, static", [
    ("hws", 4, 54, 0), ("hws", 4, 256, 0), ("bsp", 4, 0, 0), ("bsp", 2, 0, 0),
    ("bsp", 4, 0, tk.MONO_STATIC_SMEM), ("bsp", 2, 0, tk.MONO_STATIC_SMEM)])
def test_ring_fits_shared_memory(s, layout, elem_bytes, step, static):
    p = 1280 * (step or 54)
    geom = tk.round_geometry(layout, 23, p, s, step=step, width=23 * step,
                             elem_bytes=elem_bytes, static_smem=static)
    assert 2 <= geom.stages <= tk.MAX_STAGES
    assert geom.smem_bytes + geom.static_smem <= SMEM_LIMIT
    assert geom.ctas_per_sm >= 1
    # The kernels' own formula (csrc/mag1c_common.cuh: round_smem_bytes).
    if layout == "hws":
        tile = 4 * geom.tile_rows * (-(-geom.tile_cols * s // 4) * 4)
    else:
        tile = s * (tk.BF16_ROW_PITCH * 2 if elem_bytes == 2 else tk.ROUND_THREADS * 4)
    assert geom.smem_bytes == geom.stages * (tile + tk.PIX_STAGE_BYTES) + tk.ROUND_FIXED_BYTES


@pytest.mark.parametrize("s", [1, 12, 37, 50, 56, 74, 100, 127, 128])
@pytest.mark.parametrize("elem_bytes", [4, 2])
def test_mono_ring_holds_the_glue(s, elem_bytes):
    """filter_round_mono's last CTA runs the glue in its drained ring: the
    ring holds the glue's scratch and K0 staged at a row pitch whose float4
    reads are free of bank conflicts (csrc/mag1c_common.cuh: glue_smem_bytes;
    the kernel refuses a smaller ring)."""
    geom = tk.round_geometry("bsp", 23, 1280 * 54, s, elem_bytes=elem_bytes,
                             static_smem=tk.MONO_STATIC_SMEM)
    pitch = tk.glue_k0_pitch(s)
    assert pitch >= s and pitch % 4 == 0 and (pitch // 4) % 2 == 1
    assert geom.smem_bytes >= tk.glue_smem_bytes(s) == tk.GLUE_FIXED_BYTES + 4 * s * pitch


@pytest.mark.parametrize("step", [32, 54])
def test_emit_shapes_take_the_aligned_copies(step):
    h, w, s = 1280, 1242, 50
    nb = -(-w // step)
    assert tk.round_geometry("hws", nb, h * step, s, step=step, width=w).aligned
    for elem in (4, 2):
        assert tk.round_geometry("bsp", nb, h * step, s, elem_bytes=elem).aligned
    # A cube or stream that does not start on 16 bytes takes the narrow copies.
    assert not tk.round_geometry("hws", nb, h * step, s, step=step, width=w,
                                 aligned_ptr=False).aligned
    assert not tk.round_geometry("bsp", nb, h * step, s, aligned_ptr=False).aligned


@pytest.mark.parametrize("w, nb", [(45, 3), (47, 4)])
@pytest.mark.parametrize("layout, elem_bytes", [("hws", 4), ("bsp", 4), ("bsp", 2)])
def test_odd_shapes_take_the_narrow_copies(w, nb, layout, elem_bytes):
    """99 x 45 x 37 at step 15 (odd W and S, P = 1,485) and the ragged
    99 x 47 x 37 masked cube: no tile row starts on 16 bytes throughout."""
    geom = tk.round_geometry(layout, nb, 99 * 15, 37, step=15, width=w, elem_bytes=elem_bytes)
    assert not geom.aligned


class _RecordingKernels:
    """Stands in for torch.ops.starcop_mag1c and records each op's arguments."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return lambda *args: self.calls.append((name, args))


@pytest.mark.parametrize("masked", [False, True])
def test_cube_wrapper_hands_the_geometry_to_the_op(monkeypatch, masked):
    fake = _RecordingKernels()
    monkeypatch.setattr(tk, "_kernels", lambda: fake)
    monkeypatch.setattr(tk, "_stream", lambda x: 0)
    x = torch.empty((99, 47 if masked else 45, 37), device="meta")
    nb, step = (4, 15) if masked else (3, 15)
    m0, carry = torch.empty((nb, 37), device="meta"), torch.empty((nb, 4, 37), device="meta")
    if masked:
        valid = torch.empty((99, 47), dtype=torch.bool, device="meta")
        _, _, stats = tk.filter_round_masked(x, valid, nb, step, m0, carry, None, None,
                                             mode=tk.FIRST)
    else:
        _, _, stats = tk.filter_round(x, nb, step, m0, carry, None, None, mode=tk.FIRST)
    geom = tk.cube_geometry(x, nb, step)
    name, args = fake.calls[-1]
    assert name == ("filter_round_masked" if masked else "filter_round")
    assert args[-3] == geom.op_args() and stats.shape == (nb, geom.nchunks, 39)


@pytest.mark.parametrize("op", ["bsp", "woodbury", "mono"])
def test_stream_wrappers_hand_the_geometry_to_the_op(monkeypatch, op):
    fake = _RecordingKernels()
    monkeypatch.setattr(tk, "_kernels", lambda: fake)
    monkeypatch.setattr(tk, "_stream", lambda x: 0)
    xs = torch.empty((3, 40, 1485), dtype=torch.bfloat16, device="meta")
    m0, carry = torch.empty((3, 37), device="meta"), torch.empty((3, 4, 37), device="meta")
    rows = torch.empty((3, 1485), device="meta")
    if op == "bsp":
        stats = tk.filter_round_bsp(xs, None, 1485, m0, carry, None, None, mode=tk.FIRST)[2]
        geom = tk.stream_geometry(xs, 37)
    elif op == "woodbury":
        stats = tk.fused_iter(xs, None, m0, carry, rows, rows, first=True, woodbury=True)[1]
        geom = tk.stream_geometry(xs, 37)
    else:
        k0 = torch.empty((3, 37, 37), device="meta")
        tk.filter_round_mono(xs, m0, carry, None, None, torch.empty(37, device="meta"), k0,
                             1485.0, mode=tk.FIRST, alpha=1e-4, counter=tk.mono_counters(xs))
        geom = tk.stream_geometry(xs, 37, static_smem=tk.MONO_STATIC_SMEM)
        stats = fake.calls[-1][1][8]  # the partial records
    args = fake.calls[-1][1]
    assert geom.op_args() in args and stats.shape == (3, geom.nchunks, 39)
    assert not geom.aligned  # P = 1485 bf16 values: no row starts on 16 bytes


def _glue_inputs(seed=3, h=40, w=45, s=7, nb=3, step=15, masked=False):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.uniform(1.0, 3.0, (h, w, s)))
    valid = torch.from_numpy(rng.random((h, w)) > 0.1) if masked else None
    tpl = torch.from_numpy(-rng.uniform(0.1, 1.0, s))
    if masked:
        m0, c0 = tk.init_stats_masked_plain(x, valid, nb, step)
        n = tk.block_valid_counts(valid, nb, step).clamp(min=1).double()
    else:
        m0, c0 = tk.init_stats_plain(x, nb, step)
        n = float(h * step)
    k0, tgt0, cit0, norm0 = tk._woodbury_base(c0, m0, tpl, 1e-4)
    return x, valid, tpl, m0, k0, tk.pack_carry(tgt0, cit0, norm0), n


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("mode", [tk.FIRST, tk.LOOP])
def test_glue_of_chunk_records_equals_one_record(masked, mode):
    """The round twin's statistics split over the geometry's chunks (as the
    kernel writes them, one record per (block, chunk)) give filter_glue_plain
    the same carry as the twin's single record per block."""
    x, valid, tpl, m0, k0, carry, n = _glue_inputs(masked=masked)
    h, w, s = x.shape
    nb, step = 3, 15
    twin = (functools.partial(tk.filter_round_masked_plain, x, valid, nb, step) if masked
            else functools.partial(tk.filter_round_plain, x, nb, step))
    mf0, r, _ = twin(m0=m0, carry=carry, r=None, mf_prev=None, mode=tk.FIRST)
    mf, _, stats = twin(m0=m0, carry=carry, r=r, mf_prev=mf0, mode=mode)
    # Per-pixel terms of the statistics, then summed chunk by chunk.
    if masked:
        xb, keep = tk._masked_blocks(x, valid, nb, step)
        xc = torch.where(keep[..., None], xb - m0[:, None, :], 0.0)
    else:
        xc = tm.block_columns(x, nb, step) - m0[:, None, :]
    g = r * mf  # cov_scale 1
    terms = torch.cat([xc * g[..., None], g[..., None], (g * g)[..., None]], dim=2)
    geom = tk.round_geometry("hws", nb, h * step, s, step=step, width=w)
    chunks = _cube_chunks(geom, h, step)
    assert len(chunks) == geom.nchunks > 1
    records = torch.stack([terms[:, torch.tensor(ch)].sum(1) for ch in chunks], dim=1)
    torch.testing.assert_close(records.sum(1, keepdim=True), stats, rtol=1e-12, atol=1e-12)
    kw = dict(m0=m0, template=tpl, k0=k0, n=n, alpha=1e-4)
    torch.testing.assert_close(tk.filter_glue_plain(records, carry, **kw),
                               tk.filter_glue_plain(stats, carry, **kw), rtol=1e-10, atol=1e-12)


def _refuse_geometry(*args, **kwargs):
    raise AssertionError("a round worked out its own geometry")


@pytest.mark.parametrize("op", ["filter_round", "filter_round_masked", "bsp", "woodbury",
                                "mono"])
def test_wrappers_take_the_filters_geometry(monkeypatch, op):
    """A filter works out the geometry once and hands it to every round: a
    wrapper given ``geom`` passes it to the op and works out none of its own."""
    fake = _RecordingKernels()
    monkeypatch.setattr(tk, "_kernels", lambda: fake)
    monkeypatch.setattr(tk, "_stream", lambda x: 0)
    nb = 4 if op == "filter_round_masked" else 3
    x = torch.empty((99, 47 if op == "filter_round_masked" else 45, 37), device="meta")
    xs = torch.empty((3, 40, 1485), dtype=torch.bfloat16, device="meta")
    m0, carry = torch.empty((nb, 37), device="meta"), torch.empty((nb, 4, 37), device="meta")
    geom = (tk.cube_geometry(x, nb, 15) if op.startswith("filter_round") else
            tk.mono_geometry(xs, 37) if op == "mono" else tk.stream_geometry(xs, 37))
    for name in ("cube_geometry", "stream_geometry", "mono_geometry", "round_geometry"):
        monkeypatch.setattr(tk, name, _refuse_geometry)
    rows = torch.empty((3, 1485), device="meta")
    if op == "filter_round":
        stats = tk.filter_round(x, nb, 15, m0, carry, None, None, mode=tk.FIRST, geom=geom)[2]
    elif op == "filter_round_masked":
        valid = torch.empty((99, 47), dtype=torch.bool, device="meta")
        stats = tk.filter_round_masked(x, valid, nb, 15, m0, carry, None, None, mode=tk.FIRST,
                                       geom=geom)[2]
    elif op == "bsp":
        stats = tk.filter_round_bsp(xs, None, 1485, m0, carry, rows, rows, mode=tk.LOOP,
                                    geom=geom)[2]
    elif op == "woodbury":
        stats = tk.fused_iter(xs, None, m0, carry, rows, rows, first=False, woodbury=True,
                              geom=geom)[1]
    else:
        k0 = torch.empty((3, 37, 37), device="meta")
        tk.filter_round_mono(xs, m0, carry, rows, rows, torch.empty(37, device="meta"), k0,
                             1485.0, mode=tk.LOOP, alpha=1e-4, counter=tk.mono_counters(xs),
                             geom=geom)
        stats = fake.calls[-1][1][8]
    assert geom.op_args() in fake.calls[-1][1] and stats.shape == (nb, geom.nchunks, 39)


def _count_calls(monkeypatch, module, name, calls):
    fn = getattr(module, name)

    def counted(*args, **kwargs):
        calls.append(name)
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, counted)


@pytest.mark.parametrize("route", ["resident", "masked", "resident_bsp", "masked_bf16",
                                   "fused", "resident_stream", "mono", "woodbury"])
def test_filter_works_out_its_geometry_once(monkeypatch, route):
    """Each filter works out its rounds' geometry once, not once per round
    (the host cost of every launch on a host-bound path)."""
    from starcop_tpu_torch.ops import mag1c_fused as tf

    calls = []
    _count_calls(monkeypatch, tk, "round_geometry", calls)  # under every *_geometry
    rng = np.random.default_rng(5)
    h, w, s, nb, step = 8, 30, 7, 2, 15
    x = rng.uniform(1.0, 3.0, (h, w, s)).astype(np.float32)
    tpl = -rng.uniform(0.1, 1.0, s).astype(np.float32)
    valid = rng.random((h, w)) > 0.1
    kw = dict(num_iter=2, alpha=1e-4, device="cpu")
    if route == "resident":
        tk.acrwl1mf_resident(x, tpl, nb, step, **kw)
    elif route == "masked":
        tk.acrwl1mf_masked(x, tpl, valid, nb, step, **kw)
    elif route == "resident_bsp":
        tk.acrwl1mf_resident_bsp(x, tpl, nb, step, **kw)
    elif route == "masked_bf16":
        tk.acrwl1mf_masked_bf16(x, tpl, valid, nb, step, **kw)
    else:
        xb = x.reshape(h, nb, step, s).transpose(1, 0, 2, 3).reshape(nb, h * step, s)
        if route == "resident_stream":
            tf.acrwl1mf_fused(np.ascontiguousarray(xb.transpose(0, 2, 1)), tpl,
                              x_layout="bsp", glue="resident", **kw)
        else:
            tf.acrwl1mf_fused(xb, tpl, glue=route, **kw)
    assert len(calls) == 1, calls
