"""The evaluation loader's batch read (``ChipDataset.read_batch`` over
``data/chip_io.py`` and ``csrc/chip_io.cpp``): every batch ``BatchLoader``
assembles is bitwise the stack of the per-chip samples, on each layout the
native reader takes (the benchmark recipe's uncompressed 128-tiled TIFFs,
the chip cache's DEFLATE TIFFs with overviews, a ragged tile grid, strips,
``.npy``, windows inside the raster) and on those it leaves to the Python
reader (an overhanging window), mixed in one batch, the last batch partial,
with and without loader threads, into fresh arrays and through the loader
iterator's ``slot`` into reused buffers (plain CPU arrays standing in for
``prefetch_to_device``'s pinned rings; on the card, ``test_torch_staging.py``).
A consumer that sets no ``slot`` (``list(loader)``, ``prefetch_to_device`` on
the CPU) gets fresh arrays, which later batches never overwrite. The span ``data.load`` counts its chips, those read natively and
those read into the consumer's buffers, which ``eval.load_pinned_pct`` reads;
a truncated or corrupt file raises naming itself.
"""

import os
import re
import struct
import sys
import threading
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import cpu_share  # noqa: E402,F401

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from portbench import harness  # noqa: E402
from portbench.recipes.chips import write_tiff  # noqa: E402
from starcop_tpu_torch.data import chip_io  # noqa: E402
from starcop_tpu_torch.data.chip_cache import cache_chip  # noqa: E402
from starcop_tpu_torch.data.datamodule import BatchLoader, prefetch_to_device  # noqa: E402
from starcop_tpu_torch.data.dataset import ChipDataset, stack_samples  # noqa: E402
from starcop_tpu_torch.data.geotiff import write_geotiff  # noqa: E402
from starcop_tpu_torch.utils.profiling import clear_spans, spans  # noqa: E402

PRODUCTS = ("mag1c", "TOA_AVIRIS_640nm", "TOA_AVIRIS_550nm", "TOA_AVIRIS_460nm",
            "labelbinary", "weight_mag1c")
N_CHIPS = 5  # batches of 2: the last one partial
INSIDE = (20, 36, 200, 150)  # (col_off, row_off, width, height)
OVERHANG = (-10, 180, 200, 150)
# (sample format, bits) of each numpy type a striped file is written in.
_TIFF_TYPES = {np.dtype(np.uint8): (1, 8), np.dtype(np.uint16): (1, 16),
               np.dtype(np.int16): (2, 16), np.dtype(np.float32): (3, 32),
               np.dtype(np.float64): (3, 64)}
# Each product's type in the striped files (the native reader's casts).
_STRIPED = {"mag1c": np.float64, "TOA_AVIRIS_640nm": np.uint16, "TOA_AVIRIS_550nm": np.int16,
            "TOA_AVIRIS_460nm": np.float32, "labelbinary": np.uint8, "weight_mag1c": np.float32}


def _products(rng, h, w):
    out = {p: (rng.random((h, w)) * 90.0).astype(np.float32) for p in PRODUCTS}
    out["labelbinary"] = (rng.random((h, w)) > 0.97).astype(np.float32)
    out["weight_mag1c"] = np.clip(out["mag1c"] / 50.0, 0.1, 1.0).astype(np.float32)
    return out


def _as_type(arr, dtype):
    """``arr`` in ``dtype``, integers spread over the type's whole range."""
    dtype = np.dtype(dtype)
    if dtype.kind == "f":
        return arr.astype(dtype)
    info = np.iinfo(dtype)
    return (info.min + arr / arr.max() * (float(info.max) - info.min)).astype(dtype)


def write_striped(path, arr, rows_per_strip, compress):
    """A single-band little-endian TIFF in strips, DEFLATE or not."""
    arr = np.ascontiguousarray(arr, arr.dtype.newbyteorder("<"))
    h, w = arr.shape
    fmt, bits = _TIFF_TYPES[arr.dtype]
    strips = [arr[r:r + rows_per_strip].tobytes() for r in range(0, h, rows_per_strip)]
    if compress:
        strips = [zlib.compress(s, 6) for s in strips]
    n = len(strips)
    entries = [(256, 4, 1, w), (257, 4, 1, h), (258, 3, 1, bits), (259, 3, 1, 8 if compress else 1),
               (262, 3, 1, 1), (273, 4, n, None), (277, 3, 1, 1), (278, 4, 1, rows_per_strip),
               (279, 4, n, None), (339, 3, 1, fmt)]
    arrays_at = 8 + 2 + 12 * len(entries) + 4
    data_at = arrays_at + (8 * n if n > 1 else 0)
    offsets = list(np.cumsum([data_at] + [len(s) for s in strips[:-1]]))
    out = [b"II", struct.pack("<HI", 42, 8), struct.pack("<H", len(entries))]
    for tag, typ, count, value in entries:
        if tag == 273:
            value = arrays_at if n > 1 else offsets[0]
        elif tag == 279:
            value = arrays_at + 4 * n if n > 1 else len(strips[0])
        packed = struct.pack("<HI", value, 0)[:4] if typ == 3 else struct.pack("<I", value)
        out.append(struct.pack("<HHI", tag, typ, count) + packed)
    out.append(struct.pack("<I", 0))
    if n > 1:
        out += [struct.pack(f"<{n}I", *offsets), struct.pack(f"<{n}I", *[len(s) for s in strips])]
    with open(path, "wb") as fh:
        fh.write(b"".join(out + strips))


def _write(folder, layout, products):
    """One chip's products in ``layout``."""
    os.makedirs(folder, exist_ok=True)
    if layout == "cache":  # the chip cache's own writer: DEFLATE, overviews
        cache_chip(folder, dict(products), output_size=products["mag1c"].shape)
        return
    for i, (name, arr) in enumerate(products.items()):
        path = os.path.join(folder, name)
        if layout == "recipe":
            write_tiff(path + ".tif", arr)
        elif layout == "ragged":
            write_geotiff(path + ".tif", arr, compress=False)
        elif layout == "striped":  # ragged last strips, one product DEFLATE
            write_striped(path + ".tif", _as_type(arr, _STRIPED[name]), 7 + i, name == "mag1c")
        else:
            np.save(path + ".npy", arr)


# case: (raster side, each chip's layout, each chip's window, chips read natively)
CASES = {
    "recipe": (256, ["recipe"] * N_CHIPS, [None] * N_CHIPS, N_CHIPS),
    "chip_cache": (256, ["cache"] * N_CHIPS, [None] * N_CHIPS, N_CHIPS),
    "ragged": (500, ["ragged"] * N_CHIPS, [None] * N_CHIPS, N_CHIPS),
    "striped": (96, ["striped"] * N_CHIPS, [None] * N_CHIPS, N_CHIPS),
    "npy": (256, ["npy"] * N_CHIPS, [None] * N_CHIPS, N_CHIPS),
    "window": (300, ["recipe"] * N_CHIPS, [INSIDE] * N_CHIPS, N_CHIPS),
    "overhang": (300, ["recipe"] * N_CHIPS, [OVERHANG] * N_CHIPS, 0),
    "mixed": (300, ["recipe", "npy", "cache", "recipe", "striped"],
              [INSIDE, INSIDE, INSIDE, OVERHANG, INSIDE], N_CHIPS - 1),
}


def _dataset(root, case):
    side, layouts, windows, _ = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case))
    rows = []
    for i, (layout, window) in enumerate(zip(layouts, windows)):
        folder = os.path.join(root, case, f"c{i}")
        _write(folder, layout, _products(rng, side, side))
        row = {"id": f"{case}{i}", "folder": folder}
        if i % 2:  # the others take has_plume from their labels
            row["has_plume"] = bool(i % 4 == 1)
        if window is not None:
            row.update(zip(("window_col_off", "window_row_off", "window_width",
                            "window_height"), window))
        rows.append(row)
    return ChipDataset(rows, PRODUCTS[:4], ["labelbinary"], "weight_mag1c",
                       extra_products=["mag1c"], add_rgb_aviris=True)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return str(tmp_path_factory.mktemp("chip_batch"))


def _assert_bitwise(got, want):
    assert list(got) == list(want)
    for key, w in want.items():
        g = got[key]
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape, key
            np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8), err_msg=key)
        else:
            assert g == w, key


def _data_load(batches_of):
    """The loader's batches under the profiler, and its ``data.load`` spans."""
    clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        batches = batches_of()
    return batches, [s for s in spans() if s.name == "data.load"]


class _Ring:
    """A consumer's ``slot``: ``depth`` plain arrays a (key, shape, dtype),
    NaN until first written, handed out in turn, as ``prefetch_to_device``
    hands out its pinned buffers."""

    def __init__(self, depth):
        self.depth, self.rings, self.lock = depth, {}, threading.Lock()

    def __call__(self, key, shape, dtype):
        with self.lock:
            ring = self.rings.setdefault((key, shape, dtype), [
                [np.full(shape, np.nan, dtype) for _ in range(self.depth)], 0])
            ring[1] += 1
            return ring[0][(ring[1] - 1) % self.depth]

    def holds(self, a):
        return any(a is b for bufs, _ in self.rings.values() for b in bufs)


def _through_slot(loader):
    """A pass that reads through the iterator's ``slot`` into a ``_Ring`` of
    ``1 + ahead`` arrays; each batch copied as it is yielded (the ring's
    turn comes again from the next ``next()`` on). Returns the copies and,
    per batch, whether its numeric arrays were the ring's."""
    it = iter(loader)
    it.slot = ring = _Ring(1 + it.ahead)
    got, held = [], []
    for b in it:
        arrays = [v for v in b.values() if isinstance(v, np.ndarray) and v.ndim == 4]
        held.append([ring.holds(a) for a in arrays])
        got.append({k: v.copy() if isinstance(v, np.ndarray) else v for k, v in b.items()})
    return got, held


def _want(ds, n, batch):
    return [stack_samples([ds[i] for i in range(s, min(s + batch, n))])
            for s in range(0, n, batch)]


@pytest.mark.parametrize("route", ["fresh", "slot"])
@pytest.mark.parametrize("num_workers", [0, 2])
@pytest.mark.parametrize("case", sorted(CASES))
def test_batch_read_is_the_stack_of_the_samples(root, case, num_workers, route):
    """Bitwise the per-chip stack: keys, order, dtypes, ids, has_plume,
    rgb_aviris / 50; each chip of a native case read natively. Through the
    iterator's ``slot``, the whole batches land in the consumer's arrays
    (``pinned_chips`` as ``native_chips``), the partial last one in fresh
    arrays (none); without it, every batch in arrays of its own."""
    ds = _dataset(root, case)
    loader = BatchLoader(ds, batch_size=2, num_workers=num_workers)
    if route == "slot":
        (got, held), loads = _data_load(lambda: _through_slot(loader))
        assert held == [[True] * 5, [True] * 5, [False] * 5]
    else:
        got, loads = _data_load(lambda: list(loader))
        arrays = [v for b in got for v in b.values() if isinstance(v, np.ndarray)]
        assert not any(np.shares_memory(a, b) for i, a in enumerate(arrays) for b in arrays[:i])
    want = _want(ds, N_CHIPS, 2)
    assert len(got) == len(want) == 3 and len(got[-1]["id"]) == 1
    for g, w in zip(got, want):
        _assert_bitwise(g, w)
    assert sum(s.counts["chips"] for s in loads) == N_CHIPS
    assert sum(s.counts["native_chips"] for s in loads) == CASES[case][3]
    for s in loads:
        whole = route == "slot" and s.counts["chips"] == 2
        assert s.counts["pinned_chips"] == (s.counts["native_chips"] if whole else 0)


def test_span_counters(root):
    """``chips``, ``native_chips`` and ``pinned_chips`` on each
    ``data.load``: the chip with an overhanging window is counted out; a
    sample that draws (a crop) keeps the per-chip path, none of its chips
    native or read into the consumer's arrays, which it leaves unused."""
    ds = _dataset(root, "mixed")
    _, loads = _data_load(lambda: list(BatchLoader(ds, batch_size=2)))
    assert [(s.counts["chips"], s.counts["native_chips"], s.counts["pinned_chips"])
            for s in loads] == [(2, 2, 0), (2, 1, 0), (1, 1, 0)]
    _, loads = _data_load(lambda: _through_slot(BatchLoader(ds, batch_size=2)))
    assert [(s.counts["chips"], s.counts["native_chips"], s.counts["pinned_chips"])
            for s in loads] == [(2, 2, 2), (2, 1, 1), (1, 1, 0)]
    ds.window_size_sample = (64, 64)
    (got, held), loads = _data_load(lambda: _through_slot(BatchLoader(ds, batch_size=3)))
    assert [(s.counts["chips"], s.counts["native_chips"], s.counts["pinned_chips"])
            for s in loads] == [(3, 0, 0), (2, 0, 0)]
    assert not any(h for hs in held for h in hs) and len(got) == 2
    assert chip_io.threads() == min(len(os.sched_getaffinity(0)), os.cpu_count())


@pytest.mark.parametrize("num_workers", [0, 2])
def test_prefetch_on_the_cpu_sets_no_slot(root, num_workers):
    """``prefetch_to_device(iter(loader), device="cpu")`` hands the loader
    no ``slot``: the batches, checked after the whole pass, are their
    samples' stack, none counted in ``pinned_chips``."""
    ds = _dataset(root, "recipe")
    it = iter(BatchLoader(ds, batch_size=2, num_workers=num_workers))
    fed, loads = _data_load(lambda: list(prefetch_to_device(it, device="cpu")))
    assert it.slot is None
    for g, w in zip(fed, _want(ds, N_CHIPS, 2), strict=True):
        assert list(g) == list(w) and g["id"] == w["id"]
        assert all(torch.equal(g[k], torch.from_numpy(v)) for k, v in w.items()
                   if isinstance(v, np.ndarray))
    assert [s.counts["pinned_chips"] for s in loads] == [0, 0, 0]


def test_slot_ring_turns_under_a_busy_pool(tmp_path):
    """Many small batches on more loader threads than this machine gives
    the test, with a short switch interval, through a ring of exactly ``1 +
    ahead`` arrays: every batch is still bitwise its samples' stack, so no
    array is handed out again while its batch is unread."""
    rows = []
    rng = np.random.default_rng(5)
    for i in range(36):
        folder = str(tmp_path / f"c{i}")
        _write(folder, "npy", _products(rng, 48, 48))
        rows.append({"id": f"c{i}", "folder": folder})
    ds = ChipDataset(rows, PRODUCTS[:4], ["labelbinary"], "weight_mag1c")
    loader = BatchLoader(ds, batch_size=2, num_workers=4)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got, held = _through_slot(loader)
    finally:
        sys.setswitchinterval(interval)
    assert all(all(h) for h in held) and iter(loader).ahead == 11
    for g, w in zip(got, _want(ds, 36, 2), strict=True):
        _assert_bitwise(g, w)


class _Span:
    def __init__(self, start, counts):
        self.name, self.start, self.end, self.counts = "data.load", start, start + 5, counts


def test_load_pinned_pct_reads_the_counters(monkeypatch):
    """``portbench/metrics/eval.load_pinned_pct.py``: 100 x the summed
    ``pinned_chips`` over the summed ``chips`` of the window's ``data.load``
    spans; None where the spans carry no such counter (a program without
    it) or none lie in the window."""
    from starcop_tpu_torch.utils import profiling

    class Window:
        t_start, t_end = 0, 100

    read = harness.load_module("metrics", "eval.load_pinned_pct").read
    log = [_Span(10, {"chips": 32, "native_chips": 32, "pinned_chips": 32}),
           _Span(20, {"chips": 32, "native_chips": 31, "pinned_chips": 31}),
           _Span(30, {"chips": 8, "native_chips": 8, "pinned_chips": 0}),
           _Span(200, {"chips": 32, "native_chips": 32, "pinned_chips": 32})]  # outside
    monkeypatch.setattr(profiling, "spans", lambda: log)
    assert read({"trace": Window}) == 100.0 * 63 / 72
    log[:] = [_Span(10, {"chips": 32, "native_chips": 32}), _Span(20, {"chips": 32})]
    assert read({"trace": Window}) is None
    log[:] = [_Span(200, {"chips": 32, "pinned_chips": 32})]
    assert read({"trace": Window}) is None


@pytest.mark.parametrize("layout, damage", [("recipe", "truncated"), ("cache", "truncated"),
                                            ("cache", "corrupt")])
def test_damaged_file_raises_naming_it(tmp_path, layout, damage):
    """A raw or DEFLATE TIFF cut inside its last tile, or a DEFLATE tile's
    bytes overwritten, raises ``OSError`` naming the file from the native
    read: never a batch with zeros in their place."""
    folder = str(tmp_path / "c0")
    _write(folder, layout, _products(np.random.default_rng(9), 256, 256))
    path = os.path.join(folder, "TOA_AVIRIS_550nm.tif")
    size = os.path.getsize(path)
    assert chip_io.plan([(path, None)])[0] is not None
    with open(path, "r+b") as fh:
        if damage == "truncated":
            fh.truncate(size - 1000)
        else:
            fh.seek(size - 3000)
            fh.write(bytes(range(256)) * 4)
    ds = ChipDataset([{"id": "c0", "folder": folder}], PRODUCTS[:4], ["labelbinary"],
                     "weight_mag1c")
    with pytest.raises(OSError, match=re.escape(path)):
        ds.read_batch([0])
