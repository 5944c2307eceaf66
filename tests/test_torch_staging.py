"""The pinned upload of host arrays (starcop_tpu_torch/utils/staging.py).

On the CPU: the band planner covers the leading axis once, in order, each
band within ``BAND_BYTES``, the last ragged; a small array, a device tensor,
the CPU device and arrays torch cannot wrap take the plain path, which
counts no ``staged_bytes`` (``test_torch_spans.py`` holds
``entry.upload``'s counters on the CPU).

On the card (marker ``cuda``, skipped without one; imports no JAX, so it
runs with ``--noconftest``): the staged upload is bitwise
``torch.as_tensor``'s for a contiguous f32 cube, a band-sliced strided
view, an f64 input and a ragged leading axis; two granules staged back to
back behind a busy stream keep their own bytes; ``emit_granule_to_mask``'s
``entry.upload`` carries ``staged_bytes == bytes``; ``Uploader`` and
``prefetch_to_device``, copying behind a busy side stream through more
uploads than their rings hold, give ``torch.as_tensor``'s bytes while the
caller reuses its arrays (``test_torch_serve.py`` holds the rings' turns
on the CPU); ``prefetch_to_device(iter(loader))``, whose loader reads every
batch straight into the rings' buffers, gives each batch's fresh read's
bytes behind a busy side stream through more batches than the rings hold,
so no buffer is read into again before its copy has run
(``test_torch_chip_batch.py`` holds the loader's side on the CPU).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import cpu_share  # noqa: E402,F401

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from starcop_tpu_torch.data.datamodule import BatchLoader, prefetch_to_device  # noqa: E402
from starcop_tpu_torch.data.dataset import ChipDataset  # noqa: E402
from starcop_tpu_torch.scenes.emit_pipeline import emit_granule_to_mask  # noqa: E402
from starcop_tpu_torch.serve.pipeline import Uploader  # noqa: E402
from starcop_tpu_torch.utils import staging  # noqa: E402
from starcop_tpu_torch.utils.profiling import clear_spans, span, spans  # noqa: E402
from starcop_tpu_torch.utils.staging import (  # noqa: E402
    BAND_BYTES,
    STAGE_MIN_BYTES,
    plan_bands,
    stage_to_device,
    staged_source,
)

CUDA = torch.device("cuda")
GRANULE = (1280, 1242, 50)  # an EMIT granule's band-selected cube


@pytest.fixture(autouse=True)
def empty_log():
    clear_spans()
    yield
    clear_spans()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return CUDA


@pytest.mark.parametrize("shape", [GRANULE, (3, 1280, 1242), (1001, 1242, 50), (67, 1242, 50),
                                   (5,), (4 << 20,), (1, 2048, 2048), (9, 3)])
def test_bands_cover_the_leading_axis_once_in_order(shape):
    bands = plan_bands(shape)
    row = 4 * int(np.prod(shape[1:]))
    assert bands[0][0] == 0 and bands[-1][1] == shape[0]
    assert all(a[1] == b[0] for a, b in zip(bands, bands[1:]))
    sizes = [stop - start for start, stop in bands]
    assert all(n >= 1 and n * row <= BAND_BYTES for n in sizes)
    assert len(set(sizes[:-1])) <= 1 and sizes[-1] <= sizes[0]
    assert (sizes[0] + 1) * row > BAND_BYTES or len(bands) == 1  # as many rows as fit


def test_granule_bands_end_ragged():
    rows = BAND_BYTES // (4 * 1242 * 50)
    bands = plan_bands(GRANULE)
    assert len(bands) == -(-1280 // rows) and bands[-1] == (rows * (len(bands) - 1), 1280)
    assert 1280 % rows and bands[-1][1] - bands[-1][0] == 1280 % rows
    assert plan_bands((3, 1280, 1242)) == [(0, 2), (2, 3)]  # the RGB planes


def test_which_inputs_are_staged():
    n = STAGE_MIN_BYTES // 4
    big = np.zeros((8, n // 8), np.float32)
    got = staged_source(big, CUDA)
    assert got is not None and got.data_ptr() == big.ctypes.data  # no copy
    assert staged_source(big.astype(np.float16), CUDA) is not None  # f32 size counts
    t = torch.from_numpy(big)
    assert staged_source(t, CUDA) is t
    assert staged_source(big[:, ::2], CUDA) is None  # under the size as float32
    assert staged_source(np.zeros((8, n // 8 - 1), np.float32), CUDA) is None  # small
    assert staged_source(big, torch.device("cpu")) is None  # the CPU device
    assert staged_source(t, torch.device("cpu")) is None
    assert staged_source(torch.empty(big.shape, device="meta"), CUDA) is None  # on a device
    assert staged_source(big[::-1], CUDA) is None  # a stride torch cannot wrap
    assert staged_source([1.0, 2.0], CUDA) is None  # not an array
    wide = np.zeros((2, BAND_BYTES // 4 + 1), np.float32)  # a row wider than a band
    assert staged_source(wide, CUDA) is None


def test_cpu_device_takes_torch_as_tensor():
    a = np.arange(STAGE_MIN_BYTES // 4, dtype=np.float64).reshape(64, -1)
    with profile(activities=[ProfilerActivity.CPU]):
        with span("upload") as s:
            got = stage_to_device(a, torch.device("cpu"))
    assert torch.equal(got, torch.as_tensor(a, dtype=torch.float32))
    assert s.counts == {} and [x.name for x in spans()] == ["upload"]
    t = torch.ones(4, 5)
    assert stage_to_device(t, torch.device("cpu")) is t


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


def _cube(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


CASES = {
    "contiguous_f32": lambda: _cube(GRANULE, 1),
    "band_sliced_view": lambda: _cube((640, 1242, 60), 2)[..., 4:54],
    "f64": lambda: _cube((400, 1242, 50), 3, np.float64),
    "ragged_rows": lambda: _cube((1001, 1242, 50), 4),
    "rgb_planes": lambda: _cube((3, 1280, 1242), 5),
    "cpu_tensor": lambda: torch.from_numpy(_cube((300, 1242, 50), 6)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_staged_upload_is_bitwise_as_tensor(card, case):
    a = CASES[case]()
    assert staged_source(a, card) is not None
    with profile(activities=[ProfilerActivity.CPU]):
        with span("upload") as s:
            got = stage_to_device(a, card)
    want = torch.as_tensor(a, dtype=torch.float32, device=card)
    assert got.is_contiguous() and got.device.type == "cuda" and got.dtype == torch.float32
    assert torch.equal(got, want)
    assert s.counts == {"staged_bytes": a.nbytes}


@pytest.mark.cuda
def test_back_to_back_granules_keep_their_own_bytes(card):
    a, b = _cube(GRANULE, 7), _cube(GRANULE, 8)
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)  # hold the stream, so the copies queue behind it
    xa = stage_to_device(a, card)
    xb = stage_to_device(b, card)
    a[:] = 0.0  # the caller reuses its arrays once the call returns
    b[:] = 0.0
    torch.cuda.synchronize()
    assert torch.equal(xa.cpu(), torch.from_numpy(_cube(GRANULE, 7)))
    assert torch.equal(xb.cpu(), torch.from_numpy(_cube(GRANULE, 8)))
    assert len(plan_bands(GRANULE)) > staging.RING_SLOTS  # every slot was reused


@pytest.mark.cuda
def test_entry_upload_counts_staged_bytes(card):
    h, w, s = 1024, 768, 16
    rng = np.random.default_rng(9)
    cube = (10.0 + rng.random((h, w, s))).astype(np.float32)
    rgb = rng.random((3, h, w)).astype(np.float32)
    template = -np.abs(np.sin(np.linspace(0.3, 3 * np.pi, s))).astype(np.float32)
    kw = dict(column_step=64, num_iter=2, alpha=1e-4, device=card)
    with profile(activities=[ProfilerActivity.CPU]):
        pred, mf = emit_granule_to_mask(cube, rgb, template, lambda x: x[:, :1], **kw)
    upload = next(x for x in spans() if x.name == "entry.upload")
    assert upload.counts == {"bytes": cube.nbytes + rgb.nbytes,
                             "staged_bytes": cube.nbytes + rgb.nbytes}
    want_pred, want_mf = emit_granule_to_mask(torch.as_tensor(cube, device=card),
                                              torch.as_tensor(rgb, device=card), template,
                                              lambda x: x[:, :1], **kw)
    assert torch.equal(pred, want_pred) and torch.equal(mf, want_mf)


# The two users of ``upload``: both hold their copies behind a stream kept
# busy by ``torch.cuda._sleep`` on the card, so that each pinned buffer's turn
# comes again while the copy that read it is still queued. Their rings are
# made before the stream is held: pinning memory may wait for the card.

HOLD_CYCLES = 1_000_000_000  # ~0.5 s on an H100, far longer than the host's work below


def _wire(seed):
    rng = np.random.default_rng(seed)
    lo = rng.standard_normal(50).astype(np.float32)
    return {"cube": rng.integers(0, 1 << 16, (320, 1242, 50), dtype=np.uint16),
            "q_lo": lo, "q_scale": lo + 1.0,  # one shape and dtype, two buffers
            "valid": np.packbits(rng.random(320 * 1242) < 0.94)}


def _on_card(a, card):
    return torch.as_tensor(a.view(np.int16) if a.dtype == np.uint16 else a, device=card)


@pytest.mark.cuda
def test_uploader_behind_a_busy_stream_is_bitwise_as_tensor(card):
    up = Uploader(card)
    wires = [_wire(seed) for seed in range(up.BUFFERS + 2)]  # every buffer taken again
    sent = [{k: a.copy() for k, a in w.items()} for w in wires]
    up({"wire": _wire(99)})  # makes the rings
    torch.cuda.synchronize()
    with torch.cuda.stream(up.stream):
        torch.cuda._sleep(HOLD_CYCLES)
    got = [up({"wire": w}) for w in sent]
    for w in sent:  # the caller reuses its arrays once the call returns
        for a in w.values():
            a[...] = 0
    for payload in got:
        staging.hand_over(payload["wire"], payload["ready"], torch.cuda.current_stream(card))
    torch.cuda.synchronize()
    for w, payload in zip(wires, got):
        assert payload["wire"].keys() == w.keys()
        assert all(torch.equal(payload["wire"][k], _on_card(a, card)) for k, a in w.items())


def _batches(n):
    rng = np.random.default_rng(11)
    return [{"input": rng.standard_normal((8, 4, 256, 256)).astype(np.float32),
             "labels": rng.integers(0, 2, (8, 1, 256, 256)).astype(np.int64),
             "id": [f"chip{i}_{j}" for j in range(8)], "has_plume": rng.random(8) < 0.5}
            for i in range(n)]


@pytest.mark.cuda
def test_prefetch_behind_a_busy_stream_is_bitwise_as_tensor(card, monkeypatch):
    held, make_stream = torch.cuda.Stream(card), torch.cuda.Stream

    def side_stream(*args, **kwargs):  # the prefetch's Stream(dev) is held; torch's own calls pass
        return make_stream(*args, **kwargs) if kwargs else held

    monkeypatch.setattr(torch.cuda, "Stream", side_stream)
    batches = _batches(7)  # batch 5 takes batch 1's buffers again (size + 2 = 4 an array)

    def refilled():  # one host array refilled for every batch, as a loader reusing its own
        x = np.empty_like(batches[0]["input"])
        for i, b in enumerate(batches):
            if i == 1:  # batch 0 made the rings: hold the side stream from here on
                with torch.cuda.stream(held):
                    torch.cuda._sleep(HOLD_CYCLES)
            x[...] = b["input"]
            yield {**b, "input": x}

    torch.cuda.synchronize()
    got = list(prefetch_to_device(refilled(), device=card, size=2))
    torch.cuda.synchronize()
    assert len(got) == len(batches)
    for b, g in zip(batches, got):
        assert list(g) == list(b) and g["id"] is b["id"] and g["has_plume"] is b["has_plume"]
        for k in ("input", "labels"):
            assert g[k].device.type == "cuda" and torch.equal(g[k], torch.as_tensor(b[k], device=card))


CHIP_PRODUCTS = ("mag1c", "TOA_AVIRIS_640nm", "TOA_AVIRIS_550nm", "TOA_AVIRIS_460nm",
                 "labelbinary", "weight_mag1c")


@pytest.mark.cuda
@pytest.mark.parametrize("num_workers", [0, 2])
def test_loader_prefetch_behind_a_busy_stream_is_bitwise_the_fresh_read(card, monkeypatch,
                                                                        tmp_path, num_workers):
    held, make_stream = torch.cuda.Stream(card), torch.cuda.Stream

    def side_stream(*args, **kwargs):  # the prefetch's Stream(dev) is held; torch's own calls pass
        return make_stream(*args, **kwargs) if kwargs else held

    monkeypatch.setattr(torch.cuda, "Stream", side_stream)
    batch, n_batches, hold_at = 4, 12, 1 + num_workers  # by then the first batches made the rings
    rng = np.random.default_rng(12)
    rows = []
    for i in range(batch * n_batches):
        folder = tmp_path / f"c{i}"
        folder.mkdir()
        for p in CHIP_PRODUCTS:
            np.save(folder / f"{p}.npy", rng.standard_normal((128, 128)).astype(np.float32))
        rows.append({"id": f"c{i}", "folder": str(folder)})
    args = (CHIP_PRODUCTS[:4], ["labelbinary"], "weight_mag1c")

    class Held(ChipDataset):
        def read_batch(self, indices, slot=None):
            if indices[0] == batch * hold_at:  # hold the side stream from here on
                with torch.cuda.stream(held):
                    torch.cuda._sleep(HOLD_CYCLES)
            return super().read_batch(indices, slot)

    fresh = ChipDataset(rows, *args)
    want = [fresh.read_batch(range(b * batch, (b + 1) * batch)) for b in range(n_batches)]
    loader = BatchLoader(Held(rows, *args), batch_size=batch, num_workers=num_workers)
    assert n_batches > 2 + 2 + iter(loader).ahead  # every buffer (size + 2 + ahead) taken again
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]):
        got = list(prefetch_to_device(iter(loader), device=card, size=2))
    torch.cuda.synchronize()
    loads = [x for x in spans() if x.name == "data.load"]
    assert sum(x.counts["pinned_chips"] for x in loads) == batch * n_batches
    assert len(got) == n_batches
    for w, g in zip(want, got):
        assert list(g) == list(w) and g["id"] == w["id"]
        for k, a in w.items():
            if isinstance(a, np.ndarray):
                assert g[k].device.type == "cuda" and torch.equal(g[k], torch.as_tensor(a, device=card))
