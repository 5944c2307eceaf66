"""The port's spans and counters (starcop_tpu_torch/utils/profiling.py) on the
CPU: off unless the profiler records on the thread (or a thread the package
started from one), the layer boundaries they mark, the worker threads that
inherit the state, and their stamps on the profiler's clock.

  * with no profiler, ``span`` is one shared no-op, no profiler mark is
    made and nothing is logged, on every traced path;
  * under ``torch.profiler.profile``: names, parents, inherited keys and
    ``entry.upload``'s ``bytes``; the pipeline's stages on its own threads
    under each granule's key, its queue waits, and ``SceneResult.timings``
    equal to the spans' durations; ``data.load`` on the loader's pool;
    ``validation.rows`` a batch;
  * the clock: an op run inside a span lies inside its stamps (1 ms slack);
  * ``trace``'s Chrome trace holds the worker threads' spans.
"""

import contextlib
import json
import os
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import cpu_share  # noqa: E402,F401

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from starcop_tpu_torch.data.datamodule import BatchLoader  # noqa: E402
from starcop_tpu_torch.data.synthetic import synthetic_scene  # noqa: E402
from starcop_tpu_torch.eval.validation import run_validation  # noqa: E402
from starcop_tpu_torch.scenes.emit_pipeline import emit_granule_to_mask  # noqa: E402
from starcop_tpu_torch.serve.pipeline import (  # noqa: E402
    ScenePipeline,
    Uploader,
    encode_payload,
    make_compute_fn,
)
from starcop_tpu_torch.utils import profiling  # noqa: E402
from starcop_tpu_torch.utils.profiling import (  # noqa: E402
    carry,
    clear_spans,
    count,
    span,
    spans,
)

H, W, S, STEP = 128, 48, 12, 16
FILTER = dict(column_step=STEP, num_iter=2, alpha=1e-4)


@pytest.fixture(autouse=True)
def empty_log():
    clear_spans()
    yield
    clear_spans()


def _traced():
    return profile(activities=[ProfilerActivity.CPU])


def _granule(seed=3):
    template = -np.abs(np.sin(np.linspace(0.3, 3 * np.pi, S))).astype(np.float32)
    sc = synthetic_scene(np.random.default_rng(seed), H, W, n_plumes=1, template=template,
                         max_concentration=8000.0)
    cube = np.ascontiguousarray(sc["radiance"], np.float32)
    rgb = np.ascontiguousarray(np.moveaxis(sc["rgb"], -1, 0), np.float32)
    return cube, rgb, template


def _model(x):
    return x[:, :1]


def _pipeline_granules(n):
    cube, rgb, _ = _granule()
    wl = np.linspace(2122.0, 2488.0, S)
    return {str(i): {"cube": cube + i, "rgb": np.ascontiguousarray(np.moveaxis(rgb, 0, -1)),
                     "fill_value": -9999.0, "wavelengths": wl, "fwhm": np.full(S, 8.5),
                     "glt": None, "transform": None, "crs_epsg": None} for i in range(n)}


def _run_pipeline(n=3):
    granules = _pipeline_granules(n)
    upload = Uploader("cpu")
    compute = make_compute_fn(_model, "cpu", download_dtype="f32", **{
        k: FILTER[k] for k in ("column_step", "num_iter")})
    return ScenePipeline(lambda name: upload(encode_payload(granules[name], "f32")), compute,
                         lambda name, out: None, queue_size=1).run(list(granules))


class _Chips:
    """A chip dataset of ``n`` rows, row i filled with i."""

    rows = []

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"input": np.full((2, 4, 4), i, np.float32), "weight": float(i), "id": f"c{i}"}


def _load(num_workers=0):
    return list(BatchLoader(_Chips(6), batch_size=2, num_workers=num_workers))


def _validation_batches(n=2, b=3):
    rng = np.random.default_rng(0)
    out = []
    for k in range(n):
        pred = torch.as_tensor(rng.random((b, 1, 8, 8)), dtype=torch.float32)
        out.append({"prediction": pred, "pred_binary": (pred > 0.5).to(torch.int32),
                    "output_norm": torch.as_tensor(rng.random((b, 1, 8, 8)) > 0.7),
                    "pred_classification": torch.ones(b, 1), "id": [f"t{k}{i}" for i in range(b)]})
    return out


def _validate():
    return run_validation(lambda batch: batch, _validation_batches())[0]


def _entry():
    cube, rgb, tpl = _granule()
    return emit_granule_to_mask(cube, rgb, tpl, _model, device="cpu", **FILTER)


# Each traced path: what drives it, and the spans it logs.
PATHS = {
    "entry": (_entry, {"entry.upload": 1, "entry.filter": 1, "mag1c.base": 1}),
    "serve": (_run_pipeline, {"serve.read": 3, "serve.encode": 3, "serve.put_wait": 3,
                              "serve.get_wait": 4, "serve.compute": 3, "entry.upload": 3,
                              "entry.filter": 3, "mag1c.base": 3, "serve.write": 3}),
    "loader": (lambda: _load(2), {"data.load": 3}),
    "validation": (_validate, {"validation.rows": 2}),
}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_no_profiler_no_spans_and_no_record_function(path, monkeypatch):
    def refused(*args, **kwargs):
        raise AssertionError("a profiler mark while tracing is off")

    monkeypatch.setattr(torch.profiler, "record_function", refused)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refused)
    PATHS[path][0]()
    assert spans() == []


@pytest.mark.parametrize("path", sorted(PATHS))
def test_each_path_logs_its_spans(path):
    with _traced():
        PATHS[path][0]()
    names = {}
    for s in spans():
        names[s.name] = names.get(s.name, 0) + 1
        assert s.start <= s.end
    assert names == PATHS[path][1]


def test_off_is_one_shared_no_op():
    assert span("a") is span("b", key="k")
    with span("a") as s:
        count("bytes", 5)
    assert s is None and spans() == []
    fn = lambda: 1  # noqa: E731
    assert carry(fn) is fn
    assert profiling._LOG.maxlen == profiling.SPAN_LOG_MAX


def test_parents_keys_and_counts():
    with _traced():
        with span("outer", key="g7") as outer:
            count("n", 2)
            with span("inner") as inner:
                count("n", 3)
                count("n", 4)
            count("n", 1)
        with span("root") as r1:
            pass
        with span("root") as r2:
            pass
        count("n", 9)  # no span open: nothing
    assert inner.parent == outer.id and outer.parent is None
    assert inner.key == outer.key == "g7"
    assert outer.counts == {"n": 3} and inner.counts == {"n": 7}
    assert isinstance(r1.key, int) and isinstance(r2.key, int) and r1.key != r2.key
    assert {s.thread for s in spans()} == {threading.get_ident()}
    assert [s.name for s in spans()] == ["inner", "outer", "root", "root"]


@pytest.mark.parametrize("on_device", [False, True])
def test_entry_spans_names_parents_and_bytes(on_device):
    cube, rgb, tpl = _granule()
    args = (torch.as_tensor(cube), torch.as_tensor(rgb)) if on_device else (cube, rgb)
    with _traced() as prof:
        with span("request", key="g1") as request:
            pred, mf = emit_granule_to_mask(*args, tpl, _model, device="cpu", **FILTER)
    upload, filt = (next(s for s in spans() if s.name == n)
                    for n in ("entry.upload", "entry.filter"))
    assert upload.parent == filt.parent == request.id
    assert upload.key == filt.key == "g1"
    assert upload.end <= filt.start
    assert upload.counts == {"bytes": 0 if on_device else cube.nbytes + rgb.nbytes}
    assert filt.counts == {}
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert {"starcop.request", "starcop.entry.upload", "starcop.entry.filter"} <= names
    want_pred, want_mf = emit_granule_to_mask(cube, rgb, tpl, _model, device="cpu", **FILTER)
    assert torch.equal(pred, want_pred) and torch.equal(mf, want_mf)


def test_pipeline_spans_on_worker_threads_and_timings():
    with _traced():
        results = _run_pipeline(3)
    assert len(results) == 3 and all(r.error is None for r in results)
    main = threading.get_ident()
    logged = spans()
    by = {(s.name, s.key): s for s in logged}
    threads = {}
    for r in results:
        for stage in ("read", "compute", "write"):
            s = by[(f"serve.{stage}", r.name)]
            assert s.parent is None and s.thread != main
            threads.setdefault(stage, set()).add(s.thread)
            assert r.timings[f"{stage}_s"] == s.seconds
        encode = by[("serve.encode", r.name)]
        assert encode.parent == by[("serve.read", r.name)].id
        put = by[("serve.put_wait", r.name)]
        assert put.thread in threads["read"] and put.start >= by[("serve.read", r.name)].end
        for name in ("entry.upload", "entry.filter"):
            assert by[(name, r.name)].parent == by[("serve.compute", r.name)].id
    assert all(len(t) == 1 for t in threads.values())
    assert len({t for ts in threads.values() for t in ts}) == 3
    waits = [s for s in logged if s.name == "serve.get_wait"]
    assert len(waits) == 4 and {s.thread for s in waits} == threads["compute"]


def test_pipeline_timings_without_tracing():
    results = _run_pipeline(2)
    assert spans() == []
    for r in results:
        assert {"read_s", "compute_s", "write_s"} <= set(r.timings)
        assert all(v >= 0 for v in r.timings.values())


@pytest.mark.parametrize("num_workers", [0, 2])
def test_loader_spans_on_its_pool(num_workers):
    with _traced():
        batches = _load(num_workers)
    want = _load(num_workers)
    assert [b["id"] for b in batches] == [b["id"] for b in want]
    assert all(np.array_equal(a["input"], b["input"]) for a, b in zip(batches, want))
    loads = [s for s in spans() if s.name == "data.load"]
    assert len(loads) == 3
    main = threading.get_ident()
    if num_workers:
        assert all(s.thread != main for s in loads)
    else:
        assert all(s.thread == main for s in loads)
    assert len({s.key for s in loads}) == 3


def test_validation_rows_a_batch_and_rows_unchanged():
    want = _validate()
    with _traced():
        got = _validate()
    assert got == want
    rows = [s for s in spans() if s.name == "validation.rows"]
    assert len(rows) == 2 and all(s.parent is None for s in rows)


def test_ops_lie_inside_their_spans_on_the_profilers_clock():
    a = torch.randn(96, 96)
    with _traced() as prof:
        for _ in range(5):
            with span("clock.mm"):
                torch.mm(a, a)
            with span("clock.cumsum"):
                torch.cumsum(a, 0)
    slack = 1_000_000  # 1 ms
    events = prof.profiler.kineto_results.events()
    for op, name in (("aten::mm", "clock.mm"), ("aten::cumsum", "clock.cumsum")):
        found = [s for s in spans() if s.name == name]
        ops = [e for e in events if e.name() == op]
        marks = [e for e in events if e.name() == profiling.SPAN_PREFIX + name]
        assert len(ops) == len(found) == len(marks) == 5
        for s, e, m in zip(found, sorted(ops, key=lambda e: e.start_ns()),
                           sorted(marks, key=lambda e: e.start_ns())):
            assert s.start - slack <= e.start_ns()
            assert e.start_ns() + e.duration_ns() <= s.end + slack
            assert abs(m.start_ns() - s.start) <= slack
            assert abs(m.start_ns() + m.duration_ns() - s.end) <= slack


def test_carry_runs_a_thread_under_the_callers_state():
    seen = {}

    def work(tag):
        with span("worker", key=tag) as s:
            seen[tag] = s is not None

    def run(target, tag):
        t = threading.Thread(target=target, args=(tag,))
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()

    with _traced():
        run(work, "plain")
        run(carry(work), "carried")
    run(carry(work), "after")
    assert seen == {"plain": False, "carried": True, "after": False}
    assert [s.key for s in spans()] == ["carried"]


def test_trace_holds_the_worker_threads_spans(tmp_path):
    with profiling.trace(str(tmp_path / "t")):
        results = _run_pipeline(2)
    assert all(r.error is None for r in results)
    with open(tmp_path / "t" / f"trace_{os.getpid()}.json") as fh:
        events = json.load(fh)["traceEvents"]
    by_name = {}
    for e in events:
        by_name.setdefault(e.get("name"), set()).add(e.get("tid"))
    if profiling._all_threads_config() is None:  # an older torch: the plain profile
        assert "starcop.serve.read" not in by_name
        return
    for stage in ("read", "compute", "write"):
        assert len(by_name[f"starcop.serve.{stage}"]) == 1
    tids = set().union(*(by_name[f"starcop.serve.{s}"] for s in ("read", "compute", "write")))
    assert len(tids) == 3


def test_span_records_when_the_block_raises():
    with _traced():
        with contextlib.suppress(ValueError):
            with span("fails"):
                raise ValueError("x")
        with span("after") as after:
            pass
    assert [s.name for s in spans()] == ["fails", "after"] and after.parent is None


def test_threads_recording_at_once_lose_no_span():
    """More threads than cores, switching every microsecond, each nesting
    spans and counting: every span logged once, with its own thread's
    parent and counts."""
    n_threads, n_spans = 4 * (os.cpu_count() or 2), 200

    def work(tag):
        for i in range(n_spans):
            with span("outer", key=(tag, i)):
                with span("inner"):
                    count("c", 1)
                    count("c", 1)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with _traced():
            threads = [threading.Thread(target=carry(work), args=(k,)) for k in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    logged = spans()
    assert len(logged) == 2 * n_threads * n_spans
    assert len({s.id for s in logged}) == len(logged)
    outer = {s.id: s for s in logged if s.name == "outer"}
    for s in logged:
        if s.name == "inner":
            parent = outer[s.parent]
            assert parent.thread == s.thread and parent.key == s.key
            assert parent.start <= s.start <= s.end <= parent.end
            assert s.counts == {"c": 2}
