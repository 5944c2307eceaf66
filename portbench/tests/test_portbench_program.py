"""The program's spans joined with the trace (``portbench/program.py``): on
hand-made spans beside the hand-made trace of ``test_portbench_trace.py``,
in traced runs of the shrunken cells on the CPU, and on the card (``-m
chip``): the spans' stamps against the profiler's own copy of them, and the
cost of a span with tracing off."""

import statistics
import time
import timeit

import pytest

from portbench import harness, program
from portbench.tests.test_portbench_trace import CPU, CUDA, Ev, view
from portbench.tests.tiny import run_tiny
from portbench.trace import TraceView


class S:
    """A program span as ``profiling.spans`` gives it."""

    def __init__(self, name, start, end, counts=None):
        self.name, self.start, self.end, self.counts = name, start, end, counts or {}


def test_spans_kept_inside_the_window_and_none_without_a_log(monkeypatch):
    log = [S("entry.upload", 20, 30), S("entry.upload", 2, 12), S("entry.upload", 95, 120),
           S("entry.filter", 40, 60)]
    found = program.spans(view(), "entry.upload", log)
    assert [(s.start, s.end) for s in found] == [(2, 12), (20, 30)]
    assert program.host_ns(found) == 20
    from starcop_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "spans")
    assert program.program_spans() is None and program.spans(view(), "entry.upload") is None


def test_device_time_by_launch_inside_program_spans():
    v = view()  # the copy launched at 8, the kernel at 45, the set at 75
    assert program.device_ns_launched_in(v, [S("a", 5, 10)]) == 40
    assert program.device_ns_launched_in(v, [S("a", 5, 10)], kernels_only=True) == 0
    assert program.device_ns_launched_in(v, [S("a", 40, 50), S("a", 44, 46)]) == 20
    assert program.device_ns_launched_in(v, [S("a", 5, 50), S("b", 70, 80)]) == 70
    assert program.device_ns_launched_in(v, [S("a", 46, 70)]) == 0


def test_idle_gaps_inside_program_spans():
    v = view()  # kernel-idle over 0-50 and 70-100
    assert program.idle_ns(v) == 80
    assert program.idle_ns_in(v, [S("a", 10, 30)]) == 20
    assert program.idle_ns_in(v, [S("a", 10, 30), S("b", 20, 40)]) == 30  # overlap once
    assert program.idle_ns_in(v, [S("a", 45, 80)]) == 15
    assert program.idle_ns_in(v, [S("a", 55, 65)]) == 0


def test_metric_readers_on_hand_made_spans(monkeypatch):
    v = TraceView([Ev("pb.window", 0, 1000, CPU),
                   Ev("cudaLaunchKernel", 110, 1, CPU, corr=1),
                   Ev("cudaMemcpyAsync", 120, 1, CPU, corr=2),
                   Ev("filter_round", 200, 50, CUDA, corr=1),
                   Ev("Memcpy HtoD (Pageable -> Device)", 260, 30, CUDA, corr=2)])
    log = [S("entry.upload", 10, 100, {"bytes": 450}), S("entry.filter", 100, 130),
           S("serve.encode", 10, 30), S("serve.encode", 500, 540), S("serve.write", 600, 610),
           S("serve.write", 700, 710), S("data.load", 300, 500), S("validation.rows", 600, 604)]
    from starcop_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "spans", lambda: log)
    bundle = {"trace": v}
    read = lambda name: harness.load_module("metrics", name).read(bundle)  # noqa: E731
    assert read("granule.upload_ms") == 90 / 1e6
    assert read("granule.upload_gbps") == 5.0
    assert read("granule.filter_device_ms") == 50 / 1e6  # the kernel, not the copy
    assert read("serve.encode_ms") == 30 / 1e6
    assert read("serve.get_wait_ms") is None  # no such span
    assert read("eval.load_ms") == 200 / 1e6
    assert read("eval.rows_ms") == 4 / 1e6
    # idle: 0-200 and 250-1000; data.load 300-500 holds 200 of 950
    assert abs(read("eval.idle_in_load_pct") - 100 * 200 / 950) < 1e-12


NEW = {
    "emit_granule_f32": {"granule.upload_ms", "granule.upload_gbps"},
    "emit_serve_default": {"serve.encode_ms", "serve.get_wait_ms", "serve.put_wait_ms"},
    "aviris_eval_bf16": {"eval.load_ms", "eval.idle_in_load_pct", "eval.rows_ms"},
}


@pytest.mark.parametrize("cell", sorted(NEW))
def test_traced_tiny_run_prints_the_new_metrics(cell):
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        line, err = run_tiny(cell, seconds=2.0, trace=1)
    finally:
        torch.set_num_threads(n)
    assert line["correct"], err
    _, layer = harness.cell_metrics(harness.load_benchmark(), cell)
    mine = {m["name"] for m in layer if m["source"] == "program_span"}
    assert NEW[cell] <= mine
    got = line["metrics"]
    for name in NEW[cell]:
        assert got[name]["value"] > 0, name
    if cell == "aviris_eval_bf16":
        assert got["eval.idle_in_load_pct"]["value"] <= 100.0


# -- on the card ---------------------------------------------------------------

GRANULE = {"config": {"granule": {"lines": 320}},
           "traffic": {"pool": 2, "check_samples": 2, "warmup_requests": 1}}


def _quantile(values, q):
    ordered = sorted(values)
    return ordered[min(len(ordered) - 1, int(q * len(ordered)))]


@pytest.mark.chip
def test_spans_agree_with_the_profilers_copy(cuda_device):
    """The granule's main-thread spans against the profiler's
    ``starcop.<name>`` events: the 99th percentile of the start and end
    gaps within 100 us."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from starcop_tpu_torch.utils import profiling

    bench = harness.load_benchmark()
    cell = harness.by_name(bench["workloads"], "emit_granule_f32", "workload")
    config = harness.merged(harness.load_json(f"{harness.ROOT}/portbench/configs/"
                                              "hyperstarcop_emit.json"), GRANULE["config"])
    traffic = harness.merged(harness.load_json(f"{harness.BENCH_DIR}/workloads/granule_f32.json"),
                             GRANULE["traffic"])
    driver = harness.load_module("drivers", "granule")
    ctx = harness.Context(cell, config, traffic, 2**31 + 5, False, cuda_device,
                          time.perf_counter())
    state = driver.setup(ctx)
    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(40):
            state["request"](state["pool"][i % len(state["pool"])])
        torch.cuda.synchronize(cuda_device)
    events = prof.profiler.kineto_results.events()
    starts, ends = [], []
    for name in ("entry.upload", "entry.filter"):
        mine = sorted((s for s in profiling.spans() if s.name == name), key=lambda s: s.start)
        theirs = sorted((e for e in events if e.name() == profiling.SPAN_PREFIX + name
                         and e.device_type() == DeviceType.CPU), key=lambda e: e.start_ns())
        assert len(mine) == len(theirs) == 40
        for s, e in zip(mine, theirs):
            starts.append(s.start - e.start_ns())
            ends.append(e.start_ns() + e.duration_ns() - s.end)
    gaps = [abs(x) for x in starts + ends]
    print(f"clock gaps ns: start median {statistics.median(starts)} p99 "
          f"{_quantile([abs(x) for x in starts], 0.99)}; end median {statistics.median(ends)} "
          f"p99 {_quantile([abs(x) for x in ends], 0.99)}; card {harness.power_limit()}")
    assert _quantile(gaps, 0.99) <= 100_000
    # No span is copied onto the device's timeline, where it would read as
    # device work (TraceView counts every device event but the harness's).
    assert not [e for e in events if e.name().startswith(profiling.SPAN_PREFIX)
                and e.device_type() != DeviceType.CPU]
    profiling.clear_spans()


@pytest.mark.chip
def test_a_span_with_tracing_off_costs_under_a_microsecond(cuda_device):
    from starcop_tpu_torch.utils.profiling import span

    def off():
        with span("entry.upload"):
            pass

    n = 200_000
    per = [timeit.timeit(off, number=n) / n * 1e9 for _ in range(5)]
    base = [timeit.timeit(lambda: None, number=n) / n * 1e9 for _ in range(5)]
    print(f"span off: {min(per):.1f}-{max(per):.1f} ns a span (a bare call "
          f"{min(base):.1f} ns); card {harness.power_limit()}")
    assert statistics.median(per) < 1000
