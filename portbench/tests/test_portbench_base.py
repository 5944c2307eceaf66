"""The readers of the filter's Woodbury base (``granule.filter_base_host_ms``,
``granule.filter_base_kernel_pct``): on hand-made spans, None without the
span or its counter, and in a traced run of the shrunken granule cell on the
CPU, where the base runs its plain twin."""

import pytest

from portbench import harness
from portbench.tests.test_portbench_program import S
from portbench.tests.test_portbench_trace import CPU, Ev
from portbench.tests.tiny import run_tiny
from portbench.trace import TraceView

BASE = [S("entry.filter", 100, 300), S("mag1c.base", 110, 140, {"blocks": 23, "kernel": 1}),
        S("entry.filter", 400, 600), S("mag1c.base", 410, 420, {"blocks": 23, "kernel": 0})]


@pytest.mark.parametrize("name, log, want", [
    ("granule.filter_base_host_ms", BASE, 40 / 2 / 1e6),
    ("granule.filter_base_host_ms", BASE[::2], None),  # no mag1c.base span
    ("granule.filter_base_host_ms", BASE[1::2], None),  # no request span
    ("granule.filter_base_kernel_pct", BASE, 50.0),
    ("granule.filter_base_kernel_pct", BASE[:2], 100.0),
    ("granule.filter_base_kernel_pct", BASE[::2], None),  # no mag1c.base span
    ("granule.filter_base_kernel_pct",
     [S("entry.filter", 100, 300), S("mag1c.base", 110, 140, {"blocks": 23})], None),
])
def test_base_readers_on_hand_made_spans(monkeypatch, name, log, want):
    """Host time in ``mag1c.base`` a request (``entry.filter``) and the
    share of bases that ran the kernel; None without the span (a program
    that has none) or the counter."""
    from starcop_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "spans", lambda: log)
    got = harness.load_module("metrics", name).read(
        {"trace": TraceView([Ev("pb.window", 0, 1000, CPU)])})
    assert got == want


def test_traced_tiny_granule_run_reads_the_base():
    """The shrunken granule cell, traced on the CPU: the base's host time
    is read, and no base ran the kernel (the twin runs on CPU tensors)."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        line, err = run_tiny("emit_granule_f32", seconds=2.0, trace=1)
    finally:
        torch.set_num_threads(n)
    assert line["correct"], err
    _, layer = harness.cell_metrics(harness.load_benchmark(), "emit_granule_f32")
    assert {"granule.filter_base_host_ms", "granule.filter_base_kernel_pct"} <= {
        m["name"] for m in layer}
    got = line["metrics"]
    assert got["granule.filter_base_host_ms"]["value"] > 0
    assert got["granule.filter_base_kernel_pct"]["value"] == 0.0
