"""The two cells of this file's kind, shrunk and run on the CPU (the
harness's look for a card skipped): ``emit_granule_swinv2_b_upernet_f32``
with a SwinV2 + UperNet of tiny widths in ``swinv2_b_upernet``'s place in
the program's registry and in the configuration, and ``emit_granule_clear``
(every pixel valid, no mask, step 54: the resident route). Each sound run is
correct; the planted faults (``controls/faults_swin.py``: the shift mask,
the position bias or the cosine attention of a stage-3 block, PPM's pooled
branches; ``controls/faults.py``: a wrong mf) make it incorrect; a traced
run reads the Swin cell's metrics and its attention spans carry the shapes;
without the network the Swin cell fails in set-up before the kernels'
build. The least-work counts against hand counts."""

import functools
import io
import time

import pytest
import torch

from portbench import harness
from portbench.controls.faults_swin import planted
from portbench.tests.tiny import TINY

SWIN_CELL = "emit_granule_swinv2_b_upernet_f32"
CLEAR_CELL = "emit_granule_clear"
TINY_MODEL = {"embed_dim": 16, "depths": [2, 2, 2, 2], "num_heads": [2, 2, 4, 4], "window": 4,
              "channels": 16}
SHRUNK = {
    SWIN_CELL: {"config": {**TINY["emit_granule_f32"]["config"], "model": TINY_MODEL},
                "traffic": TINY["emit_granule_f32"]["traffic"]},
    # Two whole blocks of 54 columns; the traffic's fill pattern selects no
    # pixel at any width.
    CLEAR_CELL: {"config": {"granule": {"lines": 1280, "samples": 108}},
                 "traffic": {"pool": 2, "warmup_requests": 1, "check_samples": 2}},
}


@pytest.fixture(autouse=True)
def tiny_swin(monkeypatch):
    from starcop_tpu_torch.models import segmenter
    from starcop_tpu_torch.models.swin import SwinV2UperNet

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    monkeypatch.setitem(segmenter.ARCHITECTURES, "swinv2_b_upernet",
                        functools.partial(SwinV2UperNet, **TINY_MODEL))
    yield
    torch.set_num_threads(n)


def run_shrunk(cell, trace=0, seconds=1.0):
    args = harness.parse_args(["--workload", cell, "--seed", str(2**31 + 93), "--seconds",
                               str(seconds), "--trace", str(trace)])
    out, err = io.StringIO(), io.StringIO()
    line = harness.run(args, time.perf_counter(), device="cpu", overrides=SHRUNK[cell],
                       out=out, err=err)
    return line, err.getvalue()


@pytest.mark.parametrize("cell", [SWIN_CELL, CLEAR_CELL])
def test_sound_run_is_correct(cell):
    line, err = run_shrunk(cell)
    assert line["correct"], err
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["metrics"]) == {"granule_ms_p95", "setup_s"}


@pytest.mark.parametrize("cell,fault", [(SWIN_CELL, "mask_off"), (SWIN_CELL, "bias_off"),
                                        (SWIN_CELL, "plain_attention"), (SWIN_CELL, "ppm_off"),
                                        (SWIN_CELL, "granule_mf"), (CLEAR_CELL, "granule_mf")])
def test_planted_fault_is_caught(cell, fault):
    with planted(fault):
        line, err = run_shrunk(cell)
    assert not line["correct"], err
    if fault != "granule_mf":
        gap = line["compared"]["mask_gap"]
        assert gap["value"] > gap["limit"]


def test_clear_pool_is_valid_and_takes_the_resident_route(monkeypatch):
    """Set-up's pool is valid at every pixel and a request calls the
    resident filter once and the masked one never."""
    from starcop_tpu_torch.ops import mag1c_kernels

    bench = harness.load_benchmark()
    cell = harness.by_name(bench["workloads"], CLEAR_CELL, "workload")
    config = harness.merged(harness.load_json(f"{harness.ROOT}/portbench/configs/"
                                              "hyperstarcop_emit.json"),
                            SHRUNK[CLEAR_CELL]["config"])
    traffic = harness.merged(harness.load_json(f"{harness.BENCH_DIR}/workloads/"
                                               "granule_clear_f32.json"),
                             SHRUNK[CLEAR_CELL]["traffic"])
    driver = harness.load_module("drivers", "granule_clear")
    ctx = harness.Context(cell, config, traffic, 5, False, torch.device("cpu"),
                          time.perf_counter())
    state = driver.setup(ctx)
    assert all(g["valid"].all() and g["valid_pixels"] == 1280 * 108 for g in state["pool"])
    assert ctx.config["filter"]["column_step"] == 54
    real, masked = mag1c_kernels.acrwl1mf_masked, []

    def counted(*args, **kwargs):
        masked.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(mag1c_kernels, "acrwl1mf_masked", counted)
    assert driver._resident_calls(state["request"], state["pool"][1]) == 1
    assert not masked


def test_traced_run_reads_the_cells_metrics_and_spans():
    from starcop_tpu_torch.utils import profiling

    profiling.clear_spans()
    line, err = run_shrunk(SWIN_CELL, trace=1)
    assert line["correct"], err
    # No kernel runs on the CPU: the device readings print nothing there.
    assert 0 < line["metrics"]["swin.mfu"]["value"] < 100
    # The entry's upload readings, which the cell shares with the granule cells.
    assert line["metrics"]["granule.upload_ms"]["value"] > 0
    assert line["metrics"]["granule.upload_gbps"]["value"] > 0
    found = [s for s in profiling.spans() if s.name.startswith(("swin.", "upernet."))]
    heads = [s for s in found if s.name == "upernet.head"]
    attention = [s for s in found if s.name == "swin.attention"]
    assert heads and len(attention) == len(heads) * sum(TINY_MODEL["depths"])
    assert {s.name for s in found} == {"swin.stage", "swin.attention", "swin.mlp", "swin.merge",
                                       "upernet.head", "upernet.ppm", "upernet.fpn",
                                       "upernet.fuse"}
    # The 1280 x 96 granule needs no reflect pad: stage maps 320x24, 160x12,
    # 80x6 and 40x3, the last two padded to 80x8 and 40x4 for windows of
    # 4 x 4; every padded map exceeds a window, so odd blocks shift.
    windows = {0: 80 * 6, 1: 40 * 3, 2: 20 * 2, 3: 10 * 1}
    for s in attention:
        assert s.counts["windows"] == windows[s.key] and s.counts["window_tokens"] == 16
        assert s.counts["heads"] == TINY_MODEL["num_heads"][s.key]
    assert sorted(s.counts["shifted"] for s in attention[:8]) == [0] * 4 + [1] * 4
    profiling.clear_spans()


def test_swin_cell_fails_before_the_build_without_the_network(monkeypatch):
    """A program whose registry lacks ``swinv2_b_upernet`` fails in set-up,
    in seconds, before the kernels' build is asked for."""
    from starcop_tpu_torch.models import segmenter
    from starcop_tpu_torch.ops import _build

    monkeypatch.delitem(segmenter.ARCHITECTURES, "swinv2_b_upernet")
    asked = []
    monkeypatch.setattr(_build, "load", lambda *a, **k: asked.append(1))
    t0 = time.perf_counter()
    with pytest.raises(ValueError, match="swinv2_b_upernet"):
        run_shrunk(SWIN_CELL)
    assert not asked and time.perf_counter() - t0 < 10


def test_counts_at_a_tiny_shape():
    """``counts_swin`` against counts by hand at a 64 x 96 input of the tiny
    widths: stage maps 16x24, 8x12, 4x6, 2x3."""
    from portbench.counts_swin import (attention_bytes, attention_flops, head_flops,
                                       stage_shapes, swin_forward_flops)

    m = {**harness.load_json(f"{harness.BENCH_DIR}/configs/swinv2_b_upernet_emit.json")["model"],
         **TINY_MODEL}
    shapes = stage_shapes(64, 96, m)
    assert shapes == [(0, 16, 2, 2, 16, 24), (1, 32, 2, 2, 8, 12), (2, 64, 4, 2, 4, 6),
                      (3, 128, 4, 2, 2, 3)]
    # Stage 1: 384 tokens of 16 channels, each query against 16 keys.
    assert attention_flops(16, 24, 16, 4) == 2 * 384 * 16 * 48 + 4 * 384 * 16 * 16 \
        + 2 * 384 * 16 * 16
    assert attention_bytes(16, 24, 16, 2, 4) == 4 * (2 * 384 * 16 + 4 * 16 * 16 + 4 * 16
                                                     + 512 * 5 + 2 + 2 * 49)
    head = (2 * (1 + 4 + 9 + 36) * 128 * 16 + 2 * 6 * (128 + 64) * 16 * 9
            + 2 * 384 * 16 * 16 + 2 * 384 * 16 * 16 * 9
            + 2 * 96 * 32 * 16 + 2 * 96 * 16 * 16 * 9
            + 2 * 24 * 64 * 16 + 2 * 24 * 16 * 16 * 9
            + 2 * 384 * 64 * 16 * 9 + 2 * 384 * 16)
    assert head_flops(shapes, m) == head
    backbone = 2 * 384 * 16 * 4 * 16
    for _, c, _, depth, h, w in shapes:
        backbone += depth * (attention_flops(h, w, c, 4) + 4 * h * w * c * 4 * c)
    backbone += 2 * 96 * 64 * 32 + 2 * 24 * 128 * 64 + 2 * 6 * 256 * 128
    assert swin_forward_flops(64, 96, m) == backbone + head


def test_counts_at_the_padded_granule():
    """SwinV2-B + UperNet at the padded 1280 x 1248 granule: 3.56 TFLOP a
    forward (53.1 ms at 67 TFLOP/s), 2.57 of them the head; the window
    attention's 0.34 TFLOP bound it at 5.07 ms."""
    from portbench.counts_swin import (attention_flops, head_flops, stage_shapes,
                                       swin_forward_flops)

    m = harness.load_json(f"{harness.BENCH_DIR}/configs/swinv2_b_upernet_emit.json")["model"]
    shapes = stage_shapes(1280, 1248, m)
    assert [s[4:] for s in shapes] == [(320, 312), (160, 156), (80, 78), (40, 39)]
    assert swin_forward_flops(1280, 1248, m) == pytest.approx(3.5588e12, rel=1e-4)
    assert head_flops(shapes, m) == pytest.approx(2.5700e12, rel=1e-4)
    attn = sum(d * attention_flops(h, w, c, 8) for _, c, _, d, h, w in shapes)
    assert attn / 67e12 == pytest.approx(5.066e-3, rel=1e-3)
