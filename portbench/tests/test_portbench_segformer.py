"""The two granule cells of this file's kind, shrunk and run on the CPU (the
harness's look for a card skipped): ``emit_granule_segformer_b5_f32`` with a
SegFormer of tiny widths in ``segformer_b5``'s place in the program's
registry and in the configuration, and ``emit_granule_bf16``. Each sound run
is correct; the planted faults (``controls/faults_segformer.py``: the
attention of a stage-3 block taken out; ``controls/faults.py``: a wrong mf)
make it incorrect; a traced run reads the SegFormer cell's metrics and its
attention spans carry the shapes."""

import functools
import io
import time

import pytest
import torch

from portbench import harness
from portbench.controls.faults_segformer import planted
from portbench.tests.tiny import TINY

SEGFORMER_CELL = "emit_granule_segformer_b5_f32"
TINY_MODEL = {"embed_dims": [8, 16, 24, 32], "num_heads": [1, 2, 3, 4], "depths": [1, 1, 2, 1],
              "decoder_dim": 32}
SHRUNK = {
    SEGFORMER_CELL: {"config": {**TINY["emit_granule_f32"]["config"], "model": TINY_MODEL},
                     "traffic": TINY["emit_granule_f32"]["traffic"]},
    # The bf16 stream's shares swing with the scene on few pixels: 12 column
    # blocks (the cell has 39) and the cell's plumes a column (6 over 1,242)
    # let them average as the cell's do; 96 columns hold 2 valid blocks.
    "emit_granule_bf16": {"config": {"granule": {"lines": 1280, "samples": 384}},
                          "traffic": {**TINY["emit_granule_f32"]["traffic"], "plumes": 2,
                                      "fill_corner": [128, 100], "fill_block": 5}},
}


@pytest.fixture(autouse=True)
def tiny_segformer(monkeypatch):
    from starcop_tpu_torch.models import segmenter
    from starcop_tpu_torch.models.segformer import SegFormer

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    shape = {k: v for k, v in TINY_MODEL.items()}
    monkeypatch.setitem(segmenter.ARCHITECTURES, "segformer_b5",
                        functools.partial(SegFormer, sr_ratios=(8, 4, 2, 1), **shape))
    yield
    torch.set_num_threads(n)


def run_shrunk(cell, trace=0, seconds=1.0):
    args = harness.parse_args(["--workload", cell, "--seed", str(2**31 + 91), "--seconds",
                               str(seconds), "--trace", str(trace)])
    out, err = io.StringIO(), io.StringIO()
    line = harness.run(args, time.perf_counter(), device="cpu", overrides=SHRUNK[cell],
                       out=out, err=err)
    return line, err.getvalue()


@pytest.mark.parametrize("cell", [SEGFORMER_CELL, "emit_granule_bf16"])
def test_sound_run_is_correct(cell):
    line, err = run_shrunk(cell)
    assert line["correct"], err
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["metrics"]) == {"granule_ms_p95", "setup_s"}


@pytest.mark.parametrize("cell,fault", [(SEGFORMER_CELL, "attention_off"),
                                        (SEGFORMER_CELL, "granule_mf"),
                                        ("emit_granule_bf16", "granule_mf")])
def test_planted_fault_is_caught(cell, fault):
    with planted(fault):
        line, err = run_shrunk(cell)
    assert not line["correct"], err
    if fault == "attention_off":
        gap = line["compared"]["mask_gap"]
        assert gap["value"] > gap["limit"]


def test_traced_run_reads_the_cells_metrics_and_spans():
    from starcop_tpu_torch.utils import profiling

    profiling.clear_spans()
    line, err = run_shrunk(SEGFORMER_CELL, trace=1)
    assert line["correct"], err
    # No kernel runs on the CPU: the device readings print nothing there.
    assert 0 < line["metrics"]["segformer.mfu"]["value"] < 100
    found = [s for s in profiling.spans() if s.name.startswith("segformer.")]
    decodes = [s for s in found if s.name == "segformer.decode"]
    attention = [s for s in found if s.name == "segformer.attention"]
    assert decodes and len(attention) == len(decodes) * sum(TINY_MODEL["depths"])
    # The padded 1280 x 96 granule: stage maps 320x24, 160x12, 80x6, 40x3.
    queries = {0: 320 * 24, 1: 160 * 12, 2: 80 * 6, 3: 40 * 3}
    keys = {0: 40 * 3, 1: 40 * 3, 2: 40 * 3, 3: 40 * 3}
    for s in attention:
        assert s.counts == {"queries": queries[s.key], "keys": keys[s.key],
                            "heads": TINY_MODEL["num_heads"][s.key]}
    profiling.clear_spans()


def test_counts_at_the_padded_granule():
    """MiT-b5 at the padded 1280 x 1248 granule: every stage attends to
    1,560 reduced keys; a forward is 1.97 TFLOP (29.3 ms at 67 TFLOP/s)."""
    from portbench.counts_segformer import segformer_forward_flops, stage_shapes

    m = harness.load_json(f"{harness.BENCH_DIR}/configs/segformer_b5_emit.json")["model"]
    assert list(stage_shapes(1280, 1248, m)) == [(0, 64, 99840, 1560, 8), (1, 128, 24960, 1560, 4),
                                                 (2, 320, 6240, 1560, 2), (3, 512, 1560, 1560, 1)]
    assert segformer_forward_flops(1280, 1248, m) == pytest.approx(1.9659e12, rel=1e-4)
