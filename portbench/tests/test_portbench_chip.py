"""The controls on the card at a size a test run can hold (``-m chip``):
the program's numbers within their limits, and the control, the plain
reference at the precision below the configuration's (TF32 for float32 with
TF32 off, fp8 operands for the bf16-resident U-Net), failing at least one of
them on three seeds. The cells' own size
is read by ``controls/readings.py`` (PERF.md gives those readings)."""

import pytest

from portbench import harness
from portbench.controls.readings import take_readings
from portbench.tests.tiny import with_train

SMALL = {
    "emit_granule_f32": {"config": {"granule": {"lines": 320}},
                         "traffic": {"pool": 2, "check_samples": 2, "warmup_requests": 1}},
    "emit_serve_default": {"config": {"granule": {"lines": 320}},
                           "traffic": {"pool": 2, "check_samples": 2, "warmup_granules": 1}},
    "aviris_train_b32": {"traffic": {"chips": 8}},
    "aviris_eval_bf16": {"traffic": {"chips": 32, "check_batches": 1}},
}


@pytest.mark.chip
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_control_fails_and_program_passes(cell, cuda_device):
    bench = with_train(harness.load_benchmark())
    traffic = harness.load_json(f"{harness.BENCH_DIR}/workloads/"
                                f"{harness.by_name(bench['workloads'], cell, 'workload')['traffic']}.json")
    limits = traffic["limits"]
    rows = take_readings(cell, [("program", s) for s in (11, 12, 13)]
                         + [("control", s) for s in (21, 22, 23)], overrides=SMALL[cell],
                         device=cuda_device, bench=bench)
    for row in rows:
        over = [k for k in limits if row[k] > limits[k]]
        if row["kind"] == "program":
            assert not over, row
        else:
            assert over, row
