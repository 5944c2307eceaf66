"""Shrunken cells for runs on the CPU: the same code paths at sizes a test
run can hold."""

import io
import time

from portbench import harness

TINY = {
    "emit_granule_f32": {
        # Blocks of the cell's 40,960 pixels (1280 lines x 32 columns): small
        # blocks are ill-conditioned in f32.
        "config": {"granule": {"lines": 1280, "samples": 96}},
        "traffic": {"fill_corner": [128, 20], "fill_block": 1, "pool": 2, "warmup_requests": 1,
                    "check_samples": 2},
    },
    "emit_serve_default": {
        "config": {"granule": {"lines": 1280, "samples": 96}},
        "traffic": {"fill_corner": [128, 20], "fill_block": 1, "pool": 2, "warmup_granules": 1,
                    "check_samples": 2},
    },
    "aviris_eval_bf16": {
        "config": {"chips": {"chip_size": 128}},
        "traffic": {"chips": 4, "batch_size": 2, "check_batches": 2},
    },
    "aviris_train_b32": {
        "config": {"chips": {"chip_size": 128},
                   "training": {"training_size": 64, "training_overlap": 32, "batch_size": 4,
                                "num_workers": 2}},
        "traffic": {"chips": 2},
    },
}


# The training cell's entries, for the tests that drive it while it is held
# out of BENCHMARK.json (PERF.md, Open questions).
TRAIN_CELL = {
    "workloads": [
        {"name": "aviris_train_b32", "config": "hyperstarcop_aviris", "traffic": "train_b32",
         "chips": 1, "why": "training steps of 32 x 128^2 windows from 64 chips of 512^2 "
         "through the loader's 4 threads, prefetch and the f32 step"},
    ],
    "end_to_end": [
        {"name": "train_tiles_per_s", "unit": "tiles/s", "better": "higher", "bound": 0.25,
         "source": "host_clock", "workloads": ["aviris_train_b32"]},
    ],
    "per_layer": [
        {"name": name, "unit": unit, "better": "lower", "source": source, "layer": layer,
         "moves": "train_tiles_per_s", "workloads": ["aviris_train_b32"]}
        for name, unit, source, layer in (
            ("train.loader_wait_ms", "ms", "host_clock", "data"),
            ("train.step_device_ms", "ms", "device_trace", "trainer"),
            ("train.device_idle_pct", "%", "device_trace", "device"))
    ] + [
        {"name": "train.mfu", "unit": "%", "better": "higher", "source": "host_clock",
         "layer": "trainer", "moves": "train_tiles_per_s", "workloads": ["aviris_train_b32"]},
    ],
}


def with_train(bench):
    """``bench`` with the training cell's entries added."""
    return {k: v + TRAIN_CELL.get(k, []) if isinstance(v, list) else v
            for k, v in bench.items()}


def run_tiny(cell: str, seed: int = 2**31 + 77, seconds: float = 1.0, trace: int = 0):
    """(result line, standard error) of one CPU run of ``cell`` shrunk."""
    args = harness.parse_args(["--workload", cell, "--seed", str(seed), "--seconds",
                               str(seconds), "--trace", str(trace)])
    out, err = io.StringIO(), io.StringIO()
    line = harness.run(args, time.perf_counter(), device="cpu", overrides=TINY[cell],
                       bench=with_train(harness.load_benchmark()), out=out, err=err)
    return line, err.getvalue()
