"""Readings that a cell's limits are set from (run on the card):

    python3 portbench/controls/readings.py --workload CELL --seeds 1 2 ... \\
        --control-seeds 7 8 9 [--out FILE]

For each of ``--seeds`` the program's answers through the cell's timed path,
compared as a run compares them (the lower readings); for each of
``--control-seeds`` the control, the plain reference in the program's place
at the precision below the configuration's (TF32 for float32 with TF32 off),
compared the same way (the upper readings); ``--plain-seeds`` gives the
reference at the configuration's own precision, as a witness; ``--fault NAME
--fault-seeds ...`` plants a fault of ``controls/faults.py`` in the program.
One JSON line a reading, and the maxima and minima at the end. ``--bench
FILE`` reads the cells from FILE (``BENCHMARK.json``'s layout) in place of
``BENCHMARK.json``, for a cell that is not in it yet.
"""

import argparse
import contextlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from portbench import harness  # noqa: E402
from portbench.controls.faults import planted  # noqa: E402


def take_readings(workload, runs, fault=None, overrides=None, device=None, bench=None):
    """[{kind, seed, seconds, <number>: value}] for ``runs`` [(kind, seed)],
    kind one of program / control / plain / fault; ``bench`` in place of
    ``BENCHMARK.json``."""
    import torch

    harness.set_cache_dirs()
    bench = bench or harness.load_benchmark()
    cell = harness.by_name(bench["workloads"], workload, "workload")
    overrides = overrides or {}
    config = harness.merged(harness.load_json(os.path.join(
        harness.ROOT, harness.by_name(bench["configs"], cell["config"], "config")["file"])),
        overrides.get("config"))
    traffic = harness.merged(harness.load_json(os.path.join(
        harness.BENCH_DIR, "workloads", f"{cell['traffic']}.json")), overrides.get("traffic"))
    driver = harness.load_module("drivers", traffic["driver"])
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    rows = []
    for kind, seed in runs:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        t0 = time.perf_counter()
        ctx = harness.Context(cell, config, traffic, seed, False, dev, t0)
        if kind in ("program", "fault"):
            with planted(fault) if kind == "fault" else contextlib.nullcontext():
                state = driver.setup(ctx)
                answers = driver.program_answers(ctx, state)
        else:
            state = driver.setup(ctx)
            tf32 = kind == "control"  # "plain": the reference at the configuration's f32
            torch.backends.cuda.matmul.allow_tf32 = tf32
            torch.backends.cudnn.allow_tf32 = tf32
            answers = driver.control_answers(ctx, state)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        compared = driver.compare(ctx, state, answers, torch.float64)
        row = {"kind": kind, "seed": seed, "seconds": time.perf_counter() - t0,
               **{name: value for name, value, _ in compared}}
        rows.append(row)
        print(json.dumps(row), flush=True)
        if hasattr(driver, "finish"):
            driver.finish(ctx, state)
        del state, answers
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--plain-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault", default=None, help="a fault of controls/faults.py, planted "
                    "in the program for --fault-seeds")
    ap.add_argument("--out", default=None)
    ap.add_argument("--bench", default=None, help="cells from this file, not BENCHMARK.json")
    args = ap.parse_args(argv)
    print(harness.power_limit(), file=sys.stderr)
    runs = ([("program", s) for s in args.seeds] + [("control", s) for s in args.control_seeds]
            + [("plain", s) for s in args.plain_seeds] + [("fault", s) for s in args.fault_seeds])
    rows = take_readings(args.workload, runs, args.fault,
                         bench=harness.load_json(args.bench) if args.bench else None)
    summary = {}
    for kind in ("program", "control", "plain", "fault"):
        sel = [r for r in rows if r["kind"] == kind]
        for name in (k for k in (sel[0] if sel else {}) if k not in ("kind", "seed", "seconds")):
            vals = [r[name] for r in sel]
            summary[f"{kind}.{name}"] = {"max": max(vals), "min": min(vals), "n": len(vals)}
    print("summary " + json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"rows": rows, "summary": summary}, fh, indent=1)


if __name__ == "__main__":
    main()
