"""The benchmark's harness: one run of one cell of ``BENCHMARK.json``.

    python3 portbench/run.py --workload CELL --seed N --seconds S --trace 0|1

Everything that belongs to one configuration, traffic mix or per-layer metric
is found by name: the configuration's file from ``BENCHMARK.json``, the
traffic mix in ``portbench/workloads/<traffic>.json`` (it names its driver),
the driver in ``portbench/drivers/<driver>.py`` and each per-layer metric's
reader in ``portbench/metrics/<metric>.py``.

A driver module provides ``setup(ctx) -> state``, ``window(ctx, state,
seconds) -> dict`` (``e2e`` values by metric name, ``attempted``,
``failed`` and whatever its metric readers read) and ``check(ctx, state,
result) -> [(name, value, limit), ...]``, where a number passes when it is at
most its limit. ``check`` runs after the window has closed and the memory
peak has been read, and frees the program's state first.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1``), ``device``, with
``--trace 1`` a ``breakdown``, and last ``compared``: each number that
decided ``correct`` with its limit (also the last lines of standard error).
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import os
import sys
import time
from typing import Dict, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_DIR = os.path.join(ROOT, "portbench")
FORBIDDEN = ("jax", "jaxlib", "flax", "starcop_tpu")
CACHE_ROOT = os.path.join(ROOT, ".portbench_cache")


def load_json(path: str):
    with open(path) as fh:
        return json.load(fh)


def load_benchmark() -> Dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def by_name(entries: List[Dict], name: str, what: str) -> Dict:
    for entry in entries:
        if entry["name"] == name:
            return entry
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def load_module(kind: str, name: str):
    """``portbench/<kind>/<name>.py``, loaded by path (a metric's name may
    hold dots)."""
    path = os.path.join(BENCH_DIR, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name.replace('.', '_')}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell_metrics(bench: Dict, cell: str):
    """(end-to-end metrics, per-layer metrics) that ``cell`` reports."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (cell in m["workloads"] if "workloads" in m else m["moves"] in moved)]
    return e2e, layer


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's, Flax's
    or the JAX package's."""
    return sorted({name for name in list(sys.modules) if name.split(".")[0] in FORBIDDEN})


def set_cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(CACHE_ROOT, sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


class Context:
    """What a driver gets: the cell, its configuration and traffic, the seed,
    the device, the set-up clock and the span helper."""

    def __init__(self, cell, config, traffic, seed, trace, device, t0):
        self.cell, self.config, self.traffic = cell, config, traffic
        self.seed, self.trace, self.device, self.t0 = seed, trace, device, t0
        self.stages: Dict[str, float] = {}
        self._last = t0

    def stage(self, name: str) -> None:
        """Close the set-up stage ``name`` at now."""
        now = time.perf_counter()
        self.stages[name] = now - self._last
        self._last = now

    def span(self, name: str):
        """A host span ``pb.<name>`` in traced runs (nothing otherwise)."""
        if not self.trace:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function(f"pb.{name}")

    def synchronize(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def device_info(device, chips: int, trace_view=None) -> Dict:
    import torch

    info = {"platform": "gpu" if device.type == "cuda" else device.type, "kind": None,
            "count": chips, "memory_peak_bytes": 0}
    if device.type == "cuda":
        info["kind"] = torch.cuda.get_device_name(device)
        info["memory_peak_bytes"] = int(max(torch.cuda.max_memory_allocated(i)
                                            for i in range(chips)))
    if trace_view is not None:
        info["busy_s"], info["window_s"] = trace_view.busy_s, trace_view.window_s
    return info


def power_limit() -> Optional[str]:
    """The card's name and power limit as nvidia-smi reports them."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


def merged(base: Dict, updates: Optional[Dict]) -> Dict:
    """``base`` with ``updates`` applied, one level into nested dicts."""
    out = dict(base)
    for k, v in (updates or {}).items():
        out[k] = {**out[k], **v} if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def run(args, t0: float, device=None, overrides: Optional[Dict] = None,
        bench: Optional[Dict] = None, out=sys.stdout, err=sys.stderr) -> Optional[Dict]:
    """One run; returns the result object (None when it cannot run). A test
    may pass ``device`` (the CPU) to skip the look for a card,
    ``overrides`` ({"config": {...}, "traffic": {...}}) to shrink the cell,
    and ``bench`` in place of ``BENCHMARK.json``."""
    set_cache_dirs()
    bench = bench or load_benchmark()
    cell = by_name(bench["workloads"], args.workload, "workload")
    config_entry = by_name(bench["configs"], cell["config"], "config")
    overrides = overrides or {}
    config = merged(load_json(os.path.join(ROOT, config_entry["file"])), overrides.get("config"))
    traffic = merged(load_json(os.path.join(BENCH_DIR, "workloads", f"{cell['traffic']}.json")),
                     overrides.get("traffic"))
    e2e, layer = cell_metrics(bench, cell["name"])

    import torch

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            print(f"portbench: {cell['name']} needs {cell['chips']} CUDA device(s); "
                  f"available: {torch.cuda.is_available()}, "
                  f"count: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=err)
            return None
        device = torch.device("cuda", 0)
    device = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = power_limit() if device.type == "cuda" else None
    if card:
        print(f"card: {card}", file=err)

    driver = load_module("drivers", traffic["driver"])
    ctx = Context(cell, config, traffic, args.seed, bool(args.trace), device, t0)
    state = driver.setup(ctx)
    ctx.synchronize()
    setup_s = time.perf_counter() - t0
    print("setup " + json.dumps({k: round(v, 4) for k, v in ctx.stages.items()}), file=err)

    view = None
    if args.trace:
        from portbench.trace import traced

        seconds = min(args.seconds, float(traffic.get("trace_seconds", args.seconds)))
        with traced() as holder:
            with ctx.span("window"):
                result = driver.window(ctx, state, seconds)
            ctx.synchronize()
        view = holder.view()
    else:
        result = driver.window(ctx, state, args.seconds)
    info = device_info(device, cell["chips"], view)

    compared = driver.check(ctx, state, result)
    found = forbidden_modules()
    if found:
        print(f"portbench: forbidden modules loaded: {found}", file=err)
        return None
    # A request that failed is an answer that never came.
    correct = result["failed"] == 0 and all(value <= limit for _, value, limit in compared)

    metrics = {}
    if args.trace:
        bundle = {"ctx": ctx, "result": result, "trace": view}
        for m in layer:
            value = load_module("metrics", m["name"]).read(bundle)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        values = dict(result["e2e"], setup_s=setup_s)
        for m in e2e:
            metrics[m["name"]] = {"value": float(values[m["name"]]), "unit": m["unit"]}
    line = {"correct": bool(correct), "attempted": int(result["attempted"]),
            "failed": int(result["failed"]), "metrics": metrics, "device": info}
    if view is not None:
        line["breakdown"] = view.breakdown()
    if card:
        line["card"] = card
    line["compared"] = {name: {"value": float(v), "limit": float(lim)}
                        for name, v, lim in compared}
    for name, v, lim in compared:
        print(f"compared {name}: {v!r} limit {lim!r} {'ok' if v <= lim else 'FAIL'}", file=err)
    err.flush()
    print(json.dumps(line), file=out, flush=True)
    return line


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="one run of one benchmark cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, t0: Optional[float] = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    args = parse_args(argv)
    return 0 if run(args, t0) is not None else 3
