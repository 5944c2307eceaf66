"""BENCHMARK.json and every file it names: found by name, within the
contract's limits."""

import json
import os
import re

import pytest

from portbench import harness
from portbench.tests.tiny import with_train

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = harness.load_benchmark()


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert os.path.getsize(os.path.join(harness.ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_units_and_bounds():
    every = BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"]
    for entry in every:
        assert NAME.match(entry["name"]), entry["name"]
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[kind]]
        assert len(names) == len(set(names))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


ALL = with_train(BENCH)


@pytest.mark.parametrize("cell", [c["name"] for c in ALL["workloads"]])
def test_cell_resolves(cell):
    """Each cell's configuration, traffic mix, driver and per-layer readers
    are found by name, and it reports setup_s, another end-to-end metric and
    a per-layer metric; so does the training cell held out of it."""
    c = harness.by_name(ALL["workloads"], cell, "workload")
    assert c["chips"] in (1, 4) and 1 <= len(c["why"]) <= 200
    entry = harness.by_name(BENCH["configs"], c["config"], "config")
    config = harness.load_json(os.path.join(harness.ROOT, entry["file"]))
    assert entry["file"].startswith("portbench/") and config["reduced"] == entry["reduced"]
    traffic = harness.load_json(os.path.join(harness.BENCH_DIR, "workloads",
                                             f"{c['traffic']}.json"))
    driver = harness.load_module("drivers", traffic["driver"])
    for fn in ("setup", "window", "check"):
        assert callable(getattr(driver, fn))
    e2e, layer = harness.cell_metrics(ALL, cell)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2 and layer
    for m in layer:
        assert m["moves"] in names
        assert callable(harness.load_module("metrics", m["name"]).read)
    assert set(traffic["limits"]) and all(v >= 0 for v in traffic["limits"].values())


def test_every_config_used_and_files_distinct():
    used = {c["config"] for c in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    pairs = [(c["config"], c["traffic"]) for c in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_per_layer_layers_are_named_alike():
    layers = {m["layer"] for m in ALL["per_layer"]}
    assert layers <= {"entry", "serve", "filter", "kernels", "model", "data", "trainer",
                      "validation", "device"}


def test_roofline_and_mfu_names():
    for m in BENCH["per_layer"]:
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for c in BENCH["workloads"]:
        _, layer = harness.cell_metrics(BENCH, c["name"])
        assert any("mfu" in m["name"] for m in layer), c["name"]


def test_json_files_load():
    for folder in ("configs", "workloads"):
        for name in os.listdir(os.path.join(harness.BENCH_DIR, folder)):
            with open(os.path.join(harness.BENCH_DIR, folder, name)) as fh:
                json.load(fh)
