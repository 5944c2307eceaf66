"""What a run imports, reads and writes: no module whose top-level name,
compared whole, is jax, jaxlib, flax or starcop_tpu (the port's name begins
with the last); nothing read under benchmarks/ or bench.py; nothing written
outside the checkout, HOME, XDG_CACHE_HOME and TMPDIR."""

import json
import os
import subprocess
import sys
import types

from portbench import harness
from portbench.tests.tiny import run_tiny

PROBE = r"""
import json, os, sys
written, read = [], []
def hook(event, args):
    if event == "open" and isinstance(args[0], (str, bytes, os.PathLike)):
        path = os.path.abspath(os.fsdecode(args[0]))
        mode = args[1] if isinstance(args[1], str) else ""
        flags = args[2] if len(args) > 2 and isinstance(args[2], int) else 0
        if any(c in mode for c in "wax+") or flags & (os.O_WRONLY | os.O_RDWR | os.O_CREAT):
            written.append(path)
        else:
            read.append(path)
sys.addaudithook(hook)
sys.path.insert(0, sys.argv[1])
import torch
torch.set_num_threads(2)
from portbench import harness
from portbench.tests.tiny import run_tiny
line, err = run_tiny(sys.argv[2])
print("PROBE " + json.dumps({"correct": line["correct"], "modules": sorted(sys.modules),
                             "written": written, "read": read}))
"""


def _probe(cell, tmp_path):
    env = dict(os.environ)
    for var in ("HOME", "XDG_CACHE_HOME", "TMPDIR"):
        env[var] = str(tmp_path / var.lower())
        os.makedirs(env[var])
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", PROBE, harness.ROOT, cell], env=env,
                         capture_output=True, text=True, timeout=600, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-4000:]
    line = next(x for x in out.stdout.splitlines() if x.startswith("PROBE "))
    return json.loads(line[6:]), env


def _check(found, env):
    tops = {m.split(".")[0] for m in found["modules"]}
    assert not tops & {"jax", "jaxlib", "flax", "starcop_tpu"}, tops & {"jax", "flax"}
    assert "starcop_tpu_torch" in tops
    allowed = [harness.ROOT] + [env[v] for v in ("HOME", "XDG_CACHE_HOME", "TMPDIR")]
    allowed = [os.path.realpath(p) + os.sep for p in allowed] + ["/dev/null"]
    for path in found["written"]:
        real = os.path.realpath(path)
        assert any(real.startswith(a) or real == a for a in allowed), path
    for path in found["read"]:
        assert not path.startswith(os.path.join(harness.ROOT, "benchmarks") + os.sep), path
        assert path != os.path.join(harness.ROOT, "bench.py"), path


def test_granule_run_imports_and_files(tmp_path):
    found, env = _probe("emit_granule_f32", tmp_path)
    assert found["correct"]
    _check(found, env)


def test_train_run_imports_and_files(tmp_path):
    found, env = _probe("aviris_train_b32", tmp_path)
    assert found["correct"]
    _check(found, env)
    assert any(p.startswith(env["TMPDIR"]) for p in found["written"])  # the chips


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "starcop_tpu_torch_probe", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jaxtyping_probe", types.ModuleType("x"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "flax.linen", types.ModuleType("flax.linen"))
    assert harness.forbidden_modules() == ["flax.linen"]


def test_a_run_that_loaded_jax_prints_no_result(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    line, err = run_tiny("emit_granule_f32")
    assert line is None and "forbidden modules" in err
