"""The port's profiling hooks (starcop_tpu_torch/utils/profiling.py) against
JAX's (starcop_tpu/utils/profiling.py), and the infer_emit CLI's timed line,
on the CPU.

  * ``trace`` writes a Chrome trace of what ran inside it into its
    directory;
  * ``StageTimer``: JAX's stages and report (the same names, accumulated
    over repeats, the same log lines); on the CPU nothing is synchronised,
    and ``device=None`` means the card, which raises here without one;
  * infer_emit's line is JAX's format, its seconds the ``total`` stage.
"""

import json
import logging
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import cpu_share  # noqa: E402,F401

from starcop_tpu.utils import profiling as jprofiling  # noqa: E402
from starcop_tpu_torch.utils import profiling  # noqa: E402
from starcop_tpu_torch.utils import StageTimer, trace  # noqa: E402


def test_trace_writes_a_chrome_trace(tmp_path):
    a = torch.randn(64, 64)
    with trace(str(tmp_path / "t")):
        b = torch.mm(a, a).sum()
    assert float(b) == float(torch.mm(a, a).sum())
    (name,) = os.listdir(tmp_path / "t")
    assert name == f"trace_{os.getpid()}.json"
    with open(tmp_path / "t" / name) as fh:
        events = json.load(fh)["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)


def _stages(timer):
    for name in ("read", "filter", "read"):
        with timer.stage(name):
            sum(range(1000))
    return timer.report()


def test_stage_timer_matches_jax(caplog, monkeypatch):
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: synced.append(a))
    with caplog.at_level(logging.INFO):
        got = _stages(StageTimer(device="cpu"))
        want = _stages(jprofiling.StageTimer())
    assert list(got) == list(want) == ["read", "filter"]
    assert all(isinstance(v, float) and v > 0 for v in got.values())
    lines = [r.getMessage() for r in caplog.records]
    ours = [ln for r, ln in zip(caplog.records, lines) if r.name == "starcop_tpu_torch.profiling"]
    theirs = [ln for r, ln in zip(caplog.records, lines) if r.name == "starcop_tpu.profiling"]
    assert [ln.split()[:2] for ln in ours] == [ln.split()[:2] for ln in theirs] == [
        ["stage", "read"], ["stage", "filter"]]
    assert synced == []  # nothing to wait for on the CPU
    timer = StageTimer(device="cpu")
    with pytest.raises(ZeroDivisionError):
        with timer.stage("fails"):
            1 / 0
    assert list(timer.report(log=False)) == ["fails"]  # a stage that raises is timed
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            StageTimer()


def test_infer_emit_line_is_the_total_stage(tmp_path, capsys, monkeypatch):
    pytest.importorskip("h5py")
    from starcop_tpu_torch.cli.infer_emit import main
    from starcop_tpu_torch.models.segmenter import EMIT_INPUT_PRODUCTS, SegmentationModel
    from tests.test_torch_serve import _granule

    path, _ = _granule(tmp_path, "EMIT_timed", 29)
    model = SegmentationModel(EMIT_INPUT_PRODUCTS).init(torch.Generator().manual_seed(0))
    torch.save(model.network.state_dict(), tmp_path / "model.pt")
    reports = []
    real = profiling.StageTimer.report

    def report(self, log=True):
        reports.append(real(self, log))
        return reports[-1]

    monkeypatch.setattr(profiling.StageTimer, "report", report)
    assert main([path, "--checkpoint", str(tmp_path / "model.pt"), "--output",
                 str(tmp_path / "out"), "--column-step", "16", "--num-iter", "3",
                 "--device", "cpu"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    m = re.fullmatch(r"EMIT inference EMIT_timed\.nc: (\d+\.\d\d)s; pred mean (\d\.\d{4})", line)
    assert m, line
    (times,) = reports
    assert list(times) == ["total"] and m.group(1) == f"{times['total']:.2f}"
    assert 0 < float(m.group(2)) < 1
    assert sorted(os.listdir(tmp_path / "out")) == [
        "albedo.tif", "mag1c.tif", "prediction.tif", "rgb.tif"]
    assert np.isfinite(float(m.group(2)))
