"""Runs of the shrunken cells on the CPU (the harness's look for a card
skipped) with the timed path broken underneath (``controls/faults.py``):
``correct`` comes out false for each fault the cell can have, and true for
the sound run."""

import pytest
import torch

from portbench.controls.faults import planted
from portbench.tests.tiny import run_tiny


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_granule_sound_run_is_correct():
    line, err = run_tiny("emit_granule_f32")
    assert line["correct"], err
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["metrics"]) == {"granule_ms_p95", "setup_s"}
    assert list(line)[-1] == "compared"


@pytest.mark.parametrize("fault", ["granule_mf", "granule_mask"])
def test_granule_altered_answer_is_caught(fault):
    with planted(fault):
        line, err = run_tiny("emit_granule_f32")
    assert not line["correct"], err


def test_serve_sound_run_is_correct():
    line, err = run_tiny("emit_serve_default", seconds=2.0)
    assert line["correct"], err
    assert set(line["metrics"]) == {"served_granules_per_s", "setup_s"}


@pytest.mark.parametrize("fault", ["granule_mf", "granule_mask"])
def test_serve_altered_answer_is_caught(fault):
    with planted(fault):
        line, err = run_tiny("emit_serve_default", seconds=2.0)
    assert not line["correct"], err


def test_eval_sound_run_is_correct():
    line, err = run_tiny("aviris_eval_bf16")
    assert line["correct"], err
    assert set(line["metrics"]) == {"eval_tiles_per_s", "setup_s"}


def test_eval_altered_prediction_is_caught():
    with planted("eval_prediction"):
        line, err = run_tiny("aviris_eval_bf16")
    assert not line["correct"], err


def test_train_sound_run_is_correct():
    line, err = run_tiny("aviris_train_b32")
    assert line["correct"], err
    assert set(line["metrics"]) == {"train_tiles_per_s", "setup_s"}


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered_row"])
def test_train_fault_is_caught(fault):
    with planted(fault):
        line, err = run_tiny("aviris_train_b32")
    assert not line["correct"], err
    if fault == "altered_row":
        row = line["compared"]["loader_row_gap"]
        assert row["value"] > row["limit"]
