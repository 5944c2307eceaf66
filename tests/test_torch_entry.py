"""The port's entry module (starcop_tpu_torch/entry.py, the counterpart of
the root ``__graft_entry__.py``) and the world launcher it runs on
(``parallel.run_world``), on the CPU.

  * ``entry()``: the unet_semseg forward on JAX's example input (the same
    seeded (2, 4, 128, 128) array), finite logits of its shape;
  * ``dryrun_multichip(2)`` over two gloo CPU ranks: JAX's checks and its
    OK line; no kernel counted on the CPU (the plain twins ran);
  * the launcher fails the world, within its timeout, when a rank raises
    (its traceback in the error), when a rank hangs, and when NCCL is asked
    for ranks without a card each.
"""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import cpu_share  # noqa: E402,F401

from starcop_tpu_torch import entry  # noqa: E402
from starcop_tpu_torch.parallel import run_world  # noqa: E402
from tests import torch_parallel_worlds as worlds  # noqa: E402


def test_entry_forward():
    fn, (model, x) = entry.entry("cpu")
    assert model.model_type == "unet_semseg" and not model.training
    want_x = np.random.default_rng(0).uniform(0, 100, size=(2, 4, 128, 128)).astype(np.float32)
    np.testing.assert_array_equal(x.numpy(), want_x)
    logits = fn(model, x)
    assert logits.shape == (2, 1, 128, 128) and bool(torch.isfinite(logits).all())
    assert float(logits.std()) > 0


def test_dryrun_multichip_two_cpu_ranks(capsys):
    out = entry.dryrun_multichip(2, device="cpu")
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert re.match(r"dryrun_multichip\(2\) OK: train loss \d+\.\d{4}, sharded mag1c mf max "
                    r"[\d.]+, 4 granule->mask scenes served over 2 workers \(mf_max \d+-\d+, "
                    r"mask_mean [\d.]+-[\d.]+\)$", line), line
    assert np.isfinite(out["loss"]) and len(out["ranks"]) == 2
    assert [sorted(name for name, _, _ in r["served"]) for r in out["ranks"]] == [
        ["0", "1"], ["2", "3"]]
    assert all(v == 0 for r in out["ranks"] for v in r["launches"].values())


def test_run_world_fails_on_a_failed_rank(tmp_path):
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed(.|\n)*on purpose"):
        run_world(worlds.fail_on_rank_1, 2, device="cpu", init_file=str(tmp_path / "a"),
                  timeout_s=60)


def test_run_world_fails_on_a_hang(tmp_path):
    with pytest.raises(TimeoutError, match="did not finish within 8 s"):
        run_world(worlds.hang, 2, device="cpu", init_file=str(tmp_path / "b"), timeout_s=8)


def test_run_world_refuses_nccl_without_a_card_each(tmp_path):
    with pytest.raises(RuntimeError, match="backend='nccl' needs the card"):
        run_world(worlds.hang, 2, backend="nccl", device="cpu", init_file=str(tmp_path / "c"),
                  timeout_s=60)
