"""The train CLI and the Trainer in and outside a launched world (the
port's data-parallel training; tests/test_torch_parallel_train.py holds the
steps and Trainer.fit against the one-process port and JAX).

  * the train CLI with ``training.devices=2`` in a gloo world of two CPU
    processes (``parallel.run_world``, a ``file://`` rendezvous): one
    experiment dir for both ranks (rank 0's timestamp), the one-process
    run's files, the parameters bitwise equal across the ranks;
  * outside a launched world ``training.devices=2`` and
    ``Trainer(n_devices=2)`` raise and name torchrun, before anything is
    written.
"""

import glob
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import cpu_share  # noqa: E402,F401

from starcop_tpu_torch.data.synthetic import write_synthetic_chip_dataset  # noqa: E402
from starcop_tpu_torch.models.segmenter import SegmentationModel  # noqa: E402
from starcop_tpu_torch.parallel import run_world  # noqa: E402
from starcop_tpu_torch.train import loop as tloop  # noqa: E402
from tests import torch_parallel_worlds as worlds  # noqa: E402


def _world(fn, tmp, *args):
    return run_world(fn, 2, backend="gloo", device="cpu", init_file=str(tmp / "rdv"),
                     timeout_s=300.0, args=args)


def test_outside_a_world_several_devices_raise(tmp_path, monkeypatch):
    from starcop_tpu_torch.cli.train import main

    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    model = SegmentationModel(["mag1c"], model_type="single")
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        tloop.Trainer(model, n_devices=2, device="cpu")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        main(["training.devices=2", "training.accelerator=cpu", "model.model_type=cnn"])
    assert not (tmp_path / "experiments").exists()


def test_train_cli_in_a_world_of_two(tmp_path, monkeypatch):
    """The train CLI at training.devices=2 (cnn, batch 8 of 128^2 windows:
    4 a rank) against the one-process CLI on the same chips."""
    from starcop_tpu_torch.cli.train import main

    chips = write_synthetic_chip_dataset(str(tmp_path / "chips"), np.random.default_rng(4),
                                         n_tiles=2, size=256)
    root, name = os.path.split(chips)
    argv = [f"dataset.root_folder={root}", f"dataset.train_csv={name}",
            f"dataset.test_csv={name}", "model.model_type=cnn", "dataloader.batch_size=8",
            "dataloader.num_workers=0", "training.max_epochs=1", "training.accelerator=cpu",
            "plot_samples=2"]
    (tmp_path / "one").mkdir()
    monkeypatch.chdir(tmp_path / "one")
    assert main(argv) == 0
    (one,) = glob.glob(str(tmp_path / "one" / "experiments" / "experiment" / "*"))
    (tmp_path / "two").mkdir()
    r0, r1 = _world(worlds.cli_world, tmp_path, str(tmp_path / "two"),
                    argv + ["training.devices=2"])
    assert r0["exp_dir"] == r1["exp_dir"] and r0["step"] == r1["step"] > 0
    (two,) = glob.glob(str(tmp_path / "two" / "experiments" / "experiment" / "*"))
    assert os.path.basename(two) == os.path.basename(r0["exp_dir"])
    files = {k: sorted(os.path.relpath(p, e) for p in glob.glob(f"{e}/**", recursive=True)
                       if os.path.isfile(p)) for k, e in (("one", one), ("two", two))}
    assert files["two"] == files["one"]
    assert {"best.npz", "final_checkpoint_model.npz", "history.json", "metrics.jsonl",
            "test/results.csv", "train/results.csv"} <= set(files["two"])
    for k in r0["params"]:
        np.testing.assert_array_equal(r0["params"][k], r1["params"][k], err_msg=k)
