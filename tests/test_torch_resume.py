"""Resuming training and the storage seam of the port's checkpoints and train
CLI (starcop_tpu_torch.train.loop.Trainer.fit(resume_from=...),
.train.checkpoint.load_checkpoint, .cli.train's resume_from_checkpoint and
upload_path), against an uninterrupted run and the JAX package on the CPU.

Bars: a run resumed from a port checkpoint after k steps ends bitwise where
the uninterrupted run of the same steps ends (step, weights, batch-norm
statistics, Adam's moments; dropout masks come from (seed, step)); a resume
from a JAX checkpoint starts from exactly the state JAX's own resume
restores, and after the same steps has JAX's step count and a val_loss
within 2 % of JAX's (the bar of test_torch_train_data.py's fit test: f32
steps in two packages); the CLI resumes from the checkpoint JAX's glob
picks.
"""

import glob
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from starcop_tpu.models import SegmentationModel as FlaxSegmentationModel  # noqa: E402
from starcop_tpu.train import loop as jloop  # noqa: E402
from starcop_tpu.train.checkpoint import load_checkpoint as j_load_checkpoint  # noqa: E402
from starcop_tpu.train.checkpoint import save_checkpoint as j_save_checkpoint  # noqa: E402
from starcop_tpu_torch import setup_shims  # noqa: E402
from starcop_tpu_torch.config import Config  # noqa: E402
from starcop_tpu_torch.data.synthetic import (  # noqa: E402
    synthetic_chip_batch,
    write_synthetic_chip_dataset,
)
from starcop_tpu_torch.models.segmenter import SegmentationModel  # noqa: E402
from starcop_tpu_torch.train import loop as tloop  # noqa: E402
from starcop_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint  # noqa: E402
from starcop_tpu_torch.utils import storage  # noqa: E402
from tests.test_torch_train_data import _cli_args  # noqa: E402

LR = 3e-3


@pytest.fixture(scope="module")
def batches():
    r = np.random.default_rng(1)
    return [synthetic_chip_batch(r, batch_size=8, size=64, input_products=("mag1c",))
            for _ in range(6)]


def _flat_state(state, tmp_path, name):
    """{checkpoint key: array} of a port state, in JAX's npz layout."""
    with np.load(save_checkpoint(str(tmp_path), state, name=name)) as data:
        return {k: data[k] for k in data.files}


def _trainer(model):
    return tloop.Trainer(model, learning_rate=LR, max_epochs=1, val_check_interval=1.0,
                         device="cpu")


@pytest.mark.parametrize("model_type", ["cnn", "unet_dropout"])
def test_resume_equals_uninterrupted(model_type, batches, tmp_path):
    """6 steps in one fit; 3 steps, a checkpoint, and 3 more in a fresh
    Trainer.fit(resume_from=...) on a fresh model: the same state bitwise."""
    seed = 7

    def model():
        return SegmentationModel(["mag1c"], model_type=model_type, pos_weight=3.0)

    full = _trainer(model()).fit(lambda: iter(batches), lambda: iter(batches[:2]), seed=seed)
    first = _trainer(model()).fit(lambda: iter(batches[:3]), lambda: iter(batches[:2]),
                                  seed=seed)
    path = save_checkpoint(str(tmp_path), first, name="k3")
    resumed = _trainer(model()).fit(lambda: iter(batches[3:]), lambda: iter(batches[:2]),
                                    seed=seed, resume_from=path)
    assert full.step == resumed.step == 6
    a, b = _flat_state(full, tmp_path, "a"), _flat_state(resumed, tmp_path, "b")
    assert a.keys() == b.keys() and any(k.startswith("opt_state/") for k in a)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_resume_from_jax_checkpoint(batches, tmp_path):
    """A JAX checkpoint after 3 JAX steps: the port's resume restores exactly
    the state JAX's load_checkpoint restores; both packages' resumed fits
    then run the same 3 steps to JAX's step count and val_loss within 2 %."""
    jm = FlaxSegmentationModel(["mag1c"], model_type="cnn", pos_weight=3.0)
    jstate, _ = jloop.create_train_state(jm, jax.random.PRNGKey(0),
                                         jnp.zeros((8, 1, 64, 64), jnp.float32), LR)
    jt = jloop.Trainer(jm, learning_rate=LR, max_epochs=1, val_check_interval=1.0)
    jstate = jt.fit(lambda: iter(batches[:3]), lambda: iter(batches[:2]), state=jstate)
    path = j_save_checkpoint(str(tmp_path), jstate, name="jax_k3")

    # The state right after the resume (no epoch run): JAX's restore, leaf for leaf.
    port0 = tloop.Trainer(SegmentationModel(["mag1c"], model_type="cnn", pos_weight=3.0),
                          learning_rate=LR, max_epochs=0, device="cpu").fit(
        lambda: iter(batches), lambda: iter(batches[:2]), resume_from=path)
    restored = j_load_checkpoint(path, jstate)
    got = _flat_state(port0, tmp_path, "port0")
    with np.load(j_save_checkpoint(str(tmp_path), restored, name="jax0")) as data:
        want = {k: data[k] for k in data.files}
    assert got.keys() == want.keys() and int(got["step"]) == 3
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    jt2 = jloop.Trainer(jm, learning_rate=LR, max_epochs=1, val_check_interval=1.0)
    jfinal = jt2.fit(lambda: iter(batches[3:]), lambda: iter(batches[:2]), resume_from=path)
    tt = _trainer(SegmentationModel(["mag1c"], model_type="cnn", pos_weight=3.0))
    final = tt.fit(lambda: iter(batches[3:]), lambda: iter(batches[:2]), resume_from=path)
    assert final.step == int(jfinal.step) == 6
    assert len(tt.history) == len(jt2.history) == 1
    assert tt.history[0]["val_loss"] == pytest.approx(jt2.history[0]["val_loss"], rel=2e-2)


def test_checkpoint_loads_through_storage_seam(tmp_path, monkeypatch):
    """load_checkpoint opens its path with storage.open_file (binary), as
    JAX's does, and restores the state."""
    model = SegmentationModel(["mag1c"], model_type="cnn")
    state = tloop.create_train_state(model, 4, 1e-3, "cpu")
    path = save_checkpoint(str(tmp_path), state)
    opened = []
    real = storage.open_file

    def spy(p, mode="r"):
        opened.append((p, mode))
        return real(p, mode)

    monkeypatch.setattr(storage, "open_file", spy)
    fresh = tloop.create_train_state(SegmentationModel(["mag1c"], model_type="cnn"), 9, 1e-3,
                                     "cpu")
    load_checkpoint(path, fresh)
    assert opened == [(path, "rb")]
    for p, q in zip(state.model.network.parameters(), fresh.model.network.parameters()):
        assert torch.equal(p, q)


@pytest.fixture(scope="module")
def chips(tmp_path_factory):
    root = tmp_path_factory.mktemp("chips")
    return write_synthetic_chip_dataset(str(root), np.random.default_rng(4), n_tiles=2, size=256)


class _Picked(Exception):
    pass


def test_cli_resume_picks_jax_checkpoint(chips, tmp_path, monkeypatch):
    """resume_from_checkpoint=true: both CLIs hand Trainer.fit the same
    file, the newest of experiments/{name}/*/*.npz in sorted order."""
    from starcop_tpu.cli.train import main as jax_main
    from starcop_tpu_torch.cli.train import main as port_main

    monkeypatch.setenv("STARCOP_COMPILE_CACHE", "0")
    monkeypatch.chdir(tmp_path)
    state = tloop.create_train_state(SegmentationModel(["mag1c"], model_type="cnn"), 0, 1e-4,
                                     "cpu")
    for stamp, name in (("2024-01-01_10-00", "best"), ("2024-01-02_09-00", "best"),
                        ("2024-01-02_09-00", "final_checkpoint_model"),
                        ("2023-12-31_23-59", "best")):
        save_checkpoint(os.path.join("experiments", "experiment", stamp), state, name=name)
    newest = sorted(glob.glob(os.path.join("experiments", "experiment", "*", "*.npz")))[-1]
    picked = {}

    def recorder(key):
        def fit(self, *args, resume_from=None, **kw):
            picked[key] = resume_from
            raise _Picked

        return fit

    monkeypatch.setattr(jloop.Trainer, "fit", recorder("jax"))
    monkeypatch.setattr(tloop.Trainer, "fit", recorder("port"))
    for key, main in (("jax", jax_main), ("port", port_main)):
        with pytest.raises(_Picked):
            main(_cli_args(chips, ["model.test=false", "resume_from_checkpoint=true"]))
    assert picked["port"] == picked["jax"] == newest
    assert newest.endswith(os.path.join("2024-01-02_09-00", "final_checkpoint_model.npz"))


def test_cli_resumes_and_uploads(chips, tmp_path, monkeypatch):
    """The port's train CLI resumes from the newest checkpoint (the step
    count goes on from it) and, with a local upload_path, copies the
    experiment dir to {upload_path}/{experiment_name}/{time}; a failing
    upload is logged and the run stands."""
    from starcop_tpu_torch.cli.train import run

    monkeypatch.chdir(tmp_path)
    cfg = Config().apply_overrides(["model.model_type=cnn"])
    state = tloop.create_train_state(setup_shims.get_model(cfg), 0, 1e-4, "cpu")
    state.step = 40
    save_checkpoint(os.path.join("experiments", "experiment", "2000-01-01_00-00"), state,
                    name="best")
    up = tmp_path / "uploads"
    exp_dir, final = run(_cli_args(chips, ["model.test=false", "resume_from_checkpoint=true",
                                           f"upload_path={up}"]))
    assert final.step == 40 + 2  # 18 windows of 128^2 in batches of 8, drop_last
    copied = up / "experiment" / os.path.basename(exp_dir)
    files = sorted(os.path.relpath(p, exp_dir) for p in glob.glob(f"{exp_dir}/**", recursive=True)
                   if os.path.isfile(p))
    assert "final_checkpoint_model.npz" in files
    for f in files:
        assert (copied / f).read_bytes() == open(os.path.join(exp_dir, f), "rb").read(), f

    def fail(*args, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(storage, "put", fail)
    exp_dir2, final2 = run(_cli_args(chips, ["model.test=false", f"upload_path={up}"]))
    assert final2.step == 2 and os.path.exists(os.path.join(exp_dir2, "history.json"))
