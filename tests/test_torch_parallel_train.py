"""Data-parallel training in the port (``Trainer`` over a mesh, the train
step's gradient average, batch norm over the global batch, dropout, the
train CLI under a launched world) against the one-process port and JAX's
``make_train_step`` on ``make_mesh(2)``, on the CPU.

The worlds are gloo worlds of two CPU processes (tests/torch_parallel_worlds.py,
``parallel.run_world``, a ``file://`` rendezvous in tmp_path). Bars:
  * two float64 steps of the full-width unet_semseg over two ranks (a
    global batch of 4 x 4 x 64^2, 2 a rank) against the one-process steps
    on the whole batch: both steps' losses within 1e-12 relative, each
    gradient, running statistic and parameter leaf after the second step
    within 1e-9 of the largest absolute value of its kind (the gradients,
    the running statistics, the parameters: leaves whose true value is 0,
    such as the bias of a batch norm feeding a batch norm, hold rounding
    noise only, ~1e-16, so a leaf's own scale cannot be the bar; measured on
    the CPU with torch 2.13: 2.5e-11, 1.7e-12 and 2.1e-11, the losses 2.2e-15
    and 5.9e-15), and the parameters bitwise equal across the ranks; one step of
    unet_dropout the same way (its masks the rows of the global mask);
  * one float32 step over two ranks from a carried JAX state against JAX's
    ``make_train_step`` on ``make_mesh(2)`` at tests/test_torch_train.py's
    float32 bars: the loss within rel 1e-5, the running statistics within
    1e-4, the parameters within 2 lr; the gradients no farther from the
    float64 ones than 4x the one-process float32 step's + 1e-6 (the port's
    one-process float64 gradients, which equal JAX's: test_torch_train.py);
  * ``Trainer.fit`` over two ranks (float64 cnn, early stopping at
    patience 0): the one-process history (val_loss within 1e-12 relative,
    every other metric equal), both ranks stopping at the same step, rank
    0 alone writing ``best.npz``;
  * the train CLI: tests/test_torch_parallel_cli.py.
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

import cpu_share  # noqa: E402,F401

import optax  # noqa: E402

from starcop_tpu.models import SegmentationModel as FlaxSegmentationModel  # noqa: E402
from starcop_tpu.parallel import mesh as jmesh  # noqa: E402
from starcop_tpu.train import loop as jloop  # noqa: E402
from starcop_tpu.train.checkpoint import save_checkpoint as j_save_checkpoint  # noqa: E402
from starcop_tpu_torch.models.segmenter import SegmentationModel  # noqa: E402
from starcop_tpu_torch.models.weights import torch_to_flax_variables  # noqa: E402
from starcop_tpu_torch.parallel import run_world  # noqa: E402
from starcop_tpu_torch.train import loop as tloop  # noqa: E402
from starcop_tpu_torch.train.checkpoint import load_checkpoint  # noqa: E402
from tests import torch_parallel_worlds as worlds  # noqa: E402
from tests.test_torch_eval import flax_variables  # noqa: E402
from tests.test_torch_train import _batch, _jax, _l2_err, _leaves  # noqa: E402

LR = worlds.LR


def _world(fn, tmp, *args):
    return run_world(fn, 2, backend="gloo", device="cpu", init_file=str(tmp / "rdv"),
                     timeout_s=300.0, args=args)


@pytest.fixture(scope="module")
def jax_f32():
    """A JAX state (the U-Net's Flax variables filled from numpy, optax's
    Adam) and a global f32 batch of 4 x 64^2."""
    jm = FlaxSegmentationModel(worlds.PRODUCTS, model_type="unet_semseg", encoder_weights=None,
                               pos_weight=15.0)
    variables = flax_variables(7)
    tx = optax.inject_hyperparams(optax.adam)(learning_rate=LR)
    jstate = jloop.TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                              batch_stats=variables["batch_stats"],
                              opt_state=tx.init(variables["params"]))
    return jm, jstate, tx, _batch(9, b=4)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jax_f32):
    tmp = tmp_path_factory.mktemp("train")
    _, jstate, _, batch32 = jax_f32
    ckpt = j_save_checkpoint(str(tmp), jstate, name="jax")
    path = tmp / "inputs.npz"
    np.savez(path, batch64=np.asarray(_batch(8, b=4), dtype=object),
             batch32=np.asarray(batch32, dtype=object), jax_checkpoint=ckpt, tmp=str(tmp))
    return _world(worlds.train_world, tmp, str(path)), tmp


def _kinds(sd, grads):
    """{kind: {name: array}}: gradients, running statistics, parameters."""
    stats = {k: v for k, v in sd.items() if "running" in k}
    params = {k: v for k, v in sd.items() if k not in stats and "num_batches" not in k}
    return {"gradients": grads, "running statistics": stats, "parameters": params}


def _hold_f64(got, want):
    """Each leaf within 1e-9 of the largest absolute value of its kind;
    returns the worst of each kind."""
    worst = {}
    for kind, ref in _kinds(want[1], want[2]).items():
        new = _kinds(got[1], got[2])[kind]
        assert new.keys() == ref.keys()
        if not ref:  # unet_dropout has no batch norm
            continue
        scale = max(float(np.abs(v).max()) for v in ref.values())
        worst[kind] = max(float(np.abs(new[k] - v).max()) for k, v in ref.items()) / scale
        assert worst[kind] <= 1e-9, (kind, worst[kind])
    return worst


def test_two_rank_f64_steps_are_the_global_batch_steps(ranks):
    (r0, r1), _ = ranks
    want = worlds.run_steps(worlds.semseg_f64_state("cpu"), _batch(8, b=4), 2)
    got = r0["f64"]
    assert got[0][0] == pytest.approx(want[0][0], rel=1e-12, abs=0)
    assert got[0][1] == pytest.approx(want[0][1], rel=1e-12, abs=0)
    assert r1["f64"][0] == got[0]
    _hold_f64(got, want)
    for a, b in ((r0["f64"][1], r1["f64"][1]), (r0["f64"][2], r1["f64"][2])):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_two_rank_dropout_step_is_the_global_batch_step(ranks):
    (r0, r1), _ = ranks
    want = worlds.run_steps(worlds.dropout_f64_state("cpu"), _batch(8, b=4), 1, seed=7)
    got = r0["dropout_f64"]
    assert got[0][0] == pytest.approx(want[0][0], rel=1e-12, abs=0)
    _hold_f64(got, want)
    for k in got[1]:
        np.testing.assert_array_equal(got[1][k], r1["dropout_f64"][1][k], err_msg=k)
    # The masks of another step give another loss: the test sees the masks.
    later = worlds.dropout_f64_state("cpu")
    later.step = 1
    assert abs(worlds.run_steps(later, _batch(8, b=4), 1, seed=7)[0][0] - want[0][0]) > 1e-6


def _carried(path):
    """The port's TrainState holding the JAX state saved at ``path``."""
    model = SegmentationModel(worlds.PRODUCTS, model_type="unet_semseg", encoder_weights=None,
                              pos_weight=15.0)
    return load_checkpoint(path, tloop.create_train_state(model, 0, LR, "cpu"))


def test_two_rank_f32_step_matches_jax_mesh_step(ranks, jax_f32):
    """The gradients' bar takes the one-process port as its reference
    (its f64 gradients equal JAX's within test_torch_train.py's
    GRAD64_BARS): the two ranks' f32 gradients no farther from the f64
    ones than 4x the one-process f32 step's + 1e-6."""
    (r0, r1), tmp = ranks
    jm, jstate, tx, batch = jax_f32
    mesh = jmesh.make_mesh(2)
    ckpt = str(tmp / "jax.npz")
    own32 = worlds.run_steps(_carried(ckpt), batch, 1)[2]
    twin = _carried(ckpt).model.double().train()
    b64 = {k: torch.as_tensor(v).double() for k, v in batch.items()}
    twin.loss_fn(twin(b64["input"]), b64["output"], b64["weight_loss"]).backward()
    want64 = {n: p.grad.numpy() for n, p in twin.network.named_parameters()}
    placed = jloop.TrainState(step=jstate.step, params=jmesh.replicate(mesh, jstate.params),
                              batch_stats=jmesh.replicate(mesh, jstate.batch_stats),
                              opt_state=jmesh.replicate(mesh, jstate.opt_state))
    new, jloss = jloop.make_train_step(jm, tx)(placed, jmesh.shard_batch(mesh, _jax(batch)),
                                               jnp.asarray(LR, jnp.float32))
    loss, sd, grads = r0["f32"]
    assert loss == r1["f32"][0]
    np.testing.assert_allclose(loss[0], float(jloss), rtol=1e-5)
    assert grads.keys() == want64.keys() == own32.keys()
    assert _l2_err(grads, want64) <= 4 * _l2_err(own32, want64) + 1e-6
    variables = torch_to_flax_variables({k: torch.from_numpy(v) for k, v in sd.items()})
    for path, s in _leaves(jax.device_get(new.batch_stats)).items():
        np.testing.assert_allclose(_leaves(variables["batch_stats"])[path], s, rtol=1e-4,
                                   atol=1e-4, err_msg=str(path))
    for path, p in _leaves(jax.device_get(new.params)).items():
        assert np.abs(_leaves(variables["params"])[path] - p).max() <= 2 * LR * (1 + 1e-3), path
    for k in sd:
        np.testing.assert_array_equal(sd[k], r1["f32"][1][k], err_msg=k)


def test_trainer_fit_over_two_ranks_is_one_process(ranks, tmp_path):
    (r0, r1), tmp = ranks
    want = worlds.fit_run(None, "cpu", str(tmp_path / "one"))
    assert len(want["history"]) < 8  # early stopping cut the run
    for r in (r0, r1):
        got = r["fit"]
        assert got["step"] == want["step"]
        assert len(got["history"]) == len(want["history"])
        for g, w in zip(got["history"], want["history"]):
            assert g.keys() == w.keys()
            assert g["val_loss"] == pytest.approx(w["val_loss"], rel=1e-12, abs=0)
            assert {k: v for k, v in g.items() if k != "val_loss"} == \
                {k: v for k, v in w.items() if k != "val_loss"}
        scale = max(float(np.abs(v).max()) for v in want["params"].values())
        for k, v in want["params"].items():
            assert np.abs(got["params"][k] - v).max() <= 1e-9 * scale, k
    assert r0["fit"]["history"] == r1["fit"]["history"]
    assert "best.npz" in r0["fit"]["files"] and r1["fit"]["files"] == []
    assert not os.path.exists(tmp / "rank1")
