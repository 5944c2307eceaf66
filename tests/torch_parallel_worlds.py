"""Rank functions of the port's multi-rank tests (tests/test_torch_parallel*.py).

Each runs in a process of a gloo world on the CPU started by
``starcop_tpu_torch.parallel.run_world``, which imports this module by name
in every rank: it imports torch and the port only, never JAX. A world runs
several checks and returns their results (numpy arrays, numbers) to the
test, which holds them against the one-process port and the JAX package.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from starcop_tpu_torch.models import layers

PRODUCTS = ["mag1c", "TOA_AVIRIS_640nm", "TOA_AVIRIS_550nm", "TOA_AVIRIS_460nm"]
LR = 1e-4


def _np(t):
    return t.detach().cpu().numpy()


def _raises(fn) -> str:
    """The message of the ValueError ``fn`` raises, or '' when it returns."""
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


# ---------------------------------------------------------------------------
# The mesh: shard_batch, replicate, prefetch, batch norm, dropout
# ---------------------------------------------------------------------------


def bn_input(n: int = 4) -> np.ndarray:
    """A (n, 3, 5, 7) float64 batch whose channels have unequal means and
    spreads, so the global statistics differ from every shard's."""
    rng = np.random.default_rng(11)
    return (rng.normal(size=(n, 3, 5, 7)) * np.asarray([1.0, 3.0, 0.2])[:, None, None]
            + np.asarray([0.5, -4.0, 10.0])[:, None, None]
            + np.arange(n)[:, None, None, None])


def bn_forward(x: np.ndarray, mesh=None):
    """A training forward and backward of a float64 ``BatchNorm2d`` (weights
    and running statistics seeded, ``mesh`` None: one process) on ``x``:
    (y, running mean, running var, dx, dweight, dbias). The loss is the
    mean over the global batch of a fixed weighting of y."""
    bn = layers.BatchNorm2d(3).double()
    with torch.no_grad():
        bn.weight.copy_(torch.tensor([1.5, 0.5, -1.0]))
        bn.bias.copy_(torch.tensor([0.1, 0.2, 0.3]))
        bn.running_mean.copy_(torch.tensor([0.3, -0.2, 1.0]))
        bn.running_var.copy_(torch.tensor([2.0, 0.5, 1.5]))
    scale = torch.as_tensor(np.random.default_rng(12).normal(size=x.shape))
    size, rows = 1, slice(None)
    if mesh is not None:
        from starcop_tpu_torch.parallel.mesh import local_rows

        layers.set_data_parallel(bn, mesh)
        size, rows = mesh.size, local_rows(mesh, len(x))
    xt = torch.as_tensor(x[rows]).requires_grad_(True)
    y = bn.train()(xt)
    # The global batch's mean loss: each rank's mean over its rows / size.
    (y * scale[rows]).mean().div(size).backward()
    grads = [bn.weight.grad, bn.bias.grad]
    if mesh is not None and mesh.size > 1:
        import torch.distributed as dist

        for g in grads:
            dist.all_reduce(g)
    return (_np(y), _np(bn.running_mean), _np(bn.running_var), _np(xt.grad),
            *[_np(g) for g in grads])


def mesh_world(mesh) -> dict:
    from starcop_tpu_torch.data.datamodule import prefetch_to_device
    from starcop_tpu_torch.parallel.mesh import make_mesh, replicate, shard_batch
    from starcop_tpu_torch.train.loop import dropout_generator

    out = {"rank": mesh.rank, "size": mesh.size, "device": str(mesh.device),
           "make_mesh_3": _raises(lambda: make_mesh(3, "cpu")),
           "make_mesh_2": make_mesh(2, "cpu").size}
    # shard_batch: rows of a dict batch, and the sizes that raise
    out["shards"] = {b: _np(shard_batch(mesh, {"x": np.arange(b * 2).reshape(b, 2)})["x"])
                     for b in (2, 4, 6)}
    out["shard_raises"] = {b: _raises(lambda b=b: shard_batch(mesh, np.zeros((b, 2))))
                           for b in (1, 3, 5)}
    # replicate: every rank ends with rank 0's module and arrays
    torch.manual_seed(100 + mesh.rank)
    net = torch.nn.Sequential(torch.nn.Conv2d(2, 3, 3), layers.BatchNorm2d(3))
    with torch.no_grad():
        net[1].running_mean.uniform_()
    net[1].num_batches_tracked.fill_(mesh.rank + 5)
    replicate(mesh, net)
    out["replicated"] = {k: _np(v) for k, v in net.state_dict().items()}
    tree = replicate(mesh, {"a": np.full(3, float(mesh.rank)), "b": [np.arange(2) + mesh.rank]})
    out["replicated_tree"] = (_np(tree["a"]), _np(tree["b"][0]))
    # prefetch_to_device(mesh=): the rank's rows of every numeric array, ids whole
    batches = [{"input": np.arange(8 * 3, dtype=np.float32).reshape(8, 3) + i,
                "has_plume": np.arange(8, dtype=np.float32), "id": [f"t{j}" for j in range(8)]}
               for i in range(3)]
    fed = list(prefetch_to_device(iter(batches), mesh=mesh))
    out["prefetched"] = [({k: _np(v) for k, v in b.items() if k != "id"}, b["id"]) for b in fed]
    out["prefetch_raises"] = _raises(lambda: list(prefetch_to_device(
        iter([{"input": np.zeros((3, 2))}]), mesh=mesh)))
    # batch norm over the global batch
    out["bn"] = bn_forward(bn_input(), mesh)
    # dropout: the rank's rows of the global mask
    gen = dropout_generator(42, 3, mesh.device)
    out["dropout"] = _np(layers.dropout(torch.ones(2, 3, 4, 4), 0.5, gen, (mesh.rank, mesh.size)))
    return out


# ---------------------------------------------------------------------------
# The scene: sharded_mag1c_scene, emit_mag1c, emit_inference
# ---------------------------------------------------------------------------


def scene_world(mesh, path: str) -> dict:
    """The sharded filter on the scene saved at ``path`` (f32 on the fused
    rounds' twins; f64 and the EMIT entry points too when ``full``)."""
    from starcop_tpu_torch.parallel.scene_mag1c import block_range, sharded_mag1c_scene
    from starcop_tpu_torch.scenes.emit_pipeline import emit_inference, emit_mag1c

    with np.load(path) as f:
        d = {k: f[k] for k in f.files}
    kw = dict(column_step=int(d["step"]), num_iter=int(d["num_iter"]), alpha=1e-4)
    out = {"blocks": block_range(-(-d["cube"].shape[1] // kw["column_step"]), mesh)}
    mf, albedo = sharded_mag1c_scene(d["cube"], d["template"], d["valid"], mesh=mesh, **kw)
    out["f32"] = (_np(mf), _np(albedo))
    if not bool(d["full"]):
        return out
    mf, albedo = sharded_mag1c_scene(d["cube"], d["template"], d["valid"], mesh=mesh,
                                     compute_dtype=torch.float64, **kw)
    out["f64"] = (_np(mf), _np(albedo))
    out["emit_mag1c"] = emit_mag1c(d["cube"], d["wavelengths"], d["fwhm"], d["valid"],
                                   mesh=mesh, **kw)
    out["emit_mag1c_wrong_device"] = _raises(lambda: emit_mag1c(
        d["cube"], d["wavelengths"], d["fwhm"], d["valid"], mesh=mesh, device="meta", **kw))
    from starcop_tpu_torch.data.emit import EMITRawScene
    from starcop_tpu_torch.models.segmenter import SegmentationModel
    from starcop_tpu_torch.models.weights import load_pretrained_state_dict

    model = SegmentationModel(PRODUCTS)
    model.network.load_state_dict(load_pretrained_state_dict(str(d["checkpoint"])), strict=True)
    model.eval()
    scene = EMITRawScene(str(d["granule"]))
    try:
        out["emit_inference"] = emit_inference(scene, model, column_step=16, num_iter=5,
                                               mesh=mesh)
    finally:
        scene.close()
    return out


# ---------------------------------------------------------------------------
# Training: the data-parallel step, dropout, Trainer.fit, the train CLI
# ---------------------------------------------------------------------------


def semseg_f64_state(device):
    """unet_semseg from seed 0, in float64."""
    from starcop_tpu_torch.models.segmenter import SegmentationModel
    from starcop_tpu_torch.train.loop import create_train_state

    model = SegmentationModel(PRODUCTS, model_type="unet_semseg", encoder_weights=None,
                              pos_weight=15.0)
    state = create_train_state(model, 0, LR, device)
    model.double()
    return state


def dropout_f64_state(device):
    """unet_dropout from seed 0, in float64."""
    from starcop_tpu_torch.models.segmenter import SegmentationModel
    from starcop_tpu_torch.train.loop import create_train_state

    model = SegmentationModel(PRODUCTS, model_type="unet_dropout", encoder_weights=None,
                              pos_weight=15.0)
    state = create_train_state(model, 0, LR, device)
    model.double()
    return state


def run_steps(state, batch, n, mesh=None, seed=0):
    """``n`` train steps on ``batch`` (the rank's shard of it over ``mesh``):
    the losses, then the network's state dict and gradients as numpy."""
    from starcop_tpu_torch.parallel.mesh import shard_batch
    from starcop_tpu_torch.train.loop import make_train_step

    model = state.model
    step = make_train_step(model, seed, mesh)
    if mesh is None:
        b = {k: torch.as_tensor(v) for k, v in batch.items()}
    else:
        b = shard_batch(mesh, batch)
    losses = []
    for _ in range(n):
        state, loss = step(state, b, LR)
        losses.append(float(loss))
    return (losses, {k: _np(v) for k, v in model.network.state_dict().items()},
            {k: _np(p.grad) for k, p in model.network.named_parameters()})


def fit_run(mesh, device, ckpt_dir):
    """Trainer.fit of a float64 cnn on mag1c over ``mesh`` (None: one
    process): high lr and no patience, so early stopping cuts the run."""
    from starcop_tpu_torch.data.synthetic import synthetic_chip_batch
    from starcop_tpu_torch.models.segmenter import SegmentationModel
    from starcop_tpu_torch.train.loop import Trainer, create_train_state

    r = np.random.default_rng(1)
    train = [synthetic_chip_batch(r, batch_size=8, size=32, input_products=("mag1c",))
             for _ in range(4)]
    val = [synthetic_chip_batch(r, batch_size=4, size=32, input_products=("mag1c",))
           for _ in range(2)]
    model = SegmentationModel(["mag1c"], model_type="cnn", pos_weight=3.0)
    state = create_train_state(model, 0, 0.05, device)
    model.double()
    trainer = Trainer(model, learning_rate=0.05, max_epochs=8, val_check_interval=1.0,
                      lr_patience=0, early_stopping_patience=0, checkpoint_dir=ckpt_dir,
                      mesh=mesh, device=None if mesh is not None else device)
    final = trainer.fit(lambda: iter(train), lambda: iter(val), state=state)
    return {"history": trainer.history, "step": final.step,
            "params": {k: _np(v) for k, v in model.network.state_dict().items()}}


def train_world(mesh, path: str) -> dict:
    from starcop_tpu_torch.models.segmenter import SegmentationModel
    from starcop_tpu_torch.train.checkpoint import load_checkpoint
    from starcop_tpu_torch.train.loop import create_train_state

    with np.load(path, allow_pickle=True) as f:
        d = {k: f[k] for k in f.files}
    batch64 = d["batch64"].item()
    out = {"f64": run_steps(semseg_f64_state(mesh.device), batch64, 2, mesh),
           "dropout_f64": run_steps(dropout_f64_state(mesh.device), batch64, 1, mesh, seed=7)}
    # f32 from the carried JAX state
    model = SegmentationModel(PRODUCTS, model_type="unet_semseg", encoder_weights=None,
                              pos_weight=15.0)
    state = load_checkpoint(str(d["jax_checkpoint"]),
                            create_train_state(model, 0, LR, mesh.device), mesh=mesh)
    out["f32"] = run_steps(state, d["batch32"].item(), 1, mesh)
    out["fit"] = fit_run(mesh, mesh.device, os.path.join(str(d["tmp"]), f"rank{mesh.rank}"))
    out["fit"]["files"] = sorted(os.listdir(os.path.join(str(d["tmp"]), f"rank{mesh.rank}"))) \
        if os.path.isdir(os.path.join(str(d["tmp"]), f"rank{mesh.rank}")) else []
    return out


def cli_world(mesh, cwd: str, argv) -> dict:
    """The train CLI in a launched world, from ``cwd``."""
    from starcop_tpu_torch.cli.train import run

    os.chdir(cwd)
    exp_dir, state = run(list(argv))
    return {"exp_dir": exp_dir, "step": state.step,
            "params": {k: _np(v) for k, v in state.model.network.state_dict().items()}}


# ---------------------------------------------------------------------------
# The launcher's failure paths
# ---------------------------------------------------------------------------


def fail_on_rank_1(mesh) -> int:
    if mesh.rank == 1:
        raise ArithmeticError("rank 1 fails on purpose")
    import torch.distributed as dist

    dist.barrier()  # rank 0 would wait here for ever
    return mesh.rank


def hang(mesh) -> None:
    import time

    time.sleep(3600)
