"""Training throughput: HyperSTARCOP training steps through the port's own
loop, as ``Trainer._fit`` drives them: ``DataModule.train_loader()`` ->
``prefetch_to_device`` -> ``make_train_step``, epoch after epoch, with
validation, logging and checkpoints left out.

Set-up writes the seed's chips in the chip cache's layout
(``recipes/chips.py``) under the run's temporary directory, seeds the
full-width U-Net into the program's ``SegmentationModel`` with the program's
Adam, and drives that one training object through its first steps on the
window's own call and feed, keeping their batches, losses, the first
gradient as Adam holds it and the parameters after them. The window then goes
on with the same object and feed. ``check`` holds those steps to the plain
reference at float64, and the loader's rows to the raw chips.
"""

from __future__ import annotations

import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from portbench.recipes.chips import make_chips, write_dataset
from portbench.recipes.weights import load_into, make_params
from portbench.reference.train import adam_steps, judge_row, leaf_gap, window_of


def _products(model_cfg):
    return {"input": model_cfg["input_products"], "output": model_cfg["output_products"],
            "weight_loss": [model_cfg["weight_loss_product"]]}


def setup(ctx):
    from starcop_tpu_torch.data.datamodule import DataModule, prefetch_to_device
    from starcop_tpu_torch.device import float32_precision
    from starcop_tpu_torch.models.segmenter import SegmentationModel
    from starcop_tpu_torch.train.loop import TrainState, make_adam, make_train_step

    ctx.stage("import")
    mc, tr = ctx.config["model"], ctx.config["training"]
    p = {**ctx.config["chips"], **ctx.traffic}
    chips = {k: v.cpu().numpy() for k, v in make_chips(ctx.seed, p, ctx.device).items()}
    root = tempfile.mkdtemp(prefix="portbench-chips-")
    index = write_dataset(root, chips, "chip")
    ctx.stage("inputs")

    params = make_params(ctx.seed, ctx.device)
    ctx.stage("weights")
    model = SegmentationModel(input_products=mc["input_products"],
                              output_products=mc["output_products"],
                              pos_weight=tr["pos_weight"], use_weight_loss=True,
                              loss_name=tr["loss"])
    load_into(model.network, params)
    model.to(ctx.device)
    train_state = TrainState(model, make_adam(model, tr["lr"]), 0)
    step = make_train_step(model, ctx.seed)
    ctx.stage("model")
    dm = DataModule(index, None, input_products=mc["input_products"],
                    output_products=mc["output_products"],
                    weight_loss_product=mc["weight_loss_product"],
                    training_size=tr["training_size"], training_overlap=tr["training_overlap"],
                    batch_size=tr["batch_size"], weight_sampling=tr["weight_sampling"],
                    num_workers=tr["num_workers"], seed=ctx.seed)

    def epochs():
        while True:
            yield from prefetch_to_device(iter(dm.train_loader()), device=ctx.device)

    feed = epochs()
    ctx.stage("loader")

    batches, losses, first_grad = [], [], None
    names = [n for n, _ in model.network.named_parameters()]
    with float32_precision():
        for i in range(int(ctx.traffic["check_steps"])):
            batch = next(feed)
            batches.append({k: v.clone() if isinstance(v, torch.Tensor) else list(v)
                            for k, v in batch.items()})
            train_state, loss = step(train_state, batch, tr["lr"])
            losses.append(float(loss))
            if i == 0:
                opt = train_state.optimizer
                first_grad = {n: opt.state.get(q, {}).get("exp_avg", torch.zeros_like(q)).detach()
                              .double() / (1 - tr["adam_b1"])
                              for n, q in model.network.named_parameters()}
    after = {n: q.detach().clone() for n, q in model.network.named_parameters()}
    ctx.synchronize()
    ctx.stage("first_steps")
    return {"model": model, "train_state": train_state, "step": step, "feed": feed,
            "params": params, "chips": chips, "root": root, "batches": batches,
            "losses": losses, "first_grad": first_grad, "after": after, "names": names,
            "float32_precision": float32_precision}


def window(ctx, state, seconds: float):
    step, feed, lr = state["step"], state["feed"], ctx.config["training"]["lr"]
    batch_size = ctx.config["training"]["batch_size"]
    train_state = state["train_state"]
    losses, waits = [], 0.0
    t0 = time.perf_counter()
    t_end = t0 + seconds
    with state["float32_precision"]():
        while time.perf_counter() < t_end:
            tw = time.perf_counter()
            with ctx.span("loader"):
                batch = next(feed)
            waits += time.perf_counter() - tw
            with ctx.span("step"):
                train_state, loss = step(train_state, batch, lr)
            losses.append(loss)
        ctx.synchronize()
    elapsed = time.perf_counter() - t0
    n = len(losses)
    failed = int((~torch.isfinite(torch.stack(losses))).sum()) if n else 0
    return {"e2e": {"train_tiles_per_s": n * batch_size / elapsed},
            "attempted": n, "failed": failed, "steps": n, "elapsed_s": elapsed,
            "loader_wait_s": waits, "batch_size": batch_size}


def check(ctx, state, result):
    """The first steps against the reference at float64: the first step's
    loss (relative gap), the first gradient's norm and the parameters'
    change after the steps (the worst leaf's gap of norms, over the larger of
    its reference norm and the median leaf's; for the change, leaves whose
    reference gradient is under a thousandth of the median leaf's are left
    out), and every row of those batches against the raw chips."""
    state["feed"].close()  # stops the loader's reader threads
    for key in ("model", "train_state", "step", "feed"):
        state.pop(key, None)
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    shutil.rmtree(state.pop("root"), ignore_errors=True)
    return compare(ctx, state, program_answers(ctx, state), torch.float64)


def reference_batches(ctx, state):
    """The reference's own rows for the kept batches, and the loader's
    largest gap from them."""
    mc, tr = ctx.config["model"], ctx.config["training"]
    size = tr["training_size"]
    chips = {}
    for i in range(next(iter(state["chips"].values())).shape[0]):
        chips[f"chip{i:04d}"] = {k: torch.as_tensor(v[i], device=ctx.device)
                                 for k, v in state["chips"].items()}
    worst, out = 0.0, []
    for batch in state["batches"]:
        rows = {k: [] for k in ("input", "output", "weight_loss")}
        for j, row_id in enumerate(batch["id"]):
            win = window_of(row_id, chips, size, _products(mc))
            gap, ref_row = judge_row({k: batch[k][j] for k in rows}, win)
            worst = max(worst, gap)
            for k in rows:
                rows[k].append(ref_row[k])
        out.append({k: torch.stack(v) for k, v in rows.items()})
    flat = torch.cat([b["input"].reshape(len(b["input"]), -1) for b in state["batches"]])
    dup = len(flat) - len(torch.unique(flat, dim=0))
    if dup:
        print(f"train: {dup} of {len(flat)} rows of the first batches repeat another",
              file=sys.stderr)
    return out, worst


def compare(ctx, state, answers, dtype=torch.float64):
    """[(name, value, limit)] of ``answers`` (losses, first gradient,
    parameters after the steps) against the reference computed in
    ``dtype``."""
    losses, first_grad, after = answers
    limits = ctx.traffic["limits"]
    ref_batches, row_gap = reference_batches(ctx, state)
    ref_losses, ref_grad, ref_after = adam_steps(state["params"], ref_batches,
                                                 ctx.config["model"], ctx.config["training"],
                                                 dtype)
    names = state["names"]
    # The first step's loss: from the second step on, Adam's first update
    # (lr * g / |g|, about lr * sign(g)) flips the elements whose gradient's
    # sign is rounding, and the later losses part by ~1e-3 in sound runs.
    loss_gap = abs(losses[0] - ref_losses[0]) / abs(ref_losses[0])
    norms = {k: float(ref_grad[k].double().norm()) for k in names}
    median = float(np.median(list(norms.values())))
    moved = [k for k in names if norms[k] >= 1e-3 * median]
    left_out = sorted(set(names) - set(moved))
    if left_out:
        print(f"train: leaves left out of the change (gradient under 1e-3 of the median "
              f"leaf's): {left_out}", file=sys.stderr)
    grad_gap, grad_at = leaf_gap(first_grad, ref_grad, names)
    start = state["params"]
    change = {k: after[k].double() - start[k].double() for k in moved}
    ref_change = {k: ref_after[k].double() - start[k].double() for k in moved}
    change_gap, change_at = leaf_gap(change, ref_change, moved)
    print(f"train: losses {losses} reference {ref_losses}; worst gradient leaf {grad_at}, "
          f"worst change leaf {change_at}", file=sys.stderr)
    return [("loss1_rel_gap", loss_gap, limits["loss1_rel_gap"]),
            ("grad_norm_gap", grad_gap, limits["grad_norm_gap"]),
            ("change_norm_gap", change_gap, limits["change_norm_gap"]),
            ("loader_row_gap", row_gap, limits["loader_row_gap"])]


def control_answers(ctx, state, dtype=torch.float32):
    """The reference in the program's place at the precision below the
    configuration's (f32 with TF32 on): its losses, first gradient and
    parameters after the first steps, from the same batches."""
    for key in ("model", "train_state", "step"):
        state.pop(key, None)
    ref_batches, _ = reference_batches(ctx, state)
    losses, grads, after = adam_steps(state["params"], ref_batches, ctx.config["model"],
                                      ctx.config["training"], dtype)
    return losses, grads, after


def program_answers(ctx, state):
    return state["losses"], state["first_grad"], state["after"]


def finish(ctx, state):
    """Stop the loader and remove the run's chips (readings outside a run)."""
    feed = state.pop("feed", None)
    if feed is not None:
        feed.close()
    root = state.pop("root", None)
    if root and os.path.isdir(root):
        shutil.rmtree(root, ignore_errors=True)
