"""Evaluation throughput: ``run_validation(model.batch_with_preds, ...)`` as
``cli/evaluate.py`` builds it: a ``BatchLoader`` at batch 32 over the test
chips (one reader, in order), ``prefetch_to_device``, the bf16-resident
model, the default threshold sweep, no results files. Each pass scores every
test chip once; the window runs passes back to back.

Set-up writes the seed's chips in the chip cache's layout
(``recipes/chips.py``) under the run's temporary directory. The model's
``batch_with_preds`` is wrapped to keep, for a seeded sample of batches, the
logits it computed, and the pass keeps its per-tile rows; ``check`` holds
both to the plain reference.
"""

from __future__ import annotations

import shutil
import tempfile
import time

import numpy as np
import torch

from portbench.recipes.chips import make_chips, write_dataset
from portbench.recipes.weights import load_into, make_params
from portbench.reference.unet import fp8_round, normalize_input, unet_logits

MODEL_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


def setup(ctx):
    from starcop_tpu_torch.data.datamodule import BatchLoader, prefetch_to_device
    from starcop_tpu_torch.data.dataset import ChipDataset, read_index_csv
    from starcop_tpu_torch.device import float32_precision
    from starcop_tpu_torch.eval.validation import run_validation
    from starcop_tpu_torch.models.segmenter import SegmentationModel, cast_for_inference

    ctx.stage("import")
    mc, t = ctx.config["model"], ctx.traffic
    p = {**ctx.config["chips"], **t}
    chips = {k: v.cpu().numpy() for k, v in make_chips(ctx.seed, p, ctx.device).items()}
    root = tempfile.mkdtemp(prefix="portbench-chips-")
    index = write_dataset(root, chips, "test")
    ctx.stage("inputs")

    params = make_params(ctx.seed, ctx.device)
    model = SegmentationModel(input_products=mc["input_products"])
    load_into(model.network, params)
    if MODEL_DTYPES[t["model_dtype"]] is not None:
        cast_for_inference(model, MODEL_DTYPES[t["model_dtype"]])
    model = model.to(ctx.device).eval()
    dataset = ChipDataset(read_index_csv(index), mc["input_products"], mc["output_products"],
                          mc["weight_loss_product"])
    loader = BatchLoader(dataset, batch_size=int(t["batch_size"]))
    ctx.stage("model")

    spy = {"keep": set(), "kept": [], "batch": 0}

    def batch_with_preds(batch):
        with ctx.span("batch"):
            out = model.batch_with_preds(batch)
        if spy["batch"] in spy["keep"]:
            spy["kept"].append((spy["batch"], list(out["id"]), out["logits"].float().clone()))
        spy["batch"] += 1
        return out

    def one_pass():
        with ctx.span("pass"), torch.inference_mode(), float32_precision():
            rows, _ = run_validation(batch_with_preds,
                                     prefetch_to_device(iter(loader), device=ctx.device))
        return rows

    state = {"model": model, "params": params, "chips": chips, "root": root, "spy": spy,
             "one_pass": one_pass, "loader": loader}
    for _ in range(int(t["warmup_passes"])):
        one_pass()
    ctx.synchronize()
    ctx.stage("warmup")
    return state


def window(ctx, state, seconds: float):
    t = ctx.traffic
    spy, per_pass = state["spy"], len(state["loader"])
    sample_passes = int(t["sample_passes"])
    # The sampled batches, drawn from the seed among the first passes, which
    # the window always finishes (checked below), so the sample does not
    # hang on timing.
    rng = np.random.default_rng([ctx.seed, 3])
    keep = rng.choice(per_pass * sample_passes, size=int(t["check_batches"]), replace=False)
    spy.update(batch=0, kept=[], keep=set(keep.tolist()))
    rows_of_pass = []
    tiles = 0
    t0 = time.perf_counter()
    t_end = t0 + seconds
    while time.perf_counter() < t_end or len(rows_of_pass) < sample_passes:
        rows = state["one_pass"]()
        tiles += len(rows)
        rows_of_pass.append({r["id"]: r for r in rows} if len(rows_of_pass) < sample_passes
                            else None)
    elapsed = time.perf_counter() - t0
    spy["keep"] = set()
    kept = [(ids, pred, [rows_of_pass[b // per_pass][i] for i in ids])
            for b, ids, pred in spy["kept"]]
    return {"e2e": {"eval_tiles_per_s": tiles / elapsed}, "attempted": tiles, "failed": 0,
            "tiles": tiles, "passes": len(rows_of_pass), "elapsed_s": elapsed,
            "batches": len(rows_of_pass) * per_pass, "kept": kept}


def check(ctx, state, result):
    """The sampled batches against the reference (``compare``)."""
    for key in ("model", "one_pass", "loader"):
        state.pop(key, None)
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    shutil.rmtree(state.pop("root"), ignore_errors=True)
    return compare(ctx, state, result["kept"], torch.float64)


def held_params(ctx, state):
    """The weights as the model holds them (bf16-resident: rounded to bf16)."""
    dt = MODEL_DTYPES[ctx.traffic["model_dtype"]]
    return state["params"] if dt is None else {k: v.to(dt) for k, v in state["params"].items()}


def reference_logits(ctx, state, ids, dtype, rounding=None):
    """The reference's logits (B, 1, H, W) of the test chips ``ids``, from
    the raw chips and the weights as the model holds them."""
    mc = ctx.config["model"]
    idx = [int(i[len("test"):]) for i in ids]
    x = torch.stack([torch.as_tensor(state["chips"][n][idx], device=ctx.device)
                     for n in mc["input_products"]], dim=1).to(dtype)
    p = {k: v.to(dtype) for k, v in held_params(ctx, state).items()}
    return unet_logits(normalize_input(x, mc["input_factors"]), p, rounding=rounding)


def tile_counts(logits, label):
    """Per tile (TP, FP, FN, TN) of ``sigmoid(logits) > 0.5`` (in f32, as
    ``batch_with_preds`` thresholds) against the label, as lists."""
    pb, y = torch.sigmoid(logits.float()) > 0.5, label
    counts = {"TP": pb & y, "FP": pb & ~y, "FN": ~pb & y, "TN": ~pb & ~y}
    return {k: v.sum(dim=(1, 2, 3)).tolist() for k, v in counts.items()}


def compare(ctx, state, answers, dtype):
    """[(name, value, limit)] of ``answers`` [(ids, logits, rows)]:

    * the forward: the root-mean-square gap between the batch's logits and
      the reference's (from the raw chips and the weights as the model
      holds them), over the reference's root-mean-square; the sigmoid's
      saturation under the seeded U-Net's gain on mag1c makes gaps of the
      predictions swing from seed to seed, so the logits are compared;
    * the per-tile metrics: each tile's row (TP, FP, FN, TN at prediction >
      0.5) against the counts the reference takes from the batch's own
      logits, exactly (the forward is the number above)."""
    limits = ctx.traffic["limits"]
    rms = rows_off = 0.0
    for ids, logits, rows in answers:
        ref = reference_logits(ctx, state, ids, dtype).double()
        got = logits.to(ref.device)
        gap = ((got.double() - ref) ** 2).mean() / (ref**2).mean()
        rms = max(rms, float(gap.sqrt()))
        idx = [int(i[len("test"):]) for i in ids]
        y = torch.as_tensor(state["chips"]["labelbinary"][idx], device=ref.device)[:, None] == 1
        counts = tile_counts(got, y)
        rows_off += sum(abs(row[k] - counts[k][j]) for j, row in enumerate(rows) for k in counts)
    return [("logit_rms_rel", rms, limits["logit_rms_rel"]),
            ("rows_off", rows_off, limits["rows_off"])]


def program_answers(ctx, state):
    """One pass with every batch kept (for readings outside a window)."""
    spy = state["spy"]
    n = min(int(ctx.traffic["check_batches"]), len(state["loader"]))
    spy.update(batch=0, kept=[], keep=set(range(n)))
    rows = {r["id"]: r for r in state["one_pass"]()}
    spy["keep"] = set()
    return [(ids, pred, [rows[i] for i in ids]) for _, ids, pred in spy["kept"]]


def control_answers(ctx, state, dtype=torch.float32):
    """The reference in the program's place at the precision below the
    bf16-resident model: its convolutions on fp8 (e4m3) operands; its rows'
    counts at prediction > 0.5."""
    n = min(int(ctx.traffic["check_batches"]), len(state["loader"]))
    bs = int(ctx.traffic["batch_size"])
    state.pop("model", None)
    out = []
    for b in range(n):
        ids = [f"test{i:04d}" for i in range(b * bs, (b + 1) * bs)]
        logits = reference_logits(ctx, state, ids, dtype, rounding=fp8_round)
        idx = list(range(b * bs, (b + 1) * bs))
        y = torch.as_tensor(state["chips"]["labelbinary"][idx], device=logits.device)[:, None] == 1
        counts = tile_counts(logits, y)
        out.append((ids, logits, [{k: counts[k][j] for k in counts} for j in range(bs)]))
    return out


def finish(ctx, state):
    root = state.pop("root", None)
    if root:
        shutil.rmtree(root, ignore_errors=True)
