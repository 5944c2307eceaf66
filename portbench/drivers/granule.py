"""Granule latency: a closed loop with one client that hands a whole EMIT
granule (host numpy) to ``emit_granule_to_mask`` and waits for the mask and
mf on the host.

Set-up makes a pool of granules on the device from the seed
(``recipes/granule.py``), moves them to host memory, seeds the full-width
U-Net (``recipes/weights.py``) into the program's ``SegmentationModel`` and
warms up on the pool. The window issues requests in turn over the pool; each
is timed from its issue to both arrays being on the host. A seeded reservoir
keeps a sample of the answers, which ``check`` holds to the plain reference
at float64 once the window has closed.
"""

from __future__ import annotations

import math
import time
import traceback

import numpy as np
import torch

from portbench.recipes.granule import make_pool
from portbench.recipes.template import emit_template
from portbench.recipes.weights import load_into, make_params
from portbench.reference.granule import granule_to_mask, plume_probability
from portbench.reference.mag1c import NODATA

STREAM_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


def granule_params(ctx):
    """The granule recipe's parameters: the configuration's geometry with the
    traffic mix's fill pattern and plumes."""
    return {**ctx.config["granule"], **ctx.config["filter"], **ctx.traffic}


def setup(ctx):
    from starcop_tpu_torch.models.segmenter import SegmentationModel
    from starcop_tpu_torch.ops import _build
    from starcop_tpu_torch.scenes.emit_pipeline import emit_granule_to_mask

    ctx.stage("import")
    if ctx.device.type == "cuda":
        _build.load()
    ctx.stage("build_or_load")

    p = granule_params(ctx)
    template = emit_template(ctx.config)
    pool = make_pool(ctx.seed, template, p, ctx.device)
    ctx.stage("inputs")

    params = make_params(ctx.seed, ctx.device)
    model = SegmentationModel(input_products=ctx.config["model"]["input_products"])
    load_into(model.network, params)
    model = model.to(ctx.device).eval()
    ctx.stage("model")

    def model_apply(x):
        with ctx.span("unet"):
            return model(x)

    kwargs = dict(column_step=int(p["column_step"]), num_iter=int(p["num_iter"]),
                  alpha=float(p["alpha"]), stream_dtype=STREAM_DTYPES[p["stream_dtype"]],
                  device=ctx.device)

    def request(g):
        with ctx.span("request"):
            pred, mf = emit_granule_to_mask(g["cube"], g["rgb"], template, model_apply,
                                            valid_mask=g["valid"], **kwargs)
            with ctx.span("download"):
                return pred.cpu().numpy(), mf.cpu().numpy()

    state = {"model": model, "params": params, "pool": pool, "template": template,
             "request": request}
    for i in range(int(p["warmup_requests"])):
        request(pool[i % len(pool)])
    ctx.synchronize()
    ctx.stage("warmup")
    return state


def nearest_rank(values, q: float) -> float:
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q * len(ordered)) - 1)]


def window(ctx, state, seconds: float):
    pool, request = state["pool"], state["request"]
    k = int(ctx.traffic["check_samples"])
    rng = np.random.default_rng([ctx.seed, 1])
    latencies, served, kept = [], [], []
    attempted = failed = 0
    t_end = time.perf_counter() + seconds
    while time.perf_counter() < t_end:
        gi = attempted % len(pool)
        attempted += 1
        t = time.perf_counter()
        try:
            pred, mf = request(pool[gi])
        except Exception:  # noqa: BLE001 -- a failed request is counted, not fatal
            failed += 1
            traceback.print_exc()
            continue
        latencies.append(time.perf_counter() - t)
        served.append(gi)
        if len(kept) < k:
            kept.append((gi, pred, mf))
        else:
            j = int(rng.integers(0, len(served)))
            if j < k:
                kept[j] = (gi, pred, mf)
    return {"e2e": {"granule_ms_p95": nearest_rank(latencies, 0.95) * 1e3},
            "attempted": attempted, "failed": failed, "latencies": latencies,
            "served": served, "valid_pixels": [pool[gi]["valid_pixels"] for gi in served],
            "kept": kept}


def check(ctx, state, result):
    """The sampled answers against the reference at float64 (``compare``)."""
    state.pop("model", None)
    state.pop("request", None)
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    return compare(ctx, state, result["kept"], torch.float64)


def reference_answers(ctx, state, indices, dtype):
    """{granule: (prediction, mf)} of the reference in ``dtype``, as numpy
    float64."""
    out = {}
    for gi in sorted(set(indices)):
        g = state["pool"][gi]
        t = lambda a: torch.as_tensor(a, device=ctx.device)  # noqa: E731
        pred, mf = granule_to_mask(t(g["cube"]), t(g["rgb"]), t(g["valid"]), state["template"],
                                   state["params"], ctx.config, dtype=dtype)
        out[gi] = (pred.double().cpu().numpy(), mf.double().cpu().numpy())
        del pred, mf
    return out


def compare(ctx, state, answers, dtype):
    """[(name, value, limit)] of ``answers`` [(granule, prediction, mf)]
    against the reference computed in ``dtype``, stage by stage:

    * the filter: the share of valid pixels on which mf and the reference's
      mf fall on different sides of ``mf_threshold`` (the detection rule),
      and the root-mean-square gap of mf over the reference's;
    * the U-Net: the largest gap between the program's mask and the
      reference's mask computed from the program's own mf (the filter's
      part is the first number's);
    * the NODATA pixels, exactly."""
    limits, thr = ctx.traffic["limits"], float(ctx.traffic["mf_threshold"])
    refs = reference_answers(ctx, state, [gi for gi, _, _ in answers], dtype)
    disagree = rms = mask_gap = nodata = 0.0
    for gi, pred, mf in answers:
        g = state["pool"][gi]
        ref_mf = refs[gi][1]
        valid = g["valid"]
        nodata = max(nodata, float(np.count_nonzero((mf == NODATA) != ~valid)))
        got, want = mf[valid].astype(np.float64), ref_mf[valid]
        disagree = max(disagree, float(np.mean((got > thr) != (want > thr))))
        rms = max(rms, float(np.sqrt(np.mean((got - want) ** 2) / np.mean(want**2))))
        t = lambda a: torch.as_tensor(a, device=ctx.device)  # noqa: E731
        given = plume_probability(t(mf).to(dtype), t(g["rgb"]), state["params"],
                                  ctx.config["model"]).double().cpu().numpy()
        mask_gap = max(mask_gap, float(np.abs(pred.astype(np.float64) - given).max()))
    return [("mf_disagree", disagree, limits["mf_disagree"]),
            ("mf_rms_rel", rms, limits["mf_rms_rel"]),
            ("mask_gap", mask_gap, limits["mask_gap"]),
            ("nodata_mismatch", nodata, limits["nodata_mismatch"])]


def program_answers(ctx, state):
    """One request a sampled granule through the timed path (for readings
    outside a window): [(granule, prediction, mf)]."""
    k = min(int(ctx.traffic["check_samples"]), len(state["pool"]))
    return [(gi, *state["request"](state["pool"][gi])) for gi in range(k)]


def control_answers(ctx, state, dtype=torch.float32):
    """The reference put in the program's place at the precision below the
    configuration's (f32 with TF32 on for matmuls and convolutions)."""
    k = min(int(ctx.traffic["check_samples"]), len(state["pool"]))
    state.pop("model", None)
    refs = reference_answers(ctx, state, range(k), dtype)
    return [(gi, refs[gi][0], refs[gi][1]) for gi in range(k)]
