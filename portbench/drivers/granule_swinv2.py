"""Granule latency with SwinV2-B + UperNet in the U-Net's place: the granule
cell's closed loop (``drivers/granule.py``: its window, request sampling and
program readings as they are) with the configuration's network in the
program's ``SegmentationModel`` (``model.architecture``), handed to
``emit_granule_to_mask`` unchanged.

Set-up builds the network first, makes the pool of granules from the seed
(``recipes/granule.py``), seeds the network (``recipes/swin_weights.py``)
and warms up on the pool; the harness span ``model`` wraps the
``model_apply`` callable. The check holds the sampled answers to the plain
references at float64: mf to ``reference/mag1c.py``, the mask to
``reference/swin.py`` on the program's own mf.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.drivers.granule import (  # noqa: F401 -- the granule cell's, as they are
    STREAM_DTYPES,
    granule_params,
    program_answers,
    window,
)
from portbench.drivers.granule_segformer import reference_mf
from portbench.recipes.granule import make_pool
from portbench.recipes.swin_weights import make_params
from portbench.recipes.template import emit_template
from portbench.recipes.weights import load_into
from portbench.reference.mag1c import NODATA
from portbench.reference.swin import plume_probability


def setup(ctx):
    from starcop_tpu_torch.models.segmenter import SegmentationModel

    # The network first: a program without the architecture fails here, in
    # seconds, before the kernels' build.
    m = ctx.config["model"]
    model = SegmentationModel(input_products=m["input_products"], model_type=m["architecture"],
                              num_classes=m["num_classes"])
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

    params = make_params(ctx.seed, ctx.device, m)
    load_into(model.network, params)
    model = model.to(ctx.device).eval()
    ctx.stage("model")

    def model_apply(x):
        with ctx.span("model"):
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


def check(ctx, state, result):
    """The sampled answers against the references at float64 (``compare``)."""
    state.pop("model", None)
    state.pop("request", None)
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    return compare(ctx, state, result["kept"], torch.float64)


def _on(ctx, a):
    return torch.as_tensor(a, device=ctx.device)


def compare(ctx, state, answers, dtype):
    """[(name, value, limit)] of ``answers`` [(granule, prediction, mf)]
    against the references computed in ``dtype``, as the granule cell
    compares (``drivers/granule.py:compare``): the share of valid pixels on
    different sides of ``mf_threshold`` and the RMS gap of mf over the
    reference's; the largest gap of the mask to the reference network on
    the program's own mf; the NODATA pixels, exactly."""
    limits, thr = ctx.traffic["limits"], float(ctx.traffic["mf_threshold"])
    m = ctx.config["model"]
    refs = {gi: reference_mf(ctx, state, gi, dtype).double().cpu().numpy()
            for gi in sorted({gi for gi, _, _ in answers})}
    disagree = rms = mask_gap = nodata = 0.0
    for gi, pred, mf in answers:
        g = state["pool"][gi]
        valid = g["valid"]
        nodata = max(nodata, float(np.count_nonzero((mf == NODATA) != ~valid)))
        got, want = mf[valid].astype(np.float64), refs[gi][valid]
        disagree = max(disagree, float(np.mean((got > thr) != (want > thr))))
        rms = max(rms, float(np.sqrt(np.mean((got - want) ** 2) / np.mean(want**2))))
        given = plume_probability(_on(ctx, mf).to(dtype), _on(ctx, g["rgb"]), state["params"],
                                  m).double().cpu().numpy()
        mask_gap = max(mask_gap, float(np.abs(pred.astype(np.float64) - given).max()))
    return [("mf_disagree", disagree, limits["mf_disagree"]),
            ("mf_rms_rel", rms, limits["mf_rms_rel"]),
            ("mask_gap", mask_gap, limits["mask_gap"]),
            ("nodata_mismatch", nodata, limits["nodata_mismatch"])]


def control_answers(ctx, state, dtype=torch.float32):
    """The references put in the program's place at the precision below the
    configuration's: the filter and the network in f32 with TF32 as the
    caller left it (``controls/readings.py`` turns it on for the control,
    off for the plain witness)."""
    k = min(int(ctx.traffic["check_samples"]), len(state["pool"]))
    state.pop("model", None)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    out = []
    for gi in range(k):
        mf = reference_mf(ctx, state, gi, dtype)
        pred = plume_probability(mf, _on(ctx, state["pool"][gi]["rgb"]), state["params"],
                                 ctx.config["model"], tf32=tf32)
        out.append((gi, pred.double().cpu().numpy(), mf.double().cpu().numpy()))
    return out
