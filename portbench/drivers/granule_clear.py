"""Granule latency on a clear granule through the library's default call:
the granule cell's closed loop (``drivers/granule.py``: its window, check,
request sampling and program readings as they are) with every pixel valid,
no valid mask handed to ``emit_granule_to_mask`` and the traffic's column
step (54, the entry's default: 23 whole blocks of the 1,242 columns), so the
filter takes the resident route (``acrwl1mf_resident``: ``init_stats`` and
``filter_round``) rather than the masked one.

The traffic's column step is the filter's in this cell: set-up puts it into
the configuration that the check hands to the reference. Set-up asserts
that every pixel of the pool is valid and that a warm-up request takes the
resident route (a count of the program's ``acrwl1mf_resident`` calls over
it).
"""

from __future__ import annotations

from portbench.drivers.granule import (  # noqa: F401 -- the granule cell's, as they are
    STREAM_DTYPES,
    check,
    compare,
    control_answers,
    granule_params,
    program_answers,
    window,
)
from portbench.recipes.granule import make_pool
from portbench.recipes.template import emit_template
from portbench.recipes.weights import load_into, make_params


def _resident_calls(request, g) -> int:
    """Calls of the program's resident filter over one request of ``g``."""
    from starcop_tpu_torch.ops import mag1c_kernels

    real, calls = mag1c_kernels.acrwl1mf_resident, []

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    mag1c_kernels.acrwl1mf_resident = counted
    try:
        request(g)
    finally:
        mag1c_kernels.acrwl1mf_resident = real
    return len(calls)


def setup(ctx):
    from starcop_tpu_torch.models.segmenter import SegmentationModel
    from starcop_tpu_torch.ops import _build
    from starcop_tpu_torch.scenes.emit_pipeline import emit_granule_to_mask

    ctx.stage("import")
    if ctx.device.type == "cuda":
        _build.load()
    ctx.stage("build_or_load")

    step = int(ctx.traffic["column_step"])
    ctx.config = {**ctx.config, "filter": {**ctx.config["filter"], "column_step": step}}
    p = granule_params(ctx)
    template = emit_template(ctx.config)
    pool = make_pool(ctx.seed, template, p, ctx.device)
    if not all(g["valid"].all() for g in pool) or p["samples"] % step:
        raise RuntimeError("the clear cell's granules are valid at every pixel, in whole "
                           "column blocks")
    ctx.stage("inputs")

    params = make_params(ctx.seed, ctx.device)
    model = SegmentationModel(input_products=ctx.config["model"]["input_products"])
    load_into(model.network, params)
    model = model.to(ctx.device).eval()
    ctx.stage("model")

    def model_apply(x):
        with ctx.span("unet"):
            return model(x)

    kwargs = dict(column_step=step, num_iter=int(p["num_iter"]), alpha=float(p["alpha"]),
                  stream_dtype=STREAM_DTYPES[p["stream_dtype"]], device=ctx.device)

    def request(g):
        with ctx.span("request"):
            pred, mf = emit_granule_to_mask(g["cube"], g["rgb"], template, model_apply,
                                            **kwargs)
            with ctx.span("download"):
                return pred.cpu().numpy(), mf.cpu().numpy()

    state = {"model": model, "params": params, "pool": pool, "template": template,
             "request": request}
    if _resident_calls(request, pool[0]) != 1:
        raise RuntimeError("the clear granule takes the resident route")
    for i in range(1, int(p["warmup_requests"])):
        request(pool[i % len(pool)])
    ctx.synchronize()
    ctx.stage("warmup")
    return state
