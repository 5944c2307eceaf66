"""Served granules: a backlog drained through the program's ``ScenePipeline``
at the serving CLI's defaults (``cli/serve.py``): the reader stage encodes
each granule's wire payload (``encode_payload``) and starts its upload
(``Uploader``), the compute stage (``make_compute_fn``) decodes it, runs the
masked filter and the U-Net and downloads both products in one f16 transfer,
and the writer stage is this file's sink, which counts each granule, keeps a
seeded sample of the outputs for the check and drops the rest: no GeoTIFF is
written.

The reader maps names to a pool of granules made on the device from the seed
and held in host memory (``recipes/granule.py``), in the reader's
``read_granule`` form. A granule is served in the window when its outputs
reach the writer stage inside it.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench.recipes.granule import FILL, make_pool
from portbench.recipes.template import band_centers, emit_template
from portbench.recipes.weights import load_into, make_params
from portbench.reference.granule import granule_to_mask, plume_probability
from portbench.reference.mag1c import NODATA, column_blocks
from portbench.reference.unet import fp8_round

MODEL_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


class Sink:
    """The writer stage: the time each granule's outputs arrive, and a
    reservoir (seeded) of the outputs themselves."""

    def __init__(self, ctx, k: int):
        self.ctx, self.k = ctx, k
        self.rng = np.random.default_rng([ctx.seed, 2])
        self.arrivals, self.kept = [], []

    def __call__(self, name, outputs):
        with self.ctx.span("write"):
            self.arrivals.append(time.perf_counter())
            item = (int(name), outputs["prediction"], outputs["mag1c"])
            n = len(self.arrivals)
            if len(self.kept) < self.k:
                self.kept.append(item)
            else:
                j = int(self.rng.integers(0, n))
                if j < self.k:
                    self.kept[j] = item
            outputs.clear()


def setup(ctx):
    from starcop_tpu_torch.models.segmenter import SegmentationModel, cast_for_inference
    from starcop_tpu_torch.ops import _build
    from starcop_tpu_torch.serve.pipeline import (
        ScenePipeline,
        Uploader,
        encode_payload,
        make_compute_fn,
    )

    ctx.stage("import")
    if ctx.device.type == "cuda":
        _build.load()
    ctx.stage("build_or_load")
    t = ctx.traffic
    p = {**ctx.config["granule"], **ctx.config["filter"], **t}
    template = emit_template(ctx.config)
    g = ctx.config["granule"]
    centers = band_centers(g["wavelength_range"], g["band_spacing_nm"])
    pool = make_pool(ctx.seed, template, p, ctx.device)
    granules = [{"cube": x["cube"], "rgb": np.ascontiguousarray(np.moveaxis(x["rgb"], 0, -1)),
                 "fill_value": FILL, "wavelengths": centers,
                 "fwhm": np.full_like(centers, g["fwhm_nm"]), "glt": None, "transform": None,
                 "crs_epsg": None} for x in pool]
    ctx.stage("inputs")

    params = make_params(ctx.seed, ctx.device)
    model = SegmentationModel(input_products=ctx.config["model"]["input_products"])
    load_into(model.network, params)
    if MODEL_DTYPES[t["model_dtype"]] is not None:
        cast_for_inference(model, MODEL_DTYPES[t["model_dtype"]])
    model = model.to(ctx.device).eval()
    ctx.stage("model")

    def model_apply(x):
        with ctx.span("unet"):
            return model(x)

    upload = Uploader(ctx.device)
    compute_fn = make_compute_fn(model_apply, ctx.device, column_step=int(p["column_step"]),
                                 num_iter=int(p["num_iter"]), download_dtype=t["download_dtype"],
                                 stream_dtype=None)

    def read(name):
        with ctx.span("read"):
            return upload(encode_payload(granules[int(name)], t["upload_dtype"]))

    def compute(payload):
        with ctx.span("compute"):
            return compute_fn(payload)

    state = {"model": model, "params": params, "pool": pool, "template": template,
             "read": read, "compute": compute, "ScenePipeline": ScenePipeline}
    warm = Sink(ctx, 0)
    ScenePipeline(read, compute, warm, queue_size=int(t["queue_size"])).run(
        [str(i % len(pool)) for i in range(int(t["warmup_granules"]))])
    ctx.synchronize()
    ctx.stage("warmup")
    return state


def window(ctx, state, seconds: float):
    t = ctx.traffic
    pool = state["pool"]
    sink = Sink(ctx, int(t["check_samples"]))
    pipeline = state["ScenePipeline"](state["read"], state["compute"], sink,
                                      queue_size=int(t["queue_size"]))
    t0 = time.perf_counter()
    t_end = t0 + seconds

    def backlog():
        i = 0
        while time.perf_counter() < t_end:
            yield str(i % len(pool))
            i += 1

    results = pipeline.run(backlog())
    served = sum(1 for a in sink.arrivals if a <= t_end)
    ok = [r for r in results if r.error is None]
    timed = ok[:served]
    return {"e2e": {"served_granules_per_s": served / seconds},
            "attempted": len(results), "failed": len(results) - len(ok), "served": served,
            "seconds": seconds, "kept": sink.kept,
            "read_s": [r.timings["read_s"] for r in timed],
            "compute_s": [r.timings["compute_s"] for r in timed],
            "valid_pixels": [pool[int(r.name)]["valid_pixels"] for r in timed]}


def check(ctx, state, result):
    """The sampled served outputs against the reference (``compare``)."""
    for key in ("model", "read", "compute"):
        state.pop(key, None)
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    return compare(ctx, state, result["kept"], torch.float64)


def served_params(ctx, state):
    """The weights as the served model holds them (bf16-resident: rounded to
    bf16, batch-norm statistics too)."""
    dt = MODEL_DTYPES[ctx.traffic["model_dtype"]]
    return state["params"] if dt is None else {k: v.to(dt) for k, v in state["params"].items()}


def compare(ctx, state, answers, dtype):
    """[(name, value, limit)] of ``answers`` [(granule, prediction, mf)] as
    the writer received them, against the reference in ``dtype``:

    * the filter: the share of valid pixels on which the served mf and the
      reference's fall on different sides of ``mf_threshold``, and the
      root-mean-square gap of mf over the reference's;
    * the U-Net: the largest gap between the served mask and the
      reference's mask computed from the served mf (as the f16 wire brought
      it) with the served weights;
    * the NODATA pixels, exactly."""
    limits, thr = ctx.traffic["limits"], float(ctx.traffic["mf_threshold"])
    f = ctx.config["filter"]
    tt = lambda a: torch.as_tensor(a, device=ctx.device)  # noqa: E731
    refs = {}
    for gi in sorted({gi for gi, _, _ in answers}):
        g = state["pool"][gi]
        refs[gi] = column_blocks(tt(g["cube"]), state["template"], tt(g["valid"]),
                                 column_step=f["column_step"], num_iter=f["num_iter"],
                                 alpha=f["alpha"], dtype=dtype)[0].double().cpu().numpy()
    weights = served_params(ctx, state)
    disagree = rms = mask_gap = nodata = 0.0
    for gi, pred, mf in answers:
        g = state["pool"][gi]
        valid = g["valid"]
        nodata = max(nodata, float(np.count_nonzero((mf == NODATA) != ~valid)))
        got, want = mf[valid].astype(np.float64), refs[gi][valid]
        disagree = max(disagree, float(np.mean((got > thr) != (want > thr))))
        rms = max(rms, float(np.sqrt(np.mean((got - want) ** 2) / np.mean(want**2))))
        given = plume_probability(tt(mf).to(dtype), tt(g["rgb"]), weights,
                                  ctx.config["model"]).double().cpu().numpy()
        pred = pred.astype(np.float64)
        mask_gap = max(mask_gap, float(np.abs(pred - given).max()))
    return [("mf_disagree", disagree, limits["mf_disagree"]),
            ("mf_rms_rel", rms, limits["mf_rms_rel"]),
            ("mask_gap", mask_gap, limits["mask_gap"]),
            ("nodata_mismatch", nodata, limits["nodata_mismatch"])]


def program_answers(ctx, state):
    """The served outputs of one granule a sampled pool entry through the
    pipeline (for readings outside a window)."""
    k = min(int(ctx.traffic["check_samples"]), len(state["pool"]))
    sink = Sink(ctx, k)
    state["ScenePipeline"](state["read"], state["compute"], sink,
                           queue_size=int(ctx.traffic["queue_size"])).run(
        [str(i) for i in range(k)])
    return sorted(sink.kept, key=lambda a: a[0])


def control_answers(ctx, state, dtype=torch.float32):
    """The reference in the program's place at the precision below the
    served one: the filter in f32 with TF32 on (below the f32 stream), the
    U-Net's convolutions on fp8 (e4m3) operands (below the bf16 weights)."""
    k = min(int(ctx.traffic["check_samples"]), len(state["pool"]))
    state.pop("model", None)
    out = []
    for gi in range(k):
        g = state["pool"][gi]
        tt = lambda a: torch.as_tensor(a, device=ctx.device)  # noqa: E731
        pred, mf = granule_to_mask(tt(g["cube"]), tt(g["rgb"]), tt(g["valid"]),
                                   state["template"], served_params(ctx, state), ctx.config,
                                   dtype=dtype, rounding=fp8_round)
        out.append((gi, pred.double().cpu().numpy(), mf.double().cpu().numpy()))
    return out
