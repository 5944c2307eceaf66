#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (starcop_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs a CUDA card and nvcc

Drives the port's main path, raw EMIT granule -> plume mask, at the full
bench geometry (1280 x 1242 x 50, column_step 54, 30 iterations, alpha 1e-4,
synthetic scene seed 0, a seeded full-width MobileNetV2 U-Net), and holds
every hand-written kernel against its plain torch twin on the card:

  1. device: the card's name and power limit (nvidia-smi);
  2. build: the CUDA kernels from starcop_tpu_torch/csrc with nvcc (sm_90a);
  3. init_stats vs init_stats_plain in float64: m0 and C0 within 1e-5
     (max abs error over max abs value);
  4. filter_round and filter_glue on the main path's inputs: the kernel's
     error against the float64 twin is at most 4x the float32 twin's (the
     two differ only in summation order) plus 1e-6; then the whole filter
     vs resident_filter_plain: finite, mf correlation > 0.9999 with the f32
     twin run from the kernel route's own Woodbury base, threshold-500 agreement >= 0.999 with the f64 twin (detections
     > 0), albedo within rtol 1e-4 of the f64 twin, and bitwise equal on a
     rerun;
  5. emit_granule_to_mask on a seeded U-Net whose output spreads over
     (0, 1) (Kaiming-normal convolutions, randomised batch-norm statistics),
     with launch counts zeroed just before and read just after: each kernel
     launched as often as one filter needs, mask (1280, 1242) finite in
     [0, 1] with a standard deviation > 0.05, correlation > 0.9999 with the
     same path on the plain filter and >= 99.9% of pixels within 1e-3 of it;
  6. CUDA-event timings (median over >= 10 samples after warm-up), and one
     torch.profiler trace of granule -> mask (device busy share, top kernels);
  7. the masked route (TPU kernels 5 and 6) on a served granule: synthetic
     seed 0 at 1280 x 1242 x 50, column_step 32 (39 blocks, the last 26
     columns wide), with the fill value -9999 over rows 0-127 of columns
     0-319, in one band of 0.6 % scattered pixels and over all of block 20.
     init_stats_masked within 1e-5 of its f64 twin on the blocks with valid
     pixels; filter_round_masked (FIRST, LOOP, FINAL) and filter_glue with n
     per block within 4x the f32 twin's error against the f64 twin + 1e-6;
     the whole masked filter finite at valid pixels, the fill value exactly
     at invalid ones and across block 20, threshold-500 agreement >= 0.999
     with the f64 twin (detections > 0), albedo within 1e-4, a rerun bitwise
     equal;
  8. the served path: ScenePipeline over 4 such granules (seeds 0-3) with
     the seeded U-Net, the f32 and the u12 upload, the default f16 download,
     GeoTIFFs written to a temporary directory. No scene error; per granule
     1 / 31 / 30 launches of init_stats_masked / filter_round_masked /
     filter_glue and none of the resident kernels; the GeoTIFFs read back
     equal; mask std > 0.05; mask correlation > 0.9999 with the plain-twin
     filter path; f16 download within 4.9e-4 (prediction) and 2^-11
     (mag1c, relative) of an f32 download, NODATA exact; u12 upload
     threshold-500 agreement >= 0.999 with the f32 upload; granule 0's
     served mag1c (f32 and f16 download) against phase 7's plain-twin filter:
     correlation > 0.9999, threshold-500 agreement >= 0.999 with detections,
     NODATA equal. Pipeline wall time, granules/s, the compute stage and the
     u12 host encode are timed;
  9. the u12, u10 and u16 wires of two granules uploaded back to back,
     decoded on the card and held against the host's decode of the same
     payload: within half a quantization step, the valid mask exact.

Prints the card line, "timings" and "profile" JSON lines and a "kernels" JSON
line, and ends with {"ok": true, "device": {...}}. Any failed check exits non-zero
without the ok line. Peak rates for the bounds are NVIDIA's H100 SXM data
sheet figures (3.35 TB/s HBM, 67 TFLOP/s float32 outside the tensor cores).
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

H, W, STEP, NUM_ITER, ALPHA = 1280, 1242, 54, 30, 1e-4
MSTEP, FILL = 32, -9999.0  # the serving default column_step; EMIT's fill value
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
REPLACES = "starcop_tpu/ops/mag1c_pallas.py"


class CheckFailed(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    print(("PASS " if ok else "FAIL ") + what, flush=True)
    if not ok:
        raise CheckFailed(what)


def rel_err(a, ref) -> float:
    """max |a - ref| / max |ref| (float64)."""
    a, ref = a.double(), ref.double()
    return float((a - ref).abs().max() / ref.abs().max().clamp_min(1e-300))


def cuda_ms(fn, *, reps: int = 12, inner: int = 1, warmup: int = 2) -> float:
    """Median device time of one call of ``fn`` in ms: ``inner`` back-to-back
    calls between two CUDA events, ``reps`` samples, after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def bound_ms(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def profile_granule(run, label: str = "granule_to_mask") -> None:
    """Information, not a check: one traced run (``label``) with
    torch.profiler; prints the device's busy share of the traced window and
    the kernels that took the most device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    # Only the tracer may fail quietly; an error of ``run`` itself propagates.
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    try:
        prof.start()
    except Exception as err:  # noqa: BLE001 -- information only; a tracer may be missing
        print(f"profile: unavailable ({type(err).__name__}: {err})", flush=True)
        return
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    try:
        run()
    finally:
        end.record()
        end.synchronize()
        prof.stop()
    # Device-side rows only (kernels, copies): operator rows repeat them.
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    wall_us = start.elapsed_time(end) * 1e3
    busy_us = sum(e.self_device_time_total for e in events)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    print("profile " + json.dumps({
        "run": label, "window_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
        "idle_share": (1 - busy_us / wall_us) if wall_us > 0 else None,
        "top": [{"name": e.key[:60], "count": e.count, "ms": e.self_device_time_total / 1e3}
                for e in top]}), flush=True)


def corr(a, b) -> float:
    """Pearson correlation of two arrays or tensors, in float64."""
    flat = lambda t: (t.double().cpu().numpy() if hasattr(t, "cpu")  # noqa: E731
                      else np.asarray(t, np.float64)).ravel()
    return float(np.corrcoef(flat(a), flat(b))[0, 1])


def masked_granule(seed: int, centers, fwhm) -> dict:
    """A served granule at 1280 x 1242 x 50 in ``serve.pipeline.read_granule``'s
    form: ``synthetic_scene`` (seed) with the sensor fill in every band over
    a partial-granule region (rows 0-127 of columns 0-319: blocks 0-9 of
    step 32 partly invalid), in one band of 0.6 % scattered pixels, and over
    all of block 20 (columns 640-671). ``valid`` is the reader's rule: no
    band at the fill value."""
    from starcop_tpu_torch.data.synthetic import synthetic_scene
    from starcop_tpu_torch.ops.ch4_template import generate_template_from_bands

    template = generate_template_from_bands(centers, fwhm)[:, 1]
    sc = synthetic_scene(np.random.default_rng(seed), H, W, n_plumes=6, template=template)
    cube = sc["radiance"]
    cube[:128, :320, :] = FILL
    cube[:, 20 * MSTEP:21 * MSTEP, :] = FILL
    rng = np.random.default_rng(1000 + seed)
    rows, cols = np.nonzero(rng.random((H, W)) < 0.006)
    cube[rows, cols, rng.integers(0, cube.shape[-1], rows.size)] = FILL
    return {"cube": cube, "rgb": sc["rgb"], "fill_value": FILL, "wavelengths": centers,
            "fwhm": fwhm, "glt": None, "transform": None, "crs_epsg": None,
            "valid": ~(cube == FILL).any(-1)}


def masked_phase(dev, template, granule):
    """The weighted route (TPU kernels 5 and 6) on a served granule: each
    masked kernel against its f64 and f32 twins, then the whole masked
    filter. Returns (kernel-row dicts without launches, the filter_glue
    errors with n per block, timings, the f32 twin's (H, W) mf on the kernel
    route's Woodbury base with the fill at invalid pixels)."""
    import torch

    from starcop_tpu_torch.ops import mag1c_kernels as mk
    from starcop_tpu_torch.ops.mag1c import mag1c_column_blocks, unblock_columns

    x = torch.as_tensor(granule["cube"], device=dev)
    valid = torch.as_tensor(granule["valid"], device=dev)
    tpl = torch.as_tensor(template, dtype=torch.float32, device=dev)
    x64, tpl64 = x.double(), tpl.double()
    nb, s, p = -(-W // MSTEP), x.shape[-1], H * MSTEP
    counts = mk.block_valid_counts(valid, nb, MSTEP)
    live = counts > 0
    n = counts.clamp(min=1).float()
    n_valid = int(counts.sum())
    print(f"masked granule: {n_valid} of {H * W} pixels valid, {int((~live).sum())} of {nb} "
          f"blocks empty, last block {W - (nb - 1) * MSTEP} columns wide", flush=True)
    check(not bool(live[20]) and bool(live.sum() == nb - 1), "block 20 wholly invalid, others live")
    rows = {}

    # init_stats_masked ---------------------------------------------------------
    m0, c0 = mk.init_stats_masked(x, valid, nb, MSTEP)
    m0_64, c0_64 = mk.init_stats_masked_plain(x64, valid, nb, MSTEP)
    m0_32, c0_32 = mk.init_stats_masked_plain(x, valid, nb, MSTEP)
    e_m0, e_c0 = rel_err(m0[live], m0_64[live]), rel_err(c0[live], c0_64[live])
    check(e_m0 <= 1e-5 and e_c0 <= 1e-5,
          f"init_stats_masked vs f64 twin on live blocks: m0 rel err {e_m0:.3e}, "
          f"C0 rel err {e_c0:.3e} (<= 1e-5)")
    check(bool((m0[~live] == 0).all() and (c0[~live] == 0).all()),
          "init_stats_masked: the empty block gets m0 = 0, C0 = 0")
    rows["init_stats_masked"] = dict(
        rel_err=max(e_m0, e_c0),
        max_abs_err=max(float((m0 - m0_32).abs().max()), float((c0 - c0_32).abs().max())),
        check="m0, C0 rel err vs f64 twin <= 1e-5 on blocks with valid pixels")

    # filter_round_masked (FIRST / LOOP / FINAL) and filter_glue with n per block
    k0, tgt0, cit0, norm0 = mk._woodbury_base(c0, m0, tpl, ALPHA)
    k0 = k0.contiguous()
    carry = mk.pack_carry(tgt0, cit0, norm0)
    d64 = lambda t: None if t is None else t.double()  # noqa: E731

    def round_errs(mode, carry_in, r_in, mf_in):
        args = dict(mode=mode, cov_scale=1.0)
        out_k = mk.filter_round_masked(x, valid, nb, MSTEP, m0, carry_in, r_in, mf_in, **args)
        out_32 = mk.filter_round_masked_plain(x, valid, nb, MSTEP, m0, carry_in, r_in, mf_in,
                                              **args)
        out_64 = mk.filter_round_masked_plain(x64, valid, nb, MSTEP, d64(m0), d64(carry_in),
                                              d64(r_in), d64(mf_in), **args)
        pick = lambda o: [o[0][live], o[1][live]] + (  # noqa: E731
            [] if o[2] is None else [o[2].sum(1)[live]])
        ek = max(rel_err(a, b) for a, b in zip(pick(out_k), pick(out_64)))
        ep = max(rel_err(a, b) for a, b in zip(pick(out_32), pick(out_64)))
        ab = max(float((a - b).abs().max()) for a, b in zip(pick(out_k), pick(out_32)))
        return out_k, ek, ep, ab

    glue_kw = dict(m0=m0, template=tpl, k0=k0, n=n, alpha=ALPHA)
    (mf1, r1, st1), ek_f, ep_f, ab_f = round_errs(mk.FIRST, carry, None, None)
    carry_k = mk.filter_glue(st1, carry, **glue_kw)
    carry_32 = mk.filter_glue_plain(st1.sum(1, keepdim=True), carry, **glue_kw)
    carry_64 = mk.filter_glue_plain(d64(st1).sum(1, keepdim=True), d64(carry), m0=d64(m0),
                                    template=tpl64, k0=d64(k0), n=n.double(), alpha=ALPHA)
    ek_g = rel_err(carry_k[live], carry_64[live])
    ep_g = rel_err(carry_32[live], carry_64[live])
    check(ek_g <= 4 * ep_g + 1e-6,
          f"filter_glue (n per block) vs f64 twin: rel err {ek_g:.3e} (f32 twin {ep_g:.3e})")
    rows["filter_glue"] = dict(rel_err=ek_g,
                               max_abs_err=float((carry_k - carry_32)[live].abs().max()))
    (mf2, _, st2), ek_l, ep_l, ab_l = round_errs(mk.LOOP, carry_k, r1, mf1)
    _, ek_z, ep_z, ab_z = round_errs(mk.FINAL, mk.filter_glue(st2, carry_k, **glue_kw), r1, mf2)
    for mode, ek, ep in (("first", ek_f, ep_f), ("loop", ek_l, ep_l), ("final", ek_z, ep_z)):
        check(ek <= 4 * ep + 1e-6, f"filter_round_masked ({mode}) vs f64 twin: rel err "
                                   f"{ek:.3e} (f32 twin {ep:.3e})")
    rows["filter_round_masked_first"] = dict(
        rel_err=ek_f, max_abs_err=ab_f, check="rel err vs f64 twin <= 4x f32 twin's + 1e-6")
    rows["filter_round_masked_loop"] = dict(
        rel_err=max(ek_l, ek_z), max_abs_err=max(ab_l, ab_z),
        check="rel err vs f64 twin <= 4x f32 twin's + 1e-6 (LOOP and FINAL)")
    xbm, keepb = mk._masked_blocks(x, valid, nb, MSTEP)
    check(bool((r1[~keepb] == 1).all() and (mf1[~keepb] == 0).all()
               and (mf2[~keepb] == 0).all()),
          "filter_round_masked: mf = 0 and R = 1 wherever a pixel does not count")

    # the whole masked filter through the served route --------------------------
    kw = dict(column_step=MSTEP, num_iter=NUM_ITER, alpha=ALPHA, device=dev)
    mf_k, alb_k = mag1c_column_blocks(x, tpl, valid, **kw)
    base64 = mk._woodbury_base(c0_64, m0_64, tpl64, ALPHA)
    mf_64, r_64 = mk.masked_filter_plain(x64, valid, nb, MSTEP, m0_64, *base64, tpl64,
                                         num_iter=NUM_ITER, alpha=ALPHA)
    mf_64 = unblock_columns(mf_64, H, MSTEP)[:, :W]
    r_64 = unblock_columns(r_64, H, MSTEP)[:, :W]
    mf_32, _ = mk.masked_filter_plain(x, valid, nb, MSTEP, m0, k0, tgt0, cit0, norm0, tpl,
                                      num_iter=NUM_ITER, alpha=ALPHA)
    mf_32 = unblock_columns(mf_32, H, MSTEP)[:, :W]
    check(bool(torch.isfinite(mf_k[valid]).all() and torch.isfinite(alb_k[valid]).all()),
          "masked filter finite at valid pixels")
    check(bool((mf_k[~valid] == FILL).all() and (alb_k[~valid] == FILL).all()
               and (mf_k[:, 20 * MSTEP:21 * MSTEP] == FILL).all()),
          "masked filter: fill value exactly at invalid pixels and across block 20")
    c32 = corr(mf_k[valid].cpu(), mf_32[valid].cpu())
    check(c32 > 0.9999, f"masked filter mf correlation with the f32 twin on the kernel route's "
                        f"Woodbury base {c32:.7f} (> 0.9999)")
    det = int((mf_64[valid] > 500).sum())
    agree = float(((mf_k[valid] > 500) == (mf_64[valid] > 500)).double().mean())
    check(det > 0 and agree >= 0.999,
          f"masked threshold-500 agreement with f64 twin {agree:.6f} (>= 0.999), {det} detections")
    alb = float(((alb_k[valid].double() - r_64[valid]).abs() / r_64[valid].abs()).max())
    check(alb <= 1e-4, f"masked albedo rel err vs f64 twin {alb:.3e} (<= 1e-4)")
    mf_again, _ = mag1c_column_blocks(x, tpl, valid, **kw)
    check(bool(torch.equal(mf_again, mf_k)), "masked filter rerun bitwise identical")
    print(f"info: masked mf correlation with the f64 twin {corr(mf_k[valid].cpu(), mf_64[valid].cpu()):.7f}",
          flush=True)

    # timings of the masked kernels at this granule's shapes -----------------------
    n_round = -(-p // mk.ROUND_CHUNK)
    cube_bytes = 4.0 * n_valid * s + H * W  # the valid pixels' bands and the mask
    keepf = keepb.float()

    def library_masked_stats():
        cnt = keepf.sum(1).clamp(min=1)[:, None]
        xc = (xbm - (xbm.sum(1) / cnt)[:, None, :]) * keepf[..., None]
        return torch.bmm(xc.transpose(1, 2), xc) / cnt[..., None]

    plans = {
        "init_stats_masked": dict(
            kernel=lambda: mk.init_stats_masked(x, valid, nb, MSTEP),
            plain=lambda: mk.init_stats_masked_plain(x, valid, nb, MSTEP),
            library=library_masked_stats,
            bound=bound_ms(cube_bytes + 4.0 * nb * (s + s * s), n_valid * (s * (s + 1) + 2.0 * s)),
            replaces="1790", tpu_kernel="XLA einsum of the weighted statistics :1814-1824 "
                                        "(no Pallas kernel)"),
        "filter_round_masked_first": dict(
            kernel=lambda: mk.filter_round_masked(x, valid, nb, MSTEP, m0, carry, None, None,
                                                  mode=mk.FIRST),
            plain=lambda: mk.filter_round_masked_plain(x, valid, nb, MSTEP, m0, carry, None,
                                                       None, mode=mk.FIRST),
            library=None,
            bound=bound_ms(cube_bytes + 4.0 * (2 * nb * p + nb * 5 * s + nb * n_round * (s + 2)),
                           n_valid * (7.0 * s + 12)),
            replaces="594", tpu_kernel="_first_round_kernel (row 5)"),
        "filter_round_masked_loop": dict(
            kernel=lambda: mk.filter_round_masked(x, valid, nb, MSTEP, m0, carry_k, r1, mf1,
                                                  mode=mk.LOOP),
            plain=lambda: mk.filter_round_masked_plain(x, valid, nb, MSTEP, m0, carry_k, r1, mf1,
                                                       mode=mk.LOOP),
            library=None,
            bound=bound_ms(cube_bytes + 4.0 * (3 * nb * p + nb * 5 * s + nb * n_round * (s + 2)),
                           n_valid * (5.0 * s + 12)),
            replaces="664", tpu_kernel="_loop_round_kernel (row 6; LOOP and FINAL)"),
    }
    out = []
    for name, plan in plans.items():
        ms = cuda_ms(plan["kernel"], reps=7, inner=5)
        plain_ms = cuda_ms(plan["plain"], reps=5, inner=1, warmup=1)
        lib_ms = None if plan["library"] is None else cuda_ms(plan["library"], reps=5, warmup=1)
        bms, bby = plan["bound"]
        out.append(dict(
            name=name, route="cuda", source="starcop_tpu_torch/csrc/mag1c.cu",
            replaces=f"{REPLACES}:{plan['replaces']}", tpu_kernel=plan["tpu_kernel"],
            max_abs_err=rows[name]["max_abs_err"], rel_err_vs_f64=rows[name]["rel_err"],
            check=rows[name]["check"], ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=bby,
            library_ms=lib_ms))
    timings = {"masked_filter_ms": cuda_ms(lambda: mag1c_column_blocks(x, tpl, valid, **kw),
                                           reps=7)}
    return out, rows["filter_glue"], timings, torch.where(valid, mf_32, FILL)


def serving_phase(dev, model, granules, mf_plain0):
    """``ScenePipeline`` over the served granules (the reader stage encodes
    and uploads, the compute stage decodes, filters on the masked kernels,
    runs the U-Net and downloads once, the writer writes GeoTIFFs), once
    with the f32 and once with the u12 upload, both with the default f16
    download. Returns (launch counts of the f32 run, timings)."""
    import tempfile

    import torch

    from starcop_tpu_torch.data.geotiff import read_geotiff
    from starcop_tpu_torch.ops import mag1c_kernels as mk
    from starcop_tpu_torch.scenes.emit_pipeline import plume_mask
    from starcop_tpu_torch.serve import pipeline as sp

    names = [f"granule_{i}" for i in range(len(granules))]
    store = dict(zip(names, granules))
    upload = sp.Uploader(dev)
    compute = sp.make_compute_fn(model, dev, column_step=MSTEP, num_iter=NUM_ITER)
    compute_f32 = sp.make_compute_fn(model, dev, column_step=MSTEP, num_iter=NUM_ITER,
                                     download_dtype="f32")
    # The f32 download of granule 0 (also the warm-up): the f16 contract's reference.
    exact = compute_f32(upload(sp.encode_payload(granules[0], "f32")))
    g0 = granules[0]
    valid0, plain0 = g0["valid"], mf_plain0.cpu().numpy()

    def hold_mf(mf, what):
        """A served mag1c of granule 0 against the plain-twin filter (phase 7):
        what was encoded, uploaded, decoded, filtered and downloaded."""
        c = corr(mf[valid0], plain0[valid0])
        det = int((plain0[valid0] > 500).sum())
        agree = float(((mf[valid0] > 500) == (plain0[valid0] > 500)).mean())
        check(c > 0.9999 and det > 0 and agree >= 0.999
              and np.array_equal(mf == FILL, plain0 == FILL),
              f"{what} mag1c of granule 0 vs the plain-twin filter: correlation {c:.7f} "
              f"(> 0.9999), threshold-500 agreement {agree:.6f} (>= 0.999) over {det} "
              f"detections, NODATA equal")

    hold_mf(exact["mag1c"], "served (f32 upload, f32 download)")
    rgb0 = torch.as_tensor(np.moveaxis(g0["rgb"], -1, 0), device=dev)
    with torch.inference_mode():
        pred_plain = plume_mask(mf_plain0[None], rgb0[None], model)[0].cpu().numpy()
        pred_blind = plume_mask(torch.zeros_like(mf_plain0)[None], rgb0[None],
                                model)[0].cpu().numpy()
    pc = corr(exact["prediction"], pred_plain)
    check(pc > 0.9999, f"served mask correlation with the plain-twin filter path {pc:.8f} (> 0.9999)")
    # Information: how far the seeded model's mask moves with the filter at
    # all (barely: the mag1c checks, not the mask's, carry the served path).
    print(f"info: served mask correlation with the same model fed mf = 0: "
          f"{corr(exact['prediction'], pred_blind):.6f}", flush=True)

    runs, timings = {}, {}
    with tempfile.TemporaryDirectory() as out_dir:
        for codec in ("f32", "u12"):
            pipe = sp.ScenePipeline(lambda name, c=codec: upload(sp.encode_payload(store[name], c)),
                                    compute, sp.make_write_fn(os.path.join(out_dir, codec)))
            mk.reset_launch_counts()
            t0 = time.perf_counter()
            results = pipe.run(names)
            wall = time.perf_counter() - t0
            launches = dict(mk.LAUNCH_COUNTS)
            print(f"served launches ({codec} upload, {len(names)} granules): "
                  f"{json.dumps(launches)}", flush=True)
            errors = {r.name: r.error for r in results if r.error is not None}
            check(len(results) == len(names) and not errors,
                  f"{codec} upload: {len(results)} scenes served, errors {errors}")
            per = {k: v / len(names) for k, v in launches.items()}
            want = {"init_stats_masked": 1, "filter_round_masked_first": 1,
                    "filter_round_masked_loop": NUM_ITER, "filter_glue": NUM_ITER,
                    "init_stats": 0, "filter_round": 0}
            check(all(per[k] == v for k, v in want.items()),
                  f"{codec} upload: launches per granule {per} (want {want})")
            by_name = {r.name: r.outputs for r in results}
            for name in names:
                out = by_name[name]
                for key in ("mag1c", "prediction"):
                    back, meta = read_geotiff(os.path.join(out_dir, codec, name, f"{key}.tif"))
                    check(np.array_equal(back[0], out[key])
                          and meta.nodata == (FILL if key == "mag1c" else None),
                          f"{codec} {name}: {key}.tif reads back equal")
                check(float(out["prediction"].std()) > 0.05,
                      f"{codec} {name}: mask std {out['prediction'].std():.4f} (> 0.05)")
            runs[codec] = (results, by_name, launches)
            timings[f"pipeline_{codec}_ms_per_granule"] = wall * 1e3 / len(names)
            timings[f"pipeline_{codec}_granules_per_s"] = len(names) / wall
            for stage in ("read", "compute", "write"):  # host clock, per granule
                timings[f"pipeline_{codec}_{stage}_ms_median"] = 1e3 * statistics.median(
                    r.timings[f"{stage}_s"] for r in results)

    # The f16 download against the f32 download of granule 0.
    f16 = runs["f32"][1]["granule_0"]
    hold_mf(f16["mag1c"], "served (f32 upload, f16 download, pipeline)")
    d_pred = float(np.abs(f16["prediction"] - exact["prediction"]).max())
    mf16, mf32 = f16["mag1c"], exact["mag1c"]
    d_mf = float((np.abs(mf16 - mf32) / np.maximum(np.abs(mf32), 1.0))[valid0].max())
    check(d_pred <= 4.9e-4 and d_mf <= 2.0 ** -11 + 1e-7
          and np.array_equal(mf16 == FILL, ~valid0) and np.array_equal(mf32 == FILL, ~valid0),
          f"f16 download vs f32: prediction {d_pred:.2e} (<= 4.9e-4), mag1c rel {d_mf:.2e} "
          f"(<= 2^-11), NODATA exact at the invalid pixels")
    for name, g in zip(names, granules):
        a, b = runs["f32"][1][name]["mag1c"], runs["u12"][1][name]["mag1c"]
        ok = g["valid"]
        agree = float(((a > 500) == (b > 500))[ok].mean())
        check(agree >= 0.999 and int((a[ok] > 500).sum()) > 0,
              f"{name}: u12 vs f32 upload threshold-500 agreement {agree:.6f} (>= 0.999)")
    t0 = time.perf_counter()
    sp.encode_payload(g0, "u12")
    timings["u12_host_encode_ms"] = (time.perf_counter() - t0) * 1e3
    payload0 = upload(sp.encode_payload(g0, "f32"))
    timings["served_compute_ms"] = cuda_ms(lambda: compute(payload0), reps=5, warmup=1)
    profile_granule(lambda: compute(payload0), "served_granule")
    return runs["f32"][2], timings


def upload_phase(dev, granules):
    """Each quantized wire of ``granules`` uploaded back to back through one
    ``Uploader`` (a granule is staged while the previous one's copies may
    still be queued on the side stream), decoded on the card and held
    against ``decode_wire`` of the same payload on the CPU: cube and RGB
    within half a quantization step of their band, the valid mask exact.
    A staging buffer handed out twice would decode one band's offset with
    another array's values."""
    import torch

    from starcop_tpu_torch.serve import pipeline as sp

    upload, on_host = sp.Uploader(dev), sp.Uploader("cpu")
    for codec in ("u12", "u10", "u16"):
        payloads = [sp.encode_payload(g, codec) for g in granules]
        staged = [upload(p) for p in payloads]
        for i, (p, st) in enumerate(zip(payloads, staged)):
            torch.cuda.current_stream(dev).wait_event(st["ready"])
            got = [t.cpu() for t in sp.decode_wire(codec, st["wire"], H, W)]
            want = sp.decode_wire(codec, on_host(p)["wire"], H, W)
            step = torch.as_tensor(p["wire"]["q_scale"])
            rgb_step = torch.as_tensor(p["wire"]["rgb_scale"])[:, None, None]
            e_cube = float(((got[0] - want[0]).abs() / step).max())
            e_rgb = float(((got[1] - want[1]).abs() / rgb_step).max())
            check(e_cube <= 0.5 and e_rgb <= 0.5 and torch.equal(got[2], want[2]),
                  f"{codec} upload of granule {i} decoded on the card vs on the host: cube "
                  f"{e_cube:.2e}, RGB {e_rgb:.2e} quantization steps (<= 0.5), valid mask equal")


def seeded_model(dev, seed: int = 0):
    """A full-width SegmentationModel whose output spreads over (0, 1):
    Kaiming-normal (fan-out) convolutions, zero conv biases, batch-norm
    running means N(0, 0.05) and variances U(0.8, 1.2). At the default
    init the U-Net's output is nearly constant, and a mask check could not
    tell a wrong filter from a right one."""
    import torch
    from torch import nn

    from starcop_tpu_torch.models.segmenter import SegmentationModel

    gen = torch.Generator().manual_seed(seed)
    model = SegmentationModel()
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.Conv2d):
                nn.init.kaiming_normal_(mod.weight, mode="fan_out", generator=gen)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.BatchNorm2d):
                mod.running_mean.normal_(0.0, 0.05, generator=gen)
                mod.running_var.uniform_(0.8, 1.2, generator=gen)
    return model.to(dev).eval()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from starcop_tpu_torch.data.synthetic import synthetic_scene
    from starcop_tpu_torch.ops import _build
    from starcop_tpu_torch.ops import mag1c_kernels as mk
    from starcop_tpu_torch.ops.ch4_template import generate_template_from_bands
    from starcop_tpu_torch.ops.mag1c import block_columns, unblock_columns
    from starcop_tpu_torch.ops.padding import find_padding
    from starcop_tpu_torch.scenes.emit_pipeline import emit_granule_to_mask, plume_mask

    # 1. device --------------------------------------------------------------
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build ---------------------------------------------------------------
    t0 = time.perf_counter()
    _build.load()
    print(f"build+load {time.perf_counter() - t0:.1f} s (torch {torch.__version__}, "
          f"CUDA {torch.version.cuda})", flush=True)
    for line in _build.build_log().splitlines():
        if "registers" in line or "Compiling entry" in line:
            print("ptxas:", line.strip())

    centers = np.arange(2122.0, 2488.0, 7.4)
    template = generate_template_from_bands(centers, np.full_like(centers, 8.0))[:, 1]
    scene = synthetic_scene(np.random.default_rng(0), H, W, n_plumes=6, template=template)
    nb, s = W // STEP, len(template)
    p = H * STEP
    npix = H * W
    x = torch.as_tensor(scene["radiance"], device=dev)
    tpl = torch.as_tensor(template, dtype=torch.float32, device=dev)
    x64, tpl64 = x.double(), tpl.double()
    results = {}

    # 3. init_stats ----------------------------------------------------------
    m0, c0 = mk.init_stats(x, nb, STEP)
    m0_64, c0_64 = mk.init_stats_plain(x64, nb, STEP)
    m0_32, c0_32 = mk.init_stats_plain(x, nb, STEP)
    e_m0, e_c0 = rel_err(m0, m0_64), rel_err(c0, c0_64)
    check(e_m0 <= 1e-5 and e_c0 <= 1e-5,
          f"init_stats vs f64 twin: m0 rel err {e_m0:.3e}, C0 rel err {e_c0:.3e} (<= 1e-5)")
    results["init_stats"] = dict(
        rel_err=max(e_m0, e_c0),
        max_abs_err=max(float((m0 - m0_32).abs().max()), float((c0 - c0_32).abs().max())),
        check="m0, C0 rel err vs f64 twin <= 1e-5")

    # 4. filter_round / filter_glue on the main path's inputs ----------------
    k0, tgt0, cit0, norm0 = mk._woodbury_base(c0, m0, tpl, ALPHA)
    k0 = k0.contiguous()
    carry = mk.pack_carry(tgt0, cit0, norm0)
    d64 = lambda t: None if t is None else t.double()  # noqa: E731

    def round_errs(mode, carry_in, r_in, mf_in):
        args = dict(mode=mode, cov_scale=1.0)
        out_k = mk.filter_round(x, nb, STEP, m0, carry_in, r_in, mf_in, **args)
        out_32 = mk.filter_round_plain(x, nb, STEP, m0, carry_in, r_in, mf_in, **args)
        out_64 = mk.filter_round_plain(x64, nb, STEP, d64(m0), d64(carry_in), d64(r_in),
                                       d64(mf_in), **args)
        pick = lambda o: [o[0], o[1]] + ([] if o[2] is None else [o[2].sum(1)])  # noqa: E731
        ek = max(rel_err(a, b) for a, b in zip(pick(out_k), pick(out_64)))
        ep = max(rel_err(a, b) for a, b in zip(pick(out_32), pick(out_64)))
        ab = max(float((a - b).abs().max()) for a, b in zip(pick(out_k), pick(out_32)))
        return out_k, ek, ep, ab

    glue_kw = dict(m0=m0, template=tpl, k0=k0, n=p, alpha=ALPHA)
    (mf1, r1, st1), ek_f, ep_f, ab_f = round_errs(mk.FIRST, carry, None, None)
    carry_k = mk.filter_glue(st1, carry, **glue_kw)
    carry_32 = mk.filter_glue_plain(st1.sum(1, keepdim=True), carry, **glue_kw)
    carry_64 = mk.filter_glue_plain(d64(st1).sum(1, keepdim=True), d64(carry), m0=d64(m0),
                                    template=tpl64, k0=d64(k0), n=p, alpha=ALPHA)
    ek_g, ep_g = rel_err(carry_k, carry_64), rel_err(carry_32, carry_64)
    check(ek_g <= 4 * ep_g + 1e-6,
          f"filter_glue vs f64 twin: rel err {ek_g:.3e} (f32 twin {ep_g:.3e})")
    results["filter_glue"] = dict(rel_err=ek_g, max_abs_err=float((carry_k - carry_32).abs().max()),
                                  check="rel err vs f64 twin <= 4x f32 twin's + 1e-6")
    (mf2, _, st2), ek_l, ep_l, ab_l = round_errs(mk.LOOP, carry_k, r1, mf1)
    _, ek_z, ep_z, ab_z = round_errs(mk.FINAL, mk.filter_glue(st2, carry_k, **glue_kw), r1, mf2)
    for mode, ek, ep in (("first", ek_f, ep_f), ("loop", ek_l, ep_l), ("final", ek_z, ep_z)):
        check(ek <= 4 * ep + 1e-6,
              f"filter_round ({mode}) vs f64 twin: rel err {ek:.3e} (f32 twin {ep:.3e})")
    results["filter_round"] = dict(rel_err=max(ek_f, ek_l, ek_z), max_abs_err=max(ab_f, ab_l, ab_z),
                                   check="rel err vs f64 twin <= 4x f32 twin's + 1e-6")

    # 4b. the whole filter -----------------------------------------------------
    mf_k, r_k = mk.acrwl1mf_resident(x, tpl, nb, STEP, num_iter=NUM_ITER, alpha=ALPHA)
    # The f32 twin starts from the kernel route's own Woodbury base, so the
    # comparison holds filter_round + filter_glue against the plain twin on
    # the same inputs (init_stats was held against f64 above).
    base_k = (m0, k0, tgt0, cit0, norm0)
    mf_32, _ = mk.resident_filter_plain(x, nb, STEP, *base_k, tpl, num_iter=NUM_ITER,
                                        alpha=ALPHA)
    base64 = mk._woodbury_base(c0_64, m0_64, tpl64, ALPHA)
    mf_64, r_64 = mk.resident_filter_plain(x64, nb, STEP, m0_64, *base64, tpl64,
                                           num_iter=NUM_ITER, alpha=ALPHA)
    check(bool(torch.isfinite(mf_k).all() and torch.isfinite(r_k).all()), "filter output finite")
    check(corr(mf_k, mf_32) > 0.9999,
          f"filter mf correlation with f32 twin {corr(mf_k, mf_32):.7f} (> 0.9999)")
    # Information: the plain twin end to end in f32, covariance included.
    mf_32_own, _ = mk.resident_filter_plain(x, nb, STEP, m0_32,
                                            *mk._woodbury_base(c0_32, m0_32, tpl, ALPHA), tpl,
                                            num_iter=NUM_ITER, alpha=ALPHA)
    cond = torch.linalg.cond(mk._shrink_diag(c0_64, ALPHA))
    print(f"info: mf correlation with the f64 twin: kernel route {corr(mf_k, mf_64):.7f}, "
          f"f32 twin on its own f32 init stats {corr(mf_32_own, mf_64):.7f} (worst block "
          f"{min(corr(mf_32_own[b], mf_64[b]) for b in range(nb)):.5f}); condition number "
          f"of the shrunk covariances {float(cond.min()):.3g}..{float(cond.max()):.3g}",
          flush=True)
    det = int((mf_64 > 500).sum())
    agree = float(((mf_k > 500) == (mf_64 > 500)).double().mean())
    check(det > 0 and agree >= 0.999,
          f"threshold-500 agreement with f64 twin {agree:.6f} (>= 0.999), {det} detections")
    alb = float(((r_k.double() - r_64).abs() / r_64.abs()).max())
    check(alb <= 1e-4, f"albedo rel err vs f64 twin {alb:.3e} (<= 1e-4)")
    mf_again, _ = mk.acrwl1mf_resident(x, tpl, nb, STEP, num_iter=NUM_ITER, alpha=ALPHA)
    check(bool(torch.equal(mf_again, mf_k)), "filter rerun bitwise identical")

    # 4c. other template instantiations: 12 bands (one slot per lane) and the
    # 74-band AVIRIS-like default (three), odd heights and widths.
    for gh, gw, gstep, gtpl in ((100, 45, 15, -np.abs(np.sin(np.linspace(0.3, 9.4, 12)))),
                                (64, 64, 32, None)):
        g = synthetic_scene(np.random.default_rng(1), gh, gw, n_plumes=1, template=gtpl,
                            max_concentration=8000.0)
        gx = torch.as_tensor(g["radiance"], device=dev)
        gt = torch.as_tensor(g["template"], dtype=torch.float32, device=dev)
        gnb = gw // gstep
        gm0, gc0 = mk.init_stats(gx, gnb, gstep)
        ref = mk.init_stats_plain(gx.double(), gnb, gstep)
        e_init = max(rel_err(gm0, ref[0]), rel_err(gc0, ref[1]))
        gmf, _ = mk.acrwl1mf_resident(gx, gt, gnb, gstep, num_iter=5, alpha=ALPHA)
        gmf32, _ = mk.resident_filter_plain(gx, gnb, gstep, gm0,
                                            *mk._woodbury_base(gc0, gm0, gt, ALPHA), gt,
                                            num_iter=5, alpha=ALPHA)
        check(e_init <= 1e-5 and corr(gmf, gmf32) > 0.9999,
              f"{gh}x{gw}x{len(g['template'])} step {gstep}: init rel err {e_init:.2e}, "
              f"5-iteration mf correlation with f32 twin {corr(gmf, gmf32):.7f}")

    # 5. the slice: granule -> mask --------------------------------------------
    model = seeded_model(dev)
    rgb = np.ascontiguousarray(np.moveaxis(scene["rgb"], -1, 0))
    mk.reset_launch_counts()
    pred_d, mf_d = emit_granule_to_mask(scene["radiance"], rgb, template, model,
                                        column_step=STEP, num_iter=NUM_ITER, alpha=ALPHA)
    launches = dict(mk.LAUNCH_COUNTS)
    print("main-path launches:", json.dumps(launches), flush=True)
    # The main path runs exactly one filter: 1 init_stats, NUM_ITER + 1
    # passes and NUM_ITER glues, and none of the masked kernels.
    for name, want in (("init_stats", 1), ("filter_round", NUM_ITER + 1),
                       ("filter_glue", NUM_ITER), ("init_stats_masked", 0),
                       ("filter_round_masked_first", 0), ("filter_round_masked_loop", 0)):
        check(launches[name] == want, f"{name} launched {launches[name]} times on the main "
                                      f"path (one filter needs {want})")
    check(pred_d.is_cuda and mf_d.is_cuda, "granule -> mask returns tensors on the card")
    pred, mf_slice = pred_d.cpu().numpy(), mf_d.cpu().numpy()
    check(pred.shape == (H, W), f"mask shape {pred.shape}")
    check(bool(np.isfinite(pred).all() and pred.min() >= 0 and pred.max() <= 1),
          f"mask finite in [0, 1] (min {pred.min():.4f}, max {pred.max():.4f})")
    check(float(pred.std()) > 0.05, f"mask spread: std {pred.std():.4f} (> 0.05)")
    with torch.inference_mode():
        pred_plain = plume_mask(unblock_columns(mf_32, H, STEP)[None],
                                torch.as_tensor(rgb, device=dev)[None], model)[0].cpu().numpy()
    pcorr = float(np.corrcoef(pred.ravel().astype(np.float64),
                              pred_plain.ravel().astype(np.float64))[0, 1])
    check(pcorr > 0.9999, f"mask correlation with the plain-filter path {pcorr:.8f} (> 0.9999)")
    close = float((np.abs(pred - pred_plain) <= 1e-3).mean())
    check(close >= 0.999, f"mask within 1e-3 of the plain-filter path on {close:.6f} of pixels")
    check(np.array_equal(mf_slice, unblock_columns(mf_k, H, STEP).cpu().numpy()),
          "slice mf equals the filter run")

    # 6. timings -----------------------------------------------------------------
    n_round = -(-p // mk.ROUND_CHUNK)
    cube_bytes = 4.0 * npix * s
    xb = block_columns(x, nb, STEP)

    def library_stats():
        m = xb.mean(1, keepdim=True)
        xc = xb - m
        return torch.bmm(xc.transpose(1, 2), xc) / p

    timing_plan = {
        "init_stats": dict(
            kernel=lambda: mk.init_stats(x, nb, STEP),
            plain=lambda: mk.init_stats_plain(x, nb, STEP),
            library=library_stats,
            bound=bound_ms(cube_bytes + 4.0 * nb * (s + s * s), npix * (s * (s + 1) + 2.0 * s))),
        "filter_round": dict(
            kernel=lambda: mk.filter_round(x, nb, STEP, m0, carry_k, r1, mf1, mode=mk.LOOP),
            plain=lambda: mk.filter_round_plain(x, nb, STEP, m0, carry_k, r1, mf1, mode=mk.LOOP),
            library=None,
            bound=bound_ms(cube_bytes + 4.0 * (3 * npix + nb * 5 * s + nb * n_round * (s + 2)),
                           npix * (5.0 * s + 12))),
        "filter_glue": dict(
            kernel=lambda: mk.filter_glue(st1, carry, **glue_kw),
            plain=lambda: mk.filter_glue_plain(st1, carry, **glue_kw),
            library=None,
            bound=bound_ms(4.0 * nb * (n_round * (s + 2) + 10 * s + s * s),
                           nb * (10.0 * s * s + 40 * s))),
    }
    sources = {"init_stats": "_init_stats_swh_kernel (row 11)",
               "filter_round": "_resident_swh_kernel / _resident_filter_body (row 12)",
               "filter_glue": "_resident_swh_kernel / _glue_math :776 (row 12)"}
    lines = {"init_stats": 1332, "filter_round": 1361, "filter_glue": 1361}
    notes = {"init_stats": "one call = 2 __global__ launches (per-chunk partials, then the "
                           "f64 reduce); ms covers both"}
    kernels = []
    for name, plan in timing_plan.items():
        ms = cuda_ms(plan["kernel"], inner=10)
        plain_ms = cuda_ms(plan["plain"], inner=3)
        lib_ms = None if plan["library"] is None else cuda_ms(plan["library"], inner=3)
        bms, bby = plan["bound"]
        kernels.append(dict(
            name=name, route="cuda", source="starcop_tpu_torch/csrc/mag1c.cu",
            replaces=f"{REPLACES}:{lines[name]}", tpu_kernel=sources[name],
            launches=launches[name],
            max_abs_err=results[name]["max_abs_err"], rel_err_vs_f64=results[name]["rel_err"],
            check=results[name]["check"], ms=ms, plain_ms=plain_ms, bound_ms=bms,
            bound_by=bby, library_ms=lib_ms, **({"note": notes[name]} if name in notes else {})))

    pad_r, pad_c = find_padding(H, 32), find_padding(W, 32)
    unet_in = torch.rand((1, 4, H + sum(pad_r), W + sum(pad_c)), device=dev) * 60
    x_dev_rgb = torch.as_tensor(rgb, device=dev)
    with torch.inference_mode():
        timings = {
            "filter_ms": cuda_ms(lambda: mk.acrwl1mf_resident(x, tpl, nb, STEP,
                                                              num_iter=NUM_ITER, alpha=ALPHA)),
            "filter_plain_f32_ms": cuda_ms(lambda: mk.resident_filter_plain(
                x, nb, STEP, *base_k, tpl, num_iter=NUM_ITER, alpha=ALPHA), reps=10, warmup=1),
            "unet_forward_ms": cuda_ms(lambda: model(unet_in)),
            "granule_to_mask_ms": cuda_ms(lambda: emit_granule_to_mask(
                x, x_dev_rgb, template, model, column_step=STEP, num_iter=NUM_ITER,
                alpha=ALPHA)),
            "granule_to_mask_from_host_ms": cuda_ms(lambda: emit_granule_to_mask(
                scene["radiance"], rgb, template, model, column_step=STEP,
                num_iter=NUM_ITER, alpha=ALPHA), reps=10, warmup=1),
            "woodbury_base_ms": cuda_ms(lambda: mk._woodbury_base(c0, m0, tpl, ALPHA)),
        }
    # launches are the main path's counts, i.e. those of one filter.
    timings["filter_bound_ms"] = sum(k["bound_ms"] * k["launches"] for k in kernels)
    timings["filter_kernels_ms"] = sum(k["ms"] * k["launches"] for k in kernels)
    profile_granule(lambda: emit_granule_to_mask(x, x_dev_rgb, template, model,
                                                 column_step=STEP, num_iter=NUM_ITER,
                                                 alpha=ALPHA))

    # 7. the masked route (TPU kernels 5 and 6) on a served granule ---------------
    fwhm = np.full_like(centers, 8.0)
    granules = [masked_granule(seed, centers, fwhm) for seed in range(4)]
    masked_rows, glue_masked, masked_timings, mf_plain0 = masked_phase(dev, template,
                                                                       granules[0])

    # 8. the served path: ScenePipeline over 4 granules ------------------------------
    served, serving_timings = serving_phase(dev, model, granules, mf_plain0)

    # 9. the quantized uploads, decoded on the card, against the host decode ---------
    upload_phase(dev, granules[:2])
    per_granule = {k: v / len(granules) for k, v in served.items()}
    for row in masked_rows:
        row["launches"] = served[row["name"]]
        row["path"] = f"served granules ({len(granules)}, ScenePipeline, f32 upload)"
        if row["name"] == "init_stats_masked":
            row["note"] = notes["init_stats"]
    glue = next(k for k in kernels if k["name"] == "filter_glue")
    glue.update(served_launches=served["filter_glue"],
                served_rel_err_vs_f64=glue_masked["rel_err"],
                served_max_abs_err=glue_masked["max_abs_err"])
    masked_timings["masked_filter_bound_ms"] = (
        sum(k["bound_ms"] * per_granule[k["name"]] for k in masked_rows)
        + glue["bound_ms"] * per_granule["filter_glue"])
    masked_timings["masked_filter_kernels_ms"] = (
        sum(k["ms"] * per_granule[k["name"]] for k in masked_rows)
        + glue["ms"] * per_granule["filter_glue"])
    kernels += masked_rows
    print("timings " + json.dumps({"card": card, **timings, **masked_timings,
                                   **serving_timings}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except CheckFailed:
        sys.exit(1)
