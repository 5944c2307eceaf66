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
     rerun; the resident filter at 12 and 74 bands on small odd scenes; the
     round kernels' narrow-copy paths on shapes where no tile row starts on
     16 bytes (filter_round at 99 x 45 x 37, step 15; filter_round_masked
     at 99 x 47 x 37 with a ragged last block; filter_round_bsp f32 / bf16,
     unmasked / masked, filter_round_mono and fused_iter WOODBURY on the
     stream of the 99 x 45 x 37 cube), each FIRST / LOOP / FINAL within 4x
     the f32 twin's error against the f64 twin + 1e-6; the statistics kernel
     on odd geometries (init_stats at 99 x 45 x 37 step 15 and 60 x 50 x 128
     step 25, init_stats_masked at 99 x 47 x 37 and 60 x 72 x 128 with a
     ragged last block and a wholly invalid block) within 1e-5 of its f64
     twin, the empty block at m0 = 0 and C0 = 0, reruns bitwise equal; and
     filter_glue at S = 37 and S = 128 within 4x the f32 twin's error
     against the f64 twin + 1e-6, bitwise equal on a rerun; the stream
     statistics on the blocked streams of the same cubes (P = 1,485: 4-byte
     f32 copies and bf16 word copies; P = 1,500: 16-byte f32 copies and bf16
     word copies): init_stats_stream, init_stats_bsp (block 1 wholly
     invalid) and fused_iter CHOLESKY (first and not first, on the raw f32
     stream and on the masked centred stream with a (B, P) valid row that
     empties block 1), m0 / C0 / mean / covariance within 1e-5 of the f64
     twin and CHOLESKY's mf, mean and covariance within 4x the f32 twin's
     error + 1e-6, the empty block at 0, reruns bitwise equal;
     blocked_transpose, unmasked and masked (-9999 and NaN at invalid
     pixels), at 99 x 45 x 37 step 15 (4-byte copies, odd P = 1,485), 99 x
     47 x 37 (a ragged last block), 60 x 50 x 128 step 25 (block 1 wholly
     invalid) and step 176 (row segments narrower than the step; 8 x 352
     and, ragged, 8 x 290 x 128), each taking the geometry asserted, bitwise
     equal to its twin and on a rerun;
  5. emit_granule_to_mask on a seeded U-Net whose output spreads over
     (0, 1) and follows the filter (Kaiming-normal convolutions, randomised
     batch-norm statistics, the first layer's mag1c weights x MF_GAIN),
     with launch counts zeroed just before and read just after: each kernel
     launched as often as one filter needs, mask (1280, 1242) finite in
     [0, 1] with a standard deviation > 0.05, correlation > 0.9999 with the
     same path on the plain filter and >= 99.9% of pixels within 1e-3 of it,
     and correlation < 0.99 with the same model fed mf = 0;
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
     payload: within half a quantization step, the valid mask exact;
 10. the unmasked bf16 stream (stream_dtype=bf16, TPU rows 2, 9 and 10,
     whose statistics are phase 3's init_stats) on the bench scene:
     blocked_transpose (centred by m0, bf16) equal to its twin bitwise,
     filter_round_bsp (FIRST, LOOP, FINAL) within 4x the f32 twin's error
     against the f64 twin + 1e-6 on the same bf16 stream; the whole bf16
     filter with mf correlation > 0.9999 with the plain twin on its own
     Woodbury base, meeting the JAX bf16 contract (tests/test_mag1c.py:
     199-217, with at most 1e-5 of the pixels flipping decisively: see
     bf16_contract) against phase 4's f32 filter, bitwise equal on a rerun;
     emit_granule_to_mask at bf16 with counts zeroed around it: 1 / 1 / 31 /
     30 launches of init_stats / blocked_transpose / filter_round_bsp /
     filter_glue and no K1 or K2 round, and the same counts for
     emit_granule_to_mask_batched over two copies of the scene;
 11. the masked bf16 stream (bf16 dots, TPU rows 5-6) on phase 7's granule
     with the same per-kernel checks on the live blocks (init_stats_bsp
     within 1e-5 of its f64 twin), the fill value exact at invalid pixels,
     the whole filter against the plain twin at correlation > 0.999 and
     threshold-500 agreement >= 0.999, and no farther from the twin run in
     f64 than 4x the f32 twin is (bf16 dots amplify one-ulp differences; the
     decisive flips of the kernel and of both twins against the f32 route
     are printed); then ScenePipeline over the 4 granules with the bf16
     stream and the bf16-resident U-Net (cast_for_inference of the seeded
     model): no scene error, per granule 1 / 1 / 1 / 30 / 30 launches of
     blocked_transpose / init_stats_bsp / filter_round_bsp masked FIRST /
     LOOP+FINAL / filter_glue and nothing else, each served mag1c meeting
     the bf16 contract against phase 8's f32 served mag1c, and the
     bf16-resident mask correlating > 0.999 with the f32 model's on the same
     mf (tests/test_models.py:255).

 12. the kernels of the remaining routes on the bench blocks (TPU rows 3, 4,
     7-8, 9 at f32 and 10 on the blocked stream): blocked_transpose_shw (the
     band-major cube to the raw f32 stream, 56 rows) equal to its twin
     bitwise; init_stats_stream within 1e-5 of its f64 twin;
     filter_round_bsp on the raw stream (FIRST, LOOP, FINAL), fused_iter
     (WOODBURY and CHOLESKY, first and not first) and filter_round_mono
     (FIRST and LOOP: mf, R and the carry) within 4x the f32 twin's error
     against the f64 twin + 1e-6;
 13. their whole filters on the bench scene, launch counts zeroed just
     before and read just after each and checked equal to the design
     (mono 1 / 1 / 30 init_stats_stream / filter_round_mono FIRST / LOOP +
     FINAL and no filter_glue; woodbury 1 / 31 / 30 init_stats_stream /
     fused_iter / filter_glue; cholesky 1 / 31 init_stats_stream /
     fused_iter, its glue in torch; resident and shw 1 / 31 / 30, shw with
     one blocked_transpose_shw):
     acrwl1mf_fused(glue=mono, woodbury, cholesky, resident) on the raw f32
     stream and mag1c_column_blocks(scene_layout="shw") finite, with mf
     correlation > 0.9999 with phase 4's f32 twin, threshold-500 agreement
     >= 0.999 with its f64 twin (detections > 0) and albedo within 1e-4;
     mono, woodbury and shw at bf16 meeting bf16_contract against their f32
     route; every filter bitwise equal on a rerun; each filter timed beside
     the Woodbury base of the stream's statistics, and the mono, resident and
     cholesky filters traced;
 14. mag1c_column_blocks(num_iter=0), the rmf-only result that JAX routes
     to its plain filter, on the bench scene and on phase 7's served
     granule, with launch counts zeroed just before and read just after
     (no kernel launched), held against reference_oracle_acrwl1mf(num_iter=0)
     in float64 (per block, over the valid pixels of the served granule):
     finite, the fill value exactly at invalid pixels, threshold-500
     agreement >= 0.999 with detections.

Prints the card line, every kernel's registers, spills and static shared
memory from the build ("ptxas:" lines; a spill in any of the statistics
kernels' or blocked_transpose's instantiations fails the build check), each timed kernel's share of
its bound ("time ..."), "timings" and "profile" JSON lines and a "kernels"
JSON line, and ends with {"ok": true, "device": {...}}. Any failed check exits non-zero
without the ok line. Peak rates for the bounds are NVIDIA's H100 SXM data
sheet figures (3.35 TB/s HBM, 67 TFLOP/s float32 outside the tensor cores,
989 TFLOP/s dense bf16 on the tensor cores for products of bf16 inputs).
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
BF16_FLOP_PER_S = 989e12  # dense, tensor cores: the rate of products of bf16 inputs
REPLACES = "starcop_tpu/ops/mag1c_pallas.py"
MF_GAIN = 1000.0  # the seeded U-Net's first-layer gain on the mag1c channel


class CheckFailed(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    print(("PASS " if ok else "FAIL ") + what, flush=True)
    if not ok:
        raise CheckFailed(what)


def same_bits(a, b) -> bool:
    """Bitwise equality of two bf16 tensors (+0 and -0 apart)."""
    import torch

    return a.shape == b.shape and torch.equal(a.view(torch.int16), b.view(torch.int16))


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


def device_ms(fn, kernel: str, reps: int = 30) -> float:
    """Device time in ms per call of ``fn`` of the kernels whose name holds
    ``kernel``, from torch.profiler over ``reps`` calls after a warm-up: the
    kernel's own time. A CUDA-event timing of a few-microsecond kernel
    measures the host's launch gaps instead."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and kernel in e.key]
    check(sum(e.count for e in events) == reps, f"{kernel}: {reps} launches traced")
    return sum(e.self_device_time_total for e in events) / reps / 1e3


def host_us(fn, n: int = 200) -> float:
    """Host time of one call of ``fn`` in microseconds: ``n`` back-to-back
    calls on the host's clock after one warm-up call, the device waited for
    before and after but not in between (what the call costs the host)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / n * 1e6


def bound_ms(nbytes: float, flops: float, flop_rate: float = FP32_FLOP_PER_S):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flop_rate
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


# The statistics kernels, 4 instantiations each (T or MASKED x VEC16), whose
# 64 accumulators must stay in registers, and blocked_transpose (MASKED x
# VEC16), whose 8 converted values a lane must keep there too.
STATS_KERNELS = ("init_stats_partial_kernel", "stream_stats_partial_kernel",
                 "fused_iter_cholesky_partial_kernel", "blocked_transpose_kernel")


def stats_spills(log: str) -> dict:
    """{mangled kernel name: (spill store bytes, spill load bytes)} from the
    ptxas -v lines of a build log."""
    spills, name = {}, None
    for line in log.splitlines():
        if "Function properties for " in line:
            name = line.split("Function properties for ", 1)[1].strip()
        elif "spill stores" in line and name is not None:
            nums = [int(tok) for tok in line.replace(",", " ").split() if tok.isdigit()]
            spills[name] = (nums[1], nums[2])  # stack frame, spill stores, spill loads
            name = None
    return spills


def corr(a, b) -> float:
    """Pearson correlation of two arrays or tensors, in float64."""
    flat = lambda t: (t.double().cpu().numpy() if hasattr(t, "cpu")  # noqa: E731
                      else np.asarray(t, np.float64)).ravel()
    return float(np.corrcoef(flat(a), flat(b))[0, 1])


def print_share(name, ms, bms):
    print(f"time {name}: {ms:.4f} ms, bound {bms:.4f} ms, share of bound {bms / ms:.1%}",
          flush=True)


def kernel_rows(plans, fields, path):
    """One kernels-line row per plan (without launches): the kernel's, its
    plain twin's and the library call's times at this run's inputs, its
    bound, and the check fields."""
    out = []
    for name, plan in plans.items():
        ms = cuda_ms(plan["kernel"], reps=7, inner=5)
        plain_ms = cuda_ms(plan["plain"], reps=5, inner=1, warmup=1)
        lib_ms = None if plan["library"] is None else cuda_ms(plan["library"], reps=5, warmup=1)
        bms, bby = plan["bound"]
        print_share(name, ms, bms)
        out.append(dict(
            name=name, route="cuda", source=plan.get("source", "starcop_tpu_torch/csrc/mag1c.cu"),
            replaces=f"{REPLACES}:{plan['replaces']}", tpu_kernel=plan["tpu_kernel"], path=path,
            max_abs_err=fields[name]["max_abs_err"], rel_err_vs_f64=fields[name]["rel_err"],
            check=fields[name]["check"], ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=bby,
            share_of_bound=bms / ms, library_ms=lib_ms,
            **({"note": plan["note"]} if "note" in plan else {})))
    return out


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
    from starcop_tpu_torch.ops.mag1c_fused import acrwl1mf_fused

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
    n_round = mk.cube_geometry(x, nb, MSTEP).nchunks  # chunk records per block
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
    out = kernel_rows(plans, rows, "served granules (ScenePipeline, f32 upload)")
    timings = {"masked_filter_ms": cuda_ms(lambda: mag1c_column_blocks(x, tpl, valid, **kw),
                                           reps=7)}
    return out, rows["filter_glue"], timings, torch.where(valid, mf_32, FILL)


def serving_phase(dev, model, granules, mf_plain0):
    """``ScenePipeline`` over the served granules (the reader stage encodes
    and uploads, the compute stage decodes, filters on the masked kernels,
    runs the U-Net and downloads once, the writer writes GeoTIFFs), once
    with the f32 and once with the u12 upload, both with the default f16
    download. Returns (launch counts of the f32 run, its outputs by granule
    name, timings)."""
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
    return runs["f32"][2], runs["f32"][1], timings


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


def contract_terms(ref, got):
    """The terms of the JAX suite's bf16 detection contract
    (tests/test_mag1c.py:199-217) of ``got`` against the f32 result ``ref``:
    (indices of the decisive pixels, those outside [250, 1000] in ref, that
    fall on the other side of 500; the pixel count; agreement at 500; median
    relative error where ref > 1000; that pixel count; a text of up to 8
    flips)."""
    flat = lambda t: np.asarray(t.cpu() if hasattr(t, "cpu") else t, np.float64).ravel()  # noqa: E731
    a, b = flat(ref), flat(got)
    det_a, det_b = a > 500, b > 500
    flipped = np.flatnonzero((det_a != det_b) & ((a < 250) | (a > 1000)))
    agree = float((det_a == det_b).mean())
    big = a > 1000
    med = float(np.median(np.abs(b[big] - a[big]) / a[big])) if big.any() else float("nan")
    shown = "".join(f" [{i}: {a[i]:.1f} -> {b[i]:.1f}]" for i in flipped[:8])
    return flipped, a.size, agree, med, int(big.sum()), shown


def bf16_contract(ref, got, what: str) -> None:
    """The JAX suite's bf16 detection contract of ``got`` against the f32
    result ``ref`` (see contract_terms): decisive pixels on the same side of
    500, agreement > 0.995, median relative error < 2 % over detections.

    That suite asks for no decisive flip among ~1e3 pixels, a flip rate it
    can resolve to ~1e-3. A whole granule has ~1.5e6 pixels, and the L1
    reweighting pins a pixel whose mf touches 0 in an early round, so under
    a bf16 stream an isolated pixel can collapse from above 1000 to 0 or
    escape the pin: here at most 1e-5 of the pixels may flip decisively,
    and each flip is printed. Phase 11 shows the masked route's plain twin,
    in f32 and in f64, flipping alike (masked_bf16_phase)."""
    flipped, size, agree, med, n_big, shown = contract_terms(ref, got)
    allowed = int(1e-5 * size)
    check(len(flipped) <= allowed and agree > 0.995 and med < 0.02,
          f"{what}: {len(flipped)} decisive pixels of {size} differ (<= {allowed}){shown}; "
          f"agreement {agree:.6f} (> 0.995), median rel err {med:.2e} over {n_big} "
          f"detections (< 2e-2)")


def bsp_round_errs(xs, valid, step, m0, carry, r, mf, mode, bf16_dots, live, center=False):
    """filter_round_bsp against its f32 and f64 twins on the same stream
    over the blocks ``live``: (kernel outputs, kernel rel err vs the f64
    twin, the f32 twin's, max |kernel - f32 twin|)."""
    from starcop_tpu_torch.ops import mag1c_kernels as mk

    d64 = lambda t: None if t is None else t.double()  # noqa: E731
    args = dict(mode=mode, bf16_dots=bf16_dots, center=center)
    out_k = mk.filter_round_bsp(xs, valid, step, m0, carry, r, mf, **args)
    out_32 = mk.filter_round_bsp_plain(xs, valid, step, m0, carry, r, mf, **args)
    out_64 = mk.filter_round_bsp_plain(xs, valid, step, d64(m0), d64(carry), d64(r), d64(mf),
                                       **args)
    pick = lambda o: [o[0][live], o[1][live]] + (  # noqa: E731
        [] if o[2] is None else [o[2].sum(1)[live]])
    ek = max(rel_err(a, b) for a, b in zip(pick(out_k), pick(out_64)))
    ep = max(rel_err(a, b) for a, b in zip(pick(out_32), pick(out_64)))
    ab = max(float((a - b).abs().max()) for a, b in zip(pick(out_k), pick(out_32)))
    return out_k, ek, ep, ab


def bsp_rounds(xs, valid, step, m0, carry, glue_kw, bf16_dots, live, what, center=False):
    """FIRST, LOOP (after one glue) and FINAL passes of filter_round_bsp, each
    within 4x the f32 twin's error against the f64 twin + 1e-6. Returns
    (the kernel-row fields, the FIRST and LOOP outputs)."""
    from starcop_tpu_torch.ops import mag1c_kernels as mk

    first, ek_f, ep_f, ab_f = bsp_round_errs(xs, valid, step, m0, carry, None, None, mk.FIRST,
                                             bf16_dots, live, center)
    carry1 = mk.filter_glue(first[2], carry, **glue_kw)
    loop, ek_l, ep_l, ab_l = bsp_round_errs(xs, valid, step, m0, carry1, first[1], first[0],
                                            mk.LOOP, bf16_dots, live, center)
    _, ek_z, ep_z, ab_z = bsp_round_errs(xs, valid, step, m0, mk.filter_glue(loop[2], carry1,
                                                                             **glue_kw),
                                         first[1], loop[0], mk.FINAL, bf16_dots, live, center)
    errs = {}
    for mode, ek, ep, ab in (("first", ek_f, ep_f, ab_f), ("loop", ek_l, ep_l, ab_l),
                             ("final", ek_z, ep_z, ab_z)):
        check(ek <= 4 * ep + 1e-6, f"{what} ({mode}) vs f64 twin: rel err {ek:.3e} "
                                   f"(f32 twin {ep:.3e})")
        errs[mode] = (ek, ab)
    rule = "rel err vs f64 twin <= 4x f32 twin's + 1e-6 on the same bf16 stream"
    return errs, rule, first, (loop, carry1)


def bf16_phase(dev, x, tpl, mf_f32):
    """Phase 10, the unmasked bf16 stream at the bench geometry (TPU rows 2
    and 9; row 10's statistics are K1's init_stats, held in phase 3): each
    kernel against its twins, then the whole filter against the plain twin
    and against the f32 filter ``mf_f32`` (K1, (nb, P)). Returns
    (kernel-row dicts without launches, timings)."""
    import torch

    from starcop_tpu_torch.ops import mag1c_kernels as mk

    nb, s = W // STEP, x.shape[-1]
    rows, p, npix = mk.stream_rows(s), H * STEP, H * W
    fields = {}

    m0, c0 = mk.init_stats(x, nb, STEP)
    xs = mk.blocked_transpose(x, nb, STEP, rows, m0)
    check(same_bits(xs, mk.blocked_transpose_plain(x, nb, STEP, rows, m0))
          and same_bits(mk.blocked_transpose(x, nb, STEP, rows, m0), xs),
          "blocked_transpose (bf16, centred by m0) equals its twin bitwise, pad rows included; "
          "rerun bitwise identical")
    fields["blocked_transpose"] = dict(rel_err=0.0, max_abs_err=0.0,
                                       check="bitwise equal to its twin")

    k0, tgt0, cit0, norm0 = mk._woodbury_base(c0, m0, tpl, ALPHA)
    k0 = k0.contiguous()
    carry = mk.pack_carry(tgt0, cit0, norm0)
    glue_kw = dict(m0=m0, template=tpl, k0=k0, n=p, alpha=ALPHA)
    errs, rule, (mf1, r1, _), ((_, _, _), carry1) = bsp_rounds(
        xs, None, STEP, m0, carry, glue_kw, False, slice(None), "filter_round_bsp")
    fields["filter_round_bsp"] = dict(rel_err=max(e for e, _ in errs.values()),
                                      max_abs_err=max(a for _, a in errs.values()), check=rule)

    kw = dict(num_iter=NUM_ITER, alpha=ALPHA)
    mf_k, r_k = mk.acrwl1mf_resident_bsp(x, tpl, nb, STEP, device=dev, **kw)
    mf_32, _ = mk.bsp_filter_plain(xs, None, STEP, m0, k0, tgt0, cit0, norm0, tpl, p, **kw)
    check(bool(torch.isfinite(mf_k).all() and torch.isfinite(r_k).all()),
          "bf16 filter output finite")
    c32 = corr(mf_k, mf_32)
    check(c32 > 0.9999, f"bf16 filter mf correlation with the plain twin on its own Woodbury "
                        f"base {c32:.7f} (> 0.9999)")
    bf16_contract(mf_f32, mf_k, "bf16 filter vs the f32 filter (K1) on the same scene")
    print(f"info: bf16 filter mf correlation with the f32 filter {corr(mf_k, mf_f32):.7f}",
          flush=True)
    mf_again, _ = mk.acrwl1mf_resident_bsp(x, tpl, nb, STEP, device=dev, **kw)
    check(bool(torch.equal(mf_again, mf_k)), "bf16 filter rerun bitwise identical")

    n_round = mk.stream_geometry(xs, s).nchunks  # chunk records per block
    stream_bytes = 2.0 * npix * s  # the live band rows of the bf16 stream
    plans = {
        "blocked_transpose": dict(
            kernel=lambda: mk.blocked_transpose(x, nb, STEP, rows, m0),
            plain=lambda: mk.blocked_transpose_plain(x, nb, STEP, rows, m0),
            library=lambda: (x.reshape(H, nb, STEP, s).permute(1, 3, 0, 2)
                             - m0[:, :, None, None]).to(torch.bfloat16),
            bound=bound_ms(4.0 * npix * s + 4.0 * nb * s + stream_bytes, 1.0 * npix * s),
            note="library: permute, subtract and cast (no pad rows); bound: live band rows",
            replaces="170", tpu_kernel="_blocked_transpose_swh_kernel (row 2; row 1 "
                                       "_blocked_transpose_kernel :92 computes the same) and "
                                       "the XLA centre-and-cast :1706"),
        "filter_round_bsp": dict(
            kernel=lambda: mk.filter_round_bsp(xs, None, STEP, m0, carry1, r1, mf1, mode=mk.LOOP),
            plain=lambda: mk.filter_round_bsp_plain(xs, None, STEP, m0, carry1, r1, mf1,
                                                    mode=mk.LOOP),
            library=None,
            bound=bound_ms(stream_bytes + 4.0 * (3 * npix + nb * 5 * s + nb * n_round * (s + 2)),
                           npix * (4.0 * s + 12)),
            replaces="1048", tpu_kernel="_resident_kernel / _resident_filter_body (row 9; "
                                        "bf16 storage, f32 products)"),
    }
    out = kernel_rows(plans, fields, "bf16 granule -> mask (unmasked route, step 54)")
    timings = {"bf16_filter_ms": cuda_ms(lambda: mk.acrwl1mf_resident_bsp(x, tpl, nb, STEP,
                                                                          device=dev, **kw)),
               "bf16_filter_plain_f32_ms": cuda_ms(lambda: mk.bsp_filter_plain(
                   xs, None, STEP, m0, k0, tgt0, cit0, norm0, tpl, p, **kw), reps=5, warmup=1),
               # A device-to-device copy of the cube: the rate HBM gives a plain read
               # and write of this size, beside blocked_transpose's share of its bound.
               "cube_copy_ms": cuda_ms(lambda: x.clone(), reps=7, inner=5)}
    return out, timings


def masked_bf16_phase(dev, template, granule):
    """Phase 11a, the masked bf16 stream on a served granule (TPU rows 5-6
    with bf16 dots): each kernel against its twins on the blocks with valid
    pixels, then the whole filter, with the plain twin in f32 and in f64 as
    witnesses of how far bf16 dots alone move it. Returns (kernel-row dicts
    without launches, timings)."""
    import torch

    from starcop_tpu_torch.ops import mag1c_kernels as mk
    from starcop_tpu_torch.ops.mag1c import mag1c_column_blocks, unblock_columns
    from starcop_tpu_torch.ops.mag1c_fused import acrwl1mf_fused

    x = torch.as_tensor(granule["cube"], device=dev)
    valid = torch.as_tensor(granule["valid"], device=dev)
    tpl = torch.as_tensor(template, dtype=torch.float32, device=dev)
    nb, s = -(-W // MSTEP), x.shape[-1]
    rows, p = mk.stream_rows(s), H * MSTEP
    counts = mk.block_valid_counts(valid, nb, MSTEP)
    live = counts > 0
    n = counts.clamp(min=1).float()
    n_valid = int(counts.sum())
    fields = {}

    m0 = mk.masked_block_means(x, valid, nb, MSTEP, n)
    xs = mk.blocked_transpose(x, nb, MSTEP, rows, m0, valid=valid)
    check(same_bits(xs, mk.blocked_transpose_plain(x, nb, MSTEP, rows, m0, valid=valid))
          and same_bits(mk.blocked_transpose(x, nb, MSTEP, rows, m0, valid=valid), xs),
          "blocked_transpose (bf16, centred, masked, ragged) equals its twin bitwise; rerun "
          "bitwise identical")
    check(not bool(xs[20].any()), "blocked_transpose: the wholly invalid block 20 is all zero")
    fields["blocked_transpose_masked"] = dict(rel_err=0.0, max_abs_err=0.0,
                                              check="bitwise equal to its twin")
    c0r = mk.init_stats_bsp(xs, n, s)
    c0_64 = mk.init_stats_bsp_plain(xs.double(), n.double(), s)
    c0_32 = mk.init_stats_bsp_plain(xs, n, s)
    e_c0 = rel_err(c0r[live], c0_64[live])
    check(e_c0 <= 1e-5 and bool((c0r[~live] == 0).all()),
          f"init_stats_bsp (n per block) vs f64 twin: C0 rel err {e_c0:.3e} (<= 1e-5) on the "
          f"live blocks, 0 on the empty one")
    fields["init_stats_bsp"] = dict(rel_err=e_c0, max_abs_err=float((c0r - c0_32).abs().max()),
                                    check="C0 rel err vs f64 twin <= 1e-5 on live blocks")

    k0, tgt0, cit0, norm0 = mk._woodbury_base(c0r, m0, tpl, ALPHA)
    k0 = k0.contiguous()
    carry = mk.pack_carry(tgt0, cit0, norm0)
    glue_kw = dict(m0=m0, template=tpl, k0=k0, n=n, alpha=ALPHA)
    errs, rule, (mf1, r1, _), ((mf2, _, _), carry1) = bsp_rounds(
        xs, valid, MSTEP, m0, carry, glue_kw, True, live, "filter_round_bsp (masked, bf16 dots)")
    fields["filter_round_bsp_masked_first"] = dict(rel_err=errs["first"][0],
                                                   max_abs_err=errs["first"][1], check=rule)
    fields["filter_round_bsp_masked_loop"] = dict(
        rel_err=max(errs["loop"][0], errs["final"][0]),
        max_abs_err=max(errs["loop"][1], errs["final"][1]), check=rule + " (LOOP and FINAL)")
    keep = mk._keep_rows(valid, nb, MSTEP)
    check(bool((r1[~keep] == 1).all() and (mf1[~keep] == 0).all() and (mf2[~keep] == 0).all()),
          "filter_round_bsp (masked): mf = 0 and R = 1 wherever a pixel does not count")

    kw = dict(column_step=MSTEP, num_iter=NUM_ITER, alpha=ALPHA, device=dev)
    mf_k, alb_k = mag1c_column_blocks(x, tpl, valid, stream_dtype=torch.bfloat16, **kw)
    check(bool(torch.isfinite(mf_k[valid]).all() and torch.isfinite(alb_k[valid]).all()),
          "masked bf16 filter finite at valid pixels")
    check(bool((mf_k[~valid] == FILL).all() and (alb_k[~valid] == FILL).all()
               and (mf_k[:, 20 * MSTEP:21 * MSTEP] == FILL).all()),
          "masked bf16 filter: fill value exactly at invalid pixels and across block 20")
    # Witnesses: the plain twin from the kernel route's Woodbury base, in f32
    # and in f64 (bf16 dots round both alike; only the arithmetic between
    # the roundings differs). bf16 dots round cit and g, so a one-ulp
    # difference (another summation order, or f64) can move a product by
    # 2^-9, and 30 reweighting rounds amplify it: the whole filter is held
    # by how far the twin's own f32 arithmetic moves it.
    base = (m0, k0, tgt0, cit0, norm0, tpl, n)
    twin_kw = dict(bf16_dots=True, num_iter=NUM_ITER, alpha=ALPHA)
    grid = lambda mf: unblock_columns(mf, H, MSTEP)[:, :W][valid]  # noqa: E731
    mf_32 = grid(mk.bsp_filter_plain(xs, valid, MSTEP, *base, **twin_kw)[0])
    mf_64 = grid(mk.bsp_filter_plain(xs, valid, MSTEP, *(t.double() for t in base),
                                     **twin_kw)[0])
    mf_kv = mf_k[valid]
    c32, c_k64, c_3264 = corr(mf_kv, mf_32), corr(mf_kv, mf_64), corr(mf_32, mf_64)
    det = int((mf_32 > 500).sum())
    agree = float(((mf_kv > 500) == (mf_32 > 500)).double().mean())
    check(c32 > 0.999 and det > 0 and agree >= 0.999,
          f"masked bf16 filter vs the plain twin on its own Woodbury base: mf correlation "
          f"{c32:.7f} (> 0.999), threshold-500 agreement {agree:.6f} (>= 0.999) over {det} "
          f"detections")
    check(1 - c_k64 <= 4 * (1 - c_3264) + 1e-6,
          f"masked bf16 filter vs the f64 twin (bf16 dots): 1 - correlation {1 - c_k64:.3e} "
          f"(<= 4x the f32 twin's {1 - c_3264:.3e} + 1e-6)")
    # The decisive flips against the f32 route (K2) on the same granule: the
    # kernel's, and the twins' in f32 and f64.
    mf_f32 = mag1c_column_blocks(x, tpl, valid, **kw)[0][valid]
    flips = {}
    for name, mf in (("kernel", mf_kv), ("f32 twin", mf_32), ("f64 twin", mf_64)):
        flipped, _, agr, med, n_big, shown = contract_terms(mf_f32, mf)
        flips[name] = set(flipped.tolist())
        print(f"info: masked bf16 {name} vs the f32 filter (K2): {len(flipped)} decisive flips"
              f"{shown}; agreement {agr:.6f}, median rel err {med:.2e} over {n_big}", flush=True)
    print(f"info: decisive flips shared by the kernel and the f32 / f64 twin: "
          f"{len(flips['kernel'] & flips['f32 twin'])} / {len(flips['kernel'] & flips['f64 twin'])}"
          f" of the kernel's {len(flips['kernel'])}; f32 and f64 twin share "
          f"{len(flips['f32 twin'] & flips['f64 twin'])}", flush=True)
    mf_again, _ = mag1c_column_blocks(x, tpl, valid, stream_dtype=torch.bfloat16, **kw)
    check(bool(torch.equal(mf_again, mf_k)), "masked bf16 filter rerun bitwise identical")

    n_round = mk.stream_geometry(xs, s).nchunks  # chunk records per block
    live_bytes = 2.0 * nb * s * p  # the live band rows of the whole stream
    stream_bytes = 2.0 * n_valid * s + H * W  # the valid pixels' live bands and the mask
    xs32 = xs[:, :s].float().contiguous()  # the live rows, upcast (set-up)
    m0_cols = m0.repeat_interleave(MSTEP, 0)[:W]  # each column's block mean (set-up)

    def library_masked_transpose():
        xc = torch.where(valid[..., None], x - m0_cols, 0.0)
        xc = torch.nn.functional.pad(xc, (0, 0, 0, nb * MSTEP - W))
        return xc.view(H, nb, MSTEP, s).permute(1, 3, 0, 2).to(torch.bfloat16)

    def library_centred_stats():
        return torch.bmm(xs32, xs32.transpose(1, 2)) / n[:, None, None]

    plans = {
        "blocked_transpose_masked": dict(
            kernel=lambda: mk.blocked_transpose(x, nb, MSTEP, rows, m0, valid=valid),
            plain=lambda: mk.blocked_transpose_plain(x, nb, MSTEP, rows, m0, valid=valid),
            library=library_masked_transpose,
            bound=bound_ms(4.0 * n_valid * s + H * W + 4.0 * nb * s + live_bytes,
                           1.0 * n_valid * s),
            note="bound: the valid pixels read, the live band rows written; library: where, "
                 "pad, permute and cast (no pad rows)",
            replaces="1796", tpu_kernel="XLA centre, mask and transpose of the masked stream "
                                        ":1796-1798 (no Pallas kernel)"),
        "init_stats_bsp": dict(
            kernel=lambda: mk.init_stats_bsp(xs, n, s),
            plain=lambda: mk.init_stats_bsp_plain(xs, n, s),
            library=library_centred_stats,
            bound=bound_ms(live_bytes + 4.0 * nb * (1 + s * s), 1.0 * n_valid * s * (s + 1),
                           BF16_FLOP_PER_S),
            note="one call = 2 __global__ launches; bound: the live band rows, products of "
                 "bf16 inputs at the tensor-core rate; library: bmm on the live rows upcast "
                 "to f32",
            replaces="1814", tpu_kernel="XLA second moment of the bf16 stream :1814-1824 (no "
                                        "Pallas kernel)"),
        "filter_round_bsp_masked_first": dict(
            kernel=lambda: mk.filter_round_bsp(xs, valid, MSTEP, m0, carry, None, None,
                                               mode=mk.FIRST, bf16_dots=True),
            plain=lambda: mk.filter_round_bsp_plain(xs, valid, MSTEP, m0, carry, None, None,
                                                    mode=mk.FIRST, bf16_dots=True),
            library=None,
            bound=bound_ms(stream_bytes + 4.0 * (2 * nb * p + nb * 5 * s + nb * n_round * (s + 2)),
                           n_valid * (6.0 * s + 12)),
            replaces="594", tpu_kernel="_first_round_kernel, bf16_dots=True (row 5)"),
        "filter_round_bsp_masked_loop": dict(
            kernel=lambda: mk.filter_round_bsp(xs, valid, MSTEP, m0, carry1, r1, mf1,
                                               mode=mk.LOOP, bf16_dots=True),
            plain=lambda: mk.filter_round_bsp_plain(xs, valid, MSTEP, m0, carry1, r1, mf1,
                                                    mode=mk.LOOP, bf16_dots=True),
            library=None,
            bound=bound_ms(stream_bytes + 4.0 * (3 * nb * p + nb * 5 * s + nb * n_round * (s + 2)),
                           n_valid * (4.0 * s + 12)),
            replaces="664", tpu_kernel="_loop_round_kernel, bf16_dots=True (row 6; LOOP and "
                                       "FINAL)"),
    }
    out = kernel_rows(plans, fields, "served granules, bf16 stream (ScenePipeline, f32 upload)")
    timings = {"bf16_masked_filter_ms": cuda_ms(
        lambda: mag1c_column_blocks(x, tpl, valid, stream_dtype=torch.bfloat16, **kw), reps=7),
        # The route's second pass over the cube, plain torch (f64 sums).
        "masked_block_means_ms": cuda_ms(lambda: mk.masked_block_means(x, valid, nb, MSTEP, n),
                                         reps=7)}
    return out, timings


def serving_bf16_phase(dev, model, model_bf16, granules, f32_outputs):
    """Phase 11b: ScenePipeline over the served granules with the bf16
    stream and the bf16-resident U-Net (f32 upload, f16 download), against
    phase 8's f32 pipeline. Returns (launch counts, timings)."""
    import tempfile

    import torch

    from starcop_tpu_torch.ops import mag1c_kernels as mk
    from starcop_tpu_torch.scenes.emit_pipeline import plume_mask
    from starcop_tpu_torch.serve import pipeline as sp

    names = [f"granule_{i}" for i in range(len(granules))]
    store = dict(zip(names, granules))
    upload = sp.Uploader(dev)
    compute = sp.make_compute_fn(model_bf16, dev, column_step=MSTEP, num_iter=NUM_ITER,
                                 stream_dtype=torch.bfloat16)
    payload0 = upload(sp.encode_payload(granules[0], "f32"))
    compute(payload0)  # warm-up
    timings = {}
    with tempfile.TemporaryDirectory() as out_dir:
        pipe = sp.ScenePipeline(lambda name: upload(sp.encode_payload(store[name], "f32")),
                                compute, sp.make_write_fn(out_dir))
        mk.reset_launch_counts()
        t0 = time.perf_counter()
        results = pipe.run(names)
        wall = time.perf_counter() - t0
        launches = dict(mk.LAUNCH_COUNTS)
    print(f"served launches (bf16 stream, bf16 U-Net, {len(names)} granules): "
          f"{json.dumps(launches)}", flush=True)
    errors = {r.name: r.error for r in results if r.error is not None}
    check(len(results) == len(names) and not errors,
          f"bf16 stream: {len(results)} scenes served, errors {errors}")
    per = {k: v / len(names) for k, v in launches.items()}
    want = {k: 0 for k in launches}
    want.update({"blocked_transpose": 1, "init_stats_bsp": 1,
                 "filter_round_bsp_masked_first": 1, "filter_round_bsp_masked_loop": NUM_ITER,
                 "filter_glue": NUM_ITER})
    check(per == want, f"bf16 stream: launches per granule {per} (want {want}: no K1, K2 or "
                       f"unmasked bsp kernel)")
    by_name = {r.name: r.outputs for r in results}
    for name, g in zip(names, granules):
        ok = g["valid"]
        got, ref = by_name[name]["mag1c"], f32_outputs[name]["mag1c"]
        check(np.array_equal(got == FILL, ~ok), f"{name}: bf16-stream NODATA exactly at the "
                                               f"invalid pixels")
        bf16_contract(ref[ok], got[ok], f"{name}: served bf16-stream mag1c vs phase 8's f32")
        print(f"info: {name} served mask correlation, bf16 stream + bf16 U-Net vs f32 + f32: "
              f"{corr(by_name[name]['prediction'], f32_outputs[name]['prediction']):.6f}",
              flush=True)
    mf0 = torch.as_tensor(by_name["granule_0"]["mag1c"], device=dev)
    rgb0 = torch.as_tensor(np.moveaxis(granules[0]["rgb"], -1, 0), device=dev)
    with torch.inference_mode():  # plume_mask feeds NODATA to the model as 0
        pb = plume_mask(mf0[None], rgb0[None], model_bf16)[0]
        pf = plume_mask(mf0[None], rgb0[None], model)[0]
    mc = corr(pb, pf)
    check(mc > 0.999, f"bf16-resident U-Net mask vs the f32 model's on granule 0's served mf: "
                      f"correlation {mc:.6f} (> 0.999), std {float(pb.float().std()):.4f}")
    timings["pipeline_bf16_ms_per_granule"] = wall * 1e3 / len(names)
    timings["pipeline_bf16_granules_per_s"] = len(names) / wall
    for stage in ("read", "compute", "write"):
        timings[f"pipeline_bf16_{stage}_ms_median"] = 1e3 * statistics.median(
            r.timings[f"{stage}_s"] for r in results)
    timings["served_compute_bf16_ms"] = cuda_ms(lambda: compute(payload0), reps=5, warmup=1)
    return launches, timings


FUSED_SOURCE = "starcop_tpu_torch/csrc/mag1c_fused.cu"


def held_against_twins(what, out_k, out_32, out_64):
    """The kernel's outputs (lists of tensors) within 4x the f32 twin's error
    against the f64 twin + 1e-6, the rule of the other f32 kernels. Returns
    (rel err vs the f64 twin, max |kernel - f32 twin|)."""
    ek = max(rel_err(a, b) for a, b in zip(out_k, out_64))
    ep = max(rel_err(a, b) for a, b in zip(out_32, out_64))
    check(ek <= 4 * ep + 1e-6, f"{what} vs f64 twin: rel err {ek:.3e} (f32 twin {ep:.3e})")
    return ek, max(float((a - b).abs().max()) for a, b in zip(out_k, out_32))


def stream_kernels_phase(dev, x, tpl):
    """Phase 12, the kernels of the remaining routes on the bench blocks: TPU
    row 3 (``blocked_transpose_shw``: the band-major cube to the raw f32
    stream (nb, 56, P)), row 10 on that stream (``init_stats_stream``), row 9
    at f32 (``filter_round_bsp`` centring the raw stream), row 4
    (``fused_iter`` WOODBURY and CHOLESKY, first and not first) and rows 7-8
    (``filter_round_mono`` FIRST and LOOP: mf, R and the carry), each against
    its twins. Returns (kernel-row dicts without launches, the band-major
    cube, the stream, its m0 and C0)."""
    import torch

    from starcop_tpu_torch.ops import mag1c_kernels as mk

    nb, s = W // STEP, x.shape[-1]
    rows, p, npix = mk.stream_rows(s), H * STEP, H * W
    d64 = lambda t: None if t is None else t.double()  # noqa: E731
    fields = {}

    x_shw = x.permute(2, 0, 1).contiguous()  # the band-major cube (set-up)
    xs = mk.blocked_transpose_shw(x_shw, nb, STEP, rows)
    check(torch.equal(xs, mk.blocked_transpose_shw_plain(x_shw, nb, STEP, rows)),
          "blocked_transpose_shw equals its twin bitwise, pad rows included")
    fields["blocked_transpose_shw"] = dict(rel_err=0.0, max_abs_err=0.0,
                                           check="bitwise equal to its twin")

    m0, c0 = mk.init_stats_stream(xs, s)
    m0_64, c0_64 = mk.init_stats_stream_plain(xs.double(), s)
    m0_32, c0_32 = mk.init_stats_stream_plain(xs, s)
    e_m0, e_c0 = rel_err(m0, m0_64), rel_err(c0, c0_64)
    check(e_m0 <= 1e-5 and e_c0 <= 1e-5, f"init_stats_stream vs f64 twin: m0 rel err "
                                         f"{e_m0:.3e}, C0 rel err {e_c0:.3e} (<= 1e-5)")
    fields["init_stats_stream"] = dict(
        rel_err=max(e_m0, e_c0),
        max_abs_err=max(float((m0 - m0_32).abs().max()), float((c0 - c0_32).abs().max())),
        check="m0, C0 rel err vs f64 twin <= 1e-5")

    k0, tgt0, cit0, norm0 = mk._woodbury_base(c0, m0, tpl, ALPHA)
    k0 = k0.contiguous()
    carry = mk.pack_carry(tgt0, cit0, norm0)
    glue_kw = dict(m0=m0, template=tpl, k0=k0, n=p, alpha=ALPHA)
    errs, rule, (mf1, r1, _), ((mf2, _, _), carry1) = bsp_rounds(
        xs, None, STEP, m0, carry, glue_kw, False, slice(None),
        "filter_round_bsp (raw f32 stream, centred in the kernel)", center=True)
    fields["filter_round_bsp_f32"] = dict(rel_err=max(e for e, _ in errs.values()),
                                          max_abs_err=max(a for _, a in errs.values()),
                                          check=rule.replace("bf16", "raw f32"))

    # Row 4 from the round's R and mf; the first call reads JAX's dummy carry.
    carry_first = mk.pack_carry(tgt0, torch.zeros_like(cit0), torch.ones_like(norm0))
    for woodbury, name in ((True, "fused_iter_woodbury"), (False, "fused_iter_cholesky")):
        got = []
        for first, carry_in, mf_in in ((True, carry_first, mf1), (False, carry1, mf2)):
            kw = dict(first=first, woodbury=woodbury, center=True)
            outs = (mk.fused_iter(xs, None, m0, carry_in, r1, mf_in, **kw),
                    mk.fused_iter_plain(xs, None, m0, carry_in, r1, mf_in, **kw),
                    mk.fused_iter_plain(xs, None, d64(m0), d64(carry_in), d64(r1), d64(mf_in),
                                        **kw))
            flat = [[o[0], o[1].sum(1)] if woodbury else [o[0], *o[1]] for o in outs]
            got.append(held_against_twins(f"{name} ({'first' if first else 'not first'})",
                                          *flat))
        fields[name] = dict(rel_err=max(e for e, _ in got), max_abs_err=max(a for _, a in got),
                            check="mf and statistics rel err vs f64 twin <= 4x f32 twin's "
                                  "+ 1e-6, first and not first")

    n = torch.full((nb,), float(p), dtype=torch.float32, device=dev)
    mono_kw = dict(alpha=ALPHA, center=True)
    counter = mk.mono_counters(xs)  # zeroed once; each launch leaves it at 0

    def mono_round(mode, carry_in, r_in, mf_in):
        outs = (mk.filter_round_mono(xs, m0, carry_in, r_in, mf_in, tpl, k0, n, mode=mode,
                                     counter=counter, **mono_kw),
                mk.filter_round_mono_plain(xs, m0, carry_in, r_in, mf_in, tpl, k0, n, mode=mode,
                                           **mono_kw),
                mk.filter_round_mono_plain(xs, d64(m0), d64(carry_in), d64(r_in), d64(mf_in),
                                           tpl.double(), d64(k0), n.double(), mode=mode,
                                           **mono_kw))
        mode_name = {mk.FIRST: "first", mk.LOOP: "loop"}[mode]
        err = held_against_twins(f"filter_round_mono ({mode_name}: mf, R, carry)",
                                 *([t for t in o if t is not None] for o in outs))
        return outs[0], err

    (mfm1, rm1, cm1), e_first = mono_round(mk.FIRST, carry, None, None)
    _, e_loop = mono_round(mk.LOOP, cm1, rm1, mfm1)
    rule = "mf, R and carry rel err vs f64 twin <= 4x f32 twin's + 1e-6"
    fields["filter_round_mono_first"] = dict(rel_err=e_first[0], max_abs_err=e_first[1],
                                             check=rule)
    fields["filter_round_mono_loop"] = dict(rel_err=e_loop[0], max_abs_err=e_loop[1], check=rule)

    n_round, stream_bytes = mk.stream_geometry(xs, s).nchunks, 4.0 * npix * s
    xs_live = xs[:, :s]
    rows_bytes = lambda k: 4.0 * (k * npix + nb * 5 * s + nb * n_round * (s + 2))  # noqa: E731
    glue_ops = nb * (10.0 * s * s + 40 * s)  # filter_glue's

    def library_stream_stats():
        xc = xs_live - xs_live.mean(2, keepdim=True)
        return torch.bmm(xc, xc.transpose(1, 2)) / p

    fused_kw = dict(r=r1, mf_prev=mf1, first=False, center=True)
    plans = {
        "blocked_transpose_shw": dict(
            kernel=lambda: mk.blocked_transpose_shw(x_shw, nb, STEP, rows),
            plain=lambda: mk.blocked_transpose_shw_plain(x_shw, nb, STEP, rows),
            library=lambda: x_shw.view(s, H, nb, STEP).permute(2, 0, 1, 3).contiguous(),
            bound=bound_ms(2 * stream_bytes, 0.0), source=FUSED_SOURCE,
            note="bound: the live band rows read and written; library: permute + contiguous "
                 "(no pad rows)",
            replaces="295", tpu_kernel="_blocked_transpose_shw_kernel (row 3)"),
        "init_stats_stream": dict(
            kernel=lambda: mk.init_stats_stream(xs, s),
            plain=lambda: mk.init_stats_stream_plain(xs, s),
            library=library_stream_stats,
            bound=bound_ms(stream_bytes + 4.0 * nb * (s + s * s),
                           npix * (s * (s + 1) + 2.0 * s)),
            note="one call = 2 __global__ launches; library: mean + bmm on the live rows",
            replaces="1164", tpu_kernel="_init_stats_kernel (row 10) on the raw f32 stream"),
        "filter_round_bsp_f32": dict(
            kernel=lambda: mk.filter_round_bsp(xs, None, STEP, m0, carry1, r1, mf1, mode=mk.LOOP,
                                               center=True),
            plain=lambda: mk.filter_round_bsp_plain(xs, None, STEP, m0, carry1, r1, mf1,
                                                    mode=mk.LOOP, center=True),
            library=None, bound=bound_ms(stream_bytes + rows_bytes(3), npix * (5.0 * s + 12)),
            replaces="1048", tpu_kernel="_resident_kernel (row 9), the raw f32 stream "
                                        "centred in the kernel"),
        "fused_iter_woodbury": dict(
            kernel=lambda: mk.fused_iter(xs, None, m0, carry1, woodbury=True, **fused_kw),
            plain=lambda: mk.fused_iter_plain(xs, None, m0, carry1, woodbury=True, **fused_kw),
            library=None, bound=bound_ms(stream_bytes + rows_bytes(3), npix * (5.0 * s + 12)),
            source=FUSED_SOURCE, replaces="386",
            tpu_kernel="_fused_iter_kernel, woodbury=True (row 4)"),
        "fused_iter_cholesky": dict(
            kernel=lambda: mk.fused_iter(xs, None, m0, carry1, woodbury=False, **fused_kw),
            plain=lambda: mk.fused_iter_plain(xs, None, m0, carry1, woodbury=False, **fused_kw),
            library=None,
            bound=bound_ms(stream_bytes + 4.0 * (3 * npix + nb * (5 * s + s * s)),
                           npix * (s * (s + 1) + 5.0 * s + 12)),
            source=FUSED_SOURCE, replaces="386",
            note="one call = 2 __global__ launches; bound: per pixel the centring (S), proj "
                 "(2 S), modx (2 S) and the scatter's triangle (S (S + 1)), as init_stats_stream",
            tpu_kernel="_fused_iter_kernel, woodbury=False (row 4)"),
        "filter_round_mono_first": dict(
            kernel=lambda: mk.filter_round_mono(xs, m0, carry, None, None, tpl, k0, n,
                                                mode=mk.FIRST, counter=counter, **mono_kw),
            plain=lambda: mk.filter_round_mono_plain(xs, m0, carry, None, None, tpl, k0, n,
                                                     mode=mk.FIRST, **mono_kw),
            library=None,
            bound=bound_ms(stream_bytes + rows_bytes(2) + 4.0 * nb * s * s,
                           npix * (7.0 * s + 12) + glue_ops),
            source=FUSED_SOURCE, replaces="880", tpu_kernel="_mono_first_kernel (row 7)"),
        "filter_round_mono_loop": dict(
            kernel=lambda: mk.filter_round_mono(xs, m0, cm1, rm1, mfm1, tpl, k0, n, mode=mk.LOOP,
                                                counter=counter, **mono_kw),
            plain=lambda: mk.filter_round_mono_plain(xs, m0, cm1, rm1, mfm1, tpl, k0, n,
                                                     mode=mk.LOOP, **mono_kw),
            library=None,
            bound=bound_ms(stream_bytes + rows_bytes(3) + 4.0 * nb * s * s,
                           npix * (5.0 * s + 12) + glue_ops),
            source=FUSED_SOURCE, replaces="927",
            tpu_kernel="_mono_loop_kernel (row 8; LOOP and FINAL)"),
    }
    out = kernel_rows(plans, fields, "acrwl1mf_fused on the bench blocks, raw f32 stream; "
                                     "scene_layout='shw'")
    return out, x_shw, xs, m0, c0


def fused_routes_phase(dev, x_shw, xs, m0, c0, tpl, mf_32, mf_64, r_64):
    """Phase 13, the whole filters of the remaining routes on the bench
    scene, each with its launch counts zeroed just before and read just
    after: ``acrwl1mf_fused`` on the raw f32 stream with glue mono,
    woodbury, cholesky and resident, and ``mag1c_column_blocks
    (scene_layout="shw")``, held against phase 4's twins (f64: threshold-500
    agreement >= 0.999 with detections, albedo within 1e-4; f32 from K1's
    Woodbury base: mf correlation > 0.9999); mono, woodbury and shw at bf16
    held to bf16_contract against their f32 route; every filter bitwise
    equal on a rerun. Returns (launch counts by route, timings)."""
    import torch

    from starcop_tpu_torch.ops import mag1c_kernels as mk
    from starcop_tpu_torch.ops.mag1c import mag1c_column_blocks, unblock_columns
    from starcop_tpu_torch.ops.mag1c_fused import acrwl1mf_fused

    nb, s = W // STEP, x_shw.shape[0]
    xs_live = xs[:, :s].contiguous()  # glue woodbury / cholesky take S rows only
    grid = lambda t: unblock_columns(t, H, STEP)  # noqa: E731
    bf16 = torch.bfloat16

    def fused(glue, stream, dtype=None):
        def run():
            mf, r = acrwl1mf_fused(stream, tpl, num_iter=NUM_ITER, alpha=ALPHA,
                                   stream_dtype=dtype, x_layout="bsp", glue=glue, device=dev)
            return grid(mf[..., 0]), grid(r[..., 0])
        return run

    def shw(dtype=None):
        return lambda: mag1c_column_blocks(x_shw, tpl, None, column_step=STEP, num_iter=NUM_ITER,
                                           alpha=ALPHA, stream_dtype=dtype, scene_layout="shw",
                                           device=dev)

    mono_counts = dict(init_stats_stream=1, filter_round_mono_first=1,
                       filter_round_mono_loop=NUM_ITER)
    shw_counts = dict(blocked_transpose_shw=1, init_stats_stream=1, filter_glue=NUM_ITER)
    woodbury_counts = dict(init_stats_stream=1, fused_iter_woodbury=NUM_ITER + 1,
                           filter_glue=NUM_ITER)
    routes = {  # name: (run, launches by design, the f32 route it is held to at bf16)
        "mono": (fused("mono", xs), mono_counts, None),
        "woodbury": (fused("woodbury", xs_live), woodbury_counts, None),
        "cholesky": (fused("cholesky", xs_live),
                     dict(init_stats_stream=1, fused_iter_cholesky=NUM_ITER + 1), None),
        "resident": (fused("resident", xs), dict(init_stats_stream=1, filter_glue=NUM_ITER,
                                                 filter_round_bsp_f32=NUM_ITER + 1), None),
        "shw": (shw(), dict(shw_counts, filter_round_bsp_f32=NUM_ITER + 1), None),
        "mono_bf16": (fused("mono", xs, bf16), mono_counts, "mono"),
        "woodbury_bf16": (fused("woodbury", xs_live, bf16), woodbury_counts, "woodbury"),
        "shw_bf16": (shw(bf16), dict(shw_counts, filter_round_bsp=NUM_ITER + 1), "shw"),
    }
    mf32, mf64, r64 = grid(mf_32), grid(mf_64), grid(r_64)
    det = int((mf64 > 500).sum())
    outs, launches, timings = {}, {}, {}
    for name, (run, design, f32_route) in routes.items():
        mk.reset_launch_counts()
        mf, r = run()
        counts = dict(mk.LAUNCH_COUNTS)
        want = {k: 0 for k in counts}
        want.update(design)
        check(counts == want, f"{name}: launches {({k: v for k, v in counts.items() if v})} "
                              f"(want {design})")
        launches[name] = counts
        check(bool(torch.isfinite(mf).all() and torch.isfinite(r).all()),
              f"{name}: filter output finite")
        if f32_route is None:
            c32 = corr(mf, mf32)
            agree = float(((mf > 500) == (mf64 > 500)).double().mean())
            alb = float(((r.double() - r64).abs() / r64.abs()).max())
            check(c32 > 0.9999 and det > 0 and agree >= 0.999 and alb <= 1e-4,
                  f"{name}: mf correlation with phase 4's f32 twin {c32:.7f} (> 0.9999), "
                  f"threshold-500 agreement with its f64 twin {agree:.6f} (>= 0.999) over {det} "
                  f"detections, albedo rel err {alb:.3e} (<= 1e-4)")
            print(f"info: {name} mf correlation with the f64 twin {corr(mf, mf64):.7f}",
                  flush=True)
        else:
            bf16_contract(outs[f32_route], mf, f"{name} vs the f32 {f32_route} route")
        check(bool(torch.equal(run()[0], mf)), f"{name}: rerun bitwise identical")
        outs[name] = mf
        timings[f"{name}_filter_ms"] = cuda_ms(run, reps=7, warmup=1)
    print("fused-route launches: " + json.dumps(
        {k: {n: v for n, v in c.items() if v} for k, c in launches.items()}), flush=True)
    timings["stream_woodbury_base_ms"] = cuda_ms(lambda: mk._woodbury_base(c0, m0, tpl, ALPHA))
    profile_granule(routes["mono"][0], "fused_mono_filter")
    profile_granule(routes["resident"][0], "fused_resident_filter")
    profile_granule(routes["cholesky"][0], "fused_cholesky_filter")
    return launches, timings


def held_rounds(what, run, twin, carry, glue, records=True):
    """FIRST, LOOP (after one glue) and FINAL of a round kernel ``run`` against
    its twin ``twin`` in f32 and f64 from the first carry ``carry``, each
    within 4x the f32 twin's error against the f64 twin + 1e-6.
    ``run(mode, carry, r, mf)`` and ``twin(mode, carry, r, mf, dtype)``
    return (mf, R, chunk records, or the next carry when not ``records``);
    ``glue(out, carry)`` gives the next carry. Returns the worst (rel err vs
    f64, max |kernel - f32 twin|)."""
    import torch

    d64 = lambda t: None if t is None else t.double()  # noqa: E731
    r, mf, worst = None, None, (0.0, 0.0)
    for mode in (0, 1, 2):  # FIRST, LOOP, FINAL
        outs = (run(mode, carry, r, mf), twin(mode, carry, r, mf, torch.float32),
                twin(mode, d64(carry), d64(r), d64(mf), torch.float64))
        flat = [[o[0], o[1]] + ([] if o[2] is None else [o[2].sum(1) if records else o[2]])
                for o in outs]
        name = {0: "first", 1: "loop", 2: "final"}[mode]
        err = held_against_twins(f"{what} ({name})", *flat)
        worst = (max(worst[0], err[0]), max(worst[1], err[1]))
        if mode != 2:
            mf, r_out, nxt = outs[0]
            r = r_out if r is None else r
            carry = glue(nxt, carry)
    return worst


def odd_geometry_phase(dev):
    """The narrow-copy paths of the redesigned round bodies on shapes where no
    tile row starts on 16 bytes (odd W, odd S, odd P = H * step), each held
    against its twins FIRST / LOOP / FINAL: filter_round at 99 x 45 x 37,
    step 15 (3 blocks, P = 1,485); filter_round_masked at 99 x 47 x 37, step
    15 (a ragged last block 2 columns wide); filter_round_bsp on the stream
    of the 99 x 45 x 37 cube at f32 (raw, centred in the kernel; and centred
    and masked) and bf16 (unmasked; masked with bf16 dots); filter_round_mono
    and fused_iter WOODBURY on the raw f32 stream. Checks that each took the
    narrow path. Returns {kernel: (rel err vs f64, max abs err)}."""
    import torch

    from starcop_tpu_torch.data.synthetic import synthetic_scene
    from starcop_tpu_torch.ops import mag1c_kernels as mk
    from starcop_tpu_torch.ops.mag1c import block_columns

    s, step, gh = 37, 15, 99
    tpl_np = -np.abs(np.sin(np.linspace(0.3, 9.4, s)))
    g = synthetic_scene(np.random.default_rng(2), gh, 47, n_plumes=1, template=tpl_np,
                        max_concentration=8000.0)
    x47 = torch.as_tensor(g["radiance"], device=dev).contiguous()
    x45 = x47[:, :45].contiguous()
    tpl = torch.as_tensor(g["template"], dtype=torch.float32, device=dev)
    rng = np.random.default_rng(3)
    valid47 = torch.as_tensor(rng.random((gh, 47)) > 0.05, device=dev)
    valid47[10:20, 5:25] = False
    valid45 = valid47[:, :45].contiguous()
    out = {}

    def base(m0, c0):
        k0, tgt0, cit0, norm0 = mk._woodbury_base(c0, m0, tpl, ALPHA)
        return k0.contiguous(), mk.pack_carry(tgt0, cit0, norm0)

    def glue_fn(m0, k0, n):
        return lambda stats, carry: mk.filter_glue(stats, carry, m0=m0, template=tpl, k0=k0, n=n,
                                                   alpha=ALPHA)

    # The cube rounds: unmasked 99 x 45, masked ragged 99 x 47.
    for name, x, valid, nb in (("filter_round", x45, None, 3),
                               ("filter_round_masked", x47, valid47, 4)):
        check(not mk.cube_geometry(x, nb, step).aligned, f"odd geometry: {name} takes the "
                                                         f"4-byte copies")
        if valid is None:
            m0, c0 = mk.init_stats(x, nb, step)
            n = float(gh * step)
        else:
            m0, c0 = mk.init_stats_masked(x, valid, nb, step)
            n = mk.block_valid_counts(valid, nb, step).clamp(min=1).float()
        k0, carry0 = base(m0, c0)

        def run(mode, carry, r, mf, x=x, valid=valid, nb=nb, m0=m0):
            if valid is None:
                return mk.filter_round(x, nb, step, m0, carry, r, mf, mode=mode)
            return mk.filter_round_masked(x, valid, nb, step, m0, carry, r, mf, mode=mode)

        def twin(mode, carry, r, mf, dt, x=x, valid=valid, nb=nb, m0=m0):
            if valid is None:
                return mk.filter_round_plain(x.to(dt), nb, step, m0.to(dt), carry.to(dt), r, mf,
                                             mode=mode)
            return mk.filter_round_masked_plain(x.to(dt), valid, nb, step, m0.to(dt),
                                                carry.to(dt), r, mf, mode=mode)

        out[f"{name}_odd"] = held_rounds(f"odd geometry {name}", run, twin, carry0,
                                         glue_fn(m0, k0, n))

    # The stream of the 99 x 45 x 37 cube (P = 1,485 pixels, 40 rows).
    nb, p, rows = 3, gh * step, mk.stream_rows(s)
    x_shw = x45.permute(2, 0, 1).contiguous()
    raw = mk.blocked_transpose_shw(x_shw, nb, step, rows)
    m0, c0 = mk.init_stats_stream(raw, s)
    k0, carry0 = base(m0, c0)
    n_m = mk.block_valid_counts(valid45, nb, step).clamp(min=1).float()
    m0_m = mk.masked_block_means(x45, valid45, nb, step, n_m)
    keep = mk._keep_rows(valid45, nb, step)
    xc = torch.where(keep[..., None], block_columns(x45, nb, step) - m0_m[:, None, :], 0.0)
    centred_masked = torch.nn.functional.pad(xc.transpose(1, 2), (0, 0, 0, rows - s)).contiguous()
    k0_m, carry0_m = base(m0_m, mk.init_stats_bsp_plain(centred_masked, n_m, s))
    bf16 = mk.blocked_transpose(x45, nb, step, rows, m0)
    bf16_m = mk.blocked_transpose(x45, nb, step, rows, m0_m, valid=valid45)
    streams = (  # name, stream, mask, m0, k0, carry0, n, bf16 dots, centre
        ("filter_round_bsp_f32_odd", raw, None, m0, k0, carry0, float(p), False, True),
        ("filter_round_bsp_f32_masked_odd", centred_masked, valid45, m0_m, k0_m, carry0_m, n_m,
         False, False),
        ("filter_round_bsp_odd", bf16, None, m0, k0, carry0, float(p), False, False),
        ("filter_round_bsp_masked_odd", bf16_m, valid45, m0_m, k0_m, carry0_m, n_m, True, False))
    for name, xs, valid, m0_, k0_, c0_, n_, dots, center in streams:
        check(not mk.stream_geometry(xs, s).aligned, f"odd geometry: {name} takes the narrow "
                                                     f"copies ({xs.dtype})")
        kw = dict(bf16_dots=dots, center=center)

        def run(mode, carry, r, mf, xs=xs, valid=valid, m0_=m0_, kw=kw):
            return mk.filter_round_bsp(xs, valid, step, m0_, carry, r, mf, mode=mode, **kw)

        def twin(mode, carry, r, mf, dt, xs=xs, valid=valid, m0_=m0_, kw=kw):
            return mk.filter_round_bsp_plain(xs, valid, step, m0_.to(dt), carry.to(dt), r, mf,
                                             mode=mode, **kw)

        out[name] = held_rounds(f"odd geometry {name}", run, twin, c0_, glue_fn(m0_, k0_, n_))

    # filter_round_mono (the glue in the round) and fused_iter WOODBURY on the raw stream.
    n = torch.full((nb,), float(p), dtype=torch.float32, device=dev)
    counter = mk.mono_counters(raw)

    def mono(mode, carry, r, mf):
        return mk.filter_round_mono(raw, m0, carry, r, mf, tpl, k0, n, mode=mode, alpha=ALPHA,
                                    counter=counter, center=True)

    def mono_twin(mode, carry, r, mf, dt):
        return mk.filter_round_mono_plain(raw, m0.to(dt), carry.to(dt), r, mf, tpl.to(dt),
                                          k0.to(dt), n.to(dt), mode=mode, alpha=ALPHA,
                                          center=True)

    out["filter_round_mono_odd"] = held_rounds(
        "odd geometry filter_round_mono (mf, R, carry)", mono, mono_twin, carry0,
        lambda nxt, _: nxt, records=False)
    mf1, r1, _ = mk.filter_round_bsp(raw, None, step, m0, carry0, None, None, mode=mk.FIRST,
                                     center=True)
    got = []
    for first in (True, False):
        kw = dict(first=first, woodbury=True, center=True)
        outs = [mk.fused_iter(raw, None, m0, carry0, r1, mf1, **kw)]
        for dt in (torch.float32, torch.float64):
            outs.append(mk.fused_iter_plain(raw, None, m0.to(dt), carry0.to(dt), r1.to(dt),
                                            mf1.to(dt), **kw))
        got.append(held_against_twins(f"odd geometry fused_iter WOODBURY "
                                      f"({'first' if first else 'not first'})",
                                      *([o[0], o[1].sum(1)] for o in outs)))
    out["fused_iter_woodbury_odd"] = (max(e for e, _ in got), max(a for _, a in got))
    print("odd geometry: " + json.dumps(out), flush=True)
    return out


def odd_stats_phase(dev):
    """Phase 4d, the redesigned statistics kernel and glue on odd geometries:
    init_stats at 99 x 45 x 37 (step 15, 4-byte copies) and 60 x 50 x 128
    (step 25, 16-byte copies, one CTA per SM), init_stats_masked at 99 x 47 x
    37 and 60 x 72 x 128 (a ragged last block, block 1 wholly invalid), each
    within 1e-5 of its f64 twin on the blocks with valid pixels, m0 = 0 and
    C0 = 0 on the empty one, bitwise equal on a rerun; then filter_glue at
    S = 37 and S = 128 from the cube's own first round against its twins,
    bitwise equal on a rerun. Returns {check: (rel err vs f64, max abs err)}."""
    import torch

    from starcop_tpu_torch.ops import mag1c_kernels as mk

    rng = np.random.default_rng(4)

    def cube(h, w, s):
        base = rng.uniform(2.0, 6.0, (1, 1, s))
        x = rng.uniform(0.5, 2.0, (h, w, 1)) * base * (1 + 0.02 * rng.normal(size=(h, w, s)))
        return torch.as_tensor(x.astype(np.float32), device=dev)

    def empty_block(h, w, step):
        valid = torch.as_tensor(rng.random((h, w)) > 0.1, device=dev)
        valid[:, step:2 * step] = False  # block 1
        return valid

    cases = (  # name, cube, mask, nb, step, 16-byte copies
        ("init_stats 99x45x37 step 15", cube(99, 45, 37), None, 3, 15, False),
        ("init_stats_masked 99x47x37 step 15", cube(99, 47, 37), empty_block(99, 47, 15), 4, 15,
         False),
        ("init_stats 60x50x128 step 25", cube(60, 50, 128), None, 2, 25, True),
        ("init_stats_masked 60x72x128 step 25", cube(60, 72, 128), empty_block(60, 72, 25), 3,
         25, True))
    out, glue_inputs = {}, {}
    for name, x, valid, nb, step, aligned in cases:
        geom = mk.cube_stats_geometry(x, nb, step)
        check(geom.aligned == aligned, f"{name}: {'16' if aligned else '4'}-byte copies "
                                       f"({geom._asdict()})")
        if valid is None:
            run = lambda x=x, nb=nb, step=step: mk.init_stats(x, nb, step)  # noqa: E731
            m0_64, c0_64 = mk.init_stats_plain(x.double(), nb, step)
            m0_32, c0_32 = mk.init_stats_plain(x, nb, step)
            live = torch.ones(nb, dtype=torch.bool, device=dev)
        else:
            run = lambda x=x, v=valid, nb=nb, step=step: mk.init_stats_masked(x, v, nb, step)  # noqa: E731
            m0_64, c0_64 = mk.init_stats_masked_plain(x.double(), valid, nb, step)
            m0_32, c0_32 = mk.init_stats_masked_plain(x, valid, nb, step)
            live = mk.block_valid_counts(valid, nb, step) > 0
        m0, c0 = run()
        e = max(rel_err(m0[live], m0_64[live]), rel_err(c0[live], c0_64[live]))
        empty = bool((m0[~live] == 0).all() and (c0[~live] == 0).all())
        again = run()
        check(e <= 1e-5 and empty and int((~live).sum()) == (valid is not None)
              and torch.equal(again[0], m0) and torch.equal(again[1], c0),
              f"odd geometry {name}: m0, C0 rel err vs f64 twin {e:.3e} (<= 1e-5), "
              f"{int((~live).sum())} empty block(s) at m0 = 0, C0 = 0, rerun bitwise equal")
        out[name] = (e, max(float((m0 - m0_32).abs().max()), float((c0 - c0_32).abs().max())))
        if valid is None:
            glue_inputs[x.shape[2]] = (x, nb, step, m0, c0)

    d64 = lambda t: t.double()  # noqa: E731
    for s, (x, nb, step, m0, c0) in glue_inputs.items():
        tpl = -torch.abs(torch.sin(torch.linspace(0.3, 9.4, s, device=dev)))
        k0, tgt0, cit0, norm0 = mk._woodbury_base(c0, m0, tpl, ALPHA)
        k0 = k0.contiguous()
        carry = mk.pack_carry(tgt0, cit0, norm0)
        n = x.shape[0] * step
        _, _, st = mk.filter_round(x, nb, step, m0, carry, None, None, mode=mk.FIRST)
        kw = dict(m0=m0, template=tpl, k0=k0, n=n, alpha=ALPHA)
        got = mk.filter_glue(st, carry, **kw)
        err = held_against_twins(
            f"odd geometry filter_glue at S = {s}", [got],
            [mk.filter_glue_plain(st.sum(1, keepdim=True), carry, **kw)],
            [mk.filter_glue_plain(d64(st).sum(1, keepdim=True), d64(carry), m0=d64(m0),
                                  template=d64(tpl), k0=d64(k0), n=n, alpha=ALPHA)])
        check(bool(torch.isfinite(got).all()) and torch.equal(mk.filter_glue(st, carry, **kw), got),
              f"odd geometry filter_glue at S = {s}: finite, rerun bitwise equal")
        out[f"filter_glue S={s}"] = err

    # The stream statistics (stream_stats_chunk) on the blocked streams of the
    # same cubes: P = 1,485 (4-byte f32 copies, bf16 word copies) at S = 37 and
    # P = 1,500 (16-byte f32 copies, bf16 word copies) at S = 128.
    for s, (x, nb, step, _, _) in glue_inputs.items():
        out.update(odd_stream_stats(dev, x, nb, step, empty_block(x.shape[0], x.shape[1], step)))
    print("odd geometry statistics: " + json.dumps(out), flush=True)
    return out


def odd_transpose_phase(dev):
    """Phase 4d, the redesigned blocked_transpose on odd geometries: 99 x 45
    x 37 at step 15 (4-byte copies, odd P = 1,485: element-wise stores),
    unmasked and masked; 99 x 47 x 37 with a ragged last block 2 columns
    wide; 60 x 50 x 128 at step 25 (16-byte copies, 100-pixel tiles at P =
    1,500: 4-byte pair stores), unmasked and masked with block 1 wholly
    invalid; and a step of 176 columns wider than a tile (row segments of 96
    columns, 16-byte stores), unmasked at 8 x 352 x 128 and masked with a
    ragged last block at 8 x 290 x 128. Masked cubes hold -9999 and NaN at
    their invalid pixels. Each asserts the geometry it took, equals
    blocked_transpose_plain bitwise (pad rows included) and a rerun is
    bitwise identical."""
    import torch

    from starcop_tpu_torch.ops import mag1c_kernels as mk
    from starcop_tpu_torch.ops.mag1c import block_columns

    rng = np.random.default_rng(6)
    cases = (  # h, w, s, step, mask, 16-byte copies, row segments
        (99, 45, 37, 15, None, False, False), (99, 45, 37, 15, "scattered", False, False),
        (99, 47, 37, 15, "ragged", False, False), (60, 50, 128, 25, None, True, False),
        (60, 50, 128, 25, "block 1 empty", True, False), (8, 352, 128, 176, None, True, True),
        (8, 290, 128, 176, "ragged", True, True))
    for h, w, s, step, mask, aligned, segments in cases:
        nb, rows = -(-w // step), mk.stream_rows(s)
        base = rng.uniform(2.0, 6.0, (1, 1, s))
        x = rng.uniform(0.5, 2.0, (h, w, 1)) * base * (1 + 0.02 * rng.normal(size=(h, w, s)))
        x = torch.as_tensor(x.astype(np.float32), device=dev)
        valid = None
        if mask is None:
            m0 = block_columns(x, nb, step).mean(1)
        else:
            valid = torch.as_tensor(rng.random((h, w)) > 0.1, device=dev)
            if mask == "block 1 empty":
                valid[:, step:2 * step] = False
            fill = np.where(rng.random((h, w, s)) > 0.5, np.nan, FILL).astype(np.float32)
            x = torch.where(valid[..., None], x, torch.as_tensor(fill, device=dev))
            n = mk.block_valid_counts(valid, nb, step).clamp(min=1).float()
            m0 = mk.masked_block_means(x, valid, nb, step, n)
        geom = mk.cube_transpose_geometry(x, nb, step)
        name = f"blocked_transpose {h}x{w}x{s} step {step} ({mask or 'unmasked'})"
        check(geom.aligned == aligned and (geom.tile_cols < step) == segments,
              f"odd geometry {name}: {'16' if aligned else '4'}-byte copies, "
              f"{'row segments' if segments else 'whole rows'} ({geom._asdict()})")
        got = mk.blocked_transpose(x, nb, step, rows, m0, valid=valid)
        want = mk.blocked_transpose_plain(x, nb, step, rows, m0, valid=valid)
        check(same_bits(got, want) and bool(torch.isfinite(got.float()).all())
              and same_bits(mk.blocked_transpose(x, nb, step, rows, m0, valid=valid), got),
              f"odd geometry {name}: equals its twin bitwise, pad rows included, finite; "
              f"rerun bitwise identical")


def odd_stream_stats(dev, x, nb, step, valid):
    """The three stream statistics kernels on the blocked streams of the
    (H, nb * step, S) cube x: init_stats_stream on the raw f32 stream (m0, C0
    within 1e-5 of the f64 twin), init_stats_bsp on the centred bf16 stream
    masked by ``valid`` (block 1 wholly invalid: C0 within 1e-5 on the live
    blocks, 0 on the empty one), and fused_iter CHOLESKY, first and not first,
    on the raw f32 stream centred in the kernel and on the masked centred
    stream (f32 at S < 128, else bf16) with its (B, P) valid row: mean and
    covariance within 1e-5 of the f64 twin and, with mf, within 4x the f32
    twin's error + 1e-6; the empty block at mean 0, covariance 0 and mf 0.
    Every kernel bitwise equal on a rerun. Returns {check: (rel err vs f64,
    max abs err)}."""
    import torch

    from starcop_tpu_torch.ops import mag1c_kernels as mk
    from starcop_tpu_torch.ops.mag1c import _shrink_diag, block_columns
    from starcop_tpu_torch.ops.mag1c_fused import _cho_solve, _rmf_init

    h, _, s = x.shape
    p, rows = h * step, mk.stream_rows(s)
    tpl = -torch.abs(torch.sin(torch.linspace(0.3, 9.4, s, device=dev)))

    def copies(xs):
        if mk.stream_stats_geometry_for(xs, s).aligned:
            return "16-byte"
        return "4-byte" if xs.dtype == torch.float32 else "word"

    same = lambda a, b: all(torch.equal(u, v) for u, v in zip(a, b))  # noqa: E731
    out = {}

    raw = mk.blocked_transpose_shw(x.permute(2, 0, 1).contiguous(), nb, step, rows)
    m0, c0 = mk.init_stats_stream(raw, s)
    m0_64, c0_64 = mk.init_stats_stream_plain(raw.double(), s)
    m0_32, c0_32 = mk.init_stats_stream_plain(raw, s)
    e = max(rel_err(m0, m0_64), rel_err(c0, c0_64))
    name = f"init_stats_stream S = {s} P = {p}"
    check(e <= 1e-5 and same(mk.init_stats_stream(raw, s), (m0, c0)),
          f"odd geometry {name} ({copies(raw)} copies): m0, C0 rel err vs f64 twin {e:.3e} "
          f"(<= 1e-5), rerun bitwise equal")
    out[name] = (e, max(float((m0 - m0_32).abs().max()), float((c0 - c0_32).abs().max())))

    counts = mk.block_valid_counts(valid, nb, step)
    live, n = counts > 0, counts.clamp(min=1).float()
    m0_m = mk.masked_block_means(x, valid, nb, step, n)
    xs16 = mk.blocked_transpose(x, nb, step, rows, m0_m, valid=valid)
    c0_m = mk.init_stats_bsp(xs16, n, s)
    c0_m64 = mk.init_stats_bsp_plain(xs16.double(), n.double(), s)
    e = rel_err(c0_m[live], c0_m64[live])
    name = f"init_stats_bsp S = {s} P = {p}"
    check(e <= 1e-5 and int((~live).sum()) == 1 and bool((c0_m[~live] == 0).all())
          and torch.equal(mk.init_stats_bsp(xs16, n, s), c0_m),
          f"odd geometry {name} ({copies(xs16)} copies): C0 rel err vs f64 twin {e:.3e} "
          f"(<= 1e-5) on the live blocks, 0 on the empty one, rerun bitwise equal")
    out[name] = (e, float((c0_m - mk.init_stats_bsp_plain(xs16, n, s)).abs().max()))

    keep = mk._keep_rows(valid, nb, step)  # the (B, P) valid row; block 1 empty
    xc = torch.where(keep[..., None], block_columns(x, nb, step) - m0_m[:, None, :], 0.0)
    xs_m = torch.nn.functional.pad(xc.transpose(1, 2), (0, 0, 0, rows - s)).contiguous()
    if s >= 128:
        xs_m = xs_m.to(torch.bfloat16)
    every = torch.ones(nb, dtype=torch.bool, device=dev)
    for label, xs, vrow, m0_c, c0_c, center, lv in (
            ("raw f32, centred in the kernel", raw, None, m0, c0, True, every),
            (f"masked {str(xs_m.dtype)[6:]}, a (B, P) valid row", xs_m, keep, m0_m, c0_m, False,
             live)):
        tgt0 = tpl[None, :] * m0_c
        cit0 = _cho_solve(_shrink_diag(c0_c, ALPHA), tgt0)
        norm0 = (tgt0 * cit0).sum(1)
        mf0, r = _rmf_init(xs, m0_c, cit0, norm0, center)
        got = []
        for first in (True, False):
            carry = (mk.pack_carry(tgt0, torch.zeros_like(cit0), torch.ones_like(norm0)) if first
                     else mk.pack_carry(tgt0, cit0, norm0))
            kw = dict(first=first, woodbury=False, center=center)
            k = mk.fused_iter(xs, vrow, m0_c, carry, r, mf0, **kw)
            again = mk.fused_iter(xs, vrow, m0_c, carry, r, mf0, **kw)
            t32 = mk.fused_iter_plain(xs, vrow, m0_c, carry, r, mf0, **kw)
            t64 = mk.fused_iter_plain(xs, vrow, m0_c.double(), carry.double(), r.double(),
                                      mf0.double(), **kw)
            flat = [[o[0], o[1][0][lv], o[1][1][lv]] for o in (k, t32, t64)]
            e_stats = max(rel_err(a, b) for a, b in zip(flat[0][1:], flat[2][1:]))
            empty = bool((k[1][0][~lv] == 0).all() and (k[1][1][~lv] == 0).all())
            if vrow is not None:
                empty = empty and bool((k[0][~vrow] == 0).all())
            what = (f"odd geometry fused_iter CHOLESKY S = {s} P = {p} ({label}, "
                    f"{copies(xs)} copies, {'first' if first else 'not first'})")
            check(e_stats <= 1e-5 and empty and same([k[0], *k[1]], [again[0], *again[1]]),
                  f"{what}: mean, cov rel err vs f64 twin {e_stats:.3e} (<= 1e-5), the empty "
                  f"block at 0, rerun bitwise equal")
            got.append(held_against_twins(what + ": mf, mean, cov", *flat))
        out[f"fused_iter CHOLESKY S = {s} P = {p} {label}"] = (max(e for e, _ in got),
                                                              max(a for _, a in got))
    return out


def num_iter0_phase(dev, x, template, granule):
    """Phase 14: mag1c_column_blocks(num_iter=0) on the bench scene (x, on
    the card) and on a served granule, launch counts zeroed just before and
    read just after each (the rmf-only result is JAX's plain route: no
    kernel), held against reference_oracle_acrwl1mf(num_iter=0) in float64
    (on the served granule per block, over its valid pixels)."""
    import torch

    from starcop_tpu_torch.ops import mag1c_kernels as mk
    from starcop_tpu_torch.ops.mag1c import (
        block_columns,
        mag1c_column_blocks,
        reference_oracle_acrwl1mf,
        unblock_columns,
    )

    tpl = torch.as_tensor(template, dtype=torch.float32, device=dev)
    kw = dict(num_iter=0, alpha=ALPHA, device=dev)
    for name, cube, valid, step in (
            ("bench scene", x, None, STEP),
            ("served granule", torch.as_tensor(granule["cube"], device=dev),
             torch.as_tensor(granule["valid"], device=dev), MSTEP)):
        nb = -(-W // step)
        mk.reset_launch_counts()
        mf, alb = mag1c_column_blocks(cube, tpl, valid, column_step=step, **kw)
        torch.cuda.synchronize()
        launched = {k: v for k, v in mk.LAUNCH_COUNTS.items() if v}
        ok = torch.ones((H, W), dtype=torch.bool, device=dev) if valid is None else valid
        check(not launched and mf.is_cuda and mf.shape == (H, W)
              and bool(torch.isfinite(mf[ok]).all() and torch.isfinite(alb[ok]).all())
              and bool((mf[~ok] == FILL).all() and (alb[~ok] == FILL).all()),
              f"num_iter=0 on the {name}: (H, W) on the card, finite at valid pixels, the fill "
              f"value at invalid ones, no kernel launched ({launched})")
        if valid is None:
            xb = block_columns(cube.double(), nb, step).cpu().numpy()
            ref = reference_oracle_acrwl1mf(xb, template, num_iter=0, alpha=ALPHA)[0][..., 0]
        else:
            ref = np.zeros((nb, H * step))
            xm, keep = mk._masked_blocks(cube.double(), valid, nb, step)
            xm, keep = xm.cpu().numpy(), keep.cpu().numpy()
            for b in range(nb):
                if keep[b].any():
                    ref[b, keep[b]] = reference_oracle_acrwl1mf(
                        xm[b][keep[b]][None], template, num_iter=0, alpha=ALPHA)[0][0, :, 0]
        ref = unblock_columns(torch.as_tensor(ref), H, step)[:, :W].numpy()
        got = mf.cpu().numpy()
        okn = ok.cpu().numpy()
        det = int((ref[okn] > 500).sum())
        agree = float(((got[okn] > 500) == (ref[okn] > 500)).mean())
        check(det > 0 and agree >= 0.999,
              f"num_iter=0 on the {name}: threshold-500 agreement with the f64 oracle "
              f"{agree:.6f} (>= 0.999) over {det} detections; mf correlation "
              f"{corr(got[okn], ref[okn]):.7f}")


def seeded_model(dev, seed: int = 0, bf16: bool = False):
    """A full-width SegmentationModel whose output spreads over (0, 1) and
    follows the filter: Kaiming-normal (fan-out) convolutions, zero conv
    biases, batch-norm running means N(0, 0.05) and variances U(0.8, 1.2),
    and the first convolution's weights on the mag1c channel scaled by
    MF_GAIN. At the default init the U-Net's output is nearly constant, and
    without the gain it barely depends on mf (the mask correlated 0.999945
    with the same model fed mf = 0): either way a mask check could not tell
    a wrong filter from a right one. ``bf16`` gives the same weights
    bf16-resident (``cast_for_inference``)."""
    import torch
    from torch import nn

    from starcop_tpu_torch.models.segmenter import SegmentationModel, cast_for_inference

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
        model.network.encoder.features[0][0].weight[:, 0] *= MF_GAIN
    if bf16:
        cast_for_inference(model)
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
    from starcop_tpu_torch.scenes.emit_pipeline import (
        emit_granule_to_mask,
        emit_granule_to_mask_batched,
        plume_mask,
    )

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
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("ptxas:", line.strip())
    spills = stats_spills(_build.build_log())
    for family in STATS_KERNELS:
        found = {k: v for k, v in spills.items() if family in k}
        check(len(found) == 4 and all(v == (0, 0) for v in found.values()),
              f"ptxas: {len(found)} instantiations of {family} (4), none spilling "
              f"({sorted(set(found.values()))} bytes of spill stores, loads)")

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

    # 4c. other band counts: 12 and the 74-band AVIRIS-like default (not a
    # multiple of 4: the projection's tail), odd heights and widths.
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

    # 4d. the redesigned rounds' narrow-copy paths, the statistics kernels, the glue
    # and blocked_transpose on odd shapes -------------------------------------------
    odd_geometry_phase(dev)
    odd_stats_phase(dev)
    odd_transpose_phase(dev)
    for what, geom in (("filter_round (bench cube)", mk.cube_geometry(x, nb, STEP)),
                       ("filter_round_masked (served cube)",
                        mk.cube_geometry(x, -(-W // MSTEP), MSTEP)),
                       ("init_stats (bench cube)", mk.cube_stats_geometry(x, nb, STEP)),
                       ("init_stats_masked (served cube)",
                        mk.cube_stats_geometry(x, -(-W // MSTEP), MSTEP))):
        print(f"geometry {what}: {geom._asdict()}", flush=True)

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
    with torch.inference_mode():
        pred_blind = plume_mask(torch.zeros_like(mf_d)[None], torch.as_tensor(rgb, device=dev)[None],
                                model)[0].cpu().numpy()
    blind = corr(pred, pred_blind)
    check(blind < 0.99, f"mask follows the filter: correlation {blind:.6f} with the same model "
                        f"fed mf = 0 (< 0.99)")
    check(np.array_equal(mf_slice, unblock_columns(mf_k, H, STEP).cpu().numpy()),
          "slice mf equals the filter run")

    # 6. timings -----------------------------------------------------------------
    geom = mk.cube_geometry(x, nb, STEP)  # as acrwl1mf_resident works it out once
    n_round = geom.nchunks  # chunk records per block
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
            kernel=lambda: mk.filter_round(x, nb, STEP, m0, carry_k, r1, mf1, mode=mk.LOOP,
                                           geom=geom),
            plain=lambda: mk.filter_round_plain(x, nb, STEP, m0, carry_k, r1, mf1, mode=mk.LOOP),
            library=None,
            bound=bound_ms(cube_bytes + 4.0 * (3 * npix + nb * 5 * s + nb * n_round * (s + 2)),
                           npix * (5.0 * s + 12))),
        "filter_glue": dict(
            kernel=lambda: mk.filter_glue(st1, carry, **glue_kw),
            plain=lambda: mk.filter_glue_plain(st1, carry, **glue_kw),
            library=None,
            bound=bound_ms(4.0 * nb * (n_round * (s + 2) + 10 * s + s * s),
                           nb * (10.0 * s * s + 40 * s)),
            device_kernel="filter_glue_kernel"),
    }
    sources = {"init_stats": "_init_stats_swh_kernel (row 11)",
               "filter_round": "_resident_swh_kernel / _resident_filter_body (row 12)",
               "filter_glue": "_resident_swh_kernel / _glue_math :776 (row 12)"}
    lines = {"init_stats": 1332, "filter_round": 1361, "filter_glue": 1361}
    notes = {"init_stats": "one call = 2 __global__ launches (per-chunk partials, then the "
                           "f64 reduce); ms covers both",
             "filter_glue": "ms: the kernel's device time per launch (torch.profiler); "
                            "event_ms: CUDA events around back-to-back calls, which the host's "
                            "launch gaps set"}
    kernels = []
    for name, plan in timing_plan.items():
        ms = cuda_ms(plan["kernel"], inner=10)
        extra = {}
        if "device_kernel" in plan:
            extra["event_ms"] = ms
            ms = device_ms(plan["kernel"], plan["device_kernel"])
        plain_ms = cuda_ms(plan["plain"], inner=3)
        lib_ms = None if plan["library"] is None else cuda_ms(plan["library"], inner=3)
        bms, bby = plan["bound"]
        print_share(name, ms, bms)
        kernels.append(dict(
            name=name, route="cuda", source="starcop_tpu_torch/csrc/mag1c.cu",
            replaces=f"{REPLACES}:{lines[name]}", tpu_kernel=sources[name],
            launches=launches[name],
            max_abs_err=results[name]["max_abs_err"], rel_err_vs_f64=results[name]["rel_err"],
            check=results[name]["check"], ms=ms, plain_ms=plain_ms, bound_ms=bms,
            bound_by=bby, share_of_bound=bms / ms, library_ms=lib_ms, **extra,
            **({"note": notes[name]} if name in notes else {})))

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
    # Host cost of one round launch: with the filter's geometry (the main
    # path), with the geometry worked out in the call, and the geometry alone.
    loop_round = lambda **kw: mk.filter_round(x, nb, STEP, m0, carry_k, r1, mf1,  # noqa: E731
                                              mode=mk.LOOP, **kw)
    timings["round_host_us"] = host_us(lambda: loop_round(geom=geom))
    timings["round_host_geometry_us"] = host_us(loop_round)
    timings["cube_geometry_us"] = host_us(lambda: mk.cube_geometry(x, nb, STEP), n=2000)
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
    served, f32_served, serving_timings = serving_phase(dev, model, granules, mf_plain0)

    # 9. the quantized uploads, decoded on the card, against the host decode ---------
    upload_phase(dev, granules[:2])

    # 10. the unmasked bf16 stream at the bench geometry ------------------------------
    bf16_rows, bf16_timings = bf16_phase(dev, x, tpl, mf_k)
    mk.reset_launch_counts()
    pred_b, mf_b = emit_granule_to_mask(scene["radiance"], rgb, template, model,
                                        column_step=STEP, num_iter=NUM_ITER, alpha=ALPHA,
                                        stream_dtype=torch.bfloat16)
    launches_b = dict(mk.LAUNCH_COUNTS)
    print("bf16 main-path launches:", json.dumps(launches_b), flush=True)
    want = {k: 0 for k in launches_b}
    want.update({"init_stats": 1, "blocked_transpose": 1, "filter_round_bsp": NUM_ITER + 1,
                 "filter_glue": NUM_ITER})
    check(launches_b == want, f"bf16 granule -> mask launches {launches_b} (want {want}: one "
                              f"bf16 filter, no K1 or K2 round)")
    pred_b = pred_b.cpu().numpy()
    check(pred_b.shape == (H, W) and bool(np.isfinite(pred_b).all()),
          f"bf16 granule -> mask: mask {pred_b.shape} finite")
    bf16_contract(mf_slice, mf_b, "bf16 granule -> mask mf vs the f32 slice's")
    for row in bf16_rows:
        row["launches"] = launches_b[row["name"]]
    # The batched entry point: two copies of the scene side by side, one filter.
    mk.reset_launch_counts()
    _, mf_bb = emit_granule_to_mask_batched(np.stack([scene["radiance"]] * 2),
                                            np.stack([rgb] * 2), template, model,
                                            column_step=STEP, num_iter=NUM_ITER, alpha=ALPHA,
                                            stream_dtype=torch.bfloat16)
    launches_bb = dict(mk.LAUNCH_COUNTS)
    cb = corr(mf_bb[1], mf_b)
    check(launches_bb == want and cb > 0.9999,
          f"bf16 batched granules -> masks (B = 2): launches {launches_bb} as one filter's, "
          f"each scene's mf correlation {cb:.7f} with the single call's (> 0.9999)")
    with torch.inference_mode():
        bf16_timings["granule_to_mask_bf16_ms"] = cuda_ms(lambda: emit_granule_to_mask(
            x, x_dev_rgb, template, model, column_step=STEP, num_iter=NUM_ITER, alpha=ALPHA,
            stream_dtype=torch.bfloat16))
    glue = next(k for k in kernels if k["name"] == "filter_glue")
    init = next(k for k in kernels if k["name"] == "init_stats")
    init.update(bf16_launches=launches_b["init_stats"],
                also_replaces=f"{REPLACES}:1164 (_init_stats_kernel, row 10, on the bf16 route)")
    shared = (init, launches_b["init_stats"]), (glue, launches_b["filter_glue"])
    bf16_timings["bf16_filter_bound_ms"] = (
        sum(k["bound_ms"] * k["launches"] for k in bf16_rows)
        + sum(k["bound_ms"] * c for k, c in shared))
    bf16_timings["bf16_filter_kernels_ms"] = (
        sum(k["ms"] * k["launches"] for k in bf16_rows) + sum(k["ms"] * c for k, c in shared))
    profile_granule(lambda: emit_granule_to_mask(x, x_dev_rgb, template, model,
                                                 column_step=STEP, num_iter=NUM_ITER,
                                                 alpha=ALPHA, stream_dtype=torch.bfloat16),
                    "granule_to_mask_bf16")

    # 11. the masked bf16 stream on a served granule, then served with the bf16-resident
    # U-Net ------------------------------------------------------------------------------
    masked_bf16_rows, masked_bf16_timings = masked_bf16_phase(dev, template, granules[0])
    model_bf16 = seeded_model(dev, bf16=True)
    served_b, served_bf16_timings = serving_bf16_phase(dev, model, model_bf16, granules,
                                                       f32_served)
    with torch.inference_mode():
        served_bf16_timings["unet_forward_bf16_ms"] = cuda_ms(lambda: model_bf16(unet_in))
    count_key = {"blocked_transpose_masked": "blocked_transpose"}
    for row in masked_bf16_rows:
        row["launches"] = served_b[count_key.get(row["name"], row["name"])]
    n_g = len(granules)
    masked_bf16_timings["bf16_masked_filter_bound_ms"] = (
        sum(k["bound_ms"] * k["launches"] / n_g for k in masked_bf16_rows)
        + glue["bound_ms"] * served_b["filter_glue"] / n_g)
    masked_bf16_timings["bf16_masked_filter_kernels_ms"] = (
        sum(k["ms"] * k["launches"] / n_g for k in masked_bf16_rows)
        + glue["ms"] * served_b["filter_glue"] / n_g)
    per_granule = {k: v / len(granules) for k, v in served.items()}
    for row in masked_rows:
        row["launches"] = served[row["name"]]
        if row["name"] == "init_stats_masked":
            row["note"] = notes["init_stats"]
    glue.update(served_launches=served["filter_glue"],
                served_rel_err_vs_f64=glue_masked["rel_err"],
                served_max_abs_err=glue_masked["max_abs_err"],
                bf16_launches=launches_b["filter_glue"],
                bf16_served_launches=served_b["filter_glue"])
    masked_timings["masked_filter_bound_ms"] = (
        sum(k["bound_ms"] * per_granule[k["name"]] for k in masked_rows)
        + glue["bound_ms"] * per_granule["filter_glue"])
    masked_timings["masked_filter_kernels_ms"] = (
        sum(k["ms"] * per_granule[k["name"]] for k in masked_rows)
        + glue["ms"] * per_granule["filter_glue"])
    kernels += masked_rows + bf16_rows + masked_bf16_rows

    # 12. the kernels of the remaining routes on the bench blocks ----------------------
    route_rows, x_shw, xs_stream, m0_s, c0_s = stream_kernels_phase(dev, x, tpl)

    # 13. the whole filters of those routes, launches counted per route --------------
    route_launches, route_timings = fused_routes_phase(dev, x_shw, xs_stream, m0_s, c0_s, tpl,
                                                       mf_32, mf_64, r_64)
    counted_on = {"blocked_transpose_shw": "shw", "init_stats_stream": "shw",
                  "filter_round_bsp_f32": "shw", "fused_iter_woodbury": "woodbury",
                  "fused_iter_cholesky": "cholesky", "filter_round_mono_first": "mono",
                  "filter_round_mono_loop": "mono"}
    for row in route_rows:
        row["launches"] = route_launches[counted_on[row["name"]]][row["name"]]
    for route, names in (("mono", ("init_stats_stream", "filter_round_mono_first",
                                   "filter_round_mono_loop")),
                         ("woodbury", ("init_stats_stream", "fused_iter_woodbury")),
                         ("shw", ("blocked_transpose_shw", "init_stats_stream",
                                  "filter_round_bsp_f32"))):
        used = [k for k in route_rows if k["name"] in names]
        glues = route_launches[route]["filter_glue"]
        route_timings[f"{route}_filter_bound_ms"] = (
            sum(k["bound_ms"] * k["launches"] for k in used) + glue["bound_ms"] * glues)
        route_timings[f"{route}_filter_kernels_ms"] = (
            sum(k["ms"] * k["launches"] for k in used) + glue["ms"] * glues)
    kernels += route_rows

    # 14. num_iter=0: JAX's plain route, on the bench scene and a served granule ------
    num_iter0_phase(dev, x, template, granules[0])
    print("timings " + json.dumps({"card": card, **timings, **masked_timings,
                                   **serving_timings, **bf16_timings, **masked_bf16_timings,
                                   **served_bf16_timings, **route_timings}), flush=True)
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
