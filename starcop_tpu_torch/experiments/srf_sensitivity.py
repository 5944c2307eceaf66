"""SRF approximation sensitivity: bound the error of the tabulated SRFs
(counterpart of the JAX package's ``experiments/srf_sensitivity/run.py``:
the same constants, perturbation family, numpy draws in the same order,
and summary layout).

The framework ships super-Gaussian SRF tabulations built from published
band centers and FWHM (``data/srf.py``). This harness perturbs the band
shapes within published instrument tolerances (center shift, FWHM scale,
edge slope, in-band ripple), runs the WV3 simulation -> Varon ratio ->
detection chain on a synthetic plume scene for each draw on ``device``,
and reports the deltas on simulated radiances, ratio products and best-F1
detection.

    python -m starcop_tpu_torch.experiments.srf_sensitivity [--quick] [--out PATH]
        [--device cpu]

writes the summary (default ``srf_sensitivity_summary.json`` beside this
file).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from starcop_tpu_torch.device import DeviceLike

# Published instrument tolerances bounding the perturbation family:
#   center: S2 MSI spectral calibration accuracy is <~1 nm; WV3 SWIR band
#           placement tolerance a few nm -> +-3 nm is conservative.
#   FWHM:   +-5% covers the spread between published unit values.
#   order:  super-Gaussian order +-2 spans Gaussian-ish (2) to near-square (8)
#           edge slopes.
#   ripple: +-3% sinusoidal in-band ripple (interference-filter fringing).
CENTER_TOL_NM = 3.0
FWHM_TOL = 0.05
ORDER_RANGE = (2, 8)
RIPPLE = 0.03

VARON_PAIRS = [("SWIR7", "SWIR5"), ("SWIR8", "SWIR5"), ("SWIR7", "SWIR6")]
BAND_NAMES = ["SWIR5", "SWIR6", "SWIR7", "SWIR8"]
DEFAULT_OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "srf_sensitivity_summary.json")


def perturbed_table(rng, bands, orders, step_nm=1.0):
    """A measured-like SRF table drawn from the tolerance family."""
    from starcop_tpu_torch.data.srf import super_gaussian

    names = list(bands)
    lo = min(c - 1.3 * f for c, f in bands.values())
    hi = max(c + 1.3 * f for c, f in bands.values())
    wl = np.arange(np.floor(lo), np.ceil(hi) + step_nm, step_nm)
    cols = []
    for name in names:
        c, f = bands[name]
        c = c + rng.uniform(-CENTER_TOL_NM, CENTER_TOL_NM)
        f = f * (1.0 + rng.uniform(-FWHM_TOL, FWHM_TOL))
        order = int(np.clip(orders + rng.integers(-2, 3), *ORDER_RANGE))
        v = super_gaussian(wl, c, f, order)
        phase = rng.uniform(0, 2 * np.pi)
        v = v * (1.0 + RIPPLE * np.sin(2 * np.pi * (wl - c) / (f / 3.0) + phase))
        cols.append(np.clip(v, 0.0, None))
    values = np.stack(cols, axis=1)
    values[values < 1e-6] = 0.0
    keep = values.any(axis=1)
    return wl[keep], values[keep], names


def best_f1(score, label, n_thr=64):
    """Threshold-free detection quality: best F1 over a quantile sweep."""
    flat = score.ravel()
    lab = label.ravel() > 0
    thrs = np.quantile(flat, np.linspace(0.5, 0.999, n_thr))
    best = 0.0
    for t in thrs:
        pred = flat > t
        tp = float(np.sum(pred & lab))
        denom = float(pred.sum() + lab.sum())
        if denom:
            best = max(best, 2 * tp / denom)
    return best


def run(quick: bool = False, seed: int = 0, size: int = None, n_draws: int = None,
        device: DeviceLike = None):
    """The sensitivity summary; the simulation and the ratios run on
    ``device`` (None: the CUDA card) in the scene's float32."""
    import torch

    from starcop_tpu_torch.data.sensors import (
        WV3_SWIR_CENTERS_FWHM,
        gaussian_srf_weights,
        srf_from_table,
        transform_to_srf,
    )
    from starcop_tpu_torch.data.srf import _ORDER, WV3_BANDS, srf_table_weights
    from starcop_tpu_torch.data.synthetic import synthetic_scene
    from starcop_tpu_torch.device import resolve_device
    from starcop_tpu_torch.ops.ch4_template import generate_template_from_bands
    from starcop_tpu_torch.ops.ratios import ratio_2c_match_c_from_sums_outlier

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    size = size or (128 if quick else 256)
    n_draws = n_draws or (4 if quick else 24)

    # AVIRIS-like grid covering the WV3 SWIR5-8 window (the Varon-chain
    # bands); the CH4 LUT starts at 1399.6 nm.
    centers = np.arange(1400.0, 2500.0, 5.0)
    fwhm = np.full_like(centers, 5.5)
    template = generate_template_from_bands(centers, fwhm)[:, 1]
    # Plume strength such that the nominal Varon chain lands mid-range
    # (best-F1 ~0.5-0.7): a delta-F1 bound only means something where the
    # detector has headroom in both directions.
    scene = synthetic_scene(
        rng, size, size, n_plumes=4, template=template, n_confounders=2,
        max_concentration=1200.0, noise=0.02,
    )
    cube = torch.as_tensor(scene["radiance"], device=dev)
    label = scene["label"]

    def simulate(weights):
        sim = transform_to_srf(cube, weights, device=dev)
        bands = dict(zip(BAND_NAMES, sim))
        # The CH4-absorbing band is the ``background_channel`` and the
        # non-absorbing band the ``signal``, so R = (c*SWIR5 - SWIR7) /
        # (SWIR7 + eps) is positive over plumes (the >0.05 Varon threshold).
        ratios = {f"{a}/{b}": ratio_2c_match_c_from_sums_outlier(bands[a], bands[b])
                  .cpu().numpy() for a, b in VARON_PAIRS}
        return sim.cpu().numpy(), ratios

    w_nom, _ = srf_table_weights(centers, "WV3", bands=BAND_NAMES)
    sim_nom, ratios_nom = simulate(w_nom)
    f1_nom = {k: best_f1(v, label) for k, v in ratios_nom.items()}

    # Context row: the Gaussian fallback against the shipped super-Gaussian.
    w_gauss, _ = gaussian_srf_weights(centers, WV3_SWIR_CENTERS_FWHM, BAND_NAMES)
    sim_g, ratios_g = simulate(w_gauss)

    def deltas(sim, ratios):
        band_rel = float(np.max([
            np.sqrt(np.mean((sim[i] - sim_nom[i]) ** 2)) / (np.mean(np.abs(sim_nom[i])) + 1e-12)
            for i in range(len(BAND_NAMES))]))
        ratio_rms = float(np.max([np.sqrt(np.mean((ratios[k] - ratios_nom[k]) ** 2))
                                  for k in ratios_nom]))
        df1 = {k: best_f1(ratios[k], label) - f1_nom[k] for k in ratios_nom}
        return band_rel, ratio_rms, df1

    draws = []
    for d in range(n_draws):
        wl, values, names = perturbed_table(rng, WV3_BANDS, _ORDER["WV3"])
        idx = [names.index(b) for b in BAND_NAMES]
        w_pert = srf_from_table(centers, wl, values[:, idx])
        band_rel, ratio_rms, df1 = deltas(*simulate(w_pert))
        draws.append({"band_rel_rms": band_rel, "ratio_rms": ratio_rms, "delta_f1": df1})
        print(f"draw {d}: band_rel_rms {band_rel:.2e}, ratio_rms {ratio_rms:.2e}, "
              f"dF1 max {max(abs(v) for v in df1.values()):.4f}", file=sys.stderr)

    g_band, g_ratio, g_df1 = deltas(sim_g, ratios_g)
    return {
        "config": {
            "size": size, "n_draws": n_draws, "seed": seed,
            "center_tol_nm": CENTER_TOL_NM, "fwhm_tol": FWHM_TOL,
            "order_range": list(ORDER_RANGE), "ripple": RIPPLE,
        },
        "nominal_best_f1": f1_nom,
        "perturbation_family": {
            "band_rel_rms_max": max(d["band_rel_rms"] for d in draws),
            "band_rel_rms_mean": float(np.mean([d["band_rel_rms"] for d in draws])),
            "ratio_rms_max": max(d["ratio_rms"] for d in draws),
            "ratio_rms_mean": float(np.mean([d["ratio_rms"] for d in draws])),
            "abs_delta_f1_max": max(abs(v) for d in draws for v in d["delta_f1"].values()),
            "abs_delta_f1_mean": float(
                np.mean([abs(v) for d in draws for v in d["delta_f1"].values()])),
        },
        "gaussian_fallback_vs_table": {
            "band_rel_rms": g_band, "ratio_rms": g_ratio,
            "abs_delta_f1_max": max(abs(v) for v in g_df1.values()),
        },
        "draws": draws,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="SRF approximation sensitivity")
    p.add_argument("--quick", action="store_true")
    p.add_argument("--out", default=DEFAULT_OUT)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)
    summary = run(quick=args.quick, device=args.device)
    with open(args.out, "w") as fh:
        json.dump(summary, fh, indent=1)
    print(json.dumps(summary["perturbation_family"]))
    print(f"wrote {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
