"""Band-ratio and regression products for multispectral sensors
(counterpart of starcop_tpu/ops/ratios.py).

The mag1c loss weight, the Varon-style outlier-robust two-band ratio, the
Sanchez-Garcia multiple-linear-regression ratio in its four division modes,
and the linear-regression residual. Plain torch on the tensors' device; the
least-squares solves run in full f32 (TF32 off, ``float32_precision``).

The percentiles of the outlier rejection interpolate linearly between the
sorted values, as ``jnp.percentile`` does, by a sort: ``torch.quantile``
refuses inputs of more than 2^24 elements, which a scene's band exceeds.
"""

from __future__ import annotations

from typing import Sequence

import torch

from starcop_tpu_torch.device import float32_precision


def weight_mag1c(mag1c: torch.Tensor) -> torch.Tensor:
    """Per-pixel loss weight from the matched filter: clip(mag1c / 400, 0.1,
    1), down-weighting pixels the filter already marks ambiguous
    (ratios.py:23-30)."""
    return torch.clamp(torch.as_tensor(mag1c) / 400.0, 0.1, 1.0)


def _percentiles(sorted_flat: torch.Tensor, qs: Sequence[float]):
    """The ``qs`` percentiles (0-100) of sorted values, linearly interpolated
    between the two nearest ranks (numpy's and ``torch.quantile``'s default)."""
    n = sorted_flat.numel()
    out = []
    for q in qs:
        pos = q / 100.0 * (n - 1)
        lo = int(pos)
        hi = min(lo + 1, n - 1)
        out.append(torch.lerp(sorted_flat[lo], sorted_flat[hi], pos - lo))
    return out


def _inlier_sum(d: torch.Tensor, percentile: float) -> torch.Tensor:
    """Sum of the elements within the [p, 100 - p] percentile range."""
    flat = d.reshape(-1)
    lo, hi = _percentiles(torch.sort(flat).values, (percentile, 100.0 - percentile))
    return torch.where((flat >= lo) & (flat <= hi), flat, 0.0).sum()


def ratio_2c_match_c_from_sums_outlier(
    background_channel: torch.Tensor,
    signal: torch.Tensor,
    p: float = 5.0,
    zero_value_out: float = -0.6,
) -> torch.Tensor:
    """Outlier-robust two-band ratio (Varon et al. 2021 style):
    c = sum(background inliers) / sum(signal inliers),
    R = (c * signal - background) / (background + 1e-6), and
    ``zero_value_out`` where both bands are ~0 (ratios.py:41-57)."""
    zero_both = (signal < 1e-6) & (background_channel < 1e-6)
    c = _inlier_sum(background_channel, p) / _inlier_sum(signal, p)
    r = (c * signal - background_channel) / (background_channel + 1e-6)
    return torch.where(zero_both, zero_value_out, r)


def _ols_fit_predict(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Ordinary least squares with intercept; the in-sample predictions.
    x (N, K) regressors, y (N,) target, by the normal equations of the
    centred system with a ridge jitter of 1e-6 of the gram's mean eigenvalue,
    so a rank-deficient regressor set (a constant or duplicated band) gives
    the minimum-norm fit's predictions rather than NaN (ratios.py:60-82).
    The right-hand side is a column sum: on the CPU, MKL's product of the
    transposed regressors and the target sums in an order set by the thread
    count (in f32 up to 7x farther from f64 on one thread than on eight, at
    1,920 pixels); torch's sum gave the same bits on 1-8 threads up to 2^20
    pixels."""
    xm = x.mean(0, keepdim=True)
    ym = y.mean()
    xc = x - xm
    with float32_precision():
        gram = xc.T @ xc
        k = x.shape[1]
        eps = 1e-6 * (torch.trace(gram) / k) + 1e-30
        coef = torch.linalg.solve(gram + eps * torch.eye(k, dtype=x.dtype, device=x.device),
                                  (xc * (y - ym)[:, None]).sum(0))
        return xc @ coef + ym


def ratio_mlr_local(
    bands_bg: Sequence[torch.Tensor],
    band_target_signal: torch.Tensor,
    division: str = "c_matched_outliers",
    autoclip: bool = False,
) -> torch.Tensor:
    """MLR ratio (Sanchez-Garcia et al. 2022): regress the target band on the
    background bands, then ratio the target against its reconstruction.

    Division modes (ratios.py:85-128):
      * ``simple``: L / L_ref; no-data pixels -> 1.
      * ``simple_plus``: -(L / L_ref), z-scored per tile; no-data -> min.
      * ``residual``: (L - L_ref) / L_ref; no-data -> 0.
      * ``c_matched_outliers`` (default): outlier-robust c-matched ratio of
        target vs reconstruction; no-data -> -0.5.
    ``autoclip`` clips the result to [-0.2, 0.2].
    """
    target = band_target_signal
    x = torch.stack([b.reshape(-1) for b in bands_bg], dim=1)
    recon = _ols_fit_predict(x, target.reshape(-1)).reshape(target.shape)
    nodata = target == 0.0
    if division == "simple":
        r = torch.where(nodata, 1.0, target / (recon + 1e-6))
    elif division == "simple_plus":
        r = -(target / (recon + 1e-6))
        r = (r - r.mean()) / r.std(correction=0)
        r = torch.where(nodata, r.min(), r)
    elif division == "residual":
        r = torch.where(nodata, 0.0, (target - recon) / (recon + 1e-6))
    elif division == "c_matched_outliers":
        r = ratio_2c_match_c_from_sums_outlier(target, recon, zero_value_out=-0.5)
        r = torch.where(nodata, -0.5, r)
    else:
        raise ValueError(f"Unknown division mode: {division}")
    if autoclip:
        r = torch.clamp(r, -0.2, 0.2)
    return r


def lr_bands(regressors: Sequence[torch.Tensor], signal: torch.Tensor) -> torch.Tensor:
    """Linear-regression residual product (Sanchez-Garcia et al. 2021): fit
    the signal on the regressors with an intercept and return prediction -
    signal (ratios.py:131-138)."""
    x = torch.stack([r.reshape(-1) for r in regressors], dim=1)
    return _ols_fit_predict(x, signal.reshape(-1)).reshape(signal.shape) - signal
