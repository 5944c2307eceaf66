"""Raw EMIT granule -> plume mask (counterpart of starcop_tpu/scenes/emit_pipeline.py).

  band-selected radiance -> column-blocked matched filter (30 iterations,
  alpha 1e-4) -> EMIT->AVIRIS renormalisation -> reflect-padded whole-scene
  U-Net forward -> sigmoid mask.

``emit_granule_to_mask`` uploads the cube and the RGB once, keeps every
stage on the device, and downloads the mask and the filter output together
once. The batched variant and ``emit_inference`` (the h5 reader) wait for a
later slice.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from starcop_tpu_torch.data.emit import DEFAULT_WAVELENGTH_RANGE, renormalize_emit_to_aviris
from starcop_tpu_torch.device import DeviceLike, float32_precision, resolve_device
from starcop_tpu_torch.ops.ch4_template import generate_template_from_bands
from starcop_tpu_torch.ops.mag1c import NODATA, mag1c_column_blocks
from starcop_tpu_torch.ops.padding import padded_apply


def emit_mag1c(
    radiance: np.ndarray,
    wavelengths: np.ndarray,
    fwhm: np.ndarray,
    valid_mask: Optional[np.ndarray] = None,
    *,
    wavelength_range: Tuple[float, float] = DEFAULT_WAVELENGTH_RANGE,
    column_step: int = 32,
    num_iter: int = 30,
    alpha: float = 1e-4,
    device: DeviceLike = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Matched filter over an EMIT-like (rows, cols, bands) radiance cube.

    Selects the bands inside ``wavelength_range``, builds the CH4 template
    for them, and runs ``mag1c_column_blocks``. Returns (mf, albedo) float32
    (rows, cols) numpy arrays with NODATA at invalid pixels.
    """
    dev = resolve_device(device)
    sel = (wavelengths >= wavelength_range[0]) & (wavelengths <= wavelength_range[1])
    if not sel.any():
        raise ValueError("No bands in the selected wavelength range")
    target = generate_template_from_bands(wavelengths[sel], fwhm[sel])[:, 1]
    cube = np.asarray(radiance[..., sel], np.float32)
    mf, albedo = mag1c_column_blocks(
        cube, target, valid_mask, column_step=column_step, num_iter=num_iter, alpha=alpha,
        device=dev,
    )
    return mf.cpu().numpy(), albedo.cpu().numpy()


def plume_mask(mf: torch.Tensor, rgb_chw: torch.Tensor, model_apply: Callable) -> torch.Tensor:
    """Matched filter (H, W) and RGB radiance (3, H, W) -> sigmoid mask (H, W):
    renormalise into the AVIRIS domain, reflect-pad to a multiple of 32, run
    ``model_apply`` ((1, 4, H', W') -> (1, 1, H', W') logits) and crop."""
    m_n, rgb_n = renormalize_emit_to_aviris(torch.where(mf == NODATA, 0.0, mf), rgb_chw)
    model_input = torch.cat([m_n[None], rgb_n])
    pred = padded_apply(model_input, lambda b: torch.sigmoid(model_apply(b)), divisor=32)
    return pred[0] if pred.ndim == 3 else pred


def emit_granule_to_mask(
    cube,
    rgb_chw,
    template,
    model_apply: Callable[[torch.Tensor], torch.Tensor],
    *,
    column_step: int = 54,
    num_iter: int = 30,
    alpha: float = 1e-4,
    valid_mask=None,
    device: DeviceLike = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Raw granule -> plume mask with one upload and one download.

    Args:
        cube: (H, W, S) radiance already band-selected to the filter window.
        rgb_chw: (3, H, W) radiance at the RGB picks.
        template: (S,) target spectrum.
        model_apply: (1, 4, H', W') input -> (1, 1, H', W') logits, on
            ``device`` (e.g. a ``models.segmenter.SegmentationModel`` in eval
            mode, which normalises its input).

    Returns:
        (prediction (H, W), mf (H, W)) float32 numpy arrays.
    """
    dev = resolve_device(device)
    with torch.inference_mode(), float32_precision():
        x = torch.as_tensor(cube, dtype=torch.float32, device=dev)
        rgb = torch.as_tensor(rgb_chw, dtype=torch.float32, device=dev)
        mf, _ = mag1c_column_blocks(
            x, template, valid_mask, column_step=column_step, num_iter=num_iter,
            alpha=alpha, device=dev,
        )
        pred = plume_mask(mf, rgb, model_apply)
        out = torch.stack([pred, mf]).cpu().numpy()
    return out[0], out[1]
