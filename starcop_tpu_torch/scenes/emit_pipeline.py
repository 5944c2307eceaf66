"""Raw EMIT granule -> plume mask (counterpart of starcop_tpu/scenes/emit_pipeline.py).

  band-selected radiance -> column-blocked matched filter (30 iterations,
  alpha 1e-4) -> EMIT->AVIRIS renormalisation -> reflect-padded whole-scene
  U-Net forward -> sigmoid mask.

``emit_granule_to_mask`` (and its batched variant) keep every stage on the
device and return device tensors, so that a caller downloads once (the
serving pipeline stacks the mask and the filter output into one transfer).
``emit_inference`` is the step-by-step flow over an opened ``EMITRawScene``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from starcop_tpu_torch.data.emit import (
    DEFAULT_WAVELENGTH_RANGE,
    EMITRawScene,
    renormalize_emit_to_aviris,
)
from starcop_tpu_torch.device import DeviceLike, float32_precision, resolve_device
from starcop_tpu_torch.ops.ch4_template import generate_template_from_bands
from starcop_tpu_torch.ops.mag1c import NODATA, mag1c_column_blocks
from starcop_tpu_torch.ops.padding import find_padding, reflect_pad
from starcop_tpu_torch.parallel.mesh import mesh_device
from starcop_tpu_torch.parallel.scene_mag1c import sharded_mag1c_scene
from starcop_tpu_torch.utils.profiling import count, span
from starcop_tpu_torch.utils.staging import stage_to_device


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
    mesh=None,
    compute_dtype=torch.float32,
    device: DeviceLike = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Matched filter over an EMIT-like (rows, cols, bands) radiance cube.

    Selects the bands inside ``wavelength_range``, builds the CH4 template
    for them, and runs ``mag1c_column_blocks`` (``compute_dtype`` f32, or
    f64 for parity runs), or with a ``mesh`` (``parallel.Mesh``) the column
    blocks split over its ranks (``parallel.sharded_mag1c_scene``, on the
    mesh's device; a ``device`` other than it raises). Returns (mf, albedo)
    float32 (rows, cols) numpy arrays with NODATA at invalid pixels.
    """
    sel = (wavelengths >= wavelength_range[0]) & (wavelengths <= wavelength_range[1])
    if not sel.any():
        raise ValueError("No bands in the selected wavelength range")
    target = generate_template_from_bands(wavelengths[sel], fwhm[sel])[:, 1]
    cube = np.asarray(radiance[..., sel], np.float32)
    kw = dict(column_step=column_step, num_iter=num_iter, alpha=alpha,
              compute_dtype=compute_dtype)
    if mesh is not None:
        mesh_device(mesh, device)
        mf, albedo = sharded_mag1c_scene(cube, target, valid_mask, mesh=mesh, **kw)
    else:
        mf, albedo = mag1c_column_blocks(cube, target, valid_mask, device=resolve_device(device),
                                         **kw)
    return mf.cpu().numpy().astype(np.float32), albedo.cpu().numpy().astype(np.float32)


def plume_mask(mf: torch.Tensor, rgb_chw: torch.Tensor, model_apply: Callable) -> torch.Tensor:
    """Matched filter (B, H, W) and RGB radiance (B, 3, H, W) -> sigmoid mask
    (B, H, W): renormalise into the AVIRIS domain (NODATA to 0), reflect-pad
    to a multiple of 32, run ``model_apply`` ((B, 4, H', W') -> (B, 1, H', W')
    logits) and crop."""
    h, w = mf.shape[-2:]
    m_n, rgb_n = renormalize_emit_to_aviris(torch.where(mf == NODATA, 0.0, mf), rgb_chw)
    model_input = torch.cat([m_n[:, None], rgb_n], dim=1)  # (B, 4, H, W)
    pad_r, pad_c = find_padding(h, 32), find_padding(w, 32)
    out = torch.sigmoid(model_apply(reflect_pad(model_input, pad_r, pad_c)))
    rows = slice(pad_r[0], None if pad_r[1] <= 0 else -pad_r[1])
    cols = slice(pad_c[0], None if pad_c[1] <= 0 else -pad_c[1])
    return out[:, 0, rows, cols]


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
    stream_dtype=None,
    device: DeviceLike = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Raw granule -> plume mask, every stage on the device.

    Args:
        cube: (H, W, S) radiance already band-selected to the filter window.
        rgb_chw: (3, H, W) radiance at the RGB picks.
        template: (S,) target spectrum.
        model_apply: (1, 4, H', W') input -> (1, 1, H', W') logits, on
            ``device`` (e.g. a ``models.segmenter.SegmentationModel`` in eval
            mode, which normalises its input).
        valid_mask: optional (H, W) bool; invalid pixels leave the filter's
            statistics and come out NODATA in mf (0 in the model input).
        stream_dtype: the filter's stream, None / ``torch.float32`` or
            ``torch.bfloat16`` (half the bytes per pass; see
            ``ops.mag1c.mag1c_column_blocks``).

    Returns:
        (prediction (H, W), mf (H, W)) float32 tensors on ``device``.

    A host input bound for the card (numpy or a CPU tensor, 8 MiB or more as
    float32: the cube, then the RGB planes) is staged through a pinned ring
    kept across calls, its host copy of one row band overlapping the DMA of
    the band before (``utils.staging.stage_to_device``); anything else moves
    by ``torch.as_tensor``. Either way the card receives the same float32
    values.

    Traced (``utils.profiling``), the inputs' move to the device is span
    ``entry.upload``, its counter ``bytes`` the bytes of the inputs handed in
    from host memory (0 for tensors on the device already) and its counter
    ``staged_bytes`` the part of them that went through the ring (absent
    when none did), and the filter is span ``entry.filter``.
    """
    dev = resolve_device(device)
    with torch.inference_mode(), float32_precision():
        with span("entry.upload") as upload:
            x = stage_to_device(cube, dev)
            rgb = stage_to_device(rgb_chw, dev)
            if upload is not None:
                count("bytes", _host_bytes(cube, dev) + _host_bytes(rgb_chw, dev))
        with span("entry.filter"):
            mf, _ = mag1c_column_blocks(
                x, template, valid_mask, column_step=column_step, num_iter=num_iter,
                alpha=alpha, stream_dtype=stream_dtype, device=dev,
            )
        return plume_mask(mf[None], rgb[None], model_apply)[0], mf


def _host_bytes(a, dev: torch.device) -> int:
    """The bytes ``torch.as_tensor(a, device=dev)`` reads from ``a``: 0 for
    a tensor already on a ``dev.type`` device."""
    if isinstance(a, torch.Tensor):
        return 0 if a.device.type == dev.type else a.nbytes
    return np.asarray(a).nbytes


def emit_granule_to_mask_batched(
    cubes,
    rgbs_chw,
    template,
    model_apply: Callable[[torch.Tensor], torch.Tensor],
    *,
    column_step: int = 54,
    num_iter: int = 30,
    alpha: float = 1e-4,
    stream_dtype=None,
    device: DeviceLike = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """B same-shaped granules -> plume masks in one filter and one U-Net call.

    The scenes are laid side by side along the width before the
    column-blocked filter. Column blocks are the statistic unit, so as long
    as each width is a multiple of ``column_step`` no block straddles two
    scenes and each result equals a separate call's; a ragged width would
    merge one scene's tail block with the next scene's first columns, so it
    raises.

    Args:
        cubes: (B, H, W, S) radiance, band-selected to the filter window.
        rgbs_chw: (B, 3, H, W) radiance at the RGB picks.
        template: (S,) target spectrum.
        model_apply: (B, 4, H', W') input -> (B, 1, H', W') logits.
        stream_dtype: the filter's stream, as in ``emit_granule_to_mask``.

    Returns:
        (prediction (B, H, W), mf (B, H, W)) float32 tensors on ``device``.
    """
    dev = resolve_device(device)
    b, h, w, s = cubes.shape
    if w % column_step:
        raise ValueError(
            f"batched granule->mask requires width ({w}) to be a multiple of "
            f"column_step ({column_step}): a ragged tail block would merge "
            "statistics across scenes"
        )
    with torch.inference_mode(), float32_precision():
        x = torch.as_tensor(cubes, dtype=torch.float32, device=dev)
        wide = x.permute(1, 0, 2, 3).reshape(h, b * w, s)  # (H, B*W, S)
        mf_wide, _ = mag1c_column_blocks(
            wide, template, None, column_step=column_step, num_iter=num_iter, alpha=alpha,
            stream_dtype=stream_dtype, device=dev,
        )
        mf = mf_wide.reshape(h, b, w).permute(1, 0, 2)  # (B, H, W)
        rgb = torch.as_tensor(rgbs_chw, dtype=torch.float32, device=dev)
        return plume_mask(mf, rgb, model_apply), mf


def emit_inference(
    scene: EMITRawScene,
    model_apply: Callable[[torch.Tensor], torch.Tensor],
    *,
    column_step: int = 32,
    num_iter: int = 30,
    alpha: float = 1e-4,
    mesh=None,
    georeference: bool = False,
    device: DeviceLike = None,
) -> Dict[str, np.ndarray]:
    """Full zero-shot pipeline on a raw EMIT granule, step by step.

    Args:
        scene: an opened ``EMITRawScene``.
        model_apply: (1, 4, H', W') normalized-domain input -> (1, 1, H', W')
            logits on ``device``; the channels are [mag1c, R, G, B] in the
            AVIRIS training domain.
        mesh: optional ``parallel.Mesh``: the filter's column blocks split
            over its ranks (every rank then holds the whole mf and runs the
            U-Net on its device, the mesh's).
        georeference: also gather the outputs onto the GLT grid.

    Returns a dict of numpy arrays: mag1c, albedo, rgb, prediction (sigmoid)
    and, if asked, mag1c_geo and prediction_geo.
    """
    dev = resolve_device(device) if mesh is None else mesh_device(mesh, device)
    sel = scene.band_slice()
    cube = scene.read_bands(sel)
    invalid = scene.invalid_mask(cube)
    mf, albedo = emit_mag1c(cube, scene.wavelengths[sel], scene.fwhm[sel], ~invalid,
                            column_step=column_step, num_iter=num_iter, alpha=alpha, mesh=mesh,
                            device=dev)
    rgb = scene.read_rgb()  # (rows, cols, 3)
    with torch.inference_mode(), float32_precision():
        pred = plume_mask(torch.as_tensor(mf, device=dev)[None],
                          torch.as_tensor(np.moveaxis(rgb, -1, 0), device=dev)[None],
                          model_apply)[0].cpu().numpy()
    out = {"mag1c": mf, "albedo": albedo, "rgb": rgb, "prediction": pred}
    if georeference:
        out["mag1c_geo"] = scene.georeference(mf)
        out["prediction_geo"] = scene.georeference(pred, fill_value=0.0)
    return out
