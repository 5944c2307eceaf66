"""AVIRIS full-scene matched filter by detector column groups.

Counterpart of ``starcop_tpu/scenes/aviris_pipeline.py``. An AVIRIS
pushbroom scene carries a GLT band mapping every pixel to its detector sample
(CCD column), and the filter's statistics must be computed per column group.
Groups are ragged, so they are bucketed by padded pixel count (the 1.3x
ladder of ``_bucket_sizes``), and each bucket runs in chunks of up to
``groups_per_batch`` groups as one (G, P_max, S) batch with a 0/1 weight row.

Routes, per chunk:
  * float32 (the default): ``acrwl1mf_fused(glue="fused")`` with the weight
    row, whose rounds are ``filter_round_bsp`` (masked, f32 storage: TPU
    rows 5-6) and ``filter_glue`` on the card, their plain twins on the CPU;
  * ``compute_dtype=torch.float64``: the plain ``acrwl1mf``, as JAX runs
    its XLA path there (aviris_pipeline.py:119-121).

The cube is uploaded once, in float32 whatever ``compute_dtype`` (JAX's host
batches are f32 too, :133-135); each chunk is gathered and its results
scattered on the device by index tensors, and only the bookkeeping of the
indices runs on the host. Intended deviations: a chunk holds only its own
groups (JAX pads G up to ``groups_per_batch`` so that each bucket compiles one
XLA shape, :129-136; nothing here compiles per shape), and ``tile_p``, which
JAX matches to the bucket (:111-116), has no counterpart.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from starcop_tpu_torch.device import DeviceLike, float32_precision, resolve_device
from starcop_tpu_torch.ops import mag1c_fused
from starcop_tpu_torch.ops.ch4_template import generate_template_from_bands, get_mask_bad_bands
from starcop_tpu_torch.ops.mag1c import NODATA, acrwl1mf

MIN_PIXELS_PER_GROUP = 10  # groups with <= 10 valid pixels are skipped


def _bucket_sizes(sizes: Sequence[int], growth: float = 1.3) -> Dict[int, int]:
    """Map each group size to its padded bucket size: 128 pixels, then steps
    of ``growth`` rounded up to a multiple of 128."""
    out = {}
    for s in sorted(set(sizes)):
        b = 1 << 7
        while b < s:
            b = int(np.ceil(b * growth / 128.0) * 128)
        out[s] = b
    return out


def _group_indices(valid_mask: np.ndarray, groups: np.ndarray) -> List[np.ndarray]:
    """Each group's flat pixel indices (its valid pixels, in scan order), the
    groups in increasing id, those with <= MIN_PIXELS_PER_GROUP valid
    pixels left out."""
    flat_valid = np.asarray(valid_mask).reshape(-1)
    flat_groups = np.asarray(groups).reshape(-1)
    order = np.argsort(flat_groups[flat_valid], kind="stable")
    valid_idx = np.nonzero(flat_valid)[0][order]
    _, starts = np.unique(flat_groups[valid_idx], return_index=True)
    ends = np.append(starts[1:], len(valid_idx))
    return [valid_idx[a:b] for a, b in zip(starts, ends) if b - a > MIN_PIXELS_PER_GROUP]


def _chunks(group_indices, groups_per_batch: int):
    """(P_max, groups) of every chunk: buckets in increasing size, each cut
    into runs of ``groups_per_batch`` groups in group order."""
    buckets = _bucket_sizes([len(gi) for gi in group_indices])
    by_bucket: Dict[int, list] = {}
    for gi in group_indices:
        by_bucket.setdefault(buckets[len(gi)], []).append(gi)
    for p_max, members in sorted(by_bucket.items()):
        for start in range(0, len(members), groups_per_batch):
            yield p_max, members[start:start + groups_per_batch]


def _gather(flat_rad: torch.Tensor, p_max: int, chunk, dtype):
    """One chunk on flat_rad's device: (xb (G, P_max, S) in ``dtype``, 0 past
    each group's pixels; keep (G, P_max) bool; idx (G, P_max) flat pixel
    indices)."""
    idx = np.zeros((len(chunk), p_max), np.int64)
    keep = np.zeros((len(chunk), p_max), bool)
    for j, gi in enumerate(chunk):
        idx[j, :len(gi)] = gi
        keep[j, :len(gi)] = True
    idx_d = torch.as_tensor(idx, device=flat_rad.device)
    keep_d = torch.as_tensor(keep, device=flat_rad.device)
    return torch.where(keep_d[..., None], flat_rad[idx_d], 0.0).to(dtype), keep_d, idx_d


def run_mag1c_groups(
    radiance: np.ndarray,
    groups: np.ndarray,
    valid_mask: Optional[np.ndarray] = None,
    template: Optional[np.ndarray] = None,
    wavelengths: Optional[np.ndarray] = None,
    fwhm: Optional[np.ndarray] = None,
    *,
    num_iter: int = 30,
    alpha: float = 0.0,
    covariance_update_scaling: float = 1.0,
    groups_per_batch: int = 64,
    compute_dtype=torch.float32,
    fill_value: float = NODATA,
    device: DeviceLike = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Matched filter per detector column group over a full AVIRIS scene.

    radiance (H, W, S), band-selected (e.g. 2122-2488 nm after
    ``get_mask_bad_bands``); groups (H, W) int detector sample per pixel
    (GLT band 0); valid_mask (H, W) bool, by default every band > NODATA;
    template (S,), by default from ``wavelengths`` and ``fwhm``.
    ``compute_dtype`` is torch.float32 (the kernels) or torch.float64 (the
    plain filter, for parity runs). ``device`` None is the card.

    Returns (mf, albedo), (H, W) float32 numpy arrays with ``fill_value``
    where a pixel is invalid or its group has <= 10 valid pixels.
    """
    if compute_dtype not in (torch.float32, torch.float64):
        raise ValueError(f"compute_dtype must be torch.float32 or torch.float64, "
                         f"got {compute_dtype!r}")
    h, w, s = radiance.shape
    if template is None:
        if wavelengths is None or fwhm is None:
            raise ValueError("Provide template or wavelengths+fwhm")
        template = generate_template_from_bands(wavelengths, fwhm)[:, 1]
    if valid_mask is None:
        valid_mask = np.all(radiance > NODATA, axis=-1)
    dev = resolve_device(device)

    mf_out = torch.full((h * w,), fill_value, dtype=torch.float32, device=dev)
    albedo_out = torch.full((h * w,), fill_value, dtype=torch.float32, device=dev)

    group_indices = _group_indices(valid_mask, groups)
    if not group_indices:
        return mf_out.reshape(h, w).cpu().numpy(), albedo_out.reshape(h, w).cpu().numpy()

    flat_rad = torch.as_tensor(np.asarray(radiance).reshape(-1, s), dtype=torch.float32,
                               device=dev)
    tpl = torch.as_tensor(np.asarray(template), dtype=compute_dtype, device=dev)
    kw = dict(num_iter=num_iter, alpha=alpha, covariance_update_scaling=covariance_update_scaling)
    for p_max, chunk in _chunks(group_indices, groups_per_batch):
        xb, keep_d, idx_d = _gather(flat_rad, p_max, chunk, compute_dtype)
        wb = keep_d.to(compute_dtype)
        if compute_dtype == torch.float32:
            mf, albedo = mag1c_fused.acrwl1mf_fused(xb, tpl, wb, glue="fused", device=dev, **kw)
        else:
            with float32_precision():
                mf, albedo = acrwl1mf(xb, tpl, wb, **kw)
        dest = idx_d[keep_d]
        mf_out[dest] = mf[..., 0][keep_d].float()
        albedo_out[dest] = albedo[..., 0][keep_d].float()
    return mf_out.reshape(h, w).cpu().numpy(), albedo_out.reshape(h, w).cpu().numpy()


def run_mag1c_scene(
    radiance: np.ndarray,
    wavelengths: np.ndarray,
    fwhm: np.ndarray,
    glt_samples: Optional[np.ndarray] = None,
    wavelength_range: Tuple[float, float] = (2122.0, 2488.0),
    **kwargs,
) -> Tuple[np.ndarray, np.ndarray]:
    """The whole scene: keep the bands outside the water-vapour windows and
    inside ``wavelength_range``, make their template, and filter by detector
    column group (``run_mag1c_groups``, which takes ``kwargs``). Without a
    GLT every column is its own group."""
    wavelengths = np.asarray(wavelengths, np.float64)
    fwhm = np.asarray(fwhm, np.float64)
    keep = get_mask_bad_bands(wavelengths)
    keep &= (wavelengths >= wavelength_range[0]) & (wavelengths <= wavelength_range[1])
    if not keep.any():
        raise ValueError("No bands left after masking")
    template = generate_template_from_bands(wavelengths[keep], fwhm[keep])[:, 1]
    cube = np.asarray(radiance)[..., keep]
    if glt_samples is None:
        glt_samples = np.broadcast_to(np.arange(cube.shape[1]), cube.shape[:2])
    valid = np.all(cube > NODATA, axis=-1)
    return run_mag1c_groups(cube, glt_samples, valid, template=template, **kwargs)
