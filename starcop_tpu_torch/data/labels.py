"""Label refinement: human RGBA annotations + matched filter -> binary masks
(counterpart of starcop_tpu/data/labels.py).

``proposed_mask`` thresholds mag1c at 200, opens then dilates it with the
3x3 cross (skimage's disk(1)), keeps the 8-connected components that touch
the human annotation, and intersects them with the raw threshold again.
The morphology runs on the port's ``ops/morphology.py`` (torch, on the
host); connected components on scipy.ndimage (offline label preparation).
``mosaic_labels`` burns per-plume label rasters into one scene mosaic.
"""

from __future__ import annotations

import numpy as np
import torch

from starcop_tpu_torch.ops.morphology import CROSS_KERNEL, binary_opening, dilation

MAG1C_LABEL_THRESHOLD = 200.0


def mosaic_labels(scene_shape, windows, rasters) -> np.ndarray:
    """Burn per-plume label rasters into one full-scene label mosaic, each
    pasted at its window (``window_{row,col}_off``) with a max merge on
    overlap. Works for (H, W) binary or (C, H, W) RGBA labels; f32."""
    if not rasters:
        return np.zeros(scene_shape, np.float32)
    first = np.asarray(rasters[0])
    channels = first.shape[0] if first.ndim == 3 else None
    out_shape = (channels,) + tuple(scene_shape) if channels else tuple(scene_shape)
    mosaic = np.zeros(out_shape, np.float32)
    h_scene, w_scene = scene_shape
    for win, raster in zip(windows, rasters):
        raster = np.asarray(raster, np.float32)
        r0, c0 = win["window_row_off"], win["window_col_off"]
        rh, rw = raster.shape[-2:]
        rr0, cc0 = max(r0, 0), max(c0, 0)
        rr1, cc1 = min(r0 + rh, h_scene), min(c0 + rw, w_scene)
        if rr1 <= rr0 or cc1 <= cc0:
            continue
        src = raster[..., rr0 - r0:rr1 - r0, cc0 - c0:cc1 - c0]
        dst = mosaic[..., rr0:rr1, cc0:cc1]
        np.maximum(dst, src, out=dst)
    return mosaic


def proposed_mask(label_rgba_values: np.ndarray, mag1c_values: np.ndarray) -> np.ndarray:
    """The refined (H, W) bool plume mask of a (4, H, W) RGBA annotation
    (alpha != 0 marks annotated pixels) and a (1, H, W) mag1c raster.
    Erosion treats outside the image as set (skimage's border_value=1),
    dilation as clear."""
    existing_label = np.asarray(label_rgba_values)[-1] != 0
    mag1c = np.asarray(mag1c_values)[0]
    thresholded = mag1c >= MAG1C_LABEL_THRESHOLD

    opened = binary_opening(torch.from_numpy(thresholded), CROSS_KERNEL)
    opened_dilated = dilation(opened, CROSS_KERNEL).numpy()

    from scipy import ndimage

    components, _ = ndimage.label(opened_dilated, structure=np.ones((3, 3), bool))
    keep = np.unique(components[existing_label & (components != 0)])
    mask = np.isin(components, keep) & (components != 0)
    return mask & thresholded
