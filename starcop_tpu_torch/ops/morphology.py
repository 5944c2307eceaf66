"""Binary morphology on (..., H, W) tensors (counterpart of
starcop_tpu/ops/morphology.py).

A structuring element's hit count is a "same" 2-D convolution in float32
with zero padding, one channel per image, compared with a threshold:

  * dilation: count > 0 (outside the image counts as 0);
  * erosion: count >= support, where support is the same convolution of
    ones (``border_value=1``: outside the image never erodes, the kornia and
    scikit-image convention) or the element's size (``border_value=0``:
    scipy.ndimage's default, borders erode).

Counts of 0/1 values are small integers, exact in float32, so the result is
bitwise the JAX package's. Every function returns a bool tensor.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from starcop_tpu_torch.device import float32_precision

# The reference baselines' structuring element and skimage.morphology.disk(1)
# are both this 3x3 cross.
CROSS_KERNEL = np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]], dtype=np.float32)


def _kernel(kernel, device) -> torch.Tensor:
    k = CROSS_KERNEL if kernel is None else kernel
    return torch.as_tensor(k, dtype=torch.float32, device=device)


def _conv2d_same(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Cross-correlation of (..., H, W) with a (kh, kw) kernel, padded as
    XLA's "SAME" (the extra row or column of an even kernel at the end)."""
    h, w = x.shape[-2:]
    kh, kw = k.shape
    xr = F.pad(x.reshape(-1, 1, h, w).float(),
               ((kw - 1) // 2, kw // 2, (kh - 1) // 2, kh // 2))
    with float32_precision():
        out = F.conv2d(xr, k[None, None])
    return out.reshape(x.shape)


def dilation(x: torch.Tensor, kernel=None) -> torch.Tensor:
    """Binary dilation of (..., H, W) by a structuring element."""
    return _conv2d_same(x, _kernel(kernel, x.device)) > 0.5


def erosion(x: torch.Tensor, kernel=None, border_value: int = 1) -> torch.Tensor:
    """Binary erosion of (..., H, W) by a structuring element.

    border_value=1 (default) matches kornia and scikit-image: out-of-image
    pixels never erode. border_value=0 matches scipy.ndimage: borders erode.
    """
    k = _kernel(kernel, x.device)
    counts = _conv2d_same(x, k)
    support = _conv2d_same(torch.ones_like(x, dtype=torch.float32), k) if border_value \
        else k.sum()
    return counts >= support - 0.5


def binary_opening(x: torch.Tensor, kernel=None, border_value: int = 1) -> torch.Tensor:
    """Binary opening (erosion, then dilation)."""
    return dilation(erosion(x, kernel, border_value=border_value), kernel)
