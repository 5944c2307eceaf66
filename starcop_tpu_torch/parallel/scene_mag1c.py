"""The column-blocked scene filter with its blocks split over a world
(counterpart of starcop_tpu/parallel/scene_mag1c.py).

Column blocks are independent (each keeps its own statistics), so a rank
filters its contiguous range of blocks alone: it gathers those columns from
the host cube, uploads them and runs the filter on its device. The ranks
then assemble the whole (H, W) output on every rank by one ``all_reduce``
(SUM) of zero-filled full outputs: each pixel has exactly one non-zero
term, so the sum is exact, and the collective is one that NCCL and gloo
(CPU and CUDA tensors alike) both run.

Routes, as JAX's (:74-92): at float32 each rank runs
``acrwl1mf_fused(glue="fused")`` with a weight row (``filter_round_bsp`` on
the masked f32 stream and ``filter_glue`` on the card, TPU rows 5-6; their
plain twins on the CPU); at float64 the plain ``acrwl1mf``.

Intended deviations: JAX pads the block count to a multiple of the mesh
with zero-weight blocks so that its shards come out even (:47-59); here a
rank takes the blocks it is given (``np.array_split``'s split: the first
``nb % size`` ranks one more), with nothing compiled per shape to feed, and
a rank with no blocks still joins the collective. Invalid pixels leave by a
select, never by JAX's multiply ``xb * wb`` (:66), which keeps a NaN.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from starcop_tpu_torch.device import float32_precision
from starcop_tpu_torch.ops.mag1c import NODATA, acrwl1mf, block_columns, unblock_columns
from starcop_tpu_torch.ops.mag1c_fused import acrwl1mf_fused
from starcop_tpu_torch.ops.mag1c_kernels import _keep_rows
from starcop_tpu_torch.parallel.mesh import Mesh, all_reduce_


def block_range(nb: int, mesh: Mesh) -> Tuple[int, int]:
    """The rank's contiguous blocks [lo, hi) of ``nb``: the first
    ``nb % size`` ranks take one block more."""
    per, extra = divmod(nb, mesh.size)
    lo = mesh.rank * per + min(mesh.rank, extra)
    return lo, lo + per + (mesh.rank < extra)


def sharded_mag1c_scene(
    scene,
    template,
    valid_mask=None,
    *,
    mesh: Mesh,
    column_step: int = 32,
    num_iter: int = 30,
    alpha: float = 1e-4,
    fill_value: float = NODATA,
    compute_dtype=torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The matched filter over a (H, W, S) scene (numpy or a tensor), its
    ``column_step``-wide blocks split over the world's ranks.

    Returns (mf, albedo), (H, W) tensors of ``compute_dtype`` on the rank's
    device, the same on every rank, with ``fill_value`` at invalid pixels.
    """
    if compute_dtype not in (torch.float32, torch.float64):
        raise ValueError(f"compute_dtype must be torch.float32 or torch.float64, "
                         f"got {compute_dtype!r}")
    dev = mesh.device
    h, w_dim, s = scene.shape
    step = int(column_step) if column_step else w_dim
    nb = -(-w_dim // step)
    lo, hi = block_range(nb, mesh)
    c0, c1 = lo * step, min(hi * step, w_dim)

    valid = (torch.ones((h, w_dim), dtype=torch.bool, device=dev) if valid_mask is None
             else torch.as_tensor(valid_mask, dtype=torch.bool, device=dev))
    mf = torch.zeros((h, w_dim), dtype=compute_dtype, device=dev)
    albedo = torch.zeros((h, w_dim), dtype=compute_dtype, device=dev)
    if hi > lo:
        part = scene[:, c0:c1]
        if isinstance(part, np.ndarray):
            part = np.ascontiguousarray(part)
        x = torch.as_tensor(part).to(dev, compute_dtype)
        pad = (hi - lo) * step - (c1 - c0)
        xb = block_columns(F.pad(x, (0, 0, 0, pad)), hi - lo, step)
        keep = _keep_rows(valid[:, c0:c1], hi - lo, step)
        tpl = torch.as_tensor(template, dtype=compute_dtype, device=dev)
        if compute_dtype == torch.float32:
            mf_b, albedo_b = acrwl1mf_fused(xb, tpl, keep, num_iter=num_iter, alpha=alpha,
                                            glue="fused", device=dev)
        else:
            with float32_precision():
                mf_b, albedo_b = acrwl1mf(torch.where(keep[..., None], xb, 0.0), tpl,
                                          keep.to(compute_dtype), num_iter=num_iter,
                                          alpha=alpha)
        grid = lambda v: unblock_columns(v[..., 0], h, step)[:, :c1 - c0]  # noqa: E731
        mf[:, c0:c1] = torch.where(valid[:, c0:c1], grid(mf_b), 0.0)
        albedo[:, c0:c1] = torch.where(valid[:, c0:c1], grid(albedo_b), 0.0)
    # One collective for both outputs; every pixel has one non-zero term.
    both = all_reduce_(mesh, torch.stack([mf, albedo]))
    return torch.where(valid, both[0], fill_value), torch.where(valid, both[1], fill_value)
