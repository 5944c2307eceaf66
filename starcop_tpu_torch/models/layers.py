"""Layers and initialisation that follow Flax's semantics where torch's differ.

  * ``BatchNorm2d``: Flax ``nn.BatchNorm`` (momentum 0.9, eps 1e-5; the
    JAX networks' setting, starcop_tpu/models/mobilenet_unet.py:72) updates
    its running variance with the **biased** batch variance, and accepts one
    value per channel in training. ``torch.nn.BatchNorm2d`` updates with the
    unbiased variance (8/7 of it at a 2 x 2 x 2 level) and raises on one
    value. This subclass normalises exactly as torch does and updates the
    running statistics as Flax does.
  * ``init_like_flax``: Flax ``nn.Conv`` draws its kernel from
    ``lecun_normal`` (a normal truncated at +-2 sigma, variance 1 / fan_in,
    fan_in = kh * kw * in / groups) with a zero bias, and batch norm starts
    at scale 1, bias 0, mean 0, variance 1. Torch's default
    ``kaiming_uniform(a=sqrt(5))`` is about sqrt(3) narrower, so training
    from scratch would start elsewhere.
  * ``dropout``: inverted dropout drawn from an explicit generator (Flax
    draws from a key folded with the step; the masks cannot be equal).
  * ``set_data_parallel``: a network trained by a world of ranks, each on
    its shard of the global batch, computes what the one-process network
    computes on the whole batch (as a Flax network under ``jit`` on a
    batch-sharded array does): batch norm normalises with the global batch
    statistics and dropout slices the rank's rows out of the global mask.

And the transformers' one attention site, ``attention``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

# The standard deviation of a unit normal truncated to [-2, 2]: lecun_normal
# divides by it so that the truncated draw keeps variance 1 / fan_in.
_TRUNC_STD = 0.87962566103423978


class _SumOverGroup(torch.autograd.Function):
    """The sum of a tensor over a process group, differentiable: each rank's
    gradient is the sum of the ranks' output gradients."""

    @staticmethod
    def forward(ctx, t: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` with Flax's training update of the running
    statistics: ``mean <- (1 - m) mean + m * batch_mean`` and ``var <- (1 -
    m) var + m * biased_batch_var`` (m = ``momentum``, 0.1 as torch counts
    it, Flax's 0.9), the batch statistics in f32 at least. The
    normalisation is torch's own (biased batch variance in training, the
    running statistics in eval). One value per channel normalises to the
    bias, as in Flax."""

    process_group = None  # set by ``set_data_parallel``: statistics of the global batch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if self.process_group is not None:
            return self._global_forward(x)
        n = x.numel() // x.shape[1]
        m = self.momentum
        self.num_batches_tracked.add_(1)
        if n > 1:
            # torch's kernel updates with the unbiased variance, v * n / (n - 1):
            # its increment over (1 - m) var_old is rescaled by (n - 1) / n on
            # the C-sized buffer, so no second pass over x is made. The kernel
            # updates a copy of the variance, which autograd holds and which
            # stays as the kernel left it.
            kept = self.running_var.detach() * (1.0 - m)
            var = self.running_var.clone()
            y = F.batch_norm(x, self.running_mean, var, self.weight, self.bias, True, m, self.eps)
            with torch.no_grad():
                torch.lerp(kept, var, (n - 1) / n, out=self.running_var)
            return y
        with torch.no_grad():
            self.running_mean.mul_(1.0 - m).add_(x.detach().reshape(-1).to(self.running_mean.dtype),
                                                 alpha=m)
            self.running_var.mul_(1.0 - m)
        # (x - mean) is 0 with one value a channel: torch's kernel refuses it.
        shape = (1, -1, 1, 1)
        return (x - x.mean((0, 2, 3), keepdim=True)) * (
            self.weight * torch.rsqrt(torch.full_like(self.weight, self.eps))).view(shape) \
            + self.bias.view(shape)

    def _global_forward(self, x: torch.Tensor) -> torch.Tensor:
        """Training forward on the rank's shard with the global batch's
        statistics: the shard's count, mean and M2 (at f32 at least), combined
        over the group by Chan's update in f64 through a differentiable
        all_reduce (the global mean first, then the M2 terms about it), the
        biased variance, and Flax's running update."""
        c = x.shape[1]
        dt = torch.promote_types(x.dtype, torch.float32)
        var, mean = torch.var_mean(x.to(dt), dim=(0, 2, 3), correction=0)
        n = torch.full((1,), float(x.numel() // c), dtype=torch.float64, device=x.device)
        mean, m2 = mean.double(), var.double() * n
        total = _SumOverGroup.apply(torch.cat([n * mean, n]), self.process_group)
        count = total[c:].detach()
        g_mean = total[:c] / count
        g_var = _SumOverGroup.apply(m2 + n * (mean - g_mean) ** 2, self.process_group) / count
        m = self.momentum
        self.num_batches_tracked.add_(1)
        with torch.no_grad():
            self.running_mean.lerp_(g_mean.to(self.running_mean.dtype), m)
            self.running_var.lerp_(g_var.to(self.running_var.dtype), m)
        shape = (1, -1, 1, 1)
        inv = torch.rsqrt(g_var + self.eps).to(dt)
        y = (x.to(dt) - g_mean.to(dt).view(shape)) * (self.weight.to(dt) * inv).view(shape) \
            + self.bias.to(dt).view(shape)
        return y.to(x.dtype)


def set_data_parallel(network: nn.Module, mesh) -> nn.Module:
    """Make ``network``'s training forward on the rank's shard that of the
    global batch over ``mesh`` (a ``parallel.Mesh``): every ``BatchNorm2d``
    takes the global statistics over the mesh's group and dropout draws the
    global mask and keeps the rank's rows. A world of one changes nothing."""
    group = mesh.group if mesh.size > 1 else None
    shard = (mesh.rank, mesh.size) if mesh.size > 1 else None
    for mod in network.modules():
        if isinstance(mod, BatchNorm2d):
            mod.process_group = group
        if hasattr(mod, "dropout_rate"):
            mod.batch_shard = shard
    return network


def lecun_normal_(weight: torch.Tensor, generator: Optional[torch.Generator] = None):
    """Flax's ``lecun_normal`` on a torch conv weight (O, I / groups, kh, kw):
    a normal truncated at +-2 standard deviations, variance 1 / fan_in."""
    fan_in = weight[0].numel()
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    return nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


@torch.no_grad()
def init_like_flax(module: nn.Module, generator: Optional[torch.Generator] = None) -> nn.Module:
    """Re-initialise ``module``'s convolutions and batch norms as Flax's
    defaults would: ``lecun_normal`` kernels and zero biases; batch norm
    scale 1, bias 0, mean 0, variance 1. Draws from ``generator``."""
    for mod in module.modules():
        if isinstance(mod, nn.Conv2d):
            lecun_normal_(mod.weight, generator)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.BatchNorm2d):
            mod.reset_parameters()
    return module


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              bias: Optional[torch.Tensor] = None, scale: Optional[float] = None) -> torch.Tensor:
    """``softmax(scale * q k^T + bias) v`` over (..., heads, tokens, d)
    inputs, through ``scaled_dot_product_attention``: ``scale`` None is 1 /
    sqrt(d); ``bias`` an additive mask that broadcasts to the scores, cast
    to q's dtype. At f32 it runs where SDPA puts f32 inputs with a mask or
    without (the memory-efficient kernel on an H100); bf16 inputs take a
    flash kernel where there is no bias."""
    if bias is not None:
        bias = bias.to(q.dtype)
    return F.scaled_dot_product_attention(q, k, v, attn_mask=bias, scale=scale)


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator,
            shard: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Inverted dropout as Flax's ``nn.Dropout``: each element kept with
    probability 1 - ``rate`` and scaled by 1 / (1 - rate), the draw from
    ``generator`` (on ``x``'s device). ``shard`` = (rank, size): ``x`` is
    the rank's contiguous rows of a global batch ``size`` times as long,
    whose mask is drawn and the rank's rows of it kept."""
    if shard is None:
        keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    else:
        rank, size = shard
        b = x.shape[0]
        keep = torch.rand((b * size, *x.shape[1:]), generator=generator,
                          device=x.device)[rank * b:(rank + 1) * b] >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))
