"""Seeded full-width U-Net parameters, made on the device from the seed.

The recipe is a frozen copy of ``chip_smoke.seeded_model`` (rewritten to draw
on the card in a few large calls): Kaiming-normal convolutions with the
fan-out mode (std sqrt(2 / (c_out * k * k))), zero
convolution biases, batch-norm scale 1 and shift 0, running means N(0, 0.05)
and running variances U(0.8, 1.2), and the first convolution's weights on the
mag1c channel scaled by ``MF_GAIN``. At a default initialisation the U-Net's
output is nearly constant and barely depends on the filter's output, so a
comparison could not tell a wrong filter from a right one; with this recipe
the mask spreads over (0, 1) and follows mf.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from portbench.reference.unet import bn_prefix, conv_specs

MF_GAIN = 1000.0


def make_params(seed: int, device, dtype=torch.float32, in_channels: int = 4,
                num_classes: int = 1) -> Dict[str, torch.Tensor]:
    """smp-named U-Net parameters and batch-norm statistics from ``seed``,
    drawn with a generator on ``device``: one normal draw for every
    convolution weight, one for the running means, one uniform for the
    running variances."""
    specs = list(conv_specs(in_channels, num_classes))
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2**63))
    shapes = [(co, ci // g, k, k) for _, ci, co, k, g in specs]
    sizes = [math.prod(s) for s in shapes]
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    bns = [(bn_prefix(name), co) for name, _, co, _, _ in specs if not name.startswith("segm")]
    n_bn = sum(c for _, c in bns)
    means = torch.randn(n_bn, generator=gen, device=device, dtype=torch.float32) * 0.05
    variances = torch.rand(n_bn, generator=gen, device=device, dtype=torch.float32) * 0.4 + 0.8

    params: Dict[str, torch.Tensor] = {}
    off = 0
    for (name, _, co, k, _), shape, size in zip(specs, shapes, sizes):
        std = math.sqrt(2.0 / (co * k * k))  # kaiming_normal_, mode="fan_out", gain sqrt(2)
        params[f"{name}.weight"] = flat[off:off + size].view(shape) * std
        off += size
    params["segmentation_head.0.bias"] = torch.zeros(num_classes, device=device)
    params["encoder.features.0.0.weight"][:, 0] *= MF_GAIN
    off = 0
    for name, c in bns:
        params[f"{name}.weight"] = torch.ones(c, device=device)
        params[f"{name}.bias"] = torch.zeros(c, device=device)
        params[f"{name}.running_mean"] = means[off:off + c]
        params[f"{name}.running_var"] = variances[off:off + c]
        off += c
    return {k: v.to(dtype).contiguous() for k, v in params.items()}


def load_into(network: torch.nn.Module, params: Dict[str, torch.Tensor]) -> None:
    """Copy ``params`` into the program's network by name; every parameter
    and running statistic of the network must be given (its batch counters
    excepted)."""
    state = network.state_dict()
    missing = [k for k in state if k not in params and not k.endswith("num_batches_tracked")]
    unused = [k for k in params if k not in state]
    if missing or unused:
        raise KeyError(f"parameter names differ: missing {missing[:4]}, unused {unused[:4]}")
    with torch.no_grad():
        for k, v in params.items():
            state[k].copy_(v)
