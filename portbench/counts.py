"""Operations and bytes that the algorithms need, counted from shapes.

These counts are the benchmark's yardstick, independent of how the program
computes: a kernel that does less work than counted here would read more than
its share, so every count is the least work the algorithm needs, never what
an implementation happens to do. Peak rates are NVIDIA's data sheet figures
for one H100 SXM (dense, without sparsity).
"""

from __future__ import annotations

from portbench.reference.unet import DECODER_CHANNELS, INVERTED_RESIDUAL_CFG, conv_specs

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12  # float32 outside the tensor cores (TF32 is off)
BF16_FLOP_PER_S = 989e12  # dense bf16 on the tensor cores


def _conv_sizes(height: int, width: int, in_channels: int, num_classes: int):
    """(name, c_in, c_out, k, groups, out_h, out_w) of every convolution of
    the U-Net at an (H, W) input, H and W multiples of 32: the encoder halves
    the size at its first convolution and at the depthwise convolution that
    opens each stride-2 stage; decoder block i runs at H / 2^(4 - i), the
    head at H."""
    strided = {"encoder.features.0.0"}
    idx = 1
    for t, _, n, s in INVERTED_RESIDUAL_CFG:
        if s == 2:
            strided.add(f"encoder.features.{idx}.conv.{'1.0' if t != 1 else '0.0'}")
        idx += n
    h, w = height, width
    out = []
    for name, ci, co, k, g in conv_specs(in_channels, num_classes):
        if name in strided:
            h, w = h // 2, w // 2
        if name.startswith("decoder"):
            f = 2 ** (len(DECODER_CHANNELS) - 1 - int(name.split(".")[2]))
            h, w = height // f, width // f
        elif name.startswith("segmentation"):
            h, w = height, width
        out.append((name, ci, co, k, g, h, w))
    return out


def unet_forward_flops(height: int, width: int, batch: int = 1, in_channels: int = 4,
                       num_classes: int = 1) -> float:
    """Multiply-adds of every convolution (2 operations each) of one forward
    pass at (batch, in_channels, H, W); batch norm, activations, upsampling and
    concatenation are left out, so a share of a peak taken from this count is
    a lower bound."""
    total = 0
    for _, ci, co, k, g, oh, ow in _conv_sizes(height, width, in_channels, num_classes):
        total += 2 * co * (ci // g) * k * k * oh * ow
    return float(total * batch)


def filter_flops(valid_pixels: int, bands: int, num_iter: int) -> float:
    """Least operations of the reweighted-L1 filter over ``valid_pixels``
    pixels (those that enter the statistics) of ``bands`` bands. The initial
    pass forms the mean (S a pixel), the symmetric covariance (S (S + 1) / 2
    multiply-adds), the albedo (a dot product, 2 S) and the projection (2 S).
    An iteration removes the detections ``a_p t`` from the statistics; since
    cov(x - a t^T) follows from cov(x) by rank-one terms in sum(a x),
    sum(a) and sum(a^2), its least work a pixel is that weighted sum (2 S)
    and the projection (2 S), not a new covariance: the reference's literal
    per-iteration covariance would let an implementation of the algebraic
    form read more than 100 %. Per-block O(S^3) solves are left out."""
    s = bands
    first = valid_pixels * (s * (s + 1) + 5 * s)
    return float(first + num_iter * valid_pixels * 4 * s)


def filter_bytes(lines: int, samples: int, bands: int, in_bytes: int = 4) -> float:
    """Bytes one filter call must move at least: the cube and the valid mask
    read once, mf and albedo (f32) written once."""
    px = lines * samples
    return float(px * bands * in_bytes + px + 2 * 4 * px)


def filter_bound_s(valid_pixels: int, lines: int, samples: int, bands: int,
                   num_iter: int) -> float:
    """The least time one filter call can take on one H100."""
    return max(filter_flops(valid_pixels, bands, num_iter) / F32_FLOP_PER_S,
               filter_bytes(lines, samples, bands) / HBM_BYTES_PER_S)
