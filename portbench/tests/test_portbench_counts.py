"""The operation and byte counters against hand counts."""

import pytest
import torch
import torch.nn.functional as F

from portbench import counts
from portbench.recipes.weights import make_params
from portbench.reference import unet


def test_unet_flops_match_the_convolutions_run(monkeypatch):
    """Every convolution the reference runs, counted from its actual output
    shape (2 c_out c_in/g k^2 h w), sums to the shape count."""
    seen = []
    real = F.conv2d

    def counting(x, w, b=None, stride=1, padding=0, dilation=1, groups=1):
        y = real(x, w, b, stride, padding, dilation, groups)
        co, cig, kh, kw = w.shape
        seen.append(2 * co * cig * kh * kw * y.shape[-2] * y.shape[-1] * y.shape[0])
        return y

    monkeypatch.setattr(unet.F, "conv2d", counting)
    p = make_params(0, "cpu")
    with torch.no_grad():
        unet.unet_logits(torch.rand(2, 4, 64, 96), p)
    assert len(seen) == len(list(unet.conv_specs()))
    assert sum(seen) == counts.unet_forward_flops(64, 96, batch=2)


def test_unet_flops_hand_count_of_the_head():
    """The head alone: a 3x3 convolution of 16 -> 1 channel at H x W."""
    rows = {r[0]: r for r in counts._conv_sizes(32, 64, 4, 1)}
    name, ci, co, k, g, h, w = rows["segmentation_head.0"]
    assert (ci, co, k, g, h, w) == (16, 1, 3, 1, 32, 64)
    first = rows["encoder.features.0.0"]
    assert first[5:] == (16, 32)  # stride 2
    assert rows["encoder.features.18.0"][5:] == (1, 2)  # the head at stride 32


@pytest.mark.parametrize("p, s, it", [(3, 2, 0), (3, 2, 1), (10, 5, 4)])
def test_filter_flops_hand_count(p, s, it):
    # initial pass: mean s, covariance s(s+1) (half the matrix, 2 ops a
    # multiply-add), albedo 2s, projection 2s; an iteration 4s.
    assert counts.filter_flops(p, s, it) == p * (s + s * (s + 1) + 2 * s + 2 * s) + it * p * 4 * s


def test_filter_bytes_and_bound():
    assert counts.filter_bytes(2, 3, 4) == 2 * 3 * 4 * 4 + 6 + 8 * 6
    px, s = 1280 * 1242, 50
    bound = counts.filter_bound_s(px, 1280, 1242, s, 30)
    assert bound == max(counts.filter_flops(px, s, 30) / counts.F32_FLOP_PER_S,
                        counts.filter_bytes(1280, 1242, s) / counts.HBM_BYTES_PER_S)
