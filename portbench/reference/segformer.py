"""Plain SegFormer (Xie et al., NeurIPS 2021, arXiv:2105.15203; NVlabs'
``mix_transformer.py`` ``mit_b5`` and ``segformer_head.py``) as a function
of a parameter dict, in the dtype of its input (float64 or float32).

The equations, with NVlabs' state_dict names (``backbone.*``,
``decode_head.*``):

  * stage i: an overlapping patch embedding (convolution of kernel k_i and
    stride s_i, padding k_i // 2, then a layer norm at ``embed_norm_eps``),
    the blocks, a layer norm at ``block_norm_eps``; tokens (B, N, C), N = H *
    W row-major;
  * block: ``x + Attn(LN1(x))``, then ``x + MixFFN(LN2(x))``
    (``block_norm_eps``);
  * attention: ``Q = x Wq + bq``; the reduced map ``x_r = LN(Conv(x))`` with
    kernel and stride r_i (``embed_norm_eps``; x itself at r_i = 1); ``[K, V] = x_r
    Wkv + bkv``; per head of d channels ``softmax(Q K^T / sqrt(d)) V``,
    computed explicitly in blocks of queries; then ``Wproj``;
  * MixFFN: ``fc2(GELU(DWConv3x3(fc1(x))))`` with the exact (erf) GELU;
  * head: each stage's tokens through a linear layer to the decoder width,
    a bilinear resize (align_corners False) to the 1/4 map, the concat
    [c4, c3, c2, c1], a 1x1 convolution without bias (a matmul), batch norm
    (the running statistics; the batch's with ``train``), ReLU, a 1x1
    convolution to the classes (a matmul); a bilinear x4 resize to the
    input.

Departures from NVlabs: the input has 4 channels (mag1c and three RGB
radiances; 3 in the source) and the head 1 class (19 or 150 in the source);
mmseg's unused ``conv_seg`` is left out; dropout and drop-path, which act in
training only, are not applied (a training forward here is one at rate 0).

TF32 is turned off for the call (``tf32=True`` turns it on: the control).
Nothing here is imported from the program: this is the yardstick that the
program's outputs are held to.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, Tuple

import torch
import torch.nn.functional as F

from portbench.reference.granule import find_padding
from portbench.reference.mag1c import NODATA
from portbench.reference.unet import normalize_input

BN_EPS = 1e-5
QUERY_BLOCK = 16384  # queries a score block: 16384 x 1560 keys in f64 is 204 MB


def stages(m: Dict) -> Iterator[Tuple[int, int, int, int, int, int, int]]:
    """(index, dim, heads, depth, reduction, kernel, stride) of each stage of
    the configuration's model section ``m``."""
    yield from zip(range(len(m["embed_dims"])), m["embed_dims"], m["num_heads"], m["depths"],
                   m["sr_ratios"], m["patch_kernels"], m["patch_strides"])


def param_specs(m: Dict) -> Iterator[Tuple[str, Tuple[int, ...], str]]:
    """Every parameter as (name, shape, kind), kind one of linear, conv,
    dwconv (depthwise), bias, norm_weight, norm_bias, bn (a batch norm's
    prefix, shape (C,)):
    the shapes that the weights recipe draws."""
    cin = m["in_channels"]
    for i, c, _, depth, r, k, _ in stages(m):
        pe = f"backbone.patch_embed{i + 1}"
        yield f"{pe}.proj.weight", (c, cin, k, k), "conv"
        yield f"{pe}.proj.bias", (c,), "bias"
        yield f"{pe}.norm.weight", (c,), "norm_weight"
        yield f"{pe}.norm.bias", (c,), "norm_bias"
        hidden = c * m["mlp_ratio"]
        for j in range(depth):
            b = f"backbone.block{i + 1}.{j}"
            for norm in ("norm1", "norm2"):
                yield f"{b}.{norm}.weight", (c,), "norm_weight"
                yield f"{b}.{norm}.bias", (c,), "norm_bias"
            for name, out in (("q", c), ("kv", 2 * c), ("proj", c)):
                yield f"{b}.attn.{name}.weight", (out, c), "linear"
                yield f"{b}.attn.{name}.bias", (out,), "bias"
            if r > 1:
                yield f"{b}.attn.sr.weight", (c, c, r, r), "conv"
                yield f"{b}.attn.sr.bias", (c,), "bias"
                yield f"{b}.attn.norm.weight", (c,), "norm_weight"
                yield f"{b}.attn.norm.bias", (c,), "norm_bias"
            yield f"{b}.mlp.fc1.weight", (hidden, c), "linear"
            yield f"{b}.mlp.fc1.bias", (hidden,), "bias"
            yield f"{b}.mlp.dwconv.dwconv.weight", (hidden, 1, 3, 3), "dwconv"
            yield f"{b}.mlp.dwconv.dwconv.bias", (hidden,), "bias"
            yield f"{b}.mlp.fc2.weight", (c, hidden), "linear"
            yield f"{b}.mlp.fc2.bias", (c,), "bias"
        yield f"backbone.norm{i + 1}.weight", (c,), "norm_weight"
        yield f"backbone.norm{i + 1}.bias", (c,), "norm_bias"
        cin = c
    d = m["decoder_dim"]
    for i, c in enumerate(m["embed_dims"]):
        yield f"decode_head.linear_c{i + 1}.proj.weight", (d, c), "linear"
        yield f"decode_head.linear_c{i + 1}.proj.bias", (d,), "bias"
    yield "decode_head.linear_fuse.conv.weight", (d, d * len(m["embed_dims"]), 1, 1), "conv"
    yield "decode_head.linear_fuse.bn", (d,), "bn"
    yield "decode_head.linear_pred.weight", (m["num_classes"], d, 1, 1), "conv"
    yield "decode_head.linear_pred.bias", (m["num_classes"],), "bias"


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def layer_norm(x, p, name: str, eps: float):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * p[f"{name}.weight"] + p[f"{name}.bias"]


def linear(x, p, name: str):
    return x @ p[f"{name}.weight"].T + p[f"{name}.bias"]


def gelu(x):
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def to_map(x, h: int, w: int):
    """(B, N, C) -> (B, C, H, W)."""
    return x.transpose(1, 2).reshape(x.shape[0], x.shape[2], h, w)


def to_tokens(x):
    """(B, C, H, W) -> (B, N, C)."""
    return x.reshape(x.shape[0], x.shape[1], -1).transpose(1, 2)


def attention(x, p, name: str, h: int, w: int, heads: int, r: int, eps: float):
    b, n, c = x.shape
    d = c // heads
    q = linear(x, p, f"{name}.q").reshape(b, n, heads, d).transpose(1, 2)
    xr = x
    if r > 1:
        xr = F.conv2d(to_map(x, h, w), p[f"{name}.sr.weight"], p[f"{name}.sr.bias"], stride=r)
        xr = layer_norm(to_tokens(xr), p, f"{name}.norm", eps)
    kv = linear(xr, p, f"{name}.kv").reshape(b, -1, 2, heads, d)
    k, v = kv[:, :, 0].transpose(1, 2), kv[:, :, 1].transpose(1, 2)
    out = torch.empty_like(q)
    for s in range(0, n, QUERY_BLOCK):
        scores = (q[:, :, s:s + QUERY_BLOCK] @ k.transpose(-1, -2)) / math.sqrt(d)
        out[:, :, s:s + QUERY_BLOCK] = torch.softmax(scores, dim=-1) @ v
    return linear(out.transpose(1, 2).reshape(b, n, c), p, f"{name}.proj")


def mixffn(x, p, name: str, h: int, w: int):
    y = linear(x, p, f"{name}.fc1")
    y = F.conv2d(to_map(y, h, w), p[f"{name}.dwconv.dwconv.weight"],
                 p[f"{name}.dwconv.dwconv.bias"], padding=1, groups=y.shape[-1])
    return linear(gelu(to_tokens(y)), p, f"{name}.fc2")


def batch_norm(x, p, name: str, train: bool):
    if train:
        var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0, keepdim=True)
    else:
        mean = p[f"{name}.running_mean"].view(1, -1, 1, 1)
        var = p[f"{name}.running_var"].view(1, -1, 1, 1)
    scale = p[f"{name}.weight"].view(1, -1, 1, 1) / torch.sqrt(var + BN_EPS)
    return (x - mean) * scale + p[f"{name}.bias"].view(1, -1, 1, 1)


def conv1x1(x, weight, bias=None):
    """A 1x1 convolution as a matmul over the channel axis."""
    y = torch.einsum("oc,bchw->bohw", weight[:, :, 0, 0], x)
    return y if bias is None else y + bias.view(1, -1, 1, 1)


def segformer_logits(x: torch.Tensor, p: Dict[str, torch.Tensor], m: Dict,
                     train: bool = False, tf32: bool = False) -> torch.Tensor:
    """(B, C, H, W) normalised input -> (B, K, H, W) logits in x's dtype;
    H and W multiples of 32. ``m`` is the configuration's model section;
    ``train`` normalises the head's batch norm with the batch's
    statistics."""
    eps = m["block_norm_eps"]
    with matmul_precision(tf32):
        out_size = x.shape[-2:]
        feats = []
        for i, _, heads, depth, r, k, s in stages(m):
            pe = f"backbone.patch_embed{i + 1}"
            y = F.conv2d(x, p[f"{pe}.proj.weight"], p[f"{pe}.proj.bias"], stride=s, padding=k // 2)
            h, w = y.shape[-2:]
            t = layer_norm(to_tokens(y), p, f"{pe}.norm", m["embed_norm_eps"])
            for j in range(depth):
                b = f"backbone.block{i + 1}.{j}"
                t = t + attention(layer_norm(t, p, f"{b}.norm1", eps), p, f"{b}.attn", h, w,
                                  heads, r, m["embed_norm_eps"])
                t = t + mixffn(layer_norm(t, p, f"{b}.norm2", eps), p, f"{b}.mlp", h, w)
            x = to_map(layer_norm(t, p, f"backbone.norm{i + 1}", eps), h, w)
            feats.append(x)
        size = feats[0].shape[-2:]
        parts = []
        for i in reversed(range(len(feats))):
            f = feats[i]
            y = to_map(linear(to_tokens(f), p, f"decode_head.linear_c{i + 1}.proj"),
                       *f.shape[-2:])
            if i > 0:
                y = F.interpolate(y, size=size, mode="bilinear", align_corners=False)
            parts.append(y)
        y = conv1x1(torch.cat(parts, dim=1), p["decode_head.linear_fuse.conv.weight"])
        y = torch.relu(batch_norm(y, p, "decode_head.linear_fuse.bn", train))
        y = conv1x1(y, p["decode_head.linear_pred.weight"], p["decode_head.linear_pred.bias"])
        return F.interpolate(y, size=out_size, mode="bilinear", align_corners=False)


def plume_probability(mf, rgb, params: Dict[str, torch.Tensor], model: Dict,
                      tf32: bool = False) -> torch.Tensor:
    """mf (H, W) and rgb (3, H, W) -> sigmoid mask (H, W) in mf's dtype: the
    STARCOP zero-shot renormalisation (NODATA enters as 0), a reflect pad to
    a multiple of 32, the input normalisation, SegFormer, a sigmoid and the
    crop back (``reference/granule.py``'s steps around this network)."""
    dtype = mf.dtype
    ren = model["emit_to_aviris"]
    m = torch.where(mf == NODATA, torch.zeros((), dtype=dtype, device=mf.device), mf)
    m = torch.clamp(m / ren["mag1c_div"], 0, 2) * ren["mag1c_mult"]
    r = torch.clamp(rgb.to(dtype) / ren["rgb_div"], 0, 2) * ren["rgb_mult"]
    x = torch.cat([m[None], r])[None]
    h, w = mf.shape
    pr, pc = find_padding(h), find_padding(w)
    x = F.pad(x, (pc[0], pc[1], pr[0], pr[1]), mode="reflect")
    x = normalize_input(x, model["input_factors"])
    p = {k: v.to(dtype) for k, v in params.items()}
    out = torch.sigmoid(segformer_logits(x, p, model, tf32=tf32))[0, 0]
    return out[pr[0]:pr[0] + h, pc[0]:pc[0] + w]
