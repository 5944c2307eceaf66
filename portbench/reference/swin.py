"""Plain Swin Transformer V2 with an UperNet head (Liu et al., CVPR 2022,
arXiv:2111.09883, as torchvision's ``models/swin_transformer.py``
``swin_v2_b`` states it; Xiao et al., ECCV 2018, arXiv:1807.10221, as
mmsegmentation's ``decode_heads/uper_head.py`` and ``psp_head.py`` state
it) as a function of a parameter dict, in the dtype of its input (float64
or float32).

The equations, with torchvision's (``features.*``) and mmseg's
(``decode_head.*``) state_dict names:

  * stem: 4 x 4 patches of stride 4 times the stem's kernel (a matmul over
    each patch) plus its bias, channels last, a layer norm;
  * patch merging between stages: the tokens (2y, 2x), (2y+1, 2x), (2y,
    2x+1), (2y+1, 2x+1) concatenated in that order, a linear 4C -> 2C
    without bias, a layer norm;
  * block: ``x + LN1(WAttn(x))``, then ``x + LN2(fc2(GELU(fc1(x))))`` with
    the exact (erf) GELU;
  * WAttn: the map zero-padded on the right and bottom to multiples of the
    window w; on odd blocks of a stage a shift s = w / 2 in each direction
    whose padded size exceeds w (0 otherwise), the map rolled by (-s, -s);
    windows of w x w tokens; ``q = x Wq + bq``, ``k = x Wk`` (the k third
    of the bias is held at zero), ``v = x Wv + bv``; per head of d channels
    the scores ``(q / |q|) . (k / |k|) * exp(min(logit_scale, ln 100))``
    (norms floored at 1e-12) plus ``16 sigmoid(cpb(t))`` at the pair's
    offset, where t is each offset (dy, dx) in -(w-1) .. w-1 over w - 1,
    times 8, mapped by sign(t) log2(|t| + 1) / 3, and ``cpb`` = linear 2 ->
    512, ReLU, linear 512 -> heads without bias; on a shifted block also
    -100 between two tokens of different regions, a token's region being
    (r(y), r(x)) with r(u) = 0 for u < P - w, 1 for u < P - s, 2 after (P
    the padded size; every token in region 2 along a direction without
    shift); an explicit softmax over the keys, the weighted sum of v, the
    heads merged, the projection; the windows put back, the roll undone,
    the padding cropped;
  * each stage's output through a layer norm (``norm0`` ... ``norm3``);
  * head: for each pool scale k in 1, 2, 3, 6, the average over mmseg's
    adaptive bins (rows floor(i H / k) .. ceil((i + 1) H / k), the same for
    columns) of stage 4, a 1x1 ConvModule, a bilinear resize back; those
    and stage 4 concatenated, the 3x3 ``bottleneck``; 1x1 laterals of stages
    1-3; top-down, each level plus the level above resized to its size;
    3x3 ``fpn_convs`` of levels 1-3; the four levels resized to the 1/4 map
    and concatenated; the 3x3 ``fpn_bottleneck``; the 1x1 ``conv_seg``; a
    bilinear resize to the input. A ConvModule is a convolution without
    bias (a 3x3 one the sum of nine shifted matmuls over a zero-padded
    map), batch norm (the running statistics; the batch's with ``train``)
    and ReLU. Every resize is bilinear with align_corners False.

Departures from the sources: the input has 4 channels (mag1c and three RGB
radiances; 3 in the source) and the head 1 class (150 for ADE20K); the
per-stage output norms are mmseg's dense-prediction ones (torchvision's
classifier has one norm at the end); mmseg's auxiliary FCN head, a
training-time loss, is left out; dropout and stochastic depth, which act in
training only, are not applied (a training forward here is one at rate 0).
The position table and index are computed here; the buffers of the same
names in the parameter dict are not read.

The forward runs stage by stage (each stage's intermediates freed before the
next) and the window scores in blocks of windows, so that the granule's
whole forward fits at float64. TF32 is turned off for the call
(``tf32=True`` turns it on: the control). Nothing here is imported from the
program: this is the yardstick that the program's outputs are held to.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, List, Tuple

import torch
import torch.nn.functional as F

from portbench.reference.granule import find_padding
from portbench.reference.mag1c import NODATA
from portbench.reference.segformer import batch_norm, gelu, layer_norm, linear, matmul_precision
from portbench.reference.unet import normalize_input

LN_EPS = 1e-5
PATCH = 4
CPB_HIDDEN = 512
WINDOW_BLOCK = 2048  # windows a score block: 2048 x 4 heads x 64 x 64 in f64 is 268 MB


def stages(m: Dict) -> Iterator[Tuple[int, int, int, int]]:
    """(index, dim, heads, depth) of each stage of the configuration's model
    section ``m``."""
    for i, (heads, depth) in enumerate(zip(m["num_heads"], m["depths"])):
        yield i, m["embed_dim"] * 2**i, heads, depth


def param_specs(m: Dict) -> Iterator[Tuple[str, Tuple[int, ...], str]]:
    """Every state_dict entry as (name, shape, kind), kind one of linear,
    conv, bias, qkv_bias, norm_weight, norm_bias, cpb_weight, cpb_bias,
    logit_scale, coords_table, position_index, bn (a batch norm's prefix,
    shape (C,)): the shapes that the weights recipe draws."""
    cin, e, w = m["in_channels"], m["embed_dim"], m["window"]
    yield "features.0.0.weight", (e, cin, PATCH, PATCH), "conv"
    yield "features.0.0.bias", (e,), "bias"
    yield "features.0.2.weight", (e,), "norm_weight"
    yield "features.0.2.bias", (e,), "norm_bias"
    for i, c, heads, depth in stages(m):
        if i > 0:
            yield f"features.{2 * i}.reduction.weight", (c, 2 * c), "linear"
            yield f"features.{2 * i}.norm.weight", (c,), "norm_weight"
            yield f"features.{2 * i}.norm.bias", (c,), "norm_bias"
        hidden = c * m["mlp_ratio"]
        for j in range(depth):
            b = f"features.{2 * i + 1}.{j}"
            for norm in ("norm1", "norm2"):
                yield f"{b}.{norm}.weight", (c,), "norm_weight"
                yield f"{b}.{norm}.bias", (c,), "norm_bias"
            yield f"{b}.attn.logit_scale", (heads, 1, 1), "logit_scale"
            yield f"{b}.attn.relative_coords_table", (1, 2 * w - 1, 2 * w - 1, 2), "coords_table"
            yield f"{b}.attn.relative_position_index", (w**4,), "position_index"
            yield f"{b}.attn.qkv.weight", (3 * c, c), "linear"
            yield f"{b}.attn.qkv.bias", (3 * c,), "qkv_bias"
            yield f"{b}.attn.proj.weight", (c, c), "linear"
            yield f"{b}.attn.proj.bias", (c,), "bias"
            yield f"{b}.attn.cpb_mlp.0.weight", (CPB_HIDDEN, 2), "cpb_weight"
            yield f"{b}.attn.cpb_mlp.0.bias", (CPB_HIDDEN,), "cpb_bias"
            yield f"{b}.attn.cpb_mlp.2.weight", (heads, CPB_HIDDEN), "cpb_weight"
            yield f"{b}.mlp.0.weight", (hidden, c), "linear"
            yield f"{b}.mlp.0.bias", (hidden,), "bias"
            yield f"{b}.mlp.3.weight", (c, hidden), "linear"
            yield f"{b}.mlp.3.bias", (c,), "bias"
        yield f"norm{i}.weight", (c,), "norm_weight"
        yield f"norm{i}.bias", (c,), "norm_bias"
    dims = [c for _, c, _, _ in stages(m)]
    ch, top, h = m["channels"], dims[-1], "decode_head"
    for k in range(len(m["pool_scales"])):
        yield f"{h}.psp_modules.{k}.1.conv.weight", (ch, top, 1, 1), "conv"
        yield f"{h}.psp_modules.{k}.1.bn", (ch,), "bn"
    yield f"{h}.bottleneck.conv.weight", (ch, top + len(m["pool_scales"]) * ch, 3, 3), "conv"
    yield f"{h}.bottleneck.bn", (ch,), "bn"
    for i, c in enumerate(dims[:-1]):
        yield f"{h}.lateral_convs.{i}.conv.weight", (ch, c, 1, 1), "conv"
        yield f"{h}.lateral_convs.{i}.bn", (ch,), "bn"
    for i in range(len(dims) - 1):
        yield f"{h}.fpn_convs.{i}.conv.weight", (ch, ch, 3, 3), "conv"
        yield f"{h}.fpn_convs.{i}.bn", (ch,), "bn"
    yield f"{h}.fpn_bottleneck.conv.weight", (ch, len(dims) * ch, 3, 3), "conv"
    yield f"{h}.fpn_bottleneck.bn", (ch,), "bn"
    yield f"{h}.conv_seg.weight", (m["num_classes"], ch, 1, 1), "conv"
    yield f"{h}.conv_seg.bias", (m["num_classes"],), "bias"


def coords_table(window: int, dtype=torch.float64, device=None) -> torch.Tensor:
    """(2w-1, 2w-1, 2): each offset (dy, dx) / (w - 1) * 8, log-spaced."""
    r = torch.arange(-(window - 1), window, dtype=dtype, device=device) / (window - 1) * 8
    r = torch.sign(r) * torch.log2(r.abs() + 1.0) / 3.0
    return torch.stack([r[:, None].expand(-1, r.numel()), r[None, :].expand(r.numel(), -1)], -1)


def position_index(window: int, device=None) -> torch.Tensor:
    """(N, N) row-major index into the (2w-1)^2 offsets of the pair (token
    i, token j) of a window: (y_i - y_j + w - 1) (2w - 1) + x_i - x_j + w - 1."""
    t = torch.arange(window * window, device=device)
    y, x = t // window, t % window
    return ((y[:, None] - y[None, :] + window - 1) * (2 * window - 1)
            + x[:, None] - x[None, :] + window - 1)


def region_mask(ph: int, pw: int, window: int, shift: Tuple[int, int], dtype,
                device) -> torch.Tensor:
    """(windows, N, N): -100 between tokens of different regions, 0 within
    one, windows in row-major order over the padded map."""

    def region(size: int, s: int) -> torch.Tensor:
        u = torch.arange(size, device=device)
        if s == 0:
            return torch.full((size,), 2, device=device)
        return (u >= size - window).long() + (u >= size - s).long()

    label = region(ph, shift[0])[:, None] * 3 + region(pw, shift[1])[None, :]
    label = label.reshape(ph // window, window, pw // window, window).permute(0, 2, 1, 3)
    label = label.reshape(-1, window * window)
    differ = label[:, :, None] != label[:, None, :]
    return torch.where(differ, torch.tensor(-100.0, dtype=dtype, device=device),
                       torch.tensor(0.0, dtype=dtype, device=device))


def position_bias(p, name: str, window: int, heads: int, dtype, device) -> torch.Tensor:
    """(heads, N, N): 16 sigmoid(cpb(t)) at each pair's offset."""
    t = coords_table(window, dtype, device).reshape(-1, 2)
    hidden = torch.relu(t @ p[f"{name}.cpb_mlp.0.weight"].T + p[f"{name}.cpb_mlp.0.bias"])
    table = hidden @ p[f"{name}.cpb_mlp.2.weight"].T  # (2w-1)^2, heads
    idx = position_index(window, device)
    return 16.0 * torch.sigmoid(table[idx].permute(2, 0, 1))


def unit_rows(x):
    """x over its rows' norms floored at 1e-12 (the padded tokens' k rows are
    0; torch's vector norm gives them a zero gradient)."""
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-12)


def window_attention(x, p, name: str, heads: int, window: int, shifted: bool):
    """One WAttn over the (B, H, W, C) map x."""
    b, h, w, c = x.shape
    ph, pw = -(-h // window) * window, -(-w // window) * window
    s = window // 2
    shift = (s if shifted and ph > window else 0, s if shifted and pw > window else 0)
    xp = x.new_zeros((b, ph, pw, c))
    xp[:, :h, :w] = x
    if any(shift):
        xp = torch.roll(xp, (-shift[0], -shift[1]), (1, 2))
    n, d = window * window, c // heads
    nh, nw = ph // window, pw // window
    win = xp.reshape(b, nh, window, nw, window, c).permute(0, 1, 3, 2, 4, 5).reshape(-1, n, c)
    wq, wk, wv = p[f"{name}.qkv.weight"].split(c)
    bq, _, bv = p[f"{name}.qkv.bias"].split(c)
    split = lambda t: t.reshape(-1, n, heads, d).transpose(1, 2)  # noqa: E731
    q, k, v = split(win @ wq.T + bq), split(win @ wk.T), split(win @ wv.T + bv)
    scale = torch.exp(torch.clamp(p[f"{name}.logit_scale"], max=math.log(100.0)))
    add = position_bias(p, name, window, heads, x.dtype, x.device)[None]
    if any(shift):
        add = add + region_mask(ph, pw, window, shift, x.dtype, x.device).repeat(b, 1, 1)[:, None]
    qn, kn = unit_rows(q), unit_rows(k)
    out = torch.empty_like(q)
    for i in range(0, q.shape[0], WINDOW_BLOCK):
        sl = slice(i, i + WINDOW_BLOCK)
        scores = qn[sl] @ kn[sl].transpose(-1, -2) * scale + (add if add.shape[0] == 1
                                                              else add[sl])
        e = torch.exp(scores - scores.amax(-1, keepdim=True))
        out[sl] = (e / e.sum(-1, keepdim=True)) @ v[sl]
    out = linear(out.transpose(1, 2).reshape(-1, n, c), p, f"{name}.proj")
    out = out.reshape(b, nh, nw, window, window, c).permute(0, 1, 3, 2, 4, 5).reshape(b, ph, pw, c)
    if any(shift):
        out = torch.roll(out, shift, (1, 2))
    return out[:, :h, :w]


def patch_merge(x, p, name: str):
    b, h, w, c = x.shape
    if h % 2 or w % 2:
        x = torch.cat([x, x.new_zeros((b, h % 2, w, c))], 1)
        x = torch.cat([x, x.new_zeros((b, x.shape[1], w % 2, c))], 2)
    x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], -1)
    return layer_norm(x @ p[f"{name}.reduction.weight"].T, p, f"{name}.norm", LN_EPS)


def stem(x, p):
    """(B, C, H, W) -> (B, H / 4, W / 4, E): each 4 x 4 patch times the
    kernel, plus the bias, then the norm."""
    b, c, h, w = x.shape
    wt = p["features.0.0.weight"]
    patches = x.reshape(b, c, h // PATCH, PATCH, w // PATCH, PATCH).permute(0, 2, 4, 1, 3, 5)
    y = patches.reshape(b, h // PATCH, w // PATCH, -1) @ wt.reshape(wt.shape[0], -1).T
    return layer_norm(y + p["features.0.0.bias"], p, "features.0.2", LN_EPS)


def backbone(x, p, m: Dict) -> List[torch.Tensor]:
    """The four normed stage maps, (B, C_i, H_i, W_i)."""
    t = stem(x, p)
    feats = []
    for i, _, heads, depth in stages(m):
        if i > 0:
            t = patch_merge(t, p, f"features.{2 * i}")
        for j in range(depth):
            b = f"features.{2 * i + 1}.{j}"
            a = window_attention(t, p, f"{b}.attn", heads, m["window"], j % 2 == 1)
            t = t + layer_norm(a, p, f"{b}.norm1", LN_EPS)
            y = linear(gelu(linear(t, p, f"{b}.mlp.0")), p, f"{b}.mlp.3")
            t = t + layer_norm(y, p, f"{b}.norm2", LN_EPS)
        feats.append(layer_norm(t, p, f"norm{i}", LN_EPS).permute(0, 3, 1, 2))
    return feats


def conv(x, weight):
    """A 1x1 or 3x3 convolution (padding 1) without bias: a matmul over the
    channel axis a kernel tap, the taps summed."""
    k = weight.shape[-1]
    if k == 1:
        return torch.einsum("oc,bchw->bohw", weight[:, :, 0, 0], x)
    h, w = x.shape[-2:]
    xp = F.pad(x, (1, 1, 1, 1))
    out = None
    for dy in range(3):
        for dx in range(3):
            tap = torch.einsum("oc,bchw->bohw", weight[:, :, dy, dx],
                               xp[:, :, dy:dy + h, dx:dx + w])
            out = tap if out is None else out + tap
    return out


def conv_module(x, p, name: str, train: bool):
    return torch.relu(batch_norm(conv(x, p[f"{name}.conv.weight"]), p, f"{name}.bn", train))


def adaptive_pool(x, k: int):
    """mmseg's (torch's) adaptive average pool to k x k."""
    h, w = x.shape[-2:]
    rows = []
    for i in range(k):
        r0, r1 = (i * h) // k, -(-((i + 1) * h) // k)
        cols = [x[..., r0:r1, (j * w) // k:-(-((j + 1) * w) // k)].mean((-2, -1))
                for j in range(k)]
        rows.append(torch.stack(cols, -1))
    return torch.stack(rows, -2)


def resize(x, size):
    return F.interpolate(x, size=size, mode="bilinear", align_corners=False)


def upernet(feats: List[torch.Tensor], p, m: Dict, train: bool = False):
    h = "decode_head"
    top = feats[-1]
    size = top.shape[-2:]
    pooled = [resize(conv_module(adaptive_pool(top, k), p, f"{h}.psp_modules.{i}.1", train), size)
              for i, k in enumerate(m["pool_scales"])]
    levels = [conv_module(f, p, f"{h}.lateral_convs.{i}", train) for i, f in enumerate(feats[:-1])]
    levels.append(conv_module(torch.cat([top] + pooled, 1), p, f"{h}.bottleneck", train))
    for i in range(len(levels) - 1, 0, -1):
        levels[i - 1] = levels[i - 1] + resize(levels[i], levels[i - 1].shape[-2:])
    outs = [conv_module(lv, p, f"{h}.fpn_convs.{i}", train) for i, lv in enumerate(levels[:-1])]
    outs.append(levels[-1])
    y = torch.cat([outs[0]] + [resize(o, outs[0].shape[-2:]) for o in outs[1:]], 1)
    y = conv_module(y, p, f"{h}.fpn_bottleneck", train)
    return conv(y, p[f"{h}.conv_seg.weight"]) + p[f"{h}.conv_seg.bias"].view(1, -1, 1, 1)


def swin_logits(x: torch.Tensor, p: Dict[str, torch.Tensor], m: Dict, train: bool = False,
                tf32: bool = False) -> torch.Tensor:
    """(B, C, H, W) normalised input -> (B, K, H, W) logits in x's dtype; H
    and W multiples of 32. ``m`` is the configuration's model section;
    ``train`` normalises the head's batch norms with the batch's
    statistics."""
    with matmul_precision(tf32):
        return resize(upernet(backbone(x, p, m), p, m, train), x.shape[-2:])


def plume_probability(mf, rgb, params: Dict[str, torch.Tensor], model: Dict,
                      tf32: bool = False) -> torch.Tensor:
    """mf (H, W) and rgb (3, H, W) -> sigmoid mask (H, W) in mf's dtype: the
    STARCOP zero-shot renormalisation (NODATA enters as 0), a reflect pad to
    a multiple of 32, the input normalisation, the network, a sigmoid and the
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
    p = {k: v.to(dtype) if v.is_floating_point() else v for k, v in params.items()}
    out = torch.sigmoid(swin_logits(x, p, model, tf32=tf32))[0, 0]
    return out[pr[0]:pr[0] + h, pc[0]:pc[0] + w]
