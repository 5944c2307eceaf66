"""Swin Transformer V2 with an UperNet head: (B, C, H, W) -> (B, K, H, W)
logits, H and W multiples of 32.

The backbone follows torchvision's ``models/swin_transformer.py``
(``swin_v2_b``; Liu et al., "Swin Transformer V2", CVPR 2022,
arXiv:2111.09883) and carries its state_dict names (``features.*``); the
head is mmsegmentation's ``UPerHead`` with its ``PPM`` (Xiao et al.,
"Unified Perceptual Parsing", ECCV 2018, arXiv:1807.10221) under mmseg's
names (``decode_head.*``), so a public checkpoint loads by name.

  * stem (``features.0``): a convolution of kernel and stride 4 to
    ``embed_dim``, then channels last (B, H, W, C) and a layer norm;
  * stage i (``features.2i+1``) of ``depths[i]`` blocks at width
    ``embed_dim * 2**i``, between stages a patch merging (``features.2i``):
    the 2 x 2 neighbours concatenated (x[0::2, 0::2], x[1::2, 0::2],
    x[0::2, 1::2], x[1::2, 1::2]), a linear 4C -> 2C without bias, then a
    layer norm (V2 puts the norm after the reduction);
  * block (post-norm): ``x + LN1(WAttn(x))``, then ``x + LN2(MLP(x))``,
    MLP = linear C -> 4C, exact (erf) GELU, linear 4C -> C;
  * WAttn: the map zero-padded on the right and bottom to multiples of the
    window (the padded tokens take part, as in torchvision's
    ``shifted_window_attention``); on odd blocks a cyclic shift by half a
    window (no shift in a direction whose padded size is at most one
    window); windows of ``window`` x ``window`` tokens; ``qkv`` (its k third
    of the bias held at zero); per head the cosine attention
    ``normalize(q) normalize(k)^T exp(min(logit_scale, ln 100))`` plus
    ``16 sigmoid(cpb(table))[index]`` (the continuous relative-position
    bias: a 2 -> 512 -> heads MLP over the log-spaced offsets) plus, on
    shifted blocks, -100 between tokens of different regions; softmax,
    ``v``, the output projection; the windows reversed, the shift undone,
    the padding cropped;
  * dense outputs: a layer norm on each stage's output (``norm0`` ...
    ``norm3``, as mmseg's ``SwinTransformer`` does for dense prediction);
  * head: PPM on stage 4 (adaptive average pools to 1, 2, 3 and 6, each a
    1x1 ConvModule to ``channels`` and a bilinear resize back, concatenated
    with stage 4, a 3x3 ConvModule ``bottleneck``); 1x1 lateral
    ConvModules on stages 1-3; the top-down path (each level plus the level
    above resized to it); 3x3 ``fpn_convs`` on levels 1-3; every level
    resized to the 1/4 map and concatenated; the 3x3 ``fpn_bottleneck``;
    ``Dropout2d`` (training only), the 1x1 ``conv_seg``; then a bilinear x4
    resize to the input, as mmseg's ``EncoderDecoder`` does. A ConvModule is
    a convolution without bias, ``layers.BatchNorm2d`` and ReLU; every
    resize is bilinear with align_corners False.

Left out: torchvision's classification norm and head, and mmseg's auxiliary
FCN head, which its configurations train with and drop at inference. Every
layer norm takes eps 1e-5.

Training (``net.train()``) drops whole samples of each residual branch
(stochastic depth, ``drop_path`` x block index / (blocks - 1)) and channels
of the fused map (``dropout_rate``), drawn from the ``generator`` given to
``forward`` (a training forward without one raises).

The window attention runs through ``layers.attention`` (SDPA): the logit
scale folded into q, scale 1, and the bias and the shift mask as one
additive mask. The shift mask is built once a forward for each stage's
padded map; each block adds its own bias to it.

Traced (``utils.profiling``), each stage is span ``swin.stage`` keyed by its
index (0-3; the stem or the patch merging into it, its blocks and its
output norm), each window attention span ``swin.attention`` with counters
``windows``, ``window_tokens``, ``heads`` and ``shifted`` (1 on a shifted
block), each MLP span ``swin.mlp``, each patch merging span ``swin.merge``,
and the head span ``upernet.head`` with ``upernet.ppm``, ``upernet.fpn``
and ``upernet.fuse`` inside it.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from starcop_tpu_torch.models.layers import BatchNorm2d, attention, dropout
from starcop_tpu_torch.models.segformer import Draw, drop_path
from starcop_tpu_torch.utils.profiling import count, span

PATCH = 4
MLP_RATIO = 4
LN_EPS = 1e-5
CPB_HIDDEN = 512
BIAS_SCALE = 16.0
MASK_FILL = -100.0
LOGIT_CAP = math.log(100.0)
POOL_SCALES = (1, 2, 3, 6)


def relative_coords_table(window: int) -> torch.Tensor:
    """(1, 2w-1, 2w-1, 2) offsets -(w-1) .. w-1 over w - 1, times 8, mapped
    by sign(t) log2(|t| + 1) / 3 (torchvision's
    ``define_relative_position_bias_table``)."""
    r = torch.arange(-(window - 1), window, dtype=torch.float32)
    t = torch.stack(torch.meshgrid(r, r, indexing="ij"), -1)[None] / (window - 1) * 8
    return torch.sign(t) * torch.log2(t.abs() + 1.0) / 3.0


def relative_position_index(window: int) -> torch.Tensor:
    """(w^4,) index into the (2w-1)^2 table of every (query, key) pair of a
    window, row-major."""
    c = torch.arange(window)
    coords = torch.stack(torch.meshgrid(c, c, indexing="ij")).flatten(1)  # 2, N
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0) + (window - 1)
    return (rel[..., 0] * (2 * window - 1) + rel[..., 1]).flatten()


def shift_mask(pad_h: int, pad_w: int, window: int, shift: Tuple[int, int],
               device) -> torch.Tensor:
    """(windows, N, N) additive mask of a shifted map: 0 within a region,
    -100 across, the regions cut by the slices (0, -w), (-w, -s), (-s, end)
    of the padded map in each direction (torchvision's)."""
    label = torch.zeros((pad_h, pad_w), device=device)
    n = 0
    for h0, h1 in ((0, -window), (-window, -shift[0]), (-shift[0], None)):
        for w0, w1 in ((0, -window), (-window, -shift[1]), (-shift[1], None)):
            label[h0:h1, w0:w1] = n
            n += 1
    label = label.view(pad_h // window, window, pad_w // window, window)
    label = label.permute(0, 2, 1, 3).reshape(-1, window * window)
    diff = label[:, None, :] - label[:, :, None]
    return torch.where(diff != 0, MASK_FILL, 0.0)


def stage_geometry(h: int, w: int, window: int) -> Tuple[int, int, Tuple[int, int]]:
    """(padded H, padded W, shift) of an (h, w) map: padded to multiples of
    the window, no shift in a direction whose padded size is one window."""
    ph, pw = h + (-h) % window, w + (-w) % window
    s = window // 2
    return ph, pw, (s if ph > window else 0, s if pw > window else 0)


class ChannelsLast(nn.Module):
    """(B, C, H, W) -> (B, H, W, C) (torchvision's ``Permute``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.permute(0, 2, 3, 1)


class WindowAttentionV2(nn.Module):
    """torchvision's ``ShiftedWindowAttentionV2`` on a channels-last map."""

    def __init__(self, dim: int, num_heads: int, window: int):
        super().__init__()
        self.num_heads, self.window = num_heads, window
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.logit_scale = nn.Parameter(torch.log(10 * torch.ones((num_heads, 1, 1))))
        self.cpb_mlp = nn.Sequential(nn.Linear(2, CPB_HIDDEN), nn.ReLU(inplace=True),
                                     nn.Linear(CPB_HIDDEN, num_heads, bias=False))
        with torch.no_grad():
            self.qkv.bias[dim:2 * dim].zero_()
        self.register_buffer("relative_coords_table", relative_coords_table(window))
        self.register_buffer("relative_position_index", relative_position_index(window))

    def position_bias(self) -> torch.Tensor:
        """(heads, N, N): 16 sigmoid(cpb(table)) at each pair's offset."""
        n = self.window * self.window
        table = self.cpb_mlp(self.relative_coords_table).view(-1, self.num_heads)
        bias = table[self.relative_position_index].view(n, n, -1).permute(2, 0, 1)
        return BIAS_SCALE * torch.sigmoid(bias)

    def scaled(self, q: torch.Tensor, k: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Cosine attention's (q, k): both unit rows, q times each head's
        exp(min(logit_scale, ln 100))."""
        scale = torch.clamp(self.logit_scale, max=LOGIT_CAP).exp()
        return F.normalize(q, dim=-1) * scale, F.normalize(k, dim=-1)

    def forward(self, x: torch.Tensor, shift: Tuple[int, int],
                mask: Optional[torch.Tensor]) -> torch.Tensor:
        """x (B, H, W, C); ``shift`` (0, 0) on unshifted blocks, else the
        stage's with its ``mask`` (``shift_mask``)."""
        b, h, w, c = x.shape
        win, heads = self.window, self.num_heads
        with span("swin.attention") as traced:
            ph, pw = h + (-h) % win, w + (-w) % win
            x = F.pad(x, (0, 0, 0, pw - w, 0, ph - h))
            if any(shift):
                x = torch.roll(x, (-shift[0], -shift[1]), (1, 2))
            n = win * win
            windows = x.reshape(b, ph // win, win, pw // win, win, c).permute(0, 1, 3, 2, 4, 5)
            windows = windows.reshape(-1, n, c)
            bias = self.qkv.bias
            bias = torch.cat([bias[:c], torch.zeros_like(bias[c:2 * c]), bias[2 * c:]])
            qkv = F.linear(windows, self.qkv.weight, bias)
            q, k, v = qkv.view(-1, n, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
            q, k = self.scaled(q, k)
            add = self.position_bias()[None]
            if mask is not None:
                add = add + mask[:, None]
                if b > 1:
                    add = add.repeat(b, 1, 1, 1)
            out = attention(q.to(v.dtype), k.to(v.dtype), v, add, scale=1.0)
            out = self.proj(out.transpose(1, 2).reshape(-1, n, c))
            out = out.view(b, ph // win, pw // win, win, win, c).permute(0, 1, 3, 2, 4, 5)
            out = out.reshape(b, ph, pw, c)
            if any(shift):
                out = torch.roll(out, shift, (1, 2))
            out = out[:, :h, :w]
            if traced is not None:
                count("windows", windows.shape[0])
                count("window_tokens", n)
                count("heads", heads)
                count("shifted", int(any(shift)))
        return out


class SwinBlockV2(nn.Module):
    """Post-norm block: ``x + LN1(WAttn(x))``, ``x + LN2(MLP(x))``."""

    def __init__(self, dim: int, num_heads: int, window: int, drop_path: float):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = WindowAttentionV2(dim, num_heads, window)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        # torchvision's MLP: linear, GELU, dropout, linear, dropout (names mlp.0, mlp.3).
        self.mlp = nn.Sequential(nn.Linear(dim, dim * MLP_RATIO), nn.GELU(), nn.Identity(),
                                 nn.Linear(dim * MLP_RATIO, dim))
        self.drop_path = drop_path

    def forward(self, x: torch.Tensor, shift: Tuple[int, int], mask: Optional[torch.Tensor],
                draw: Draw = None) -> torch.Tensor:
        x = x + drop_path(self.norm1(self.attn(x, shift, mask)), self.drop_path, draw)
        with span("swin.mlp"):
            y = self.mlp(x)
        return x + drop_path(self.norm2(y), self.drop_path, draw)


class PatchMergingV2(nn.Module):
    """2 x 2 neighbours -> one token: concatenate, linear 4C -> 2C, norm."""

    def __init__(self, dim: int):
        super().__init__()
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)
        self.norm = nn.LayerNorm(2 * dim, eps=LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[1:3]
        x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]],
                      -1)
        return self.norm(self.reduction(x))


class ConvModule(nn.Module):
    """mmcv's ConvModule as UperNet uses it: convolution (no bias), batch
    norm, ReLU."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, kernel, padding=kernel // 2, bias=False)
        self.bn = BatchNorm2d(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.bn(self.conv(x)))


def _resize(x: torch.Tensor, size) -> torch.Tensor:
    return F.interpolate(x, size=size, mode="bilinear", align_corners=False)


class UPerHead(nn.Module):
    """mmseg's ``UPerHead``: four stage maps -> logits at the 1/4 map."""

    def __init__(self, in_channels: Sequence[int], channels: int, num_classes: int,
                 dropout_rate: float):
        super().__init__()
        top = in_channels[-1]
        self.psp_modules = nn.ModuleList(
            nn.Sequential(nn.AdaptiveAvgPool2d(s), ConvModule(top, channels, 1))
            for s in POOL_SCALES)
        self.bottleneck = ConvModule(top + len(POOL_SCALES) * channels, channels, 3)
        self.lateral_convs = nn.ModuleList(ConvModule(c, channels, 1) for c in in_channels[:-1])
        self.fpn_convs = nn.ModuleList(ConvModule(channels, channels, 3)
                                       for _ in in_channels[:-1])
        self.fpn_bottleneck = ConvModule(len(in_channels) * channels, channels, 3)
        self.conv_seg = nn.Conv2d(channels, num_classes, 1)
        self.dropout_rate = dropout_rate

    def psp_forward(self, x: torch.Tensor) -> torch.Tensor:
        size = x.shape[-2:]
        return self.bottleneck(torch.cat([x] + [_resize(ppm(x), size)
                                                for ppm in self.psp_modules], 1))

    def forward(self, feats: List[torch.Tensor], draw: Draw = None) -> torch.Tensor:
        with span("upernet.ppm"):
            top = self.psp_forward(feats[-1])
        with span("upernet.fpn"):
            laterals = [conv(f) for conv, f in zip(self.lateral_convs, feats)] + [top]
            for i in range(len(laterals) - 1, 0, -1):
                laterals[i - 1] = laterals[i - 1] + _resize(laterals[i], laterals[i - 1].shape[-2:])
            outs = [conv(lat) for conv, lat in zip(self.fpn_convs, laterals)] + [laterals[-1]]
            size = outs[0].shape[-2:]
            y = torch.cat([outs[0]] + [_resize(o, size) for o in outs[1:]], 1)
        with span("upernet.fuse"):
            y = self.fpn_bottleneck(y)
            if draw is not None and self.dropout_rate > 0:
                y = y * dropout(y.new_ones(y.shape[:2] + (1, 1)), self.dropout_rate, *draw)
            return self.conv_seg(y)


class SwinV2UperNet(nn.Module):
    """SwinV2 backbone + UperNet head: (B, in_channels, H, W) -> (B,
    num_classes, H, W) logits; H and W multiples of 32."""

    def __init__(self, in_channels: int, num_classes: int = 1, *, embed_dim: int,
                 depths: Sequence[int], num_heads: Sequence[int], window: int,
                 channels: int = 512, drop_path: float = 0.5, dropout_rate: float = 0.1):
        super().__init__()
        self.window, self.num_stages = window, len(depths)
        dims = [embed_dim * 2**i for i in range(len(depths))]
        layers: List[nn.Module] = [nn.Sequential(
            nn.Conv2d(in_channels, embed_dim, PATCH, PATCH), ChannelsLast(),
            nn.LayerNorm(embed_dim, eps=LN_EPS))]
        total, first = sum(depths), 0
        for i, (dim, heads, depth) in enumerate(zip(dims, num_heads, depths)):
            if i > 0:
                layers.append(PatchMergingV2(dims[i - 1]))
            layers.append(nn.ModuleList(
                SwinBlockV2(dim, heads, window, drop_path * (first + j) / max(total - 1, 1))
                for j in range(depth)))
            first += depth
        self.features = nn.Sequential(*layers)
        for i, dim in enumerate(dims):
            setattr(self, f"norm{i}", nn.LayerNorm(dim, eps=LN_EPS))
        self.decode_head = UPerHead(dims, channels, num_classes, dropout_rate)
        self.drop_path = drop_path
        self.batch_shard = None  # (rank, size) under ``layers.set_data_parallel``

    @property
    def dropout_rate(self) -> float:
        """The largest rate a training forward draws with (the trainer hands
        a generator to a network whose rate is above 0)."""
        return max(self.drop_path, self.decode_head.dropout_rate)

    def backbone(self, x: torch.Tensor, draw: Draw = None) -> List[torch.Tensor]:
        """The four stages' normed (B, C_i, H_i, W_i) maps at 1/4 ... 1/32."""
        feats = []
        for i in range(self.num_stages):
            with span("swin.stage", i):
                if i == 0:
                    x = self.features[0](x)
                else:
                    with span("swin.merge"):
                        x = self.features[2 * i](x)
                ph, pw, shift = stage_geometry(x.shape[1], x.shape[2], self.window)
                mask = shift_mask(ph, pw, self.window, shift, x.device) if any(shift) else None
                for j, block in enumerate(self.features[2 * i + 1]):
                    odd = j % 2 == 1 and mask is not None
                    x = block(x, shift if odd else (0, 0), mask if odd else None, draw)
                feats.append(getattr(self, f"norm{i}")(x).permute(0, 3, 1, 2))
        return feats

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        draw = None
        if self.training and self.dropout_rate > 0:
            if generator is None:
                raise ValueError("a training forward with drop-path or dropout needs a generator")
            draw = (generator, self.batch_shard)
        feats = self.backbone(x, draw)
        with span("upernet.head"):
            y = self.decode_head(feats, draw)
            return _resize(y, x.shape[-2:])

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None) -> "SwinV2UperNet":
        """The sources' initialisation from ``generator``: torchvision's for
        the backbone (linear weights trunc-normal with std 0.02 cut at +-2,
        zero biases, the k third of qkv's bias 0, logit scales ln 10, the
        stem at torch's default), mmseg's for the head (ConvModule
        convolutions normal with std sqrt(2 / fan_out), fan_out = k * k *
        out; ``conv_seg`` normal with std 0.01 and a zero bias); layer and
        batch norms at scale 1 and shift 0."""
        for mod in self.modules():
            if isinstance(mod, (nn.LayerNorm, nn.BatchNorm2d)):
                mod.reset_parameters()
            elif isinstance(mod, nn.Linear):
                nn.init.trunc_normal_(mod.weight, 0.0, 0.02, -2.0, 2.0, generator=generator)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, WindowAttentionV2):
                mod.logit_scale.fill_(math.log(10.0))
        stem = self.features[0][0]
        nn.init.kaiming_uniform_(stem.weight, a=math.sqrt(5), generator=generator)
        bound = 1 / math.sqrt(stem.weight[0].numel())
        nn.init.uniform_(stem.bias, -bound, bound, generator=generator)
        for mod in self.decode_head.modules():
            if isinstance(mod, ConvModule):
                fan_out = math.prod(mod.conv.kernel_size) * mod.conv.out_channels
                mod.conv.weight.normal_(0.0, math.sqrt(2.0 / fan_out), generator=generator)
        self.decode_head.conv_seg.weight.normal_(0.0, 0.01, generator=generator)
        self.decode_head.conv_seg.bias.zero_()
        return self


# torchvision's swin_v2_b (models/swin_transformer.py): patch 4, heads of 32
# channels, window 8 (the ImageNet-1k weights'), with a 512-channel head.
ARCHITECTURES: Dict[str, functools.partial] = {
    "swinv2_b_upernet": functools.partial(SwinV2UperNet, embed_dim=128, depths=(2, 2, 18, 2),
                                          num_heads=(4, 8, 16, 32), window=8),
}
