"""SegFormer: the Mix Transformer (MiT) encoder and the all-MLP decode head
(Xie et al., "SegFormer: Simple and Efficient Design for Semantic
Segmentation with Transformers", NeurIPS 2021, arXiv:2105.15203), NCHW in
and out: (B, C, H, W) -> (B, K, H, W) logits, H and W multiples of 32.

The layers follow NVlabs' ``mix_transformer.py`` and ``segformer_head.py``
and carry their state_dict names (``backbone.*``, ``decode_head.*``):

  * stage i of four: an overlapping patch embedding (a convolution of
    kernel ``PATCH_KERNELS[i]``, stride ``PATCH_STRIDES[i]``, padding k // 2,
    then a layer norm), ``depths[i]`` blocks and a layer norm; tokens are
    (B, N, C) with N = H * W row-major;
  * block: ``x + Attn(LN1(x))``, then ``x + MixFFN(LN2(x))``;
  * efficient self-attention: Q from the tokens; K and V from the tokens
    reduced by a convolution of kernel and stride ``sr_ratios[i]`` and a
    layer norm (the tokens themselves at ratio 1); heads of C / heads
    channels through ``layers.attention`` (``scaled_dot_product_attention``);
    an output projection;
  * MixFFN: ``fc2(GELU(DWConv3x3(fc1(x))))``, hidden width ``mlp_ratio``
    C, exact (erf) GELU;
  * head: each stage's tokens through a linear layer to ``decoder_dim``,
    bilinearly resized (align_corners False) to the 1/4 map, concatenated
    as [c4, c3, c2, c1], a 1x1 convolution without bias, batch norm and
    ReLU, channel dropout (``nn.Dropout2d``, training only), a 1x1
    convolution to the classes; then a bilinear x4 resize to the input, as
    mmseg's ``EncoderDecoder`` does.

The layer norms are NVlabs': eps 1e-6 in the blocks and after each stage,
torch's 1e-5 in the patch embeddings and the reductions. Left out of the
head: mmseg's unused ``conv_seg``. The head's batch norm is
``layers.BatchNorm2d`` (the trainer's running update and data parallel).

Training (``net.train()``) drops whole samples of each residual branch
(stochastic depth, rates rising linearly from 0 to ``drop_path`` over the
blocks) and channels of the fused map (``dropout``), drawn from the
``generator`` given to ``forward`` (a training forward without one raises);
evaluation drops nothing.

Precision: at float32 the attention runs where
``scaled_dot_product_attention`` puts f32 inputs (on an H100 with torch 2.11
the memory-efficient kernel, whose products stay f32-accurate with TF32 off;
flash takes only fp16 / bf16); under bf16 autocast, or with bf16 weights
(``segmenter.cast_for_inference``), the projections hand it bf16 and it
takes a flash kernel (cuDNN's sm90 one there).

Traced (``utils.profiling``), each stage is span ``segformer.stage`` keyed
by its index (0-3), each efficient attention (Q, reduction, K and V,
attention, projection) span ``segformer.attention`` with counters
``queries``, ``keys`` and ``heads``, each MixFFN span ``segformer.mixffn``,
and the head span ``segformer.decode``.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from starcop_tpu_torch.models.layers import BatchNorm2d, attention, dropout
from starcop_tpu_torch.utils.profiling import count, span

# MiT variants (mix_transformer.py: mit_b0 ... mit_b5); every one has MLP
# ratio 4, qkv bias and heads of 64 channels.
MIT = {
    "b5": dict(embed_dims=(64, 128, 320, 512), num_heads=(1, 2, 5, 8), depths=(3, 6, 40, 3),
               sr_ratios=(8, 4, 2, 1)),
}
PATCH_KERNELS = (7, 3, 3, 3)
PATCH_STRIDES = (4, 2, 2, 2)
BLOCK_EPS = 1e-6

# (generator, batch shard) of a training forward's draws, or None.
Draw = Optional[Tuple[torch.Generator, Optional[Tuple[int, int]]]]


def drop_path(y: torch.Tensor, rate: float, draw: Draw) -> torch.Tensor:
    """``y`` with whole samples zeroed at ``rate`` and the rest scaled by
    1 / (1 - rate) (stochastic depth); ``y`` itself without a draw."""
    if draw is None or rate == 0.0:
        return y
    keep = y.new_ones((y.shape[0],) + (1,) * (y.dim() - 1))
    return y * dropout(keep, rate, *draw)


def tokens_to_map(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, H * W, C) tokens -> a (B, C, H, W) view of them (channels last)."""
    return x.view(x.shape[0], h, w, x.shape[2]).permute(0, 3, 1, 2)


def map_to_tokens(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, H * W, C) tokens."""
    return x.flatten(2).transpose(1, 2)


class OverlapPatchEmbed(nn.Module):
    def __init__(self, in_channels: int, dim: int, kernel: int, stride: int):
        super().__init__()
        self.proj = nn.Conv2d(in_channels, dim, kernel, stride, kernel // 2)
        self.norm = nn.LayerNorm(dim)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, int, int]:
        x = self.proj(x)
        h, w = x.shape[-2:]
        return self.norm(map_to_tokens(x)), h, w


class Attention(nn.Module):
    """Efficient self-attention: K and V from the tokens reduced by
    ``sr_ratio`` in each direction."""

    def __init__(self, dim: int, num_heads: int, sr_ratio: int):
        super().__init__()
        self.num_heads, self.sr_ratio = num_heads, sr_ratio
        self.q = nn.Linear(dim, dim)
        self.kv = nn.Linear(dim, 2 * dim)
        self.proj = nn.Linear(dim, dim)
        if sr_ratio > 1:
            self.sr = nn.Conv2d(dim, dim, sr_ratio, sr_ratio)
            self.norm = nn.LayerNorm(dim)

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        b, n, c = x.shape
        heads = self.num_heads
        with span("segformer.attention") as traced:
            q = self.q(x).view(b, n, heads, c // heads).transpose(1, 2)
            xr = x
            if self.sr_ratio > 1:
                xr = self.norm(map_to_tokens(self.sr(tokens_to_map(x, h, w))))
            k, v = self.kv(xr).view(b, -1, 2, heads, c // heads).permute(2, 0, 3, 1, 4)
            out = attention(q, k, v)
            out = self.proj(out.transpose(1, 2).reshape(b, n, c))
            if traced is not None:
                count("queries", n)
                count("keys", k.shape[2])
                count("heads", heads)
        return out


class DWConv(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 3, 1, 1, groups=dim)

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        return map_to_tokens(self.dwconv(tokens_to_map(x, h, w)))


class MixFFN(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.dwconv = DWConv(hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        with span("segformer.mixffn"):
            return self.fc2(F.gelu(self.dwconv(self.fc1(x), h, w)))


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, sr_ratio: int, mlp_ratio: int,
                 drop_path: float):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=BLOCK_EPS)
        self.attn = Attention(dim, num_heads, sr_ratio)
        self.norm2 = nn.LayerNorm(dim, eps=BLOCK_EPS)
        self.mlp = MixFFN(dim, dim * mlp_ratio)
        self.drop_path = drop_path

    def forward(self, x: torch.Tensor, h: int, w: int, draw: Draw = None) -> torch.Tensor:
        x = x + drop_path(self.attn(self.norm1(x), h, w), self.drop_path, draw)
        return x + drop_path(self.mlp(self.norm2(x), h, w), self.drop_path, draw)


class MixTransformer(nn.Module):
    """The MiT encoder: (B, C, H, W) -> the four stages' (B, C_i, H_i, W_i)
    maps at 1/4, 1/8, 1/16 and 1/32."""

    def __init__(self, in_channels: int, embed_dims: Sequence[int], num_heads: Sequence[int],
                 depths: Sequence[int], sr_ratios: Sequence[int], mlp_ratio: int,
                 drop_path: float):
        super().__init__()
        rates = torch.linspace(0, drop_path, sum(depths)).tolist()
        cin, first = in_channels, 0
        for i, (dim, heads, depth, sr) in enumerate(zip(embed_dims, num_heads, depths, sr_ratios)):
            setattr(self, f"patch_embed{i + 1}",
                    OverlapPatchEmbed(cin, dim, PATCH_KERNELS[i], PATCH_STRIDES[i]))
            setattr(self, f"block{i + 1}", nn.ModuleList(
                Block(dim, heads, sr, mlp_ratio, rates[first + j]) for j in range(depth)))
            setattr(self, f"norm{i + 1}", nn.LayerNorm(dim, eps=BLOCK_EPS))
            cin, first = dim, first + depth
        self.num_stages = len(embed_dims)

    def forward(self, x: torch.Tensor, draw: Draw = None) -> List[torch.Tensor]:
        feats = []
        for i in range(self.num_stages):
            with span("segformer.stage", i):
                x, h, w = getattr(self, f"patch_embed{i + 1}")(x)
                for block in getattr(self, f"block{i + 1}"):
                    x = block(x, h, w, draw)
                x = tokens_to_map(getattr(self, f"norm{i + 1}")(x), h, w)
            feats.append(x)
        return feats


class MLP(nn.Module):
    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.proj = nn.Linear(in_dim, out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, C, H, W) -> (B, H * W, out) tokens."""
        return self.proj(map_to_tokens(x))


class ConvBNReLU(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, 1, bias=False)
        self.bn = BatchNorm2d(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.bn(self.conv(x)))


class SegFormerHead(nn.Module):
    """The all-MLP decoder: four stage maps -> logits at the 1/4 map."""

    def __init__(self, in_dims: Sequence[int], decoder_dim: int, num_classes: int,
                 dropout_rate: float):
        super().__init__()
        for i, c in enumerate(in_dims):
            setattr(self, f"linear_c{i + 1}", MLP(c, decoder_dim))
        self.linear_fuse = ConvBNReLU(decoder_dim * len(in_dims), decoder_dim)
        self.linear_pred = nn.Conv2d(decoder_dim, num_classes, 1)
        self.dropout_rate = dropout_rate

    def forward(self, feats: List[torch.Tensor], draw: Draw = None) -> torch.Tensor:
        size = feats[0].shape[-2:]
        parts = []
        for i in reversed(range(len(feats))):
            f = feats[i]
            y = tokens_to_map(getattr(self, f"linear_c{i + 1}")(f), *f.shape[-2:])
            if i > 0:
                y = F.interpolate(y, size=size, mode="bilinear", align_corners=False)
            parts.append(y)
        y = self.linear_fuse(torch.cat(parts, dim=1))
        if draw is not None and self.dropout_rate > 0:
            y = y * dropout(y.new_ones(y.shape[:2] + (1, 1)), self.dropout_rate, *draw)
        return self.linear_pred(y)


class SegFormer(nn.Module):
    """MiT encoder + all-MLP head: (B, in_channels, H, W) -> (B,
    num_classes, H, W) logits; H and W multiples of 32."""

    def __init__(self, in_channels: int, num_classes: int = 1, *, embed_dims: Sequence[int],
                 num_heads: Sequence[int], depths: Sequence[int], sr_ratios: Sequence[int],
                 mlp_ratio: int = 4, decoder_dim: int = 768, drop_path: float = 0.1,
                 dropout_rate: float = 0.1):
        super().__init__()
        self.backbone = MixTransformer(in_channels, embed_dims, num_heads, depths, sr_ratios,
                                       mlp_ratio, drop_path)
        self.decode_head = SegFormerHead(embed_dims, decoder_dim, num_classes, dropout_rate)
        self.drop_path = drop_path
        self.batch_shard = None  # (rank, size) under ``layers.set_data_parallel``

    @property
    def dropout_rate(self) -> float:
        """The largest rate a training forward draws with (the trainer hands
        a generator to a network whose rate is above 0)."""
        return max(self.drop_path, self.decode_head.dropout_rate)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        draw = None
        if self.training and self.dropout_rate > 0:
            if generator is None:
                raise ValueError("a training forward with drop-path or dropout needs a generator")
            draw = (generator, self.batch_shard)
        feats = self.backbone(x, draw)
        with span("segformer.decode"):
            y = self.decode_head(feats, draw)
            return F.interpolate(y, size=x.shape[-2:], mode="bilinear", align_corners=False)

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None) -> "SegFormer":
        """NVlabs' ``_init_weights`` from ``generator``: linear weights
        trunc-normal with std 0.02 (cut at +-2), convolutions normal with std
        sqrt(2 / fan_out) (fan_out = k * k * out / groups), zero biases,
        layer and batch norms at scale 1 and shift 0."""
        for mod in self.modules():
            if isinstance(mod, (nn.LayerNorm, nn.BatchNorm2d)):
                mod.reset_parameters()
            elif isinstance(mod, nn.Linear):
                nn.init.trunc_normal_(mod.weight, 0.0, 0.02, -2.0, 2.0, generator=generator)
                mod.bias.zero_()
            elif isinstance(mod, nn.Conv2d):
                fan_out = math.prod(mod.kernel_size) * mod.out_channels // mod.groups
                mod.weight.normal_(0.0, math.sqrt(2.0 / fan_out), generator=generator)
                if mod.bias is not None:
                    mod.bias.zero_()
        return self


def segformer(variant: str, in_channels: int, num_classes: int = 1, **kw) -> SegFormer:
    """SegFormer with the MiT ``variant``'s encoder (``MIT``)."""
    return SegFormer(in_channels, num_classes, **MIT[variant], **kw)


ARCHITECTURES: Dict[str, functools.partial] = {
    f"segformer_{v}": functools.partial(segformer, v) for v in MIT
}
