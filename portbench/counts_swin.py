"""SwinV2 + UperNet's operations and bytes, counted from shapes
(``counts.py``'s rules: the least work the algorithm needs, whatever an
implementation does).

A forward counts the multiply-adds (2 operations each) of its linear
layers, convolutions and attention products. In a window attention these
are each real token's q, k and v and its projection, and each real query's
scores against, and weighted sum over, the window's w^2 keys (the padded
tokens are keys; their own queries are cropped away, so they are not
counted). Layer and batch norms, GELU, the softmax, the position-bias MLP
(a few kFLOP a block), the pools, resizes, rolls and concatenations are
left out, so a share of a peak taken from these counts is a lower bound.
``m`` is the configuration's model section
(``configs/swinv2_b_upernet_emit.json``).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from portbench.reference.swin import CPB_HIDDEN, PATCH, stages


def stage_shapes(height: int, width: int, m: Dict) -> List[Tuple[int, int, int, int, int, int]]:
    """(index, dim, heads, depth, h, w) of each stage's map at an (H, W)
    input, H and W multiples of 32: the stem's 1/4 map, then each patch
    merging halves the sides (rounding up)."""
    h, w = height // PATCH, width // PATCH
    out = []
    for i, c, heads, depth in stages(m):
        if i > 0:
            h, w = -(-h // 2), -(-w // 2)
        out.append((i, c, heads, depth, h, w))
    return out


def attention_flops(h: int, w: int, dim: int, window: int) -> float:
    """One window attention over an (h, w) map: q, k, v and the projection
    of the h w tokens, and each token's scores and weighted sum over its
    window's window^2 keys, over all heads."""
    tokens, keys = h * w, window * window
    return float(2 * tokens * dim * 3 * dim + 2 * 2 * tokens * keys * dim
                 + 2 * tokens * dim * dim)


def attention_bytes(h: int, w: int, dim: int, heads: int, window: int,
                    elem: int = 4) -> float:
    """One window attention's least bytes: the tokens read and written once,
    the weights once (qkv and the projection with their biases, the
    position-bias MLP, the logit scales), and the (2 window - 1)^2 bias
    table of each head once."""
    weights = 4 * dim * dim + 4 * dim + CPB_HIDDEN * (3 + heads) + heads
    table = heads * (2 * window - 1) ** 2
    return float(elem * (2 * h * w * dim + weights + table))


def head_flops(shapes, m: Dict) -> float:
    """The UperNet head's convolutions: PPM's 1x1 at each pooled size and the
    3x3 bottleneck, the 1x1 laterals, the 3x3 FPN convolutions, the 3x3
    fuse and the 1x1 prediction."""
    ch, k = m["channels"], m["num_classes"]
    (_, _, _, _, h1, w1), (_, top, _, _, h4, w4) = shapes[0], shapes[-1]
    total = sum(2 * s * s * top * ch for s in m["pool_scales"])
    total += 2 * h4 * w4 * (top + len(m["pool_scales"]) * ch) * ch * 9
    for _, c, _, _, h, w in shapes[:-1]:
        total += 2 * h * w * c * ch + 2 * h * w * ch * ch * 9
    total += 2 * h1 * w1 * len(shapes) * ch * ch * 9 + 2 * h1 * w1 * ch * k
    return float(total)


def swin_forward_flops(height: int, width: int, m: Dict, batch: int = 1) -> float:
    """Linear layers, convolutions and attention products of one forward at
    (batch, in_channels, H, W): the stem, each block's attention and MLP,
    the patch mergings and the head."""
    shapes = stage_shapes(height, width, m)
    _, e, _, _, h1, w1 = shapes[0]
    total = 2 * h1 * w1 * e * m["in_channels"] * PATCH * PATCH
    prev = e
    for i, c, _, depth, h, w in shapes:
        if i > 0:
            total += 2 * h * w * 4 * prev * c
        total += depth * (attention_flops(h, w, c, m["window"])
                          + 2 * 2 * h * w * c * m["mlp_ratio"] * c)
        prev = c
    return float((total + head_flops(shapes, m)) * batch)
