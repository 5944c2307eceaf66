"""SegFormer's operations and bytes, counted from shapes (``counts.py``'s
rules: the least work the algorithm needs, whatever an implementation does).

A forward counts the multiply-adds (2 operations each) of its linear layers,
convolutions and attention products; layer and batch norms, GELU, the
softmax, the resizes and the concatenation are left out, so a share of a
peak taken from these counts is a lower bound. ``m`` is the configuration's
model section (``configs/segformer_b5_emit.json``).
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

from portbench.reference.segformer import stages


def stage_shapes(height: int, width: int, m: Dict) -> Iterator[Tuple[int, int, int, int, int]]:
    """(index, dim, queries, reduced keys, reduction) of each stage at an (H,
    W) input, H and W multiples of 32: the map halves its side after a
    first quarter, a reduction of r keeps floor(h / r) x floor(w / r)."""
    h, w = height, width
    for i, c, _, _, r, _, s in stages(m):
        h, w = h // s, w // s
        yield i, c, h * w, (h // r) * (w // r), r


def attention_flops(queries: int, keys: int, dim: int, reduction: int) -> float:
    """One efficient attention: Q, the reduction convolution (when r > 1),
    K and V, Q K^T and the weighted sum over all heads, the projection."""
    red = 2 * keys * dim * dim * reduction**2 if reduction > 1 else 0
    return float(2 * queries * dim * dim + red + 2 * keys * dim * 2 * dim
                 + 2 * 2 * queries * keys * dim + 2 * queries * dim * dim)


def attention_bytes(queries: int, keys: int, dim: int, reduction: int,
                    elem: int = 4) -> float:
    """One efficient attention's least bytes: Q and O read or written once,
    K and V once, and the weights of Q, K and V, the projection and the
    reduction."""
    weights = dim * dim * (4 + (reduction**2 if reduction > 1 else 0))
    return float(elem * (2 * queries * dim + 2 * keys * dim + weights))


def segformer_forward_flops(height: int, width: int, m: Dict, batch: int = 1) -> float:
    """Linear layers, convolutions and attention products of one forward at
    (batch, in_channels, H, W)."""
    total, cin = 0.0, m["in_channels"]
    shapes = list(stage_shapes(height, width, m))
    for (i, c, n, nr, r), (_, _, _, depth, _, k, _) in zip(shapes, stages(m)):
        total += 2 * n * c * cin * k * k  # the patch embedding
        hidden = m["mlp_ratio"] * c
        block = (attention_flops(n, nr, c, r)
                 + 2 * n * c * hidden + 2 * n * hidden * 9 + 2 * n * hidden * c)
        total += depth * block
        cin = c
    d, n1 = m["decoder_dim"], shapes[0][2]
    total += sum(2 * n * c * d for _, c, n, _, _ in shapes)  # the per-stage linear layers
    total += 2 * n1 * len(shapes) * d * d + 2 * n1 * d * m["num_classes"]  # fuse and predict
    return float(total * batch)
