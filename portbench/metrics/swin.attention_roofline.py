"""SwinV2's window attention's share of its roofline: over the traced
``swin.attention`` spans, the sum of each span's least time on one H100 (the
larger of its operations at 67 TFLOP/s, f32 with TF32 off, and its bytes at
3.35 TB/s; ``counts_swin.attention_flops`` and ``attention_bytes`` at the
stage's map, the span's key, of the padded granule), over the device time of
the kernels launched inside those spans (copies and sets left out)."""

from portbench import program
from portbench.counts import F32_FLOP_PER_S, HBM_BYTES_PER_S
from portbench.counts_swin import attention_bytes, attention_flops, stage_shapes
from portbench.reference.granule import find_padding


def read(bundle):
    trace, ctx = bundle["trace"], bundle["ctx"]
    found = program.spans(trace, "swin.attention")
    if not found:
        return None
    ns = program.device_ns_launched_in(trace, found, kernels_only=True)
    if ns <= 0:
        return None
    g, m = ctx.config["granule"], ctx.config["model"]
    shapes = stage_shapes(g["lines"] + sum(find_padding(g["lines"])),
                          g["samples"] + sum(find_padding(g["samples"])), m)
    bound = 0.0
    for s in found:
        _, c, heads, _, h, w = shapes[s.key]
        bound += max(attention_flops(h, w, c, m["window"]) / F32_FLOP_PER_S,
                     attention_bytes(h, w, c, heads, m["window"]) / HBM_BYTES_PER_S)
    return 100.0 * bound / (ns / 1e9)
