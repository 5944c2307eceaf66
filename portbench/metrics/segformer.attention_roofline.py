"""SegFormer's efficient attention's share of its roofline: over the traced
``segformer.attention`` spans, the sum of each span's least time on one H100
(the larger of its operations at 67 TFLOP/s, f32 with TF32 off, and its
bytes at 3.35 TB/s; ``counts_segformer.attention_flops`` and
``attention_bytes`` from the span's ``queries`` and ``keys`` counters and
its stage, the span's key), over the device time of the kernels launched
inside those spans (copies and sets left out)."""

from portbench import program
from portbench.counts import F32_FLOP_PER_S, HBM_BYTES_PER_S
from portbench.counts_segformer import attention_bytes, attention_flops


def read(bundle):
    trace, m = bundle["trace"], bundle["ctx"].config["model"]
    found = program.spans(trace, "segformer.attention")
    if not found:
        return None
    ns = program.device_ns_launched_in(trace, found, kernels_only=True)
    if ns <= 0:
        return None
    bound = 0.0
    for s in found:
        n, nr = s.counts.get("queries", 0), s.counts.get("keys", 0)
        c, r = m["embed_dims"][s.key], m["sr_ratios"][s.key]
        bound += max(attention_flops(n, nr, c, r) / F32_FLOP_PER_S,
                     attention_bytes(n, nr, c, r) / HBM_BYTES_PER_S)
    return 100.0 * bound / (ns / 1e9)
