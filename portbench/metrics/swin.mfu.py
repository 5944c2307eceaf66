"""The whole request's share of the H100's f32 peak (TF32 is off) in the
SwinV2 cell: the filter's least operations (``counts.filter_flops``) and the
SwinV2-B + UperNet forward's linear layers, convolutions and attention
products (``counts_swin.swin_forward_flops`` at the padded granule), both at
67 TFLOP/s, over the traced run's mean request time on the host clock."""

from portbench.counts import F32_FLOP_PER_S, filter_flops
from portbench.counts_swin import swin_forward_flops
from portbench.reference.granule import find_padding


def read(bundle):
    result, ctx = bundle["result"], bundle["ctx"]
    lat = result["latencies"]
    if not lat:
        return None
    g, f = ctx.config["granule"], ctx.config["filter"]
    h = g["lines"] + sum(find_padding(g["lines"]))
    w = g["samples"] + sum(find_padding(g["samples"]))
    model = swin_forward_flops(h, w, ctx.config["model"])
    work = sum(filter_flops(v, g["bands"], f["num_iter"]) + model for v in result["valid_pixels"])
    return 100.0 * work / F32_FLOP_PER_S / sum(lat)
