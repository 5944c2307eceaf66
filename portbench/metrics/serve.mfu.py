"""The served granules' share of the H100's peaks: the filter's least
operations (``counts.filter_flops``) at 67 TFLOP/s f32 and the U-Net
forward's convolutions (``counts.unet_forward_flops`` at the padded granule)
at 989 TFLOP/s for the bf16-resident weights, over the traced window's time
a served granule."""

from portbench.counts import BF16_FLOP_PER_S, F32_FLOP_PER_S, filter_flops, unet_forward_flops
from portbench.reference.granule import find_padding


def read(bundle):
    result, ctx = bundle["result"], bundle["ctx"]
    if not result["served"]:
        return None
    g, f = ctx.config["granule"], ctx.config["filter"]
    h = g["lines"] + sum(find_padding(g["lines"]))
    w = g["samples"] + sum(find_padding(g["samples"]))
    unet_rate = BF16_FLOP_PER_S if ctx.traffic["model_dtype"] == "bfloat16" else F32_FLOP_PER_S
    need = sum(filter_flops(v, g["bands"], f["num_iter"]) / F32_FLOP_PER_S
               + unet_forward_flops(h, w) / unet_rate for v in result["valid_pixels"])
    return 100.0 * need / result["seconds"]
