"""The evaluation's share of the H100's bf16 peak: the U-Net forward's
convolutions a 512^2 tile (``counts.unet_forward_flops``) times the tiles of
the traced window, over the window at 989 TFLOP/s (the bf16-resident
weights)."""

from portbench.counts import BF16_FLOP_PER_S, F32_FLOP_PER_S, unet_forward_flops


def read(bundle):
    result, ctx = bundle["result"], bundle["ctx"]
    if not result["tiles"]:
        return None
    size = ctx.config["chips"]["chip_size"]
    rate = BF16_FLOP_PER_S if ctx.traffic["model_dtype"] == "bfloat16" else F32_FLOP_PER_S
    return 100.0 * unet_forward_flops(size, size) * result["tiles"] / rate / result["elapsed_s"]
