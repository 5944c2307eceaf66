"""The training steps' share of the H100's f32 peak (TF32 is off): three
U-Net forward passes' convolutions a 128^2 tile (forward, and the backward
pass's two products), times the tiles of the traced window's steps, over the
window at 67 TFLOP/s."""

from portbench.counts import F32_FLOP_PER_S, unet_forward_flops


def read(bundle):
    result, ctx = bundle["result"], bundle["ctx"]
    if not result["steps"]:
        return None
    size = ctx.config["training"]["training_size"]
    work = 3 * unet_forward_flops(size, size) * result["steps"] * result["batch_size"]
    return 100.0 * work / F32_FLOP_PER_S / result["elapsed_s"]
