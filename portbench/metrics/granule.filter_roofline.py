"""The filter's share of its roofline in the granule cell: the least time
the algorithm's work needs on one H100 (``counts.filter_bound_s`` at each
traced request's valid pixels), summed over the traced requests, over the
device time of the kernels those requests launched outside the U-Net span
(copies left out). Kernels outside the filter that the entry point launches
(renormalisation, padding, sigmoid, crop) count as the filter's time, so the
share errs low, never high."""

from portbench.counts import filter_bound_s


def read(bundle):
    trace, result, ctx = bundle["trace"], bundle["result"], bundle["ctx"]
    n = len(trace.spans_named("request"))
    if n == 0:
        return None
    device_ns = (trace.device_ns_launched_in("request", kernels_only=True)
                 - trace.device_ns_launched_in("unet", kernels_only=True))
    if device_ns <= 0:
        return None
    g, f = ctx.config["granule"], ctx.config["filter"]
    bound = sum(filter_bound_s(v, g["lines"], g["samples"], g["bands"], f["num_iter"])
                for v in result["valid_pixels"][:n])
    return 100.0 * bound / (device_ns / 1e9)
