"""Device time a batch of the evaluation: the operations launched inside the
harness's span around each ``batch_with_preds`` call (normalisation, the
bf16 forward, sigmoid, thresholds, per-pixel losses) and inside the rest of
``run_validation``'s pass (the sweep's reductions), over the traced batches.
The chips' copies to the device run on the feed's side stream and count as
copies, not as the batch's kernels."""


def read(bundle):
    trace, result = bundle["trace"], bundle["result"]
    ns = trace.device_ns_launched_in("pass", kernels_only=True)
    return ns / result["batches"] / 1e6 if result["batches"] and ns > 0 else None
