"""Device time a granule of the SwinV2-B + UperNet forward: the operations
launched inside the harness's span ``model`` around the ``model_apply``
callable it hands to ``emit_granule_to_mask``, over the traced requests."""


def read(bundle):
    trace = bundle["trace"]
    n = len(trace.spans_named("model"))
    ns = trace.device_ns_launched_in("model")
    return ns / n / 1e6 if n and ns > 0 else None
