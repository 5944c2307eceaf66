"""Device time a training step (forward, weighted loss, backward, Adam):
the operations launched inside the harness's span around each
``train_step`` call, over the traced steps. The batch's copy to the device
runs on the feed's side stream, launched from the loader's span, and is
not counted."""


def read(bundle):
    trace = bundle["trace"]
    n = len(trace.spans_named("step"))
    ns = trace.device_ns_launched_in("step")
    return ns / n / 1e6 if n and ns > 0 else None
