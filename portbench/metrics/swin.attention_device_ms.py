"""Device time a forward of SwinV2's window attention: the kernels launched
inside the program's spans ``swin.attention`` (pad, shift, partition, qkv,
the position bias and the mask, the attention, the projection and the way
back; copies and sets left out), over the traced forwards (the program's
``upernet.head`` spans, one a forward)."""

from portbench import program


def read(bundle):
    trace = bundle["trace"]
    found = program.spans(trace, "swin.attention")
    forwards = program.spans(trace, "upernet.head")
    if not found or not forwards:
        return None
    ns = program.device_ns_launched_in(trace, found, kernels_only=True)
    return ns / len(forwards) / 1e6 if ns > 0 else None
