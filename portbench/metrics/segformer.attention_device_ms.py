"""Device time a granule of SegFormer's efficient attention: the kernels
launched inside the program's spans ``segformer.attention`` (Q, the
reduction, K and V, the attention, the projection; copies and sets left
out), over the traced forwards (the program's ``segformer.decode`` spans,
one a forward)."""

from portbench import program


def read(bundle):
    trace = bundle["trace"]
    found = program.spans(trace, "segformer.attention")
    forwards = program.spans(trace, "segformer.decode")
    if not found or not forwards:
        return None
    ns = program.device_ns_launched_in(trace, found, kernels_only=True)
    return ns / len(forwards) / 1e6 if ns > 0 else None
