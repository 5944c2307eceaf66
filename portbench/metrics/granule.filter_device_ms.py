"""Device time a request of the masked filter: the kernels launched inside
the program's span ``entry.filter`` (``mag1c_column_blocks``), copies and
sets left out, over the traced requests."""

from portbench import program


def read(bundle):
    trace = bundle["trace"]
    found = program.spans(trace, "entry.filter")
    if not found:
        return None
    ns = program.device_ns_launched_in(trace, found, kernels_only=True)
    return ns / len(found) / 1e6 if ns > 0 else None
