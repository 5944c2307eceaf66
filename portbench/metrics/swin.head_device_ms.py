"""Device time a forward of the UperNet head: the kernels launched inside
the program's spans ``upernet.head`` (PPM, the laterals and the top-down
path, the FPN convolutions, the fuse, the prediction and the resize to the
input; copies and sets left out), one span a forward."""

from portbench import program


def read(bundle):
    trace = bundle["trace"]
    found = program.spans(trace, "upernet.head")
    if not found:
        return None
    ns = program.device_ns_launched_in(trace, found, kernels_only=True)
    return ns / len(found) / 1e6 if ns > 0 else None
