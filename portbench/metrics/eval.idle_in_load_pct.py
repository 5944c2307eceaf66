"""Share of the traced window's kernel-idle time (``TraceView.idle_gaps``)
that falls inside the program's ``data.load`` spans: how much of the idle
device waits on the chip loader."""

from portbench import program


def read(bundle):
    trace = bundle["trace"]
    found = program.spans(trace, "data.load")
    idle = program.idle_ns(trace)
    if not found or idle <= 0:
        return None
    return 100.0 * program.idle_ns_in(trace, found) / idle
