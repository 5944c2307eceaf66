"""Host time a request of the filter's Woodbury base: the program's spans
``mag1c.base`` (``ops.mag1c_kernels.woodbury_base``, once a filter) summed
over the traced requests (spans ``entry.filter``). Host time on purpose:
the base's launches block nothing but the host, and it reads the same
whether its work is one kernel or hundreds of eager operations. None where
the program has no such span."""

from portbench import program


def read(bundle):
    found = program.spans(bundle["trace"], "mag1c.base")
    requests = program.spans(bundle["trace"], "entry.filter")
    if not found or not requests:
        return None
    return program.host_ns(found) / len(requests) / 1e6
