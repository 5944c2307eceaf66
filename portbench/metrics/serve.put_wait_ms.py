"""Host time a served granule that the reader waits on the compute worker:
the program's span ``serve.put_wait`` around the read queue's ``put``,
summed over the traced window, over the granules that reached the writer
stage (span ``serve.write``). High when the compute stage sets the pace."""

from portbench import program


def read(bundle):
    trace = bundle["trace"]
    found, written = program.spans(trace, "serve.put_wait"), program.spans(trace, "serve.write")
    return program.host_ns(found) / len(written) / 1e6 if found and written else None
