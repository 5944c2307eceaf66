"""Host time a served granule that the compute worker waits on the reader:
the program's span ``serve.get_wait`` around the read queue's ``get``,
summed over the traced window, over the granules that reached the writer
stage (span ``serve.write``). High when the reader sets the pace."""

from portbench import program


def read(bundle):
    trace = bundle["trace"]
    found, written = program.spans(trace, "serve.get_wait"), program.spans(trace, "serve.write")
    return program.host_ns(found) / len(written) / 1e6 if found and written else None
