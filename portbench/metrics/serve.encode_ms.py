"""Host time a served granule of the wire encode: the program's span
``serve.encode`` (``encode_payload``: the fill scan, the ranges and packs),
summed over the traced window, over the granules that reached the writer
stage (span ``serve.write``)."""

from portbench import program


def read(bundle):
    trace = bundle["trace"]
    found, written = program.spans(trace, "serve.encode"), program.spans(trace, "serve.write")
    return program.host_ns(found) / len(written) / 1e6 if found and written else None
