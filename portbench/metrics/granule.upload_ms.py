"""Host time a request of the inputs' move to the device: the program's span
``entry.upload`` in ``emit_granule_to_mask`` (the pageable copies of the
cube and the RGB planes), mean over the traced requests."""

from portbench import program


def read(bundle):
    found = program.spans(bundle["trace"], "entry.upload")
    return program.host_ns(found) / len(found) / 1e6 if found else None
