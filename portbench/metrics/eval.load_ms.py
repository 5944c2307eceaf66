"""Host time a batch of the chip loader: the program's span ``data.load``
(``BatchLoader``: a batch's chip reads and stack), mean over the traced
batches."""

from portbench import program


def read(bundle):
    found = program.spans(bundle["trace"], "data.load")
    return program.host_ns(found) / len(found) / 1e6 if found else None
