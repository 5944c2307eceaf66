"""Host time a batch of the per-tile rows: the program's span
``validation.rows`` in ``run_validation`` (the rows and sums on the host
after the batch's one copy), mean over the traced batches."""

from portbench import program


def read(bundle):
    found = program.spans(bundle["trace"], "validation.rows")
    return program.host_ns(found) / len(found) / 1e6 if found else None
