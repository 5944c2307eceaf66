"""The inputs' upload rate: the bytes counted on the program's span
``entry.upload`` (the bytes handed in from host memory) over its host time,
summed over the traced requests."""

from portbench import program


def read(bundle):
    found = program.spans(bundle["trace"], "entry.upload")
    if not found:
        return None
    moved, ns = sum(s.counts.get("bytes", 0) for s in found), program.host_ns(found)
    return moved / ns if moved and ns else None  # bytes a ns are GB/s
