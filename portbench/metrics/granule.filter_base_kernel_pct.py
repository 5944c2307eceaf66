"""Share of the filter's Woodbury bases that ran as the CUDA kernel: 100 x
the summed counter ``kernel`` (1 for ``woodbury_base``'s launch, 0 for its
plain twin) over the number of traced ``mag1c.base`` spans. None where the
program's spans carry no such counter."""

from portbench import program


def read(bundle):
    found = program.spans(bundle["trace"], "mag1c.base")
    if not found or not any("kernel" in s.counts for s in found):
        return None
    return 100.0 * sum(s.counts.get("kernel", 0) for s in found) / len(found)
