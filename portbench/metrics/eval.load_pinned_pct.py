"""Share of the evaluated chips that the chip loader read straight into the
prefetcher's reused pinned buffers: 100 x the summed counter
``pinned_chips`` over the summed counter ``chips`` of the traced
``data.load`` spans (``ChipDataset.read_batch``: natively read chips of a
batch whose arrays are the buffers ``prefetch_to_device`` hands the loader).
None where the program's spans carry no such counter."""

from portbench import program


def read(bundle):
    found = program.spans(bundle["trace"], "data.load")
    if not found or not any("pinned_chips" in s.counts for s in found):
        return None
    chips = sum(s.counts.get("chips", 0) for s in found)
    return 100.0 * sum(s.counts.get("pinned_chips", 0) for s in found) / chips if chips else None
