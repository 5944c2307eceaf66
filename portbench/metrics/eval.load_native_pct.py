"""Share of the evaluated chips that the chip loader read natively: 100 x
the summed counter ``native_chips`` over the summed counter ``chips`` of
the traced ``data.load`` spans (``ChipDataset.read_batch``: chips all of
whose products went through the threaded native reader). None where the
program's spans carry no such counters."""

from portbench import program


def read(bundle):
    found = program.spans(bundle["trace"], "data.load")
    if not found or not any("native_chips" in s.counts for s in found):
        return None
    chips = sum(s.counts.get("chips", 0) for s in found)
    return 100.0 * sum(s.counts.get("native_chips", 0) for s in found) / chips if chips else None
