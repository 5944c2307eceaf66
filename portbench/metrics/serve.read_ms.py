"""The reader stage's time a granule (wire encode and the upload's start):
``SceneResult.timings["read_s"]``, the program's own host clock, mean over
the granules served in the traced window."""


def read(bundle):
    vals = bundle["result"]["read_s"]
    return 1e3 * sum(vals) / len(vals) if vals else None
