"""The compute stage's time a granule (wire decode, filter, U-Net, the f16
download, which blocks): ``SceneResult.timings["compute_s"]``, the program's
own host clock, mean over the granules served in the traced window."""


def read(bundle):
    vals = bundle["result"]["compute_s"]
    return 1e3 * sum(vals) / len(vals) if vals else None
