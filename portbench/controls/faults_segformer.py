"""Faults of the SegFormer cell, planted in the program's timed path as
``controls/faults.py``'s are, and the cell's readings under them:

    attention_off  the attention branch of the first stage-3 block taken
                   out (the block adds nothing for it)

    python3 portbench/controls/faults_segformer.py --workload CELL \\
        --fault attention_off --seeds 1 2 3 [--out FILE]

``planted`` takes these and every fault of ``controls/faults.py``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from portbench.controls import faults  # noqa: E402


def _attention_off():
    import torch

    from starcop_tpu_torch.models import segformer

    real_init, real_forward = segformer.SegFormer.__init__, segformer.Attention.forward

    def init(self, *args, **kwargs):
        real_init(self, *args, **kwargs)
        self.backbone.block3[0].attn.planted_off = True

    def forward(self, x, h, w):
        if getattr(self, "planted_off", False):
            return torch.zeros_like(x)
        return real_forward(self, x, h, w)

    restores = [faults._patch(segformer.SegFormer, "__init__", init),
                faults._patch(segformer.Attention, "forward", forward)]
    return lambda: [r() for r in restores]


FAULTS = {"attention_off": _attention_off}


@contextlib.contextmanager
def planted(name: str):
    if name not in FAULTS:
        with faults.planted(name):
            yield
        return
    restore = FAULTS[name]()
    try:
        yield
    finally:
        restore()


def main(argv=None):
    from portbench.controls.readings import take_readings

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--fault", required=True, choices=sorted(FAULTS) + sorted(faults.FAULTS))
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    with planted(args.fault):
        rows = take_readings(args.workload, [("program", s) for s in args.seeds])
    for row in rows:
        row["kind"] = f"fault:{args.fault}"
    names = [k for k in rows[0] if k not in ("kind", "seed", "seconds")]
    summary = {n: {"min": min(r[n] for r in rows), "max": max(r[n] for r in rows)} for n in names}
    print("summary " + json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"rows": rows, "summary": summary}, fh, indent=1)


if __name__ == "__main__":
    main()
