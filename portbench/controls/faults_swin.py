"""Faults of the SwinV2 cell, planted in the program's timed path as
``controls/faults.py``'s are, each in the second (shifted) block of stage 3
(``features.5.1``) or in the head, and the cell's readings under them:

    mask_off         the shift mask left out (tokens of different regions
                     attend to each other)
    bias_off         the continuous relative-position bias left out
    plain_attention  q k^T / sqrt(d) in place of the cosine attention
    ppm_off          PPM's pooled branches left out (zeros in their place)

    python3 portbench/controls/faults_swin.py --workload CELL \\
        --fault mask_off --seeds 1 2 3 [--out FILE]

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


def _marked(fault: str):
    """Patches that mark the fault's block (``features.5.1``'s attention) on
    every network built while planted; returns the restores."""
    from starcop_tpu_torch.models import swin

    real_init = swin.SwinV2UperNet.__init__

    def init(self, *args, **kwargs):
        real_init(self, *args, **kwargs)
        self.features[5][1].attn.planted = fault

    return [faults._patch(swin.SwinV2UperNet, "__init__", init)]


def _mask_off():
    from starcop_tpu_torch.models import swin

    real = swin.WindowAttentionV2.forward

    def forward(self, x, shift, mask):
        return real(self, x, shift, None if getattr(self, "planted", None) else mask)

    return _marked("mask_off") + [faults._patch(swin.WindowAttentionV2, "forward", forward)]


def _bias_off():
    import torch

    from starcop_tpu_torch.models import swin

    real = swin.WindowAttentionV2.position_bias

    def position_bias(self):
        bias = real(self)
        return torch.zeros_like(bias) if getattr(self, "planted", None) else bias

    return _marked("bias_off") + [faults._patch(swin.WindowAttentionV2, "position_bias",
                                                position_bias)]


def _plain_attention():
    from starcop_tpu_torch.models import swin

    real = swin.WindowAttentionV2.scaled

    def scaled(self, q, k):
        if getattr(self, "planted", None):
            return q * q.shape[-1] ** -0.5, k
        return real(self, q, k)

    return _marked("plain_attention") + [faults._patch(swin.WindowAttentionV2, "scaled", scaled)]


def _ppm_off():
    import torch

    from starcop_tpu_torch.models import swin

    def psp_forward(self, x):
        zeros = x.new_zeros((x.shape[0], self.bottleneck.conv.in_channels - x.shape[1])
                            + x.shape[2:])
        return self.bottleneck(torch.cat([x, zeros], 1))

    return [faults._patch(swin.UPerHead, "psp_forward", psp_forward)]


FAULTS = {"mask_off": _mask_off, "bias_off": _bias_off, "plain_attention": _plain_attention,
          "ppm_off": _ppm_off}


@contextlib.contextmanager
def planted(name: str):
    if name not in FAULTS:
        with faults.planted(name):
            yield
        return
    restores = FAULTS[name]()
    try:
        yield
    finally:
        for restore in reversed(restores):
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
