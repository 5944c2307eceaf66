"""Zero-shot raw-EMIT inference (reference inference_on_raw_EMIT_nc_file.ipynb).

    python -m starcop_tpu_torch.examples.emit_zero_shot EMIT_L1B_RAD_xxx.nc checkpoint.ckpt out/
        [--device cpu]

Pipeline: raw granule -> band select (2122-2488 nm) -> CH4 template ->
column-blocked matched filter (the CUDA kernels on the card) -> EMIT->AVIRIS
renormalisation -> reflect-padded whole-scene U-Net forward -> GLT
georeference. Equivalent CLI: ``python -m starcop_tpu_torch.cli.infer_emit``;
arguments after the three positional ones go to it unchanged.
"""

import sys

from starcop_tpu_torch.cli import infer_emit


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if len(argv) < 3:
        print(__doc__, file=sys.stderr)
        return 2
    granule, checkpoint, out = argv[:3]
    return infer_emit.main([granule, "--checkpoint", checkpoint, "--output", out,
                            "--georeference", *argv[3:]])


if __name__ == "__main__":
    sys.exit(main())
