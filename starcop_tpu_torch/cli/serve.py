"""Batch serving CLI: process a directory of EMIT granules on the CUDA card.

    python -m starcop_tpu_torch.cli.serve --granules-dir /data/emit \
        --checkpoint model.npz --output /data/out [--watch 30]

The counterpart of starcop_tpu/cli/serve.py, with its flags and defaults:
the three-stage pipelined runtime (host read | device compute | host write),
a bf16-resident U-Net unless ``--model-dtype f32``, and the bf16 matched-
filter stream with ``--bf16-stream``. ``--devices N`` serves scenes across
cuda:0..N-1. ``--device cpu`` runs the plain torch path on the CPU instead
of the card. ``--watch N`` polls the directory every N seconds.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--granules-dir", required=True)
    p.add_argument("--pattern", default="*.nc")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--column-step", type=int, default=32)
    p.add_argument("--num-iter", type=int, default=30)
    p.add_argument("--georeference", action="store_true")
    p.add_argument("--watch", type=int, default=0, help="poll interval seconds (0 = one pass)")
    p.add_argument("--bf16-stream", action="store_true",
                   help="bf16 matched-filter stream: half the bytes per filter pass, held to "
                        "the bf16 detection contract of tests/test_mag1c.py")
    p.add_argument("--upload", choices=("f32", "u12", "u10", "u16", "bf16"), default="f32",
                   help="radiance upload codec (see serve.pipeline.encode_payload): u12 = "
                        "per-band affine 12-bit, 2 values per 3 bytes (37.5%% of f32), u10 = "
                        "10-bit pixel quads (31.25%%), u16 = per-band affine 16-bit, bf16 = "
                        "plain rounding (both 50%%)")
    p.add_argument("--download", choices=("f16", "f32"), default="f16",
                   help="result download: f16 (default) ships (prediction, mag1c) as one "
                        "stacked half-precision transfer (<= 2^-11 relative error, NODATA "
                        "exact), f32 = the results as computed")
    p.add_argument("--model-dtype", choices=("bf16", "f32"), default="bf16",
                   help="bf16 = bf16-resident U-Net weights (cast once at load; logits f32)")
    p.add_argument("--devices", type=int, default=1,
                   help="serve scenes across N cards (cuda:0..N-1), one compute worker each")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cpu = the plain torch path on the host (no card needed)")
    p.add_argument("--compress-outputs", type=int, default=0, metavar="LEVEL",
                   choices=range(0, 10),
                   help="DEFLATE level (1-9) for the output GeoTIFFs; default 0 = uncompressed")
    args = p.parse_args(argv)

    import torch

    from starcop_tpu_torch.models.segmenter import (
        EMIT_INPUT_PRODUCTS,
        SegmentationModel,
        cast_for_inference,
    )
    from starcop_tpu_torch.models.weights import load_pretrained_state_dict
    from starcop_tpu_torch.serve.pipeline import emit_serving_pipeline

    model = SegmentationModel(EMIT_INPUT_PRODUCTS)
    model.network.load_state_dict(load_pretrained_state_dict(args.checkpoint), strict=True)
    if args.model_dtype == "bf16":
        cast_for_inference(model)
    model.eval()

    if args.device == "cpu":
        devices = [torch.device("cpu")] * args.devices
    elif args.devices > 1:
        devices = [torch.device(f"cuda:{i}") for i in range(args.devices)]
    else:
        devices = None
    pipeline = emit_serving_pipeline(
        model,
        args.output,
        column_step=args.column_step,
        num_iter=args.num_iter,
        georeference=args.georeference,
        stream_dtype=torch.bfloat16 if args.bf16_stream else None,
        devices=devices,
        upload_dtype=args.upload,
        download_dtype=args.download,
        compress_outputs=args.compress_outputs,
    )

    processed = set()

    def pending():
        files = sorted(glob.glob(os.path.join(args.granules_dir, args.pattern)))
        return [f for f in files if f not in processed]

    while True:
        batch = pending()
        if batch:
            for r in pipeline.run(batch):
                status = "ERROR " + r.error if r.error else (
                    f"ok read {r.timings.get('read_s', 0):.2f}s "
                    f"compute {r.timings.get('compute_s', 0):.2f}s "
                    f"write {r.timings.get('write_s', 0):.2f}s"
                )
                print(f"{os.path.basename(r.name)}: {status}")
            processed.update(batch)
        if not args.watch:
            return 0
        time.sleep(args.watch)


if __name__ == "__main__":
    sys.exit(main())
