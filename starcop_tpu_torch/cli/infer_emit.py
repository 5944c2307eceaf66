"""Zero-shot EMIT inference CLI: a raw granule -> plume probability mask and
mag1c GeoTIFFs, on the CUDA card.

    python -m starcop_tpu_torch.cli.infer_emit EMIT_L1B_RAD_xxx.nc \
        --checkpoint model.ckpt --output out_dir [--georeference] [--device cpu]

The counterpart of starcop_tpu/cli/infer_emit.py, with its flags: the
masked matched filter, the EMIT->AVIRIS renormalisation and the
whole-scene U-Net (bf16-resident unless ``--model-dtype f32``;
``--model-type`` names another network of ``models.segmenter.ARCHITECTURES``,
e.g. ``segformer_b5``).
``--device cpu`` runs on the host instead of the card. Prints the
granule's wall time (a ``StageTimer`` stage, the device synchronised at its
edges) and its mean prediction.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def main(argv=None) -> int:
    from starcop_tpu_torch.models.segmenter import ARCHITECTURES

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("granule", help="EMIT L1B radiance .nc file")
    p.add_argument("--checkpoint", required=True,
                   help=".ckpt / .pt (Lightning, torch) or .npz weights, or a folder holding one")
    p.add_argument("--output", required=True, help="output directory")
    p.add_argument("--column-step", type=int, default=32)
    p.add_argument("--num-iter", type=int, default=30)
    p.add_argument("--georeference", action="store_true")
    p.add_argument("--model-dtype", choices=("bf16", "f32"), default="bf16",
                   help="bf16 = bf16-resident U-Net weights (cast once at load; logits f32)")
    p.add_argument("--model-type", choices=sorted(ARCHITECTURES), default="unet_semseg",
                   help="the checkpoint's network (models.segmenter.ARCHITECTURES)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cpu = the plain torch path on the host (no card needed)")
    args = p.parse_args(argv)

    from starcop_tpu_torch.data.emit import EMITRawScene
    from starcop_tpu_torch.data.geotiff import write_geotiff
    from starcop_tpu_torch.device import resolve_device
    from starcop_tpu_torch.models.segmenter import (
        EMIT_INPUT_PRODUCTS,
        SegmentationModel,
        cast_for_inference,
    )
    from starcop_tpu_torch.models.weights import load_pretrained_state_dict
    from starcop_tpu_torch.scenes.emit_pipeline import emit_inference
    from starcop_tpu_torch.utils.profiling import StageTimer

    dev = resolve_device(args.device)
    model = SegmentationModel(EMIT_INPUT_PRODUCTS, model_type=args.model_type)
    model.network.load_state_dict(load_pretrained_state_dict(args.checkpoint), strict=True)
    if args.model_dtype == "bf16":
        cast_for_inference(model)
    model.to(dev).eval()

    timer = StageTimer(device=dev)
    with timer.stage("total"):
        scene = EMITRawScene(args.granule)
        try:
            transform, crs_epsg = scene.transform, scene.crs_epsg
            out = emit_inference(scene, model, column_step=args.column_step,
                                 num_iter=args.num_iter, georeference=args.georeference,
                                 device=dev)
        finally:
            scene.close()

    os.makedirs(args.output, exist_ok=True)
    for name, arr in out.items():
        # The granule transform describes the GLT-mapped (ortho) grid; only
        # the georeferenced products carry it.
        on_ortho_grid = name.endswith("_geo")
        write_geotiff(
            os.path.join(args.output, f"{name}.tif"),
            np.asarray(arr, np.float32),
            transform=transform if on_ortho_grid else None,
            crs_epsg=crs_epsg if on_ortho_grid else None,
            descriptions=["CH4 Absorption (ppm x m)" if "mag1c" in name else name],
        )
    times = timer.report(log=False)
    print(f"EMIT inference {os.path.basename(args.granule)}: {times['total']:.2f}s; "
          f"pred mean {float(out['prediction'].mean()):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
