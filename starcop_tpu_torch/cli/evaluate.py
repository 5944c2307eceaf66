"""Evaluation CLI: checkpoint (or a classical baseline) + index CSV ->
validation artifacts, on the CUDA card.

    python -m starcop_tpu_torch.cli.evaluate --test-csv /data/chips/test.csv \
        --output out/ (--checkpoint exp/best.npz | --baseline mag1c|varon|sanchez) \
        [--model-dtype bf16|f32] [--device cpu]

The counterpart of starcop_tpu/cli/evaluate.py, with its flags: the whole
validation harness (threshold sweep, difficulty split, results.csv and
results_agg.json), batches fed through pinned buffers and a side stream.
``--device cpu`` runs on the host instead of the card. Prints one JSON line
of the headline metrics.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--test-csv", required=True)
    p.add_argument("--checkpoint", default=None,
                   help=".npz / .ckpt / .pt weights, or a folder holding one (omit for baselines)")
    p.add_argument("--baseline", default=None, choices=["mag1c", "varon", "sanchez"])
    p.add_argument("--input-products", nargs="+", default=[
        "mag1c", "TOA_AVIRIS_640nm", "TOA_AVIRIS_550nm", "TOA_AVIRIS_460nm"])
    p.add_argument("--model-type", default="unet_semseg")
    p.add_argument("--pos-weight", type=float, default=1.0)
    p.add_argument("--output", required=True)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--model-dtype", choices=("bf16", "f32"), default="bf16",
                   help="bf16 = bf16-resident U-Net weights (cast once at load; logits f32)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cpu = the plain torch path on the host (no card needed)")
    args = p.parse_args(argv)

    import torch

    from starcop_tpu_torch.data.datamodule import BatchLoader, prefetch_to_device
    from starcop_tpu_torch.data.dataset import ChipDataset, read_index_csv
    from starcop_tpu_torch.device import float32_precision, resolve_device
    from starcop_tpu_torch.eval.validation import run_validation

    dev = resolve_device(args.device)
    rows = read_index_csv(args.test_csv)
    ds = ChipDataset(rows, args.input_products, ["labelbinary"], "weight_mag1c")
    loader = BatchLoader(ds, batch_size=args.batch_size)

    apply_threshold = None
    if args.baseline:
        from starcop_tpu_torch.models.baselines import (
            Mag1cBaseline,
            SanchezBaseline,
            VaronBaseline,
        )

        model = {"mag1c": Mag1cBaseline, "varon": VaronBaseline,
                 "sanchez": SanchezBaseline}[args.baseline](args.input_products)
        apply_threshold = model.apply_threshold
    else:
        if not args.checkpoint:
            p.error("Provide --checkpoint or --baseline")
        from starcop_tpu_torch.models.segmenter import SegmentationModel, cast_for_inference
        from starcop_tpu_torch.models.weights import load_pretrained_state_dict

        model = SegmentationModel(args.input_products, model_type=args.model_type,
                                  pos_weight=args.pos_weight)
        model.network.load_state_dict(load_pretrained_state_dict(args.checkpoint), strict=True)
        if args.model_dtype == "bf16":
            cast_for_inference(model)
    model.to(dev).eval()

    with torch.inference_mode(), float32_precision():
        _, metrics = run_validation(
            model.batch_with_preds,
            prefetch_to_device(iter(loader), device=dev),
            apply_threshold=apply_threshold,
            path_save_results=args.output,
        )
    print(json.dumps({k: metrics[k] for k in ("f1score", "precision", "recall",
                                              "classification_f1score") if k in metrics}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
