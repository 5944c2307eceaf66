"""Model demo (reference notebooks/model_demos_AVIRIS.ipynb as a script).

Generates a synthetic chip dataset, loads or initialises the flagship
model, runs batch_with_preds over the test loader, renders the plot grid,
and runs the full validation harness. Swap the synthetic dataset for a
real chip index CSV and a checkpoint for the real workflow.

    python -m starcop_tpu_torch.examples.model_demo_synthetic [checkpoint] [--device cpu]
"""

import argparse
import os
import sys
import tempfile

import numpy as np

PRODUCTS = ["mag1c", "TOA_AVIRIS_640nm", "TOA_AVIRIS_550nm", "TOA_AVIRIS_460nm"]


def main(checkpoint: str = None, out_dir: str = None, device=None):
    import torch

    from starcop_tpu_torch.data.datamodule import DataModule, prefetch_to_device
    from starcop_tpu_torch.data.synthetic import write_synthetic_chip_dataset
    from starcop_tpu_torch.device import float32_precision, resolve_device
    from starcop_tpu_torch.eval.plot import plot_batch
    from starcop_tpu_torch.eval.validation import run_validation
    from starcop_tpu_torch.models import SegmentationModel

    dev = resolve_device(device)
    out_dir = out_dir or tempfile.mkdtemp(prefix="starcop_demo")
    data_dir = os.path.join(out_dir, "chips")
    index = write_synthetic_chip_dataset(data_dir, np.random.default_rng(0), n_tiles=4, size=256)

    dm = DataModule(index, index, input_products=PRODUCTS)
    model = SegmentationModel(PRODUCTS, model_type="unet_semseg", pos_weight=1.0)
    if checkpoint:
        from starcop_tpu_torch.setup_shims import load_pretrained_variables

        model.network.load_state_dict(load_pretrained_variables(checkpoint), strict=True)
    else:
        model.init(torch.Generator().manual_seed(0))
    model.to(dev).eval()

    with torch.inference_mode(), float32_precision():
        # Plot grid for one batch (reference plot_batch protocol).
        batch = model.batch_with_preds(next(iter(dm.test_loader(batch_size=2))))
        batch = {k: v.cpu().numpy() if torch.is_tensor(v) else v for k, v in batch.items()}
        fig = plot_batch(batch, PRODUCTS, ["rgb_aviris", "mag1c", "label", "pred", "differences"])
        fig.savefig(os.path.join(out_dir, "demo_grid.png"), dpi=80)

        rows, metrics = run_validation(
            model.batch_with_preds, prefetch_to_device(iter(dm.test_loader()), device=dev),
            path_save_results=os.path.join(out_dir, "validation"))
    print(f"tiles: {len(rows)}  F1: {metrics['f1score']:.4f}  "
          f"classification F1: {metrics['classification_f1score']:.4f}")
    print(f"artifacts in {out_dir}")
    return out_dir


if __name__ == "__main__":
    p = argparse.ArgumentParser(description="model demo on synthetic chips")
    p.add_argument("checkpoint", nargs="?", default=None)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args()
    main(checkpoint=args.checkpoint, device=args.device)
