"""Dataset exploration demo (reference ``dataset_exploration.ipynb`` as a
script): materialise a synthetic chip dataset with the real matched filter,
walk the index, print per-product statistics and the plume / negative
balance, and render a sample grid through the plot registry.

    python -m starcop_tpu_torch.examples.dataset_exploration [out_dir] [--device cpu]
"""

import argparse
import os
import tempfile

import numpy as np

PRODUCTS = ["mag1c", "TOA_AVIRIS_640nm", "TOA_AVIRIS_550nm", "TOA_AVIRIS_460nm"]


def main(out_dir=None, n_tiles=8, device=None, size=256):
    """``size`` is the chips' side (256 in the JAX example)."""
    from starcop_tpu_torch.data.datamodule import BatchLoader, tile_rows
    from starcop_tpu_torch.data.dataset import ChipDataset, read_index_csv
    from starcop_tpu_torch.data.synthetic import write_synthetic_chip_dataset
    from starcop_tpu_torch.device import resolve_device
    from starcop_tpu_torch.eval.plot import plot_batch

    dev = resolve_device(device)
    out_dir = out_dir or tempfile.mkdtemp(prefix="starcop_explore")
    chips = os.path.join(out_dir, "chips")
    print("materializing chips (real matched filter)...")
    write_synthetic_chip_dataset(chips, np.random.default_rng(0), n_tiles=n_tiles, size=size,
                                 run_matched_filter=True, max_confounders=2, device=dev)

    rows = read_index_csv(os.path.join(chips, "index.csv"))
    n_plume = sum(1 for r in rows if r.get("has_plume"))
    print(f"{len(rows)} chips: {n_plume} with plume, {len(rows) - n_plume} without")

    ds = ChipDataset(rows, PRODUCTS, weight_loss_product="weight_mag1c")
    for p_idx, product in enumerate(PRODUCTS):
        vals = np.stack([ds[i]["input"][p_idx] for i in range(len(ds))])
        print(f"  {product:22s} min {vals.min():8.2f} mean {vals.mean():8.2f} "
              f"max {vals.max():8.2f}")

    tiled = tile_rows(rows, training_size=128, overlap=64)
    frac = sum(1 for r in tiled if r.get("has_plume")) / max(len(tiled), 1)
    print(f"{len(tiled)} training tiles (128x128/64 overlap), plume fraction {frac:.2f}")

    batch = next(iter(BatchLoader(ds, batch_size=min(4, len(ds)))))
    batch["input_norm"] = batch["input"]
    batch["output_norm"] = batch["output"]
    fig = plot_batch(batch, PRODUCTS, ["rgb_aviris", "mag1c", "label", "weight_loss"])
    png = os.path.join(out_dir, "sample_grid.png")
    fig.savefig(png, dpi=110)
    print(f"wrote {png}")
    return out_dir


if __name__ == "__main__":
    p = argparse.ArgumentParser(description="dataset exploration on synthetic chips")
    p.add_argument("out_dir", nargs="?", default=None)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args()
    main(args.out_dir, device=args.device)
