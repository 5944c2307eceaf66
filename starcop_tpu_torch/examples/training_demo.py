"""Training demo (reference notebooks/(bonus)_training_demo.ipynb): a
short end-to-end training run on a small synthetic dataset through
``starcop_tpu_torch.cli.train``.

    python -m starcop_tpu_torch.examples.training_demo [epochs] [--device cpu]
"""

import argparse
import sys
import tempfile

import numpy as np


def main(epochs: int = 2, device: str = "gpu"):
    """``device`` is the train CLI's ``training.accelerator`` (gpu or cpu)."""
    from starcop_tpu_torch.cli.train import main as train_main
    from starcop_tpu_torch.data.synthetic import write_synthetic_chip_dataset

    root = tempfile.mkdtemp(prefix="starcop_train_demo")
    write_synthetic_chip_dataset(root, np.random.default_rng(0), n_tiles=6, size=256)
    return train_main(
        [
            f"dataset.root_folder={root}",
            "dataset.train_csv=index.csv",
            "dataset.test_csv=index.csv",
            "experiment_name=training_demo",
            f"training.max_epochs={epochs}",
            "dataloader.batch_size=8",
            "dataloader.num_workers=2",
            "model.lr=0.001",
            "training.val_check_interval=1.0",
            f"training.accelerator={device}",
        ]
    )


if __name__ == "__main__":
    p = argparse.ArgumentParser(description="a short training run on synthetic chips")
    p.add_argument("epochs", nargs="?", type=int, default=2)
    p.add_argument("--device", choices=("gpu", "cpu"), default="gpu")
    args = p.parse_args()
    sys.exit(main(args.epochs, args.device))
