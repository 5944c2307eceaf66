"""The paper's claim shape on synthetic data: the learned HyperSTARCOP
model (mag1c + RGB U-Net) beats the classical matched-filter baseline on
F1 / FPR (counterpart of the JAX package's
``examples/paper_reproduction_synthetic.py``, same seeds and settings).

Stages: chips with the real matched filter (``mag1c_column_blocks``, step
64, 30 iterations, on the device's kernels), HyperSTARCOP training
(``unet_semseg``, pos_weight 1), then ``run_validation`` of the model and
of ``Mag1cBaseline`` on the same test chips.

    python -m starcop_tpu_torch.experiments.paper_reproduction [OUT] [--n-train 20]
        [--n-test 8] [--epochs 15] [--device cpu]

writes OUT/summary.json (``model``, ``baseline``, ``f1_gain_pct``),
OUT/val_model/ and OUT/val_baseline/ (results.csv, results_agg.json) and
the chips under OUT/train and OUT/test.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import Dict, Optional, Tuple

import numpy as np

from starcop_tpu_torch.device import DeviceLike

PRODUCTS = ["mag1c", "TOA_AVIRIS_640nm", "TOA_AVIRIS_550nm", "TOA_AVIRIS_460nm"]
SUMMARY_KEYS = ("f1score", "precision", "recall", "FPR_no_plume", "classification_f1score")


def write_chips(out_dir: str, n_train: int, n_test: int, size: int = 256,
                device: DeviceLike = None) -> Tuple[str, str]:
    """The train chips from ``default_rng(0)`` and the test chips from
    ``default_rng(1)``, mag1c by the matched filter on ``device``, up to
    three confounders a chip. Returns the two index paths."""
    from starcop_tpu_torch.data.synthetic import write_synthetic_chip_dataset

    return tuple(
        write_synthetic_chip_dataset(os.path.join(out_dir, split), np.random.default_rng(seed),
                                     n_tiles=n, size=size, run_matched_filter=True,
                                     max_confounders=3, device=device)
        for split, seed, n in (("train", 0, n_train), ("test", 1, n_test)))


def validate_baseline(dm, out_dir: Optional[str], device: DeviceLike = None) -> Dict:
    """``Mag1cBaseline`` (mag1c > 500, opened) through ``run_validation`` on
    the test chips; writes ``out_dir`` where given. Returns the aggregate
    metrics."""
    from starcop_tpu_torch.models.baselines import Mag1cBaseline

    baseline = Mag1cBaseline(PRODUCTS)
    return _validate(baseline, dm, out_dir, device, apply_threshold=baseline.apply_threshold)


def _validate(model, dm, out_dir, device, apply_threshold=None) -> Dict:
    import torch

    from starcop_tpu_torch.data.datamodule import prefetch_to_device
    from starcop_tpu_torch.device import float32_precision, resolve_device
    from starcop_tpu_torch.eval.validation import run_validation

    dev = resolve_device(device)
    model.to(dev).eval()
    with torch.inference_mode(), float32_precision():
        _, metrics = run_validation(model.batch_with_preds,
                                    prefetch_to_device(iter(dm.test_loader()), device=dev),
                                    apply_threshold=apply_threshold, path_save_results=out_dir)
    return metrics


def make_datamodule(train_index: str, test_index: str):
    from starcop_tpu_torch.data.datamodule import DataModule

    return DataModule(train_index, test_index, input_products=PRODUCTS, batch_size=16,
                      num_workers=2)


def main(out_dir: Optional[str] = None, n_train: int = 12, n_test: int = 6, epochs: int = 12,
         device: DeviceLike = None, size: int = 256,
         timings: Optional[Dict[str, float]] = None) -> Dict:
    """Chips, training, both validations; returns (and writes) the summary.
    ``device`` None is the CUDA card (raises without one); ``size`` is the
    chips' side, 256 in the JAX script. ``timings``, where given, receives
    each stage's wall seconds (``chips_s``, ``train_s``, ``val_model_s``,
    ``val_baseline_s``)."""
    from starcop_tpu_torch.device import resolve_device
    from starcop_tpu_torch.models.segmenter import SegmentationModel
    from starcop_tpu_torch.train import Trainer

    dev = resolve_device(device)
    timings = {} if timings is None else timings
    out_dir = out_dir or tempfile.mkdtemp(prefix="starcop_paper")
    t0 = time.perf_counter()
    print("generating chips (real matched filter)...", flush=True)
    train_index, test_index = write_chips(out_dir, n_train, n_test, size, dev)
    timings["chips_s"] = time.perf_counter() - t0

    dm = make_datamodule(train_index, test_index)
    model = SegmentationModel(PRODUCTS, model_type="unet_semseg", pos_weight=1.0)
    trainer = Trainer(model, learning_rate=1e-3, max_epochs=epochs, val_check_interval=1.0,
                      device=dev)
    t0 = time.perf_counter()
    print("training HyperSTARCOP...", flush=True)
    trainer.fit(lambda: dm.train_loader(), lambda: dm.test_loader(batch_size=8), seed=0)
    timings["train_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    print("validating model...", flush=True)
    m_model = _validate(model, dm, os.path.join(out_dir, "val_model"), dev)
    timings["val_model_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    print("validating mag1c baseline...", flush=True)
    m_base = validate_baseline(dm, os.path.join(out_dir, "val_baseline"), dev)
    timings["val_baseline_s"] = time.perf_counter() - t0

    summary = {
        "model": {k: m_model[k] for k in SUMMARY_KEYS if k in m_model},
        "baseline": {k: m_base[k] for k in SUMMARY_KEYS if k in m_base},
    }
    if m_base.get("f1score"):
        summary["f1_gain_pct"] = 100 * (m_model["f1score"] - m_base["f1score"]) / m_base["f1score"]
    print(json.dumps(summary, indent=2))
    with open(os.path.join(out_dir, "summary.json"), "w") as fh:
        json.dump(summary, fh, indent=2)
    return summary


def cli(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("out_dir", nargs="?", default=None)
    p.add_argument("--n-train", type=int, default=12)
    p.add_argument("--n-test", type=int, default=6)
    p.add_argument("--epochs", type=int, default=12)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)
    main(args.out_dir, args.n_train, args.n_test, args.epochs, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(cli())
