"""Validation harness (counterpart of starcop_tpu/eval/validation.py): the
function whose outputs (results.csv, results_agg.json) carry the published
numbers.

  * per-tile confusion matrices and metric rows (TP / FP / TN / FN,
    label_pixels_plume, pred_classification, pred_pixels_plume);
  * the threshold sweep over [0, 1e-3, 1e-2, 0.5 .. 0.95 by 0.05, 0.99,
    0.995, 0.999], through the model's ``apply_threshold`` where it has one
    (the baselines sweep through their morphology);
  * the difficulty split (easy: > 1000 label pixels), FPR over the tiles
    with no plume, per-difficulty metrics;
  * aggregate and tile-classification metrics, and the PR-curve points.

Every count of a batch is made on the device of the batch, and the host
gets them in one copy per batch. Traced (``utils.profiling``), the batch's
rows on the host after that copy are span ``validation.rows``.
"""

from __future__ import annotations

import csv
import json
import os
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from starcop_tpu_torch.eval import metrics as sm
from starcop_tpu_torch.utils.profiling import span

DEFAULT_THRESHOLDS: List[float] = sorted(
    [0.0, 1e-3, 1e-2] + list(np.arange(0.5, 0.96, 0.05)) + [0.99, 0.995, 0.999],
    reverse=True,
)


def _batch_eval_stats(pred_binary: torch.Tensor, prediction: torch.Tensor, y: torch.Tensor,
                      valid: Optional[torch.Tensor], thresholds: Sequence[float],
                      apply_threshold: Optional[Callable] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """All counts of a (B, ...) batch on its device, int64:

      * the per-sample confusion matrices (B, 2, 2) at ``pred_binary``;
      * the threshold sweep's confusion matrices summed over the batch
        (T, 2, 2): ``prediction > thr`` (compared in the prediction's
        dtype, float32), or ``apply_threshold(prediction, thr)`` where
        given, one threshold at a time (no (B, T, N) tensor);
      * the label and pred positive-pixel counts (B,), not masked, as the
        reference rows count them.

    ``valid`` (bool, the batch's shape) restricts the matrices; None keeps
    every pixel.
    """
    b = pred_binary.shape[0]
    p = pred_binary.reshape(b, -1).to(torch.int32) == 1
    t = y.reshape(b, -1).to(torch.int32)
    t1, t0 = sm.label_flags(t, None if valid is None else valid.reshape(b, -1))
    n1, n0 = t1.sum(1), t0.sum(1)
    cms = sm.cm_from_flags(p, t1, t0, n1, n0, 1)

    pr = prediction.reshape(b, -1)
    n1_all, n0_all = n1.sum(), n0.sum()
    sweep = []
    for thr in thresholds:
        pb = (pr > thr) if apply_threshold is None else (
            apply_threshold(prediction, thr).reshape(b, -1).to(torch.int32) == 1)
        sweep.append(sm.cm_from_flags(pb, t1, t0, n1_all, n0_all))
    label_px = t.sum(1, dtype=torch.int64)
    pred_px = p.sum(1, dtype=torch.int64)
    return cms, torch.stack(sweep), label_px, pred_px


def run_validation(
    batch_with_preds: Callable[[Dict], Dict],
    batches,
    thresholds: Optional[List[float]] = None,
    apply_threshold: Optional[Callable] = None,
    path_save_results: Optional[str] = None,
    mask_from_magic: bool = False,
    plot_fn: Optional[Callable] = None,
) -> Tuple[List[Dict], Dict[str, Any]]:
    """Evaluate a model over an iterable of batch dicts.

    Args:
        batch_with_preds: enriches a batch with predictions (a
            ``SegmentationModel``'s or a baseline's ``batch_with_preds``).
        batches: iterable of batch dicts (any batch size; one row per tile).
        thresholds: the PR-sweep thresholds (default: the reference grid).
        apply_threshold: optional fn(prediction, thr) -> binary, called once
            per (B, ...) batch with per-sample semantics (the baselines'
            opening); default ``prediction > thr``.
        path_save_results: directory for results.csv and results_agg.json.
        mask_from_magic: count only valid pixels, ``batch["nodata_mask"] ==
            0`` (orthorectified EMIT scenes).
        plot_fn: optional fn(enriched_batch, sample_index, tile_id).

    Returns:
        (per-tile metric rows, aggregate metrics dict).
    """
    thresholds = sorted(thresholds or DEFAULT_THRESHOLDS, reverse=True)
    cm_total = np.zeros((2, 2), np.int64)
    cm_thresholds = {t: np.zeros((2, 2), np.int64) for t in thresholds}
    out_data: List[Dict] = []

    for batch in batches:
        enriched = batch_with_preds(batch)
        pred_binary = torch.as_tensor(enriched["pred_binary"])
        dev = pred_binary.device
        bsz = int(pred_binary.shape[0])
        as_dev = lambda k: torch.as_tensor(enriched[k], device=dev)  # noqa: E731
        valid = None
        if mask_from_magic:
            if "nodata_mask" not in enriched:
                raise KeyError("mask_from_magic requires batch['nodata_mask']")
            valid = as_dev("nodata_mask") == 0
        cms, sweep, label_px, pred_px = _batch_eval_stats(
            pred_binary, as_dev("prediction"), as_dev("output_norm"), valid, thresholds,
            apply_threshold)
        pred_cls = as_dev("pred_classification").reshape(bsz, -1)[:, 0].to(torch.int64)
        # One device-to-host copy for every count of the batch.
        host = torch.cat([cms.reshape(-1), sweep.reshape(-1), label_px, pred_px,
                          pred_cls]).cpu().numpy()
        with span("validation.rows"):
            cms, rest = host[:4 * bsz].reshape(bsz, 2, 2), host[4 * bsz:]
            sweep, rest = rest[:4 * len(thresholds)].reshape(-1, 2, 2), rest[4 * len(thresholds):]
            label_px, pred_px, pred_cls = rest.reshape(3, bsz)
            for k, thr in enumerate(thresholds):
                cm_thresholds[thr] += sweep[k]

            for i in range(bsz):
                cm_iter = cms[i]
                cm_total += cm_iter
                row: Dict[str, Any] = {}
                for fun in sm.METRICS_CONFUSION_MATRIX + [sm.TP, sm.TN, sm.FP, sm.FN]:
                    row[fun.__name__] = float(fun(cm_iter))
                ids = enriched.get("id", [str(len(out_data))] * bsz)
                row["id"] = ids[i] if isinstance(ids, (list, tuple)) else str(ids)
                row["label_pixels_plume"] = int(label_px[i])
                row["has_plume"] = row["label_pixels_plume"] > 0
                row["pred_classification"] = int(pred_cls[i])
                row["pred_pixels_plume"] = int(pred_px[i])
                out_data.append(row)
                if plot_fn is not None:
                    plot_fn(enriched, i, row["id"])

    # ---------------------------------------------------------- aggregates
    metrics: Dict[str, Any] = {}
    for row in out_data:
        row["difficulty"] = "easy" if row["label_pixels_plume"] > 1000 else "hard"

    def cm_of(rows: List[Dict]) -> np.ndarray:
        tn = sum(r["TN"] for r in rows)
        fp = sum(r["FP"] for r in rows)
        fn = sum(r["FN"] for r in rows)
        tp = sum(r["TP"] for r in rows)
        return np.asarray([[tn, fp], [fn, tp]])

    total = cm_total.sum()
    no_plume_rows = [r for r in out_data if not r["has_plume"]]
    if no_plume_rows:
        item = cm_of(no_plume_rows)
        metrics["FPR_no_plume"] = float(item[0, 1] / max(item[0, 1] + item[0, 0], 1))
        metrics["frac_total_easy"] = float(item.sum() / max(total, 1))

    for str_diff in ("easy", "hard"):
        rows = [r for r in out_data if r["has_plume"] and r["difficulty"] == str_diff]
        if not rows:
            continue
        cm_diff = cm_of(rows)
        for f in sm.METRICS_CONFUSION_MATRIX:
            metrics[f"{f.__name__}_{str_diff}"] = float(f(cm_diff))
        metrics[f"frac_total_{str_diff}"] = float(cm_diff.sum() / max(total, 1))

    for fun in sm.METRICS_CONFUSION_MATRIX:
        metrics[fun.__name__] = float(fun(cm_total))
    metrics["confusion_matrix"] = cm_total.tolist()

    cm_classification = sm.confusion_matrix(
        np.asarray([r["pred_classification"] for r in out_data]),
        np.asarray([int(r["has_plume"]) for r in out_data]),
    ).numpy()
    for fun in sm.METRICS_CONFUSION_MATRIX:
        metrics[f"classification_{fun.__name__}"] = float(fun(cm_classification))
    metrics["classification_confusion_matrix"] = cm_classification.tolist()

    metrics["thresholded"] = []
    for thr in thresholds:
        cm_t = cm_thresholds[thr]
        entry = {"threshold": float(thr), "confusion_matrix": cm_t.tolist()}
        for fun in [sm.precision, sm.recall, sm.TPR, sm.FPR]:
            entry[fun.__name__] = float(fun(cm_t))
        metrics["thresholded"].append(entry)

    if path_save_results is not None:
        os.makedirs(path_save_results, exist_ok=True)
        _write_results_csv(os.path.join(path_save_results, "results.csv"), out_data)
        with open(os.path.join(path_save_results, "results_agg.json"), "w") as fh:
            json.dump(metrics, fh, default=_json_default)

    return out_data, metrics


def _write_results_csv(path: str, rows: List[Dict]):
    if not rows:
        return
    keys = ["id"] + [k for k in rows[0] if k != "id"]
    with open(path, "w", newline="") as fh:
        writer = csv.DictWriter(fh, fieldnames=keys)
        writer.writeheader()
        writer.writerows(rows)


def _json_default(obj):
    if isinstance(obj, np.generic):
        return obj.item()
    if hasattr(obj, "tolist"):
        return obj.tolist()
    return str(obj)
