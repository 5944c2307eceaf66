"""Faults planted in the program's timed path, to show that ``correct``
catches them: each is a context manager that patches the program's module
for the duration and restores it after.

    granule_mf     mf altered where it is produced (+800 on a 20 x 20 patch of valid pixels)
    granule_mask   the mask altered where it is produced (a 2 x 2 patch inverted)
    unchanged      a training step that returns its state unchanged
    half_batch     a training step on half the batch, the mean over the rest
    altered_row    one row of the loader's batch altered where it is produced
    eval_prediction  a tile's logits altered where they are produced (a
                   10 x 10 patch negated, the predictions following)

The granule faults patch the entry point where the granule cell and the
serving pipeline's compute stage both take it.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch


def _patch(obj, name, value):
    real = getattr(obj, name)
    setattr(obj, name, value)
    return lambda: setattr(obj, name, real)


def _granule(what):
    from starcop_tpu_torch.scenes import emit_pipeline
    from starcop_tpu_torch.serve import pipeline

    real = emit_pipeline.emit_granule_to_mask

    def altered(*args, **kwargs):
        pred, mf = real(*args, **kwargs)
        if what == "mf":
            mf = mf.clone()
            patch = mf[200:220, 70:90]
            mf[200:220, 70:90] = torch.where(patch > -9999, patch + 800, patch)
        else:
            pred = pred.clone()
            pred[200:202, 70:72] = 1.0 - pred[200:202, 70:72]
        return pred, mf

    restores = [_patch(emit_pipeline, "emit_granule_to_mask", altered),
                _patch(pipeline, "emit_granule_to_mask", altered)]
    return lambda: [r() for r in restores]


def _step(fault):
    from starcop_tpu_torch.train import loop

    real = loop.make_train_step

    def make(model, seed=0, mesh=None):
        step = real(model, seed, mesh)

        def broken(state, batch, lr):
            if fault == "unchanged":
                model.train()
                logits = model(batch["input"])
                return state, model.loss_fn(logits, batch["output"], batch["weight_loss"]).detach()
            half = {k: v[: len(v) // 2] if isinstance(v, torch.Tensor) else v
                    for k, v in batch.items()}
            return step(state, half, lr)

        return broken

    return _patch(loop, "make_train_step", make)


def _row():
    from starcop_tpu_torch.data import datamodule

    real = datamodule.BatchLoader._collate

    def collate(self, indices):
        batch = real(self, indices)
        batch["input"] = batch["input"].copy()
        batch["input"][0, 0, 10:20, 10:20] += np.float32(50.0)
        return batch

    return _patch(datamodule.BatchLoader, "_collate", collate)


def _prediction():
    from starcop_tpu_torch.models.segmenter import SegmentationModel

    real = SegmentationModel.batch_with_preds

    def altered(self, batch):
        out = real(self, batch)
        out["logits"] = out["logits"].clone()
        out["logits"][0, :, 10:20, 10:20] = -out["logits"][0, :, 10:20, 10:20]
        out["prediction"] = torch.sigmoid(out["logits"])
        out["pred_binary"] = (out["prediction"] > 0.5).to(torch.int32)
        return out

    return _patch(SegmentationModel, "batch_with_preds", altered)


FAULTS = {
    "granule_mf": lambda: _granule("mf"),
    "granule_mask": lambda: _granule("mask"),
    "unchanged": lambda: _step("unchanged"),
    "half_batch": lambda: _step("half_batch"),
    "altered_row": _row,
    "eval_prediction": _prediction,
}


@contextlib.contextmanager
def planted(name: str):
    restore = FAULTS[name]()
    try:
        yield
    finally:
        restore()
