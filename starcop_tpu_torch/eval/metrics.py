"""Confusion-matrix metrics (counterpart of starcop_tpu/eval/metrics.py).

``cm[i, j]`` counts the samples of true class i predicted as class j, so
cm = [[TN, FP], [FN, TP]], as in the reference and torchmetrics' binary
ConfusionMatrix. ``confusion_matrix`` and ``masked_confusion_matrix`` count
on the device of their tensors. The metric functions take a 2x2 numpy
array or tensor and return a Python float, computed in float32 on the host
as the JAX package computes them for its per-tile rows; 0/0 gives nan
quietly (an empty class).
"""

from __future__ import annotations

import functools
from typing import Optional, Union

import numpy as np
import torch

Tensor = Union[np.ndarray, torch.Tensor]


def label_flags(target: torch.Tensor, valid: Optional[torch.Tensor] = None):
    """The (valid) label-1 and label-0 flags of int targets."""
    t1, t0 = target == 1, target == 0
    if valid is not None:
        t1, t0 = t1 & valid, t0 & valid
    return t1, t0


def cm_from_flags(pb: torch.Tensor, t1: torch.Tensor, t0: torch.Tensor, n1: torch.Tensor,
                  n0: torch.Tensor, dim=None) -> torch.Tensor:
    """[[tn, fp], [fn, tp]] (int64) of bool predictions ``pb`` against the
    label flags, reduced over ``dim`` (all axes for None), given the flags'
    counts ``n1`` / ``n0`` over the same ``dim``: two reductions, fn and tn
    by difference."""
    tp, fp = (pb & t1).sum(dim), (pb & t0).sum(dim)
    return torch.stack([torch.stack([n0 - fp, fp], -1),
                        torch.stack([n1 - tp, tp], -1)], -2).to(torch.int64)


def _cm(pred: Tensor, target: Tensor, valid: Optional[Tensor]) -> torch.Tensor:
    flat = lambda a: torch.as_tensor(a).reshape(-1)  # noqa: E731
    t1, t0 = label_flags(flat(target).to(torch.int32),
                         None if valid is None else flat(valid).to(torch.bool))
    return cm_from_flags(flat(pred).to(torch.int32) == 1, t1, t0, t1.sum(), t0.sum())


def confusion_matrix(pred: Tensor, target: Tensor) -> torch.Tensor:
    """Binary 2x2 confusion matrix [[TN, FP], [FN, TP]] (int64) of 0/1
    arrays."""
    return _cm(pred, target, None)


def masked_confusion_matrix(pred: Tensor, target: Tensor, valid: Tensor) -> torch.Tensor:
    """The confusion matrix over the ``valid`` pixels only."""
    return _cm(pred, target, valid)


def _host(cm: Tensor) -> np.ndarray:
    return cm.detach().cpu().numpy() if isinstance(cm, torch.Tensor) else np.asarray(cm)


def _f(cm: Tensor) -> np.ndarray:
    """float32 host view of a confusion matrix."""
    return _host(cm).astype(np.float32)


def _quiet(fn):
    """Silence numpy's 0/0 warnings: an empty class gives nan, as in JAX."""

    @functools.wraps(fn)
    def wrapped(cm):
        with np.errstate(divide="ignore", invalid="ignore"):
            return float(fn(cm))

    return wrapped


@_quiet
def precision(cm: Tensor):
    """TP / (TP + FP)"""
    c = _f(cm)
    return c[1, 1] / (c[1, 1] + c[0, 1])


@_quiet
def recall(cm: Tensor):
    """TP / (TP + FN)"""
    c = _f(cm)
    return c[1, 1] / (c[1, 1] + c[1, 0])


def user_accuracy(cm: Tensor):
    """TP / (TP + FP)"""
    return precision(cm)


def producer_accuracy(cm: Tensor):
    """TP / (TP + FN)"""
    return recall(cm)


def TPR(cm: Tensor):
    """TP / (TP + FN)"""
    return recall(cm)


@_quiet
def f1score(cm: Tensor):
    prec = np.float32(precision(cm))
    rec = np.float32(recall(cm))
    return 2 * (prec * rec) / (prec + rec)


@_quiet
def FPR(cm: Tensor):
    """FP / (FP + TN)"""
    c = _f(cm)
    return c[0, 1] / (c[0, 1] + c[0, 0])


@_quiet
def iou(cm: Tensor):
    """TP / (TP + FN + FP)"""
    c = _f(cm)
    return c[1, 1] / (c[1, 1] + c[1, 0] + c[0, 1])


@_quiet
def accuracy(cm: Tensor):
    """(TP + TN) / total"""
    c = _f(cm)
    return (c[1, 1] + c[0, 0]) / c.sum()


@_quiet
def cohen_kappa(cm: Tensor):
    c = _f(cm)
    sum0 = c.sum(axis=0, keepdims=True)
    sum1 = c.sum(axis=1, keepdims=True)
    expected = sum1 @ sum0 / sum0.sum()
    w = 1.0 - np.eye(2, dtype=np.float32)  # off-diagonal weights
    k = (w * c).sum() / (w * expected).sum()
    return 1 - k


@_quiet
def balanced_accuracy(cm: Tensor):
    """0.5 * (recall + TNR)"""
    c = _f(cm)
    tnr = c[0, 0] / (c[0, 0] + c[0, 1])
    return 0.5 * (np.float32(recall(cm)) + tnr)


def TP(cm: Tensor) -> float:
    return float(_host(cm)[1, 1])


def TN(cm: Tensor) -> float:
    return float(_host(cm)[0, 0])


def FP(cm: Tensor) -> float:
    return float(_host(cm)[0, 1])


def FN(cm: Tensor) -> float:
    return float(_host(cm)[1, 0])


METRICS_CONFUSION_MATRIX = [precision, recall, f1score, iou, accuracy, cohen_kappa,
                            balanced_accuracy]
