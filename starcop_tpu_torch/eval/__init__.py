"""Evaluation: confusion-matrix metrics and the validation harness."""

from starcop_tpu_torch.eval.metrics import (  # noqa: F401
    METRICS_CONFUSION_MATRIX,
    accuracy,
    balanced_accuracy,
    cohen_kappa,
    confusion_matrix,
    f1score,
    FPR,
    iou,
    precision,
    recall,
    TP,
    TN,
    FP,
    FN,
    TPR,
)
