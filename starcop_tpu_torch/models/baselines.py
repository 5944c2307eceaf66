"""Classical thresholding baselines with the ``batch_with_preds`` protocol
(counterpart of starcop_tpu/models/baselines.py):

  * Mag1cBaseline: the mag1c channel > 500 (not normalised), then a binary
    opening by the 3x3 cross;
  * SanchezBaseline: the normalised Sanchez MLR ratio > 0.05, then the opening;
  * VaronBaseline: the normalised Varon band ratio > 0.05, then the opening.

``apply_threshold`` lets the validation harness sweep thresholds through
the same morphology.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch
from torch import nn

from starcop_tpu_torch.data.normalizer import DataNormalizer
from starcop_tpu_torch.models.segmenter import differences, pred_classification
from starcop_tpu_torch.ops.morphology import binary_opening


class _ThresholdBaseline(nn.Module):
    """Select one input channel, threshold, open, classify. ``.to(device)``
    moves the normaliser; a batch is computed on that device."""

    band_name: str

    def __init__(self, input_products: List[str], threshold: float,
                 use_normalisation: bool = True, use_morphological_ops: bool = True):
        super().__init__()
        self.input_products = list(input_products)
        self.band_index = self.input_products.index(self.band_name)
        self.threshold = float(threshold)
        self.use_normalisation = use_normalisation
        self.use_morphological_ops = use_morphological_ops
        self.normalizer = DataNormalizer(input_products, ["labelbinary"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x[:, self.band_index:self.band_index + 1]

    def apply_threshold(self, pred: torch.Tensor, threshold: float) -> torch.Tensor:
        """(B, 1, H, W) prediction -> (B, 1, H, W) int32 mask, opened per
        sample."""
        thresholded = pred > threshold
        if self.use_morphological_ops:
            return binary_opening(thresholded[:, 0]).to(torch.int32)[:, None]
        return thresholded.to(torch.int32)

    def batch_with_preds(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        dev = self.normalizer.offsets.device
        x, y = (torch.as_tensor(batch[k], device=dev) for k in ("input", "output"))
        out = dict(batch)
        out["input_norm"] = self.normalizer.normalize_x(x)
        out["output_norm"] = self.normalizer.normalize_y(y)
        pred = self(out["input_norm"] if self.use_normalisation else x)
        out["prediction"] = pred
        out["pred_binary"] = self.apply_threshold(pred, self.threshold)
        out["differences"] = differences(out["pred_binary"],
                                         out["output_norm"].to(torch.int32))
        out["pred_classification"] = pred_classification(out["pred_binary"])
        return out


class Mag1cBaseline(_ThresholdBaseline):
    """mag1c > 500 (not normalised) with a morphological opening."""

    band_name = "mag1c"

    def __init__(self, input_products: List[str], mag1c_threshold: float = 500.0):
        super().__init__(input_products, mag1c_threshold, use_normalisation=False)


class SanchezBaseline(_ThresholdBaseline):
    """Sanchez MLR ratio ('B8 against the MLR of B1-B6') > 0.05, normalised."""

    band_name = "ratio_wv3_B8_B8MLR_SanchezGarcia22_sum_c_out"

    def __init__(self, input_products: List[str], baseline_threshold: float = 0.05,
                 use_normalisation: bool = True, use_morphological_ops: bool = True,
                 band_name: str = None):
        if band_name is not None:
            self.band_name = band_name
        super().__init__(input_products, baseline_threshold, use_normalisation,
                         use_morphological_ops)


class VaronBaseline(_ThresholdBaseline):
    """Varon B7/B5 band ratio > 0.05, normalised."""

    band_name = "ratio_wv3_B7_B5_varon21_sum_c_out"

    def __init__(self, input_products: List[str], baseline_threshold: float = 0.05,
                 use_normalisation: bool = True, use_morphological_ops: bool = True):
        super().__init__(input_products, baseline_threshold, use_normalisation,
                         use_morphological_ops)
