"""Regression model: network + optional normaliser + l1/mse loss
(counterpart of starcop_tpu/models/regression.py).

The band-value regression wrapper: the segmentation wrapper's skeleton with
the ``regression_output`` protocol (no sigmoid, no threshold), and the
``inhibit_normalisation`` flag under which the learned-ratio regressor reads
raw band values and predicts the raw target band. The networks are those of
``models.segmenter.ARCHITECTURES`` (``cnn_regression`` by default), so Flax
weights carry through ``models.weights`` as the segmentation networks' do.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch
from torch import nn

from starcop_tpu_torch.data.normalizer import DataNormalizer
from starcop_tpu_torch.models.layers import init_like_flax
from starcop_tpu_torch.models.segmenter import configure_architecture


class RegressionModel(nn.Module):
    """(B, C, H, W) input -> (B, num_outputs, H, W) prediction, in the
    normalised output domain unless ``inhibit_normalisation``. Its
    state_dict holds ``network.*`` only."""

    def __init__(self, input_products: Sequence[str], output_products: Sequence[str],
                 model_type: str = "cnn_regression", num_outputs: int = 1,
                 loss_name: str = "l1", inhibit_normalisation: bool = False):
        super().__init__()
        self.input_products = list(input_products)
        self.output_products = list(output_products)
        self.normalizer = (None if inhibit_normalisation
                           else DataNormalizer(self.input_products, self.output_products))
        self.network = configure_architecture(model_type, len(self.input_products), num_outputs)
        self.loss_name = loss_name

    def init(self, generator: Optional[torch.Generator] = None) -> "RegressionModel":
        """Re-initialise the network as Flax does (``init_like_flax``)."""
        init_like_flax(self.network, generator)
        return self

    def _normalize_x(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.normalizer is None else self.normalizer.normalize_x(x)

    def _normalize_y(self, y: torch.Tensor) -> torch.Tensor:
        return y if self.normalizer is None else self.normalizer.normalize_y(y)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Normalised input -> network -> prediction. ``generator`` draws the
        dropout masks of a training forward, as the segmentation wrapper's."""
        kw = {} if generator is None else {"generator": generator}
        return self.network(self._normalize_x(x), **kw)

    def loss_fn(self, prediction: torch.Tensor, y: torch.Tensor,
                weight_loss: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Mean l1 (or mse) against the normalised target, each pixel times
        ``weight_loss`` when given."""
        diff = prediction - self._normalize_y(y)
        per = diff * diff if self.loss_name == "mse" else diff.abs()
        if weight_loss is not None:
            per = per * weight_loss
        return per.mean()

    def batch_with_preds(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """The batch with prediction, output_norm and residual (prediction -
        output_norm) added, computed on the model's device. Run it under
        ``torch.inference_mode()``."""
        dev = next(self.network.parameters()).device
        x, y = (torch.as_tensor(batch[k], device=dev) for k in ("input", "output"))
        out = dict(batch)
        out.update(prediction=self(x), output_norm=self._normalize_y(y))
        out["residual"] = out["prediction"] - out["output_norm"]
        return out
