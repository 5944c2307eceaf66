"""Per-product band normalisation (counterpart of starcop_tpu/data/normalizer.py).

Each product maps to {offset, factor, clip}; inputs (and outputs with an
entry) are normalised as ``clip((x - offset) / factor, lo, hi)``. The
constants are the published reference values and are load-bearing for
checkpoint parity (e.g. mag1c factor 1750, AVIRIS RGB factor 60).
"""

from __future__ import annotations

import warnings
from typing import Dict, Sequence

import torch
from torch import nn

_TOA_UNIT = {"offset": 0.0, "factor": 1.0, "clip": (0.0, 2.0)}

BAND_NORMALIZATION: Dict[str, Dict] = {}

# All S2A/S2B TOA bands and WV3 SWIR bands: unit factor, clip [0, 2].
for _b in ["B1", "B2", "B3", "B4", "B5", "B6", "B7", "B8", "B8A", "B9", "B10", "B11", "B12"]:
    BAND_NORMALIZATION[f"TOA_S2A_{_b}"] = dict(_TOA_UNIT)
    BAND_NORMALIZATION[f"TOA_S2B_{_b}"] = dict(_TOA_UNIT)
for _i in range(1, 9):
    BAND_NORMALIZATION[f"TOA_WV3_SWIR{_i}"] = dict(_TOA_UNIT)

BAND_NORMALIZATION.update(
    {
        "TOA_AVIRIS_550nm": {"offset": 0.0, "factor": 60.0, "clip": (0.0, 2.0)},
        "TOA_AVIRIS_640nm": {"offset": 0.0, "factor": 60.0, "clip": (0.0, 2.0)},
        "TOA_AVIRIS_460nm": {"offset": 0.0, "factor": 60.0, "clip": (0.0, 2.0)},
        "TOA_AVIRIS_2004nm": {"offset": 0.0, "factor": 1.0, "clip": (0.0, 2.0)},
        "TOA_AVIRIS_2109nm": {"offset": 0.0, "factor": 5.0, "clip": (0.0, 2.0)},
        "TOA_AVIRIS_2310nm": {"offset": 0.0, "factor": 4.0, "clip": (0.0, 2.0)},
        "TOA_AVIRIS_2350nm": {"offset": 0.0, "factor": 3.0, "clip": (0.0, 2.0)},
        "TOA_AVIRIS_2360nm": {"offset": 0.0, "factor": 3.0, "clip": (0.0, 2.0)},
        "mag1c": {"offset": 0.0, "factor": 1750.0, "clip": (0.0, 2.0)},
        "ratio_aviris_2350_2310_out": {"offset": 0.0, "factor": 0.0625, "clip": (-2.0, 2.0)},
        "ratio_aviris_2350_2360_out": {"offset": 0.0, "factor": 0.0625, "clip": (-2.0, 2.0)},
        "ratio_aviris_2360_2310_out": {"offset": 0.0, "factor": 0.0625, "clip": (-2.0, 2.0)},
        "ratio_wv3_B7_B5_varon21_sum_c_out": {"offset": 0.0, "factor": 0.04, "clip": (-2.0, 2.0)},
        "ratio_wv3_B8_B5_varon21_sum_c_out": {"offset": 0.0, "factor": 0.1, "clip": (-2.0, 2.0)},
        "ratio_wv3_B7_B6_varon21_sum_c_out": {"offset": 0.0, "factor": 0.1, "clip": (-2.0, 2.0)},
        "ratio_wv3_B7_B7MLR_SanchezGarcia22_sum_c_out": {"offset": 0.0, "factor": 0.025, "clip": (-2.0, 2.0)},
        "ratio_wv3_B8_B8MLR_SanchezGarcia22_sum_c_out": {"offset": 0.0, "factor": 0.0769, "clip": (-2.0, 2.0)},
        "ratio_wv3_B7_B7MLR_SanchezGarcia22_simplediv": {"offset": 0.0, "factor": 1.0, "clip": (-2.0, 2.0)},
        "ratio_wv3_B8_B8MLR_SanchezGarcia22_simplediv": {"offset": -0.5, "factor": 1.0, "clip": (-2.0, 2.0)},
        "ratio_lrn_bands2band8only_60ep_512_l1": {"offset": 0.0, "factor": 0.5, "clip": (-2.0, 2.0)},
        "ratio_wv3_B7_B7MLR_fromS2_9bands_sum_c_out": {"offset": 0.0, "factor": 1.0, "clip": (-2.0, 2.0)},
        "ratio_wv3_B7_B7MLR_fromS2_5bands_sum_c_out": {"offset": 0.0, "factor": 0.1111111, "clip": (-2.0, 2.0)},
        "ratio_wv3_B8_B8MLR_fromS2_9bands_sum_c_out": {"offset": 0.0, "factor": 0.125, "clip": (-2.0, 2.0)},
        "ratio_wv3_B8_B8MLR_fromS2_5bands_sum_c_out": {"offset": 0.0, "factor": 0.1666666, "clip": (-2.0, 2.0)},
    }
)


class DataNormalizer(nn.Module):
    """Frozen per-channel normalisation of the input and output products,
    held as (C, 1, 1) buffers so it moves with ``.to(device)`` and
    broadcasts over (B, C, H, W). The buffers are not persistent: a network
    state_dict carries weights only. Unknown input products warn and fall
    back to identity with clip [-10, 10]; outputs with no entry (the default
    ``labelbinary``) pass through ``normalize_y`` unchanged."""

    def __init__(self, input_products: Sequence[str],
                 output_products: Sequence[str] = ("labelbinary",)):
        super().__init__()
        self.input_products = list(input_products)
        self.output_products = list(output_products)
        rows = []
        for p in self.input_products:
            if p not in BAND_NORMALIZATION:
                warnings.warn(
                    f"Product {p} has no band-normalization entry. "
                    f"It will not be normalized BUT it will be clipped to [-10, 10]"
                )
                rows.append((0.0, 1.0, -10.0, 10.0))
            else:
                rows.append(_row(BAND_NORMALIZATION[p]))
        for name, col in zip(_NAMES, _table(rows)):
            self.register_buffer(name, col, persistent=False)

        out = [BAND_NORMALIZATION[p] for p in self.output_products if p in BAND_NORMALIZATION]
        if out and len(out) != len(self.output_products):
            raise ValueError("Some output products don't have normalization. CHECK!")
        cols = _table([_row(e) for e in out]) if out else (None,) * 4
        for name, col in zip(_NAMES, cols):
            self.register_buffer(name + "_output", col, persistent=False)

    def normalize_x(self, x: torch.Tensor) -> torch.Tensor:
        return torch.clamp((x - self.offsets) / self.factors, self.clip_min, self.clip_max)

    def denormalize_x(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.factors + self.offsets

    def normalize_y(self, y: torch.Tensor) -> torch.Tensor:
        if self.factors_output is None:
            return y
        return torch.clamp((y - self.offsets_output) / self.factors_output,
                           self.clip_min_output, self.clip_max_output)

    def denormalize_y(self, y: torch.Tensor) -> torch.Tensor:
        if self.factors_output is None:
            return y
        return y * self.factors_output + self.offsets_output


_NAMES = ("offsets", "factors", "clip_min", "clip_max")


def _row(entry: Dict) -> tuple:
    return entry["offset"], entry["factor"], entry["clip"][0], entry["clip"][1]


def _table(rows) -> torch.Tensor:
    """(offset, factor, lo, hi) rows -> (4, C, 1, 1) float32 columns."""
    return torch.tensor(rows, dtype=torch.float32).T[..., None, None].clone()
