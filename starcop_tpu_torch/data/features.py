"""Feature registry and lazy product extraction (counterpart of
starcop_tpu/data/features.py).

``FEATURES`` maps each derived product name to its compute function and
input band names: all 16 products of the JAX package (weight_mag1c, 3 AVIRIS
ratios, 3 Varon WV3 ratios, 2 + 2 Sanchez WV3 ratios, the learned-regression
ratio, 4 S2 -> WV3 mixed ratios). ``extract_features`` computes the missing
products of each chip folder on a device and writes ``{folder}/{feature}.npy``
next to their inputs.

The learned ratio reconstructs WV3 SWIR8 from SWIR1-6 with a regression CNN
(``models.regression.RegressionModel`` with raw band values,
``inhibit_normalisation=True``). Its model comes from, first hit wins, an
apply registered by ``register_learned_ratio_model`` or a checkpoint (of
either package) registered by ``register_learned_ratio_checkpoint``, which
``configure_learned_ratio_from_config`` wires from a config; nothing is
fetched.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

from starcop_tpu_torch.device import DeviceLike, float32_precision, resolve_device
from starcop_tpu_torch.ops.ratios import (
    ratio_2c_match_c_from_sums_outlier,
    ratio_mlr_local,
    weight_mag1c,
)

WV3_BANDS = [f"TOA_WV3_SWIR{w + 1}" for w in range(8)]
S2_BAND_NAMES = ["B1", "B2", "B3", "B4", "B5", "B6", "B7", "B8", "B8A", "B9", "B10", "B11", "B12"]
S2A_BANDS = [f"TOA_S2A_{b}" for b in S2_BAND_NAMES]
S2B_BANDS = [f"TOA_S2B_{b}" for b in S2_BAND_NAMES]


def _mlr_5in(*bands, division="c_matched_outliers"):
    return ratio_mlr_local(list(bands[:5]), bands[5], division=division)


def _mlr_9in(*bands, division="c_matched_outliers"):
    return ratio_mlr_local(list(bands[:9]), bands[9], division=division)


def _mlr_5in_simplediv(*bands):
    return ratio_mlr_local(list(bands[:5]), bands[5], division="simple_plus")


_LEARNED_MODEL: Dict[str, object] = {"apply": None, "checkpoint": None}

#: Experiment folder of the reference's pretrained WV3 B1-6 -> B8 regressor,
#: the subdirectory ``configure_learned_ratio_from_config`` looks for.
LEARNED_RATIO_EXPERIMENT = "wv3_cnn_v2_bands2band8only_60ep_512_l1"
LEARNED_RATIO_INPUTS = [f"TOA_WV3_SWIR{i}" for i in (1, 2, 3, 4, 5, 6)]
_NPZ_NAMES = ("best.npz", "final_checkpoint_model.npz", "model.npz")


def _learned_ratio(*bands):
    """Learned-regression ratio: reconstruct SWIR8 from SWIR1-6 with the
    registered regressor (a registered checkpoint is built on the bands'
    device), then the c-matched ratio of SWIR8 against it."""
    if _LEARNED_MODEL["apply"] is None and _LEARNED_MODEL["checkpoint"]:
        _LEARNED_MODEL["apply"] = _build_learned_apply(_LEARNED_MODEL["checkpoint"],
                                                       device=bands[0].device)
    if _LEARNED_MODEL["apply"] is None:
        raise RuntimeError(
            "Learned ratio requires a registered regression model: call "
            "starcop_tpu_torch.data.features.register_learned_ratio_model(apply_fn), "
            "register_learned_ratio_checkpoint(path), or set the "
            "dataset.learned_ratio_checkpoint config key")
    recon = _LEARNED_MODEL["apply"](torch.stack(bands[:6])[None])[0, 0]
    target = bands[6]
    r = ratio_2c_match_c_from_sums_outlier(target, recon.to(target.device), zero_value_out=-0.5)
    return torch.where(target == 0.0, -0.5, r)


def register_learned_ratio_model(apply_fn: Callable) -> None:
    """Register fn((1, 6, H, W) tensor) -> (1, 1, H, W) for the learned ratio."""
    _LEARNED_MODEL["apply"] = apply_fn


def register_learned_ratio_checkpoint(path: str) -> None:
    """Record a regression checkpoint (an .npz / .pt / .ckpt file or an
    experiment folder); the model is built on the product's first use."""
    _LEARNED_MODEL["checkpoint"] = path
    _LEARNED_MODEL["apply"] = None


def configure_learned_ratio_from_config(cfg) -> bool:
    """Wire the learned ratio from a Config: ``dataset.learned_ratio_checkpoint``
    wins, else ``model.model_folder/<LEARNED_RATIO_EXPERIMENT>`` when that
    folder exists. Returns True when a checkpoint was registered."""
    explicit = getattr(cfg.dataset, "learned_ratio_checkpoint", "")
    if explicit:
        register_learned_ratio_checkpoint(explicit)
        return True
    folder = getattr(cfg.model, "model_folder", "")
    if folder:
        candidate = os.path.join(folder, LEARNED_RATIO_EXPERIMENT)
        if os.path.isdir(candidate):
            register_learned_ratio_checkpoint(candidate)
            return True
    return False


def _build_learned_apply(path: str, device: DeviceLike = None) -> Callable:
    """The (1, 6, H, W) -> (1, 1, H, W) apply of a ``cnn_regression``
    checkpoint on raw bands. In a folder an .npz (either package's layout)
    is taken first, as JAX does, then the names of
    ``models.weights.CHECKPOINT_NAMES``. ``device`` None is the card."""
    from starcop_tpu_torch.models.regression import RegressionModel
    from starcop_tpu_torch.models.weights import load_pretrained_state_dict

    if os.path.isdir(path):
        path = next((os.path.join(path, n) for n in _NPZ_NAMES
                     if os.path.exists(os.path.join(path, n))), path)
    model = RegressionModel(LEARNED_RATIO_INPUTS, ["TOA_WV3_SWIR8"],
                            model_type="cnn_regression", inhibit_normalisation=True)
    model.network.load_state_dict(load_pretrained_state_dict(path))
    model = model.to(resolve_device(device)).eval()
    dev = next(model.parameters()).device

    def apply(x: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode(), float32_precision():
            return model(torch.as_tensor(x, dtype=torch.float32, device=dev))

    return apply


FEATURES: Dict[str, Dict] = {
    "weight_mag1c": {"function": weight_mag1c, "inputs": ["mag1c"]},
    # AVIRIS band ratios
    "ratio_aviris_2350_2310_out": {
        "function": ratio_2c_match_c_from_sums_outlier,
        "inputs": ["TOA_AVIRIS_2350nm", "TOA_AVIRIS_2310nm"],
    },
    "ratio_aviris_2350_2360_out": {
        "function": ratio_2c_match_c_from_sums_outlier,
        "inputs": ["TOA_AVIRIS_2350nm", "TOA_AVIRIS_2360nm"],
    },
    "ratio_aviris_2360_2310_out": {
        "function": ratio_2c_match_c_from_sums_outlier,
        "inputs": ["TOA_AVIRIS_2360nm", "TOA_AVIRIS_2310nm"],
    },
    # WV3 Varon-style ratios
    "ratio_wv3_B7_B5_varon21_sum_c_out": {
        "function": ratio_2c_match_c_from_sums_outlier,
        "inputs": ["TOA_WV3_SWIR7", "TOA_WV3_SWIR5"],
    },
    "ratio_wv3_B8_B5_varon21_sum_c_out": {
        "function": ratio_2c_match_c_from_sums_outlier,
        "inputs": ["TOA_WV3_SWIR8", "TOA_WV3_SWIR5"],
    },
    "ratio_wv3_B7_B6_varon21_sum_c_out": {
        "function": ratio_2c_match_c_from_sums_outlier,
        "inputs": ["TOA_WV3_SWIR7", "TOA_WV3_SWIR6"],
    },
    # WV3 Sanchez MLR ratios
    "ratio_wv3_B7_B7MLR_SanchezGarcia22_sum_c_out": {
        "function": _mlr_5in,
        "inputs": ["TOA_WV3_SWIR1", "TOA_WV3_SWIR2", "TOA_WV3_SWIR4", "TOA_WV3_SWIR5",
                   "TOA_WV3_SWIR6", "TOA_WV3_SWIR7"],
    },
    "ratio_wv3_B8_B8MLR_SanchezGarcia22_sum_c_out": {
        "function": _mlr_5in,
        "inputs": ["TOA_WV3_SWIR1", "TOA_WV3_SWIR2", "TOA_WV3_SWIR4", "TOA_WV3_SWIR5",
                   "TOA_WV3_SWIR6", "TOA_WV3_SWIR8"],
    },
    "ratio_wv3_B7_B7MLR_SanchezGarcia22_simplediv": {
        "function": _mlr_5in_simplediv,
        "inputs": ["TOA_WV3_SWIR1", "TOA_WV3_SWIR2", "TOA_WV3_SWIR4", "TOA_WV3_SWIR5",
                   "TOA_WV3_SWIR6", "TOA_WV3_SWIR7"],
    },
    "ratio_wv3_B8_B8MLR_SanchezGarcia22_simplediv": {
        "function": _mlr_5in_simplediv,
        "inputs": ["TOA_WV3_SWIR1", "TOA_WV3_SWIR2", "TOA_WV3_SWIR4", "TOA_WV3_SWIR5",
                   "TOA_WV3_SWIR6", "TOA_WV3_SWIR8"],
    },
    # Learned model ratio
    "ratio_lrn_bands2band8only_60ep_512_l1": {
        "function": _learned_ratio,
        "inputs": LEARNED_RATIO_INPUTS + ["TOA_WV3_SWIR8"],
    },
    # Sanchez ratios simulated from S2 + one WV3 band
    "ratio_wv3_B7_B7MLR_fromS2_9bands_sum_c_out": {
        "function": _mlr_9in,
        "inputs": ["TOA_S2B_B2", "TOA_S2B_B3", "TOA_S2B_B4", "TOA_S2B_B5", "TOA_S2B_B6",
                   "TOA_S2B_B7", "TOA_S2B_B8", "TOA_S2B_B8A", "TOA_S2B_B11", "TOA_WV3_SWIR7"],
    },
    "ratio_wv3_B7_B7MLR_fromS2_5bands_sum_c_out": {
        "function": _mlr_5in,
        "inputs": ["TOA_S2B_B2", "TOA_S2B_B3", "TOA_S2B_B4", "TOA_S2B_B8", "TOA_S2B_B11",
                   "TOA_WV3_SWIR7"],
    },
    "ratio_wv3_B8_B8MLR_fromS2_9bands_sum_c_out": {
        "function": _mlr_9in,
        "inputs": ["TOA_S2B_B2", "TOA_S2B_B3", "TOA_S2B_B4", "TOA_S2B_B5", "TOA_S2B_B6",
                   "TOA_S2B_B7", "TOA_S2B_B8", "TOA_S2B_B8A", "TOA_S2B_B11", "TOA_WV3_SWIR8"],
    },
    "ratio_wv3_B8_B8MLR_fromS2_5bands_sum_c_out": {
        "function": _mlr_5in,
        "inputs": ["TOA_S2B_B2", "TOA_S2B_B3", "TOA_S2B_B4", "TOA_S2B_B8", "TOA_S2B_B11",
                   "TOA_WV3_SWIR8"],
    },
}

AVIRIS_WAVELENGTHS = list(range(376, 2501, 5))  # nominal AVIRIS-NG 5 nm grid


def raw_bands_available() -> List[str]:
    """Every raw product name."""
    bands = [f"TOA_AVIRIS_{wv}nm" for wv in AVIRIS_WAVELENGTHS + [550, 640, 460]]
    bands.extend(WV3_BANDS)
    bands.extend(S2A_BANDS + S2B_BANDS)
    bands.extend(["mag1c", "labelbinary", "label_rgba"])
    return bands


def extract_features(features: Sequence[str], rows: Sequence[Dict],
                     device: DeviceLike = None) -> int:
    """Compute and write the missing feature products of each tile folder:
    a product that exists as .npy or .tif is skipped; the inputs are read
    through ``data.dataset._read_product`` and the product computed on
    ``device`` (None: the card) and saved as ``{folder}/{feature}.npy``
    (float32). Returns the number of files written."""
    from starcop_tpu_torch.data.dataset import _read_product

    for feature in features:
        if feature not in FEATURES:
            raise KeyError(f"Unknown feature: {feature}")
    dev = resolve_device(device)
    written = 0
    for row in rows:
        folder = row["folder"]
        for feature in features:
            out_path = os.path.join(folder, f"{feature}.npy")
            if os.path.exists(out_path) or os.path.exists(out_path[:-4] + ".tif"):
                continue
            spec = FEATURES[feature]
            inputs = [torch.tensor(_read_product(folder, p, None), device=dev)
                      for p in spec["inputs"]]
            with torch.inference_mode():
                result = spec["function"](*inputs)
            np.save(out_path, result.to(torch.float32).cpu().numpy())
            written += 1
    return written
