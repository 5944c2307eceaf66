"""Carry MobileNetV2-UNet weights into the port.

``flax_to_torch_state_dict`` turns the JAX package's Flax variables
(``{"params", "batch_stats"}`` with array leaves) into this package's
``MobileNetV2UNet`` state_dict; it inverts
``starcop_tpu/models/torch_port.py:port_smp_mobilenetv2_unet``:

  encoder/features_0/{conv,bn}          -> encoder.features.0.{0,1}
  encoder/features_1 (t = 1 block)      -> encoder.features.1.conv.{0.0,0.1,1,2}
  encoder/features_i/{expand,depthwise,project,project_bn}
                                        -> encoder.features.i.conv.{0.*,1.*,2,3}
  encoder/features_18/{conv,bn}         -> encoder.features.18.{0,1}
  decoder_i/conv{1,2}/{conv,bn}         -> decoder.blocks.i.conv{1,2}.{0,1}
  segmentation_head                     -> segmentation_head.0

Conv kernels (kh, kw, I, O) -> (O, I, kh, kw) (depthwise (kh, kw, 1, C) ->
(C, 1, kh, kw)); BN scale/bias/mean/var -> weight/bias/running_mean/
running_var, plus ``num_batches_tracked`` so ``load_state_dict(strict=True)``
passes. ``load_lightning_state_dict`` reads a released Lightning checkpoint,
``load_pretrained_state_dict`` a checkpoint file or folder of either kind.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping

import numpy as np
import torch

_N_FEATURES = 19


def _conv(kernel) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(kernel), (3, 2, 0, 1))))


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _bn(sd: Dict[str, torch.Tensor], prefix: str, params: Mapping, stats: Mapping) -> None:
    sd[f"{prefix}.weight"] = _tensor(params["scale"])
    sd[f"{prefix}.bias"] = _tensor(params["bias"])
    sd[f"{prefix}.running_mean"] = _tensor(stats["mean"])
    sd[f"{prefix}.running_var"] = _tensor(stats["var"])
    sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def _convbn(sd, prefix_conv: str, prefix_bn: str, params: Mapping, stats: Mapping) -> None:
    sd[f"{prefix_conv}.weight"] = _conv(params["conv"]["kernel"])
    _bn(sd, prefix_bn, params["bn"], stats["bn"])


def flax_to_torch_state_dict(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax ``MobileNetV2UNet`` variables -> this package's state_dict."""
    params, stats = variables["params"], variables["batch_stats"]
    enc_p, enc_s = params["encoder"], stats["encoder"]
    sd: Dict[str, torch.Tensor] = {}
    for i in range(_N_FEATURES):
        p, s = enc_p[f"features_{i}"], enc_s[f"features_{i}"]
        pre = f"encoder.features.{i}"
        if i in (0, _N_FEATURES - 1):
            _convbn(sd, f"{pre}.0", f"{pre}.1", p, s)
            continue
        slot = 0
        if "expand" in p:
            _convbn(sd, f"{pre}.conv.0.0", f"{pre}.conv.0.1", p["expand"], s["expand"])
            slot = 1
        _convbn(sd, f"{pre}.conv.{slot}.0", f"{pre}.conv.{slot}.1", p["depthwise"],
                s["depthwise"])
        sd[f"{pre}.conv.{slot + 1}.weight"] = _conv(p["project"]["kernel"])
        _bn(sd, f"{pre}.conv.{slot + 2}", p["project_bn"], s["project_bn"])
    for i in range(5):
        for conv in ("conv1", "conv2"):
            pre = f"decoder.blocks.{i}.{conv}"
            _convbn(sd, f"{pre}.0", f"{pre}.1", params[f"decoder_{i}"][conv],
                    stats[f"decoder_{i}"][conv])
    sd["segmentation_head.0.weight"] = _conv(params["segmentation_head"]["kernel"])
    sd["segmentation_head.0.bias"] = _tensor(params["segmentation_head"]["bias"])
    return sd


CHECKPOINT_NAMES = ("final_checkpoint_model.ckpt", "model.pt", "best.npz",
                    "final_checkpoint_model.npz")


def _npz_variables(path: str) -> Dict[str, Any]:
    """A framework .npz checkpoint (flat keys ``params/...`` and
    ``batch_stats/...``; ``step`` and ``opt_state/...`` skipped) -> nested
    ``{"params", "batch_stats"}`` variables."""
    tree: Dict[str, Dict] = {}
    with np.load(path) as data:
        for key in data.files:
            parts = key.split("/")
            if parts[0] not in ("params", "batch_stats"):
                continue
            node = tree.setdefault(parts[0], {})
            for p in parts[1:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = data[key]
    return tree


def load_pretrained_state_dict(path_or_folder: str) -> Dict[str, torch.Tensor]:
    """The ``MobileNetV2UNet`` state_dict of a checkpoint file, or of the
    first of ``CHECKPOINT_NAMES`` found in a folder (the candidates and the
    .npz layout of starcop_tpu/setup_shims.py:85-121): a framework .npz
    through ``flax_to_torch_state_dict``, a Lightning .ckpt or a torch .pt
    through ``load_lightning_state_dict`` (loaded with
    ``weights_only=True``: tensors and plain containers only)."""
    path = path_or_folder
    if os.path.isdir(path):
        for name in CHECKPOINT_NAMES:
            if os.path.exists(os.path.join(path, name)):
                path = os.path.join(path, name)
                break
    if path.endswith((".ckpt", ".pt")):
        return load_lightning_state_dict(torch.load(path, map_location="cpu", weights_only=True))
    if path.endswith(".npz"):
        return flax_to_torch_state_dict(_npz_variables(path))
    raise ValueError(f"Pretrained weights not found at: {path_or_folder}")


def load_lightning_state_dict(checkpoint: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A Lightning checkpoint (or its ``state_dict``) -> the network's
    state_dict: strip the ``network.`` prefix and drop the normaliser
    constants, ``pos_weight`` and the loss buffers."""
    state = checkpoint.get("state_dict", checkpoint)
    out = {}
    for k, v in state.items():
        if k.startswith("network."):
            k = k[len("network."):]
        if k.startswith(("normalizer.", "pos_weight", "loss_function")):
            continue
        out[k] = torch.as_tensor(v)
    return out
