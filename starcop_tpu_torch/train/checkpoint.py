"""Checkpoints in the JAX package's npz layout (counterpart of
starcop_tpu/train/checkpoint.py).

One ``{name}.npz`` holds ``params/...`` and ``batch_stats/...`` at the Flax
key paths (``models.weights.torch_to_flax_variables``: conv kernels as
(kh, kw, I, O)), the Adam state under ``opt_state/...`` in the layout of
``optax.inject_hyperparams(optax.adam)`` (``models.weights.adam_state_to_flax``)
and ``step``. So the JAX package's ``load_pretrained_variables`` and
``load_checkpoint`` read a port checkpoint, and the port's
``load_pretrained_state_dict`` and ``load_checkpoint`` read a JAX one.
Orbax (``save_checkpoint_orbax``) has no counterpart. ``load_checkpoint``
opens its path through the storage seam (``utils/storage.py``), as JAX's
does, so a remote path loads where ``fsspec`` is installed.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Mapping, Optional

import numpy as np

from starcop_tpu_torch.models.weights import (
    adam_state_from_flax,
    adam_state_to_flax,
    flax_to_torch_state_dict,
    torch_to_flax_variables,
)


def _flatten(tree: Mapping[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    flat = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            flat.update(_flatten(v, f"{prefix}{k}/"))
        else:
            flat[prefix + k] = np.asarray(v)
    return flat


def save_checkpoint(directory: str, state, name: str = "checkpoint",
                    extra: Optional[Dict] = None) -> str:
    """Save a ``TrainState`` as ``directory/{name}.npz`` (and ``extra`` as
    ``{name}_meta.json``); returns the npz path."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"{name}.npz")
    network = state.model.network
    flat = _flatten(torch_to_flax_variables(network.state_dict()), "")
    flat.update(adam_state_to_flax(state.optimizer, network))
    flat["step"] = np.asarray(state.step, np.int32)
    np.savez(path, **flat)
    if extra:
        with open(os.path.join(directory, f"{name}_meta.json"), "w") as fh:
            json.dump(extra, fh, indent=2, default=str)
    return path


def load_checkpoint(path: str, state):
    """Load a checkpoint of either package into ``state`` in place (its
    network's parameters and batch-norm statistics, its Adam, its step) and
    return it. Every entry the state has must be there at its shape."""
    from starcop_tpu_torch.utils import storage

    with storage.open_file(path, "rb") as fh:
        with np.load(fh) as data:
            flat = {k: data[k] for k in data.files}
    network = state.model.network
    template = _flatten(torch_to_flax_variables(network.state_dict()), "")
    variables: Dict[str, Dict] = {}
    for key, leaf in template.items():
        if key not in flat:
            raise KeyError(f"Missing checkpoint entry: {key}")
        if flat[key].shape != leaf.shape:
            raise ValueError(f"Shape mismatch for {key}: {flat[key].shape} vs {leaf.shape}")
        node = variables
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = flat[key]
    network.load_state_dict(flax_to_torch_state_dict(variables), strict=True)
    adam_state_from_flax(flat, network, state.optimizer)
    state.step = int(flat["step"])
    return state
