"""Carry weights and optimizer state between the JAX package and the port,
both ways.

``flax_to_torch_state_dict`` turns the JAX package's Flax variables
(``{"params", "batch_stats"}`` with array leaves) into this package's
network state_dict, and ``torch_to_flax_variables`` turns a state_dict back
(the checkpoint writer's layout, ``train/checkpoint.py``). For the
``MobileNetV2UNet`` the names map as
``starcop_tpu/models/torch_port.py:port_smp_mobilenetv2_unet`` maps them:

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
passes. The other networks (``models/simple.py``, ``models/unet.py``) carry
the Flax module names, so ``a.b.weight`` is ``params/a/b/kernel`` and
``a.b.bias`` is ``params/a/b/bias``.

``adam_state_to_flax`` / ``adam_state_from_flax`` carry torch Adam's
state to and from the layout of ``optax.inject_hyperparams(optax.adam)``
flattened as the JAX checkpoints flatten it (``opt_state/count``,
``opt_state/hyperparams/*``, ``opt_state/inner_state/0/{count,mu,nu}/<Flax
path>``), so either package resumes from the other's checkpoint.

``load_lightning_state_dict`` reads a released Lightning checkpoint,
``load_pretrained_state_dict`` a checkpoint file or folder of either kind,
``load_torchvision_encoder`` an ImageNet mobilenet_v2 into the encoder.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional, Tuple

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
    """Flax variables -> this package's state_dict of the same network
    (``MobileNetV2UNet`` when the params hold an ``encoder``, else a
    network named as in Flax)."""
    params = variables["params"]
    if "encoder" not in params:
        return _flax_to_torch_by_name(params)
    stats = variables["batch_stats"]
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


def _flax_to_torch_by_name(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}

    def walk(tree, path):
        for name, leaf in tree.items():
            if isinstance(leaf, Mapping):
                walk(leaf, path + (name,))
            elif name == "kernel":
                sd[".".join(path + ("weight",))] = _conv(leaf)
            else:
                sd[".".join(path + (name,))] = _tensor(leaf)

    walk(params, ())
    return sd


_BN_LEAVES = {"weight": ("params", "scale"), "bias": ("params", "bias"),
              "running_mean": ("batch_stats", "mean"), "running_var": ("batch_stats", "var")}


def _bn_leaf(prefix: Tuple[str, ...], leaf: str):
    if leaf not in _BN_LEAVES:  # num_batches_tracked: Flax keeps no count
        return None
    coll, name = _BN_LEAVES[leaf]
    return coll, prefix + (name,)


def flax_location(key: str, semseg: bool) -> Optional[Tuple[str, Tuple[str, ...]]]:
    """(collection, Flax path) of a torch state_dict key; None for a key
    Flax has no counterpart of (``num_batches_tracked``). ``semseg``: the
    key is a ``MobileNetV2UNet``'s."""
    parts = key.split(".")
    if not semseg:
        return "params", tuple(parts[:-1]) + ({"weight": "kernel"}.get(parts[-1], parts[-1]),)
    if parts[0] == "segmentation_head":
        return "params", ("segmentation_head", {"weight": "kernel"}.get(parts[-1], parts[-1]))
    if parts[0] == "decoder":  # decoder.blocks.i.conv{1,2}.{0,1}.leaf
        pre = (f"decoder_{parts[2]}", parts[3])
        if parts[4] == "0":
            return "params", pre + ("conv", "kernel")
        return _bn_leaf(pre + ("bn",), parts[5])
    i = int(parts[2])  # encoder.features.i....
    pre = ("encoder", f"features_{i}")
    if i in (0, _N_FEATURES - 1):  # encoder.features.i.{0,1}.leaf
        return ("params", pre + ("conv", "kernel")) if parts[3] == "0" \
            else _bn_leaf(pre + ("bn",), parts[4])
    slots = ("expand", "depthwise", "project", "project_bn")[1 if i == 1 else 0:]
    slot = slots[int(parts[4])]  # encoder.features.i.conv.j....
    if slot == "project":
        return "params", pre + ("project", "kernel")
    if slot == "project_bn":
        return _bn_leaf(pre + ("project_bn",), parts[5])
    if parts[5] == "0":
        return "params", pre + (slot, "conv", "kernel")
    return _bn_leaf(pre + (slot, "bn"), parts[6])


def is_semseg(keys) -> bool:
    """Whether state_dict keys are a ``MobileNetV2UNet``'s."""
    return any(k.startswith("encoder.features.") for k in keys)


def _to_flax_array(v: torch.Tensor) -> np.ndarray:
    v = v.detach().cpu()
    if v.is_floating_point() and v.dtype != torch.float64:
        v = v.float()
    a = v.numpy()
    return np.ascontiguousarray(np.transpose(a, (2, 3, 1, 0))) if a.ndim == 4 else a.copy()


def torch_to_flax_variables(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """A network state_dict -> Flax variables ``{"params", "batch_stats"}``
    (``batch_stats`` only where the network has batch norm) of numpy arrays:
    conv weights (O, I, kh, kw) -> (kh, kw, I, O), bf16 and f16 leaves
    widened to f32."""
    semseg = is_semseg(state_dict)
    out: Dict[str, Dict] = {}
    for key, value in state_dict.items():
        loc = flax_location(key, semseg)
        if loc is None:
            continue
        node = out.setdefault(loc[0], {})
        for p in loc[1][:-1]:
            node = node.setdefault(p, {})
        node[loc[1][-1]] = _to_flax_array(value)
    return out


def load_torchvision_encoder(network, state_dict: Mapping[str, torch.Tensor]) -> None:
    """Load a torchvision mobilenet_v2 ImageNet state_dict (``features.*``;
    the classifier is ignored) into a ``MobileNetV2UNet``'s encoder, in
    place; the decoder and head keep their weights. The ImageNet stem takes
    3 input channels, so the network must too."""
    enc = {k[len("features."):]: v for k, v in state_dict.items() if k.startswith("features.")}
    want = network.encoder.features[0][0].weight.shape[1]
    if enc["0.0.weight"].shape[1] != want:
        raise ValueError(f"ImageNet encoder init requires 3 input channels, model has {want}")
    network.encoder.features.load_state_dict(enc, strict=True)


OPT = "opt_state/"
_ADAM = OPT + "inner_state/0/"


def adam_state_to_flax(optimizer: torch.optim.Optimizer, network) -> Dict[str, np.ndarray]:
    """A torch Adam over ``network``'s parameters -> the flat ``opt_state/``
    entries of ``optax.inject_hyperparams(optax.adam)``: count, the
    hyperparameters (learning rate, b1, b2, eps, eps_root 0) and mu / nu at
    each parameter's Flax path (zeros before the first step, as optax's
    init)."""
    group = optimizer.param_groups[0]
    semseg = is_semseg(dict(network.named_parameters()))
    steps = [float(st["step"]) for st in optimizer.state.values() if "step" in st]
    count = np.asarray(int(steps[0]) if steps else 0, np.int32)
    b1, b2 = group["betas"]
    flat = {OPT + "count": count, _ADAM + "count": count.copy()}
    for name, value in (("b1", b1), ("b2", b2), ("eps", group["eps"]), ("eps_root", 0.0),
                        ("learning_rate", group["lr"])):
        flat[f"{OPT}hyperparams/{name}"] = np.asarray(value, np.float32)
    for name, p in network.named_parameters():
        st = optimizer.state.get(p, {})
        path = "/".join(flax_location(name, semseg)[1])
        for mine, theirs in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
            flat[f"{_ADAM}{theirs}/{path}"] = _to_flax_array(st.get(mine, torch.zeros_like(p)))
    return flat


def _entry(flat: Mapping[str, np.ndarray], key: str, shape=None) -> np.ndarray:
    if key not in flat:
        raise KeyError(f"Missing checkpoint entry: {key}")
    arr = np.asarray(flat[key])
    if shape is not None and arr.shape != tuple(shape):
        raise ValueError(f"Shape mismatch for {key}: {arr.shape} vs {tuple(shape)}")
    return arr


def adam_state_from_flax(flat: Mapping[str, np.ndarray], network,
                         optimizer: torch.optim.Optimizer) -> None:
    """Load the flat optax Adam entries (``adam_state_to_flax``'s layout, as
    a JAX checkpoint holds them) into ``optimizer`` over ``network``'s
    parameters, in place: count -> each parameter's step, mu / nu ->
    exp_avg / exp_avg_sq, the injected learning rate -> every group's lr."""
    semseg = is_semseg(dict(network.named_parameters()))
    count = float(_entry(flat, _ADAM + "count"))
    names = {id(p): n for n, p in network.named_parameters()}
    sd = optimizer.state_dict()
    params = [p for g in optimizer.param_groups for p in g["params"]]
    for idx, p in enumerate(params):
        path = "/".join(flax_location(names[id(p)], semseg)[1])
        shape = [p.shape[d] for d in (2, 3, 1, 0)] if p.ndim == 4 else p.shape
        sd["state"][idx] = {"step": torch.tensor(count, dtype=torch.float32), **{
            mine: _conv(a) if a.ndim == 4 else _tensor(a)
            for mine, a in (("exp_avg", _entry(flat, f"{_ADAM}mu/{path}", shape)),
                            ("exp_avg_sq", _entry(flat, f"{_ADAM}nu/{path}", shape)))}}
    lr = float(_entry(flat, OPT + "hyperparams/learning_rate"))
    for g in sd["param_groups"]:
        g["lr"] = lr
    optimizer.load_state_dict(sd)


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
