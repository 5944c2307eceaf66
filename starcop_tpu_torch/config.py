"""Configuration schema and CLI overrides (a copy of starcop_tpu/config.py).

The same dataclasses, keys, defaults, YAML and dotted-path overrides
(``key.subkey=value``), so a JAX experiment's ``config.json`` loads here.
Two differences: ``ModelConfig.resolve_dtype`` gives a torch dtype, and
``TrainingConfig.accelerator`` defaults to ``"gpu"`` (the CUDA card; the
JAX package's default is ``"tpu"``). ``TrainingConfig.resolve_device``
turns it into a torch device: ``"gpu"`` is the card (raising without one),
``"cpu"`` the host, anything else raises.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Tuple


@dataclass
class WandbConfig:
    project: str = "starcop"
    entity: str = ""
    images_logging: bool = True


@dataclass
class DataLoaderConfig:
    batch_size: int = 32
    num_workers: int = 4


@dataclass
class DatasetConfig:
    input_products: List[str] = field(
        default_factory=lambda: [
            "mag1c",
            "TOA_AVIRIS_640nm",
            "TOA_AVIRIS_550nm",
            "TOA_AVIRIS_460nm",
        ]
    )
    output_products: List[str] = field(default_factory=lambda: ["labelbinary"])
    use_weight_loss: bool = True
    weight_loss: str = "weight_mag1c"
    training_size: Tuple[int, int] = (128, 128)
    training_size_overlap: Tuple[int, int] = (64, 64)
    weight_sampling: bool = True
    root_folder: str = ""
    train_csv: str = "train.csv"
    test_csv: str = "test.csv"
    # Regression checkpoint powering the learned-ratio product
    # (ratio_lrn_bands2band8only_60ep_512_l1). Empty = auto-discover
    # model.model_folder/wv3_cnn_v2_bands2band8only_60ep_512_l1 (the
    # reference's pretrained-experiment path, feature_extration.py:128).
    learned_ratio_checkpoint: str = ""


@dataclass
class ModelConfig:
    train: bool = True
    test: bool = True
    model_mode: str = "segmentation_output"  # or "regression_output"
    model_type: str = "unet_semseg"
    semseg_backbone: str = "mobilenet_v2"
    num_classes: int = 1
    optimizer: str = "adam"
    lr: float = 1e-4
    lr_decay: float = 0.5
    lr_patience: int = 4
    loss: str = "BCEWithLogitsLoss"
    pos_weight: float = 15.0
    dtype: str = "float32"  # compute dtype: float32 | bfloat16 (params stay f32)
    # 'auto' = ImageNet encoder init iff 3 input channels and a torchvision
    # checkpoint is discoverable (the reference rule, model_module.py:244-246);
    # 'imagenet' = required; 'none' = always random init.
    encoder_weights: str = "auto"

    def resolve_dtype(self):
        """Map the dtype string to a torch dtype (None = default float32)."""
        if self.dtype in ("", "float32"):
            return None
        if self.dtype == "bfloat16":
            import torch

            return torch.bfloat16
        raise ValueError(
            f"model.dtype must be 'float32' or 'bfloat16', got {self.dtype!r}"
        )
    early_stopping_patience: int = 8
    model_folder: str = ""


@dataclass
class TrainingConfig:
    accelerator: str = "gpu"
    devices: int = 1
    max_epochs: int = 15
    val_check_interval: float = 0.5
    train_log_every_n_steps: int = 10

    def resolve_device(self):
        """``"gpu"`` -> the CUDA card (raises without one), ``"cpu"`` -> the
        host; any other accelerator (``"tpu"`` from a JAX config) raises."""
        from starcop_tpu_torch.device import resolve_device

        if self.accelerator == "gpu":
            return resolve_device(None)
        if self.accelerator == "cpu":
            return resolve_device("cpu")
        raise ValueError(f"training.accelerator={self.accelerator!r} has no device in the "
                         "port: pass training.accelerator=gpu (or cpu)")


@dataclass
class Config:
    experiment_name: str = "experiment"
    seed: int = 42
    resume_from_checkpoint: bool = False
    wandb: WandbConfig = field(default_factory=WandbConfig)
    dataloader: DataLoaderConfig = field(default_factory=DataLoaderConfig)
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    training: TrainingConfig = field(default_factory=TrainingConfig)
    products_plot: List[str] = field(
        default_factory=lambda: ["rgb_aviris", "mag1c", "label", "pred", "differences"]
    )
    plot_samples: int = 8
    # Experiment-artifact upload destination (local dir or gs://... via the
    # storage seam — reference scripts/train.py:147-148). Empty = no upload.
    upload_path: str = ""

    # ------------------------------------------------------------------ I/O
    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Config":
        cfg = cls()
        _merge_into_dataclass(cfg, d)
        return cfg

    @classmethod
    def from_yaml(cls, path: str) -> "Config":
        import yaml

        with open(path) as fh:
            return cls.from_dict(yaml.safe_load(fh) or {})

    def apply_overrides(self, overrides: List[str]) -> "Config":
        """Apply hydra-style dotted overrides, e.g. ``model.lr=3e-4``."""
        for item in overrides:
            if "=" not in item:
                raise ValueError(f"Override must be key=value, got: {item}")
            key, value = item.split("=", 1)
            _set_dotted(self, key.strip(), _parse_value(value.strip()))
        return self


def _parse_value(raw: str) -> Any:
    try:
        return json.loads(raw)
    except (json.JSONDecodeError, ValueError):
        low = raw.lower()
        if low in ("true", "false"):
            return low == "true"
        if low in ("null", "none"):
            return None
        return raw


def _set_dotted(obj: Any, dotted: str, value: Any) -> None:
    parts = dotted.split(".")
    for p in parts[:-1]:
        obj = getattr(obj, p)
    leaf = parts[-1]
    if not hasattr(obj, leaf):
        raise AttributeError(f"Unknown config key: {dotted}")
    cur = getattr(obj, leaf)
    if isinstance(cur, tuple) and isinstance(value, list):
        value = tuple(value)
    setattr(obj, leaf, value)


def _merge_into_dataclass(obj: Any, d: Dict[str, Any]) -> None:
    for k, v in d.items():
        if not hasattr(obj, k):
            continue
        cur = getattr(obj, k)
        if dataclasses.is_dataclass(cur) and isinstance(v, dict):
            _merge_into_dataclass(cur, v)
        elif isinstance(cur, tuple) and isinstance(v, (list, tuple)):
            setattr(obj, k, tuple(v))
        else:
            setattr(obj, k, v)
