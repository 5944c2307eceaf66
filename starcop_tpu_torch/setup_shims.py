"""Setup shims: config -> DataModule / model (counterpart of
starcop_tpu/setup_shims.py).

``get_dataset(cfg)`` wires the learned-ratio product's checkpoint from the
config and builds the DataModule; ``get_model(cfg, name)`` builds the
segmentation or regression model and, given ``name`` and
``model.model_folder``, also loads pretrained weights from
``model.model_folder/{name}``. ``load_pretrained_variables`` reads a
checkpoint of either package (or a Lightning one) as the network's
state_dict.
"""

from __future__ import annotations

import os
from typing import Optional

from starcop_tpu_torch.config import Config

def get_dataset(cfg: Config):
    from starcop_tpu_torch.data.datamodule import DataModule
    from starcop_tpu_torch.data.features import configure_learned_ratio_from_config

    # The learned-ratio product's regressor is built from this checkpoint
    # on the product's first use (data/features.py).
    configure_learned_ratio_from_config(cfg)
    root = cfg.dataset.root_folder
    return DataModule(
        train_csv=os.path.join(root, cfg.dataset.train_csv),
        test_csv=os.path.join(root, cfg.dataset.test_csv) if cfg.dataset.test_csv else None,
        input_products=cfg.dataset.input_products,
        output_products=cfg.dataset.output_products,
        weight_loss_product=cfg.dataset.weight_loss if cfg.dataset.use_weight_loss else None,
        training_size=cfg.dataset.training_size[0],
        training_overlap=cfg.dataset.training_size_overlap[0],
        batch_size=cfg.dataloader.batch_size,
        weight_sampling=cfg.dataset.weight_sampling,
        num_workers=cfg.dataloader.num_workers,
        seed=cfg.seed,
    )


def get_model(cfg: Config, name: Optional[str] = None):
    """The model of ``cfg.model.model_mode``; with ``name`` and
    ``model.model_folder`` set, ``(model, state_dict)`` with the pretrained
    network weights (not yet loaded into the model) instead."""
    if cfg.model.model_mode == "segmentation_output":
        from starcop_tpu_torch.models.segmenter import SegmentationModel

        model = SegmentationModel(
            cfg.dataset.input_products,
            cfg.dataset.output_products,
            model_type=cfg.model.model_type,
            num_classes=cfg.model.num_classes,
            pos_weight=cfg.model.pos_weight,
            use_weight_loss=cfg.dataset.use_weight_loss,
            loss_name=cfg.model.loss,
            model_dtype=cfg.model.resolve_dtype(),
            encoder_weights=(
                None if cfg.model.encoder_weights in ("none", "") else cfg.model.encoder_weights
            ),
        )
    elif cfg.model.model_mode == "regression_output":
        from starcop_tpu_torch.models.regression import RegressionModel

        model = RegressionModel(
            cfg.dataset.input_products,
            cfg.dataset.output_products,
            model_type=cfg.model.model_type,
            num_outputs=cfg.model.num_classes,
            loss_name=cfg.model.loss,
        )
    else:
        raise ValueError(f"Unknown model_mode: {cfg.model.model_mode}")

    if name and cfg.model.model_folder:
        return model, load_pretrained_variables(os.path.join(cfg.model.model_folder, name))
    return model


def load_pretrained_variables(folder_or_file: str):
    """The network state_dict of a checkpoint file or folder: a framework
    .npz of either package, a Lightning .ckpt or a torch .pt
    (``models.weights.load_pretrained_state_dict``)."""
    from starcop_tpu_torch.models.weights import load_pretrained_state_dict

    return load_pretrained_state_dict(folder_or_file)
