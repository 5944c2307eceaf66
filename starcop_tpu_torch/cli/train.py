"""Training CLI (counterpart of starcop_tpu/cli/train.py), with the same
override style:

    python -m starcop_tpu_torch.cli.train dataset.root_folder=/data model.lr=1e-4 ...
    python -m starcop_tpu_torch.cli.train config.yaml training.accelerator=cpu ...

Flow: config + overrides -> experiment dir (``experiments/{name}/{time}``
under the working directory, ``config.json``) -> DataModule -> model ->
Trainer (plateau LR, early stopping, ``best.npz``, ``metrics.jsonl``, image
grids) -> ``final_checkpoint_model.npz`` and ``history.json`` ->
``run_validation`` on the test split and on the non-tiled train split
(``test/`` and ``train/``: results.csv, results_agg.json). The files are
the JAX CLI's; the checkpoints are in its npz layout.

``training.accelerator`` picks the device: ``gpu`` (the default) is the
CUDA card, where everything runs with TF32 off (``device.float32_precision``;
``model.dtype=bfloat16`` is the fast route), and ``cpu`` the host. Without a
card the default raises; nothing falls back to the CPU. With
``upload_path`` set, the experiment dir is copied to
``{upload_path}/{experiment_name}/{time}`` through the storage seam
(``utils/storage.put``) at the end, best-effort as in the JAX CLI: a failed
upload is logged and does not fail the run. JAX's persistent compilation
cache has no counterpart.
"""

from __future__ import annotations

import glob
import json
import logging
import os
import sys
import time

import numpy as np


def main(argv=None) -> int:
    run(argv)
    return 0


def run(argv=None):
    """The CLI's work for ``argv``; returns (experiment dir, final
    ``TrainState`` or None when ``model.train`` is false)."""
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    logger = logging.getLogger("starcop_tpu_torch.cli.train")
    argv = sys.argv[1:] if argv is None else argv

    from starcop_tpu_torch.config import Config
    from starcop_tpu_torch.device import float32_precision
    from starcop_tpu_torch.parallel.mesh import broadcast_object, initialize_multihost, make_mesh

    cfg = Config()
    yaml_args = [a for a in argv if a.endswith((".yaml", ".yml"))]
    overrides = [a for a in argv if "=" in a]
    if yaml_args:
        cfg = Config.from_yaml(yaml_args[0])
    cfg.apply_overrides(overrides)
    dev = cfg.training.resolve_device()
    initialize_multihost(device=dev)  # torchrun's world, if launched by it
    mesh = make_mesh(cfg.training.devices or None, dev)

    timestamp = broadcast_object(mesh, time.strftime("%Y-%m-%d_%H-%M"))
    exp_dir = os.path.join("experiments", cfg.experiment_name, timestamp)
    if mesh.lead:
        os.makedirs(exp_dir, exist_ok=True)
        with open(os.path.join(exp_dir, "config.json"), "w") as fh:
            fh.write(cfg.to_json())
    logger.info("experiment dir: %s (device %s, rank %d of %d)", exp_dir, mesh.device,
                mesh.rank, mesh.size)
    with float32_precision():
        state = _train_and_validate(cfg, exp_dir, mesh, logger)
    if cfg.upload_path and mesh.lead:
        # Best-effort, as the JAX CLI's upload: a failure is logged, the run stands.
        from starcop_tpu_torch.utils import storage

        try:
            dest = os.path.join(cfg.upload_path, cfg.experiment_name, timestamp)
            storage.put(exp_dir, dest, recursive=True)
            logger.info("uploaded experiment artifacts to %s", dest)
        except Exception as e:  # noqa: BLE001 - an upload failure must not fail the run
            logger.warning("artifact upload failed: %s", e)
    return exp_dir, state


def _train_and_validate(cfg, exp_dir, mesh, logger):
    import torch

    from starcop_tpu_torch.data.datamodule import BatchLoader, prefetch_to_device
    from starcop_tpu_torch.data.dataset import ChipDataset
    from starcop_tpu_torch.eval.validation import run_validation
    from starcop_tpu_torch.parallel.mesh import broadcast_object
    from starcop_tpu_torch.setup_shims import get_dataset, get_model
    from starcop_tpu_torch.train import Trainer, save_checkpoint
    from starcop_tpu_torch.train.logging import make_logger

    np.random.seed(cfg.seed)
    dm = get_dataset(cfg)
    model = get_model(cfg)
    metric_logger = make_logger(
        exp_dir, wandb_project=cfg.wandb.project if cfg.wandb.entity else "",
        wandb_entity=cfg.wandb.entity, config=cfg.to_dict(),
    ) if mesh.lead else None

    callbacks = []
    if cfg.wandb.images_logging and cfg.products_plot and mesh.lead:
        # Epoch-end image grids on one fixed test batch.
        from starcop_tpu_torch.eval.plot import ImageLogger

        try:
            fixed_batch = next(iter(dm.test_loader(batch_size=min(cfg.plot_samples, 8))))
            callbacks.append(
                ImageLogger(model, fixed_batch, cfg.dataset.input_products,
                            cfg.products_plot, os.path.join(exp_dir, "images"))
            )
        except StopIteration:
            pass

    trainer = Trainer(
        model,
        learning_rate=cfg.model.lr,
        lr_decay=cfg.model.lr_decay,
        lr_patience=cfg.model.lr_patience,
        early_stopping_patience=cfg.model.early_stopping_patience,
        max_epochs=cfg.training.max_epochs,
        val_check_interval=cfg.training.val_check_interval,
        mesh=mesh,
        checkpoint_dir=exp_dir,
        log_every_n_steps=cfg.training.train_log_every_n_steps,
        metric_logger=metric_logger,
        callbacks=callbacks,
    )

    state = None
    if cfg.model.train:
        resume_path = None
        if cfg.resume_from_checkpoint:
            # the newest best / final checkpoint under experiments/{name}, rank 0's pick
            candidates = sorted(
                glob.glob(os.path.join("experiments", cfg.experiment_name, "*", "*.npz")))
            resume_path = broadcast_object(mesh, candidates[-1] if candidates else None)
            if resume_path is not None:
                logger.info("resuming from %s", resume_path)
        state = trainer.fit(
            lambda: dm.train_loader(),
            lambda: dm.test_loader(batch_size=cfg.dataloader.batch_size),
            seed=cfg.seed,
            resume_from=resume_path,
        )
        save_checkpoint(exp_dir, state, name="final_checkpoint_model",
                        extra={"config": cfg.to_dict()}, mesh=mesh)
        if mesh.lead:
            with open(os.path.join(exp_dir, "history.json"), "w") as fh:
                json.dump(trainer.history, fh, indent=2)

    if cfg.model.test and state is not None and mesh.lead:
        dev = mesh.device
        model.eval()
        with torch.inference_mode():
            _, metrics = run_validation(
                model.batch_with_preds,
                prefetch_to_device(iter(dm.test_loader()), device=dev),
                path_save_results=os.path.join(exp_dir, "test"),
            )
            logger.info("test F1 %.4f", metrics.get("f1score", float("nan")))

            # The non-tiled train split too, as the reference does.
            train_full = ChipDataset(
                dm.train_rows, dm.input_products, dm.output_products, dm.weight_loss_product
            )
            _, metrics_train = run_validation(
                model.batch_with_preds,
                prefetch_to_device(iter(BatchLoader(train_full, batch_size=1)), device=dev),
                path_save_results=os.path.join(exp_dir, "train"),
            )
            logger.info("train F1 %.4f", metrics_train.get("f1score", float("nan")))
    return state


if __name__ == "__main__":
    sys.exit(main())
