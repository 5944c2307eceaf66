"""Training loop on one card (counterpart of starcop_tpu/train/loop.py).

  * ``train_step``: forward in training mode (batch norm on batch
    statistics, Flax's running update: ``models.layers.BatchNorm2d``), the
    weighted BCE with pos_weight and the per-pixel weight (the mean of loss
    x weight), backward, and one Adam step (lr 1e-4 by default; fused on
    the card). The plateau schedule's learning rate is written into the
    parameter group before each step, as ``optax.inject_hyperparams`` lets
    JAX change it without recompiling.
  * ``eval_step``: the loss, the pixel confusion matrix of ``logits >= 0``
    (sigmoid(z) >= 0.5; ``batch_with_preds`` thresholds ``> 0.5``, which
    differs at a logit of exactly 0) and the tile-classification matrix
    of the 10-pixel rule, on the device; a validation sums them in int64
    on the host, once.
  * ``ReduceLROnPlateau`` (factor 0.5, patience 4) and ``EarlyStopping``
    (patience 8) on val_loss, copied with JAX's semantics: an improvement
    is any decrease (torch's scheduler needs a relative 1e-4), and the
    count resets after a reduction.
  * best-on-val_loss checkpoints and the metric logger and callbacks.
  * data parallelism over a ``parallel.Mesh`` (one process per device,
    launched by torchrun or ``parallel.run_world``), with the global-batch
    semantics of JAX's sharded ``jit``: each rank steps on its contiguous
    shard of every global batch, batch norm normalises with the global
    statistics and dropout keeps the rank's rows of the global mask
    (``models.layers.set_data_parallel``), and one ``all_reduce`` averages
    the gradients (equal shards: the global batch's gradient) and the loss,
    so every rank takes the same Adam step and the parameters stay
    bitwise equal. Validation averages the loss and sums the confusion
    matrices over the ranks, so every rank sees the same val_loss and the
    plateau, early stopping and best-checkpoint choices agree; rank 0 alone
    writes checkpoints and logs.

Initialisation follows Flax's distributions (``models.layers.init_like_flax``)
from an explicit ``torch.Generator`` seeded by ``seed``; the random streams
differ from JAX's, so a state carried from JAX (``train.checkpoint``) is
what makes the two runs comparable. ``UNetDropout``'s masks come from a
generator seeded from (seed, step): an intended deviation, since JAX folds
the step into ``PRNGKey(0)``.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Dict, Iterable, Optional

import numpy as np
import torch

from starcop_tpu_torch.data.datamodule import prefetch_to_device
from starcop_tpu_torch.device import DeviceLike, float32_precision, resolve_device
from starcop_tpu_torch.eval import metrics as sm
from starcop_tpu_torch.models.layers import set_data_parallel
from starcop_tpu_torch.models.segmenter import SegmentationModel, pred_classification
from starcop_tpu_torch.parallel.mesh import (
    Mesh,
    all_reduce_,
    average_,
    make_mesh,
    mesh_device,
    replicate,
)

logger = logging.getLogger("starcop_tpu_torch.train")


@dataclasses.dataclass
class TrainState:
    """The model (its parameters and batch-norm statistics), the Adam over
    its parameters, and the number of steps taken."""

    model: SegmentationModel
    optimizer: torch.optim.Optimizer
    step: int = 0


@dataclasses.dataclass
class ReduceLROnPlateau:
    """min-mode plateau scheduler (torch semantics: factor, patience)."""

    factor: float = 0.5
    patience: int = 4
    best: float = float("inf")
    num_bad: int = 0
    scale: float = 1.0

    def update(self, metric: float) -> float:
        if metric < self.best:
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.scale *= self.factor
                self.num_bad = 0
                logger.info("ReduceLROnPlateau: scaling lr by %.3g -> x%.3g", self.factor, self.scale)
        return self.scale


@dataclasses.dataclass
class EarlyStopping:
    """min-mode early stopping on the monitored metric."""

    patience: int = 8
    best: float = float("inf")
    num_bad: int = 0
    should_stop: bool = False

    def update(self, metric: float) -> bool:
        if metric < self.best:
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.should_stop = True
        return self.should_stop


# optax.adam's b1, b2 and eps (outside the root) as inject_hyperparams holds
# them, in float32: 1 - b2 is then 0.99998712e-3, as in JAX, not 1e-3.
ADAM_B1, ADAM_B2, ADAM_EPS = (float(np.float32(v)) for v in (0.9, 0.999, 1e-8))


def make_adam(model: SegmentationModel, learning_rate: float) -> torch.optim.Adam:
    """``optax.inject_hyperparams(optax.adam)`` over the network's
    parameters, as torch's Adam (fused on the card)."""
    params = list(model.network.parameters())
    return torch.optim.Adam(params, lr=learning_rate, betas=(ADAM_B1, ADAM_B2), eps=ADAM_EPS,
                            fused=params[0].is_cuda)


def create_train_state(model: SegmentationModel, seed: int = 0, learning_rate: float = 1e-4,
                       device: DeviceLike = None) -> TrainState:
    """Initialise ``model`` as Flax would (``SegmentationModel.init``, drawn
    on the host from ``torch.Generator().manual_seed(seed)``, so the state
    is the same on the card and the CPU), move it to ``device`` (None: the
    card) and give it an Adam at ``learning_rate``."""
    dev = resolve_device(device)
    model.init(torch.Generator().manual_seed(seed)).to(dev)
    return TrainState(model, make_adam(model, learning_rate), 0)


def dropout_generator(seed: int, step: int, device: torch.device) -> torch.Generator:
    """The generator of a training step's dropout masks, from (seed, step)."""
    return torch.Generator(device).manual_seed((seed << 32) + step)


def make_train_step(model: SegmentationModel, seed: int = 0, mesh: Optional[Mesh] = None) -> Callable:
    """``train_step(state, batch, lr) -> (state, loss)``: one Adam step at
    learning rate ``lr`` on a batch already on the device. The state is
    updated in place; the loss stays on the device (no host sync). With a
    ``mesh`` of several ranks the batch is the rank's shard of the global
    batch, and the step and the loss returned are the global batch's (the
    network's batch norms and dropout are set to the global batch,
    ``models.layers.set_data_parallel``)."""
    needs_generator = getattr(model.network, "dropout_rate", 0.0) > 0
    parallel = mesh is not None and mesh.size > 1
    if mesh is not None:
        set_data_parallel(model.network, mesh)

    def train_step(state: TrainState, batch: Dict[str, Any], lr: float):
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        model.train()
        x = batch["input"]
        gen = dropout_generator(seed, state.step, x.device) if needs_generator else None
        logits = model(x, generator=gen)
        loss = model.loss_fn(logits, batch["output"], batch.get("weight_loss"))
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        loss = loss.detach()
        if parallel:
            grads = [p.grad for p in model.network.parameters() if p.grad is not None]
            average_(mesh, grads + [loss.view(1)])
        state.optimizer.step()
        state.step += 1
        return state, loss

    return train_step


def make_eval_step(model: SegmentationModel) -> Callable:
    """``eval_step(state, batch) -> (loss, cm, cm_cls)`` on the device: the
    loss, the pixel confusion matrix of ``logits >= 0`` and the tile
    classification's (int64)."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Dict[str, Any]):
        model.eval()
        logits = model(batch["input"])
        loss = model.loss_fn(logits, batch["output"], batch.get("weight_loss"))
        y = model.normalizer.normalize_y(batch["output"]).to(torch.int32)
        pred_binary = (logits >= 0).to(torch.int32)  # sigmoid(z) >= .5 <=> z >= 0
        cm = sm.confusion_matrix(pred_binary, y)
        tile_pred = pred_classification(pred_binary)[:, 0]
        cm_cls = sm.confusion_matrix(tile_pred, batch["has_plume"].to(torch.int32))
        return loss, cm, cm_cls

    return eval_step


class Trainer:
    """Epoch loop with plateau LR, early stopping and best-checkpoint
    retention. Batches reach it through ``prefetch_to_device``.

    It trains over ``mesh`` (a ``parallel.Mesh``) or else over
    ``make_mesh(n_devices, device)``: ``n_devices`` None is the launched
    world (one process when none was launched), another size than the
    world's raises. Outside a launched world that is one device (None:
    the card). Every rank reads the same global batches and keeps its rows.
    """

    def __init__(
        self,
        model: SegmentationModel,
        learning_rate: float = 1e-4,
        lr_decay: float = 0.5,
        lr_patience: int = 4,
        early_stopping_patience: int = 8,
        max_epochs: int = 15,
        val_check_interval: float = 0.5,
        n_devices: Optional[int] = None,
        mesh=None,
        checkpoint_dir: Optional[str] = None,
        log_every_n_steps: int = 10,
        callbacks: Iterable[Any] = (),
        metric_logger=None,
        device: DeviceLike = None,
    ):
        if mesh is None:
            mesh = make_mesh(n_devices, device)
        elif not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a parallel.Mesh, got {type(mesh).__name__}")
        self.mesh = mesh
        self.model = model
        self.device = mesh_device(mesh, device)
        self.learning_rate = learning_rate
        self.scheduler = ReduceLROnPlateau(factor=lr_decay, patience=lr_patience)
        self.early_stopping = EarlyStopping(patience=early_stopping_patience)
        self.max_epochs = max_epochs
        self.val_check_interval = val_check_interval
        self.checkpoint_dir = checkpoint_dir
        self.log_every_n_steps = log_every_n_steps
        self.callbacks = list(callbacks)
        self.metric_logger = metric_logger
        self.history: list = []
        self.best_val_loss = float("inf")
        self._train_step = None
        self._eval_step = None

    # ------------------------------------------------------------------
    def fit(
        self,
        train_batches: Callable[[], Iterable[Dict[str, np.ndarray]]],
        val_batches: Callable[[], Iterable[Dict[str, np.ndarray]]],
        seed: int = 0,
        state: Optional[TrainState] = None,
        resume_from: Optional[str] = None,
    ) -> TrainState:
        """Train from a fresh state initialised from ``seed`` (then loaded
        from ``resume_from`` if given: read by rank 0 and broadcast), or from
        ``state``, whose model must be this trainer's and on its device.
        ``seed`` also seeds dropout. Every rank starts from rank 0's
        parameters."""
        with float32_precision():
            return self._fit(train_batches, val_batches, seed, state, resume_from)

    def _fit(self, train_batches, val_batches, seed, state, resume_from) -> TrainState:
        if state is None:
            state = create_train_state(self.model, seed, self.learning_rate, self.device)
            if resume_from is not None:
                from starcop_tpu_torch.train.checkpoint import load_checkpoint

                state = load_checkpoint(resume_from, state, mesh=self.mesh)
                logger.info("resumed from %s at step %d", resume_from, state.step)
        elif state.model is not self.model:
            raise ValueError("the state's model must be the trainer's")
        replicate(self.mesh, self.model.network)
        self._train_step = make_train_step(self.model, seed, self.mesh)
        self._eval_step = make_eval_step(self.model)

        base_lr = self.learning_rate
        for epoch in range(self.max_epochs):
            t0 = time.time()
            losses = []
            batches = train_batches()
            # Mid-epoch validation points need the epoch length; loaders expose
            # len(). Unsized iterables validate at epoch end only.
            val_points = max(1, int(round(1.0 / max(self.val_check_interval, 1e-6))))
            try:
                n_batches = len(batches)  # type: ignore[arg-type]
            except TypeError:
                n_batches = None
            if n_batches:
                val_at = {
                    int((i + 1) * n_batches / val_points) - 1 for i in range(val_points)
                }
            else:
                val_at = set()
            last_i = -1
            for i, batch in enumerate(prefetch_to_device(iter(batches), mesh=self.mesh)):
                last_i = i
                state, loss = self._train_step(state, batch, base_lr * self.scheduler.scale)
                losses.append(loss)
                if i % self.log_every_n_steps == 0:
                    logger.info("epoch %d step %d loss %.5f", epoch, i, float(loss))
                    if self.metric_logger is not None and self.mesh.lead:
                        self.metric_logger.log({"train_loss": float(loss), "epoch": epoch},
                                               step=state.step)
                if i in val_at:
                    val_metrics = self.validate(state, val_batches)
                    self._on_validation(state, epoch, val_metrics)
                    if self.early_stopping.should_stop:
                        logger.info("Early stopping at epoch %d", epoch)
                        return state
            if not val_at and last_i >= 0:
                # Unsized epoch: validate once at epoch end.
                val_metrics = self.validate(state, val_batches)
                self._on_validation(state, epoch, val_metrics)
                if self.early_stopping.should_stop:
                    logger.info("Early stopping at epoch %d", epoch)
                    return state
            epoch_loss = float(torch.stack(losses).mean())
            logger.info("epoch %d done: train_loss %.5f (%.1fs)", epoch, epoch_loss, time.time() - t0)
            for cb in self.callbacks if self.mesh.lead else ():
                if hasattr(cb, "on_epoch_end"):
                    cb.on_epoch_end(self, state, epoch)
        return state

    # ------------------------------------------------------------------
    def validate(self, state: TrainState, val_batches) -> Dict[str, float]:
        """val_loss (the mean of the global batches' losses) and every
        confusion-matrix metric of the pixels and of the tiles. The
        per-batch results stay on the device; over a mesh the ranks' loss
        sums are averaged and their matrices summed (int64) by all_reduce,
        and the totals come home in one copy."""
        losses, cms, cms_cls = [], [], []
        with float32_precision():
            for batch in prefetch_to_device(iter(val_batches()), mesh=self.mesh):
                loss, cm_i, cm_cls_i = self._eval_step(state, batch)
                losses.append(loss)
                cms.append(cm_i)
                cms_cls.append(cm_cls_i)
        n = len(losses)
        dev = self.mesh.device
        total_loss = (torch.stack(losses).sum() if n
                      else torch.zeros((), dtype=torch.float64, device=dev))
        counts = torch.cat([torch.stack(cms).sum(0, dtype=torch.int64).reshape(-1),
                            torch.stack(cms_cls).sum(0, dtype=torch.int64).reshape(-1)]) \
            if n else torch.zeros(8, dtype=torch.int64, device=dev)
        all_reduce_(self.mesh, total_loss)
        all_reduce_(self.mesh, counts)
        counts = counts.cpu().numpy()
        cm, cm_cls = counts[:4].reshape(2, 2), counts[4:].reshape(2, 2)
        out = {"val_loss": float(total_loss) / self.mesh.size / max(n, 1)}
        for fun in sm.METRICS_CONFUSION_MATRIX:
            out[f"val_{fun.__name__}"] = float(fun(cm))
            out[f"val_classification_{fun.__name__}"] = float(fun(cm_cls))
        return out

    def _on_validation(self, state: TrainState, epoch: int, metrics: Dict[str, float]):
        self.history.append({"epoch": epoch, **metrics})
        val_loss = metrics["val_loss"]
        logger.info("val: %s", {k: round(v, 4) for k, v in metrics.items()})
        if self.metric_logger is not None and self.mesh.lead:
            self.metric_logger.log(metrics)
        self.scheduler.update(val_loss)
        self.early_stopping.update(val_loss)
        if val_loss < self.best_val_loss:
            self.best_val_loss = val_loss
            if self.checkpoint_dir is not None:
                from starcop_tpu_torch.train.checkpoint import save_checkpoint

                save_checkpoint(self.checkpoint_dir, state, name="best", mesh=self.mesh)
                logger.info("saved best checkpoint (val_loss %.5f)", val_loss)
