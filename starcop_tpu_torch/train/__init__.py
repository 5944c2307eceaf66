"""Training: the train step, schedules, early stopping, checkpoints
(counterpart of starcop_tpu/train)."""

from starcop_tpu_torch.train.loop import (  # noqa: F401
    EarlyStopping,
    ReduceLROnPlateau,
    Trainer,
    TrainState,
    create_train_state,
)
from starcop_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint  # noqa: F401
