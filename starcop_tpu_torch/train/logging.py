"""Experiment metric logging (a copy of starcop_tpu/train/logging.py).

A small logger protocol with two backends: ``JSONLLogger`` (always
available; one JSON object per step or validation event) and
``WandbLogger`` (when the wandb package imports; the project / entity of
the config). Trainer callbacks receive scalars and image paths.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


class JSONLLogger:
    """Append-only metrics log: {ts, step, **scalars} per line."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path

    def log(self, scalars: Dict[str, Any], step: Optional[int] = None):
        record = {"ts": time.time()}
        if step is not None:
            record["step"] = int(step)
        record.update({k: (float(v) if hasattr(v, "__float__") else v) for k, v in scalars.items()})
        with open(self.path, "a") as fh:
            fh.write(json.dumps(record) + "\n")

    def log_image(self, name: str, path: str, step: Optional[int] = None):
        self.log({"image": name, "path": path}, step=step)

    def finish(self):
        pass


class WandbLogger:
    """wandb backend (import-gated); same .log protocol."""

    def __init__(self, project: str = "starcop", entity: str = "", config: Optional[Dict] = None):
        import wandb  # raises ImportError when unavailable

        self._run = wandb.init(project=project, entity=entity or None, config=config or {})
        self._wandb = wandb

    def log(self, scalars: Dict[str, Any], step: Optional[int] = None):
        self._run.log(scalars, step=step)

    def log_image(self, name: str, path: str, step: Optional[int] = None):
        self._run.log({name: self._wandb.Image(path)}, step=step)

    def finish(self):
        self._run.finish()


def make_logger(out_dir: str, wandb_project: str = "", wandb_entity: str = "", config=None):
    """wandb when importable + configured, JSONL otherwise."""
    if wandb_project:
        try:
            return WandbLogger(wandb_project, wandb_entity, config)
        except ImportError:
            pass
    return JSONLLogger(os.path.join(out_dir, "metrics.jsonl"))
