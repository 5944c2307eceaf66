"""Profiling and tracing hooks (counterpart of starcop_tpu/utils/profiling.py).

``trace`` is a context manager around ``torch.profiler`` (the host and,
where there is one, the CUDA card) that writes a Chrome trace, viewable in
Perfetto or ``chrome://tracing``, into a directory; ``StageTimer`` takes
named host-clock stages with the device synchronised at their edges.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Dict

import torch

from starcop_tpu_torch.device import DeviceLike, resolve_device

logger = logging.getLogger("starcop_tpu_torch.profiling")


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler trace scope: ``with trace('/tmp/trace'): step()``
    writes ``log_dir/trace_{pid}.json``."""
    from torch.profiler import profile, supported_activities

    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=supported_activities())
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        path = os.path.join(log_dir, f"trace_{os.getpid()}.json")
        prof.export_chrome_trace(path)
        logger.info("profiler trace written to %s", path)


class StageTimer:
    """Named stage timing on the host's clock, with ``torch.cuda.synchronize``
    at the stage edges when ``sync`` (``device`` None is the card and raises
    without one; on ``"cpu"`` there is nothing to wait for).

    Example:
        timer = StageTimer()
        with timer.stage("mag1c"):
            mf = run_filter(...)
        timer.report()
    """

    def __init__(self, sync: bool = True, device: DeviceLike = None):
        self.sync = sync
        self.device = resolve_device(device)
        self.times: Dict[str, float] = {}

    def _sync(self):
        if self.sync and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def stage(self, name: str):
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            self.times[name] = self.times.get(name, 0.0) + time.perf_counter() - t0

    def report(self, log=True) -> Dict[str, float]:
        if log:
            for name, t in self.times.items():
                logger.info("stage %-20s %8.3fs", name, t)
        return dict(self.times)
