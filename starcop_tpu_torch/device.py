"""Device resolution and the float32 precision policy of the port.

``device=None`` means the CUDA card. Without a card the entry points raise
unless the caller asks for the CPU (``device="cpu"``, as the tests do): there
is no silent CPU fallback.

The matched filter's statistics and the U-Net's convolutions run in full
float32. TF32 (on by default for cuDNN convolutions) keeps ~3 decimal digits,
and the JAX package records that one reduced-precision pass broke detection
(starcop_tpu/ops/mag1c_pallas.py:1036-1045, :1195-1202), so the entry points
turn it off while they run.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator, Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device on a host without one raises."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain torch path"
        )
    return dev


# The TF32 switches are process-wide, and the serving pipeline enters the
# block from several worker threads at once: the first entry saves and turns
# them off, the last exit restores them.
_PRECISION_LOCK = threading.Lock()
_precision = {"depth": 0, "saved": None}


@contextlib.contextmanager
def float32_precision() -> Iterator[None]:
    """Turn TF32 off for matmuls and cuDNN convolutions inside the block
    (thread-safe; blocks may nest or overlap across threads)."""
    with _PRECISION_LOCK:
        if _precision["depth"] == 0:
            _precision["saved"] = (torch.backends.cuda.matmul.allow_tf32,
                                   torch.backends.cudnn.allow_tf32)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        _precision["depth"] += 1
    try:
        yield
    finally:
        with _PRECISION_LOCK:
            _precision["depth"] -= 1
            if _precision["depth"] == 0:
                (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32) = _precision["saved"]
