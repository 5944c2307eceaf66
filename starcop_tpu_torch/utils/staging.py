"""Host arrays to the card through a reused ring of pinned buffers.

``torch.as_tensor(a, device="cuda")`` on caller-owned (pageable) numpy has
CUDA bounce the copy through its own small staging buffers, and the host
waits for all of it. ``stage_to_device`` instead splits the array
along its leading axis into row bands of at most ``BAND_BYTES`` as float32,
fills a slot of a ring of ``RING_SLOTS`` pinned buffers with band i (torch's
CPU copy, which casts to float32 and gathers a strided view in the same
pass) and enqueues the slot's copy to the device on the current stream. The
host copy of band i+1 then overlaps the DMA of band i. Each slot records an
event after its copy, and a slot is written again only once that event has
completed, so a pinned buffer always outlives the copy that reads it. The
stream orders the device tensor before later work; the host does not wait
on the last band.

A ring belongs to one device and one thread; it is pinned at its first use
and kept for every later call. Nothing of the caller's array is kept: every
call reads all its bytes.
"""

from __future__ import annotations

import math
import threading
from typing import List, Optional, Tuple

import numpy as np
import torch

from starcop_tpu_torch.utils.profiling import count

STAGE_MIN_BYTES = 8 << 20  # float32 size from which a host array is staged
BAND_BYTES = 16 << 20  # a pinned slot, and the most bytes of a band
RING_SLOTS = 3


def plan_bands(shape) -> List[Tuple[int, int]]:
    """The [start, stop) row ranges of the leading axis of a float32 array
    of ``shape``, in order: as many rows a band as fit in ``BAND_BYTES`` (at
    least one), the last band ragged."""
    n = shape[0]
    row = 4 * math.prod(shape[1:])
    step = max(1, BAND_BYTES // row) if row else max(1, n)
    return [(i, min(i + step, n)) for i in range(0, n, step)]


def staged_source(a, dev: torch.device) -> Optional[torch.Tensor]:
    """``a`` as a CPU tensor sharing its memory when ``stage_to_device``
    stages it: a numpy array or CPU tensor bound for a CUDA device, of at
    least ``STAGE_MIN_BYTES`` as float32, whose rows each fit a band. None
    for everything else (a device tensor, the CPU device, a small array, an
    array torch cannot wrap), which ``torch.as_tensor`` moves."""
    if dev.type != "cuda":
        return None
    if isinstance(a, np.ndarray):
        try:
            t = torch.from_numpy(a)
        except (TypeError, ValueError):  # a dtype, byte order or stride torch does not take
            return None
    elif isinstance(a, torch.Tensor) and a.device.type == "cpu":
        t = a
    else:
        return None
    if t.dim() == 0 or 4 * t.numel() < STAGE_MIN_BYTES or 4 * t[0].numel() > BAND_BYTES:
        return None
    return t


class _Ring:
    """``RING_SLOTS`` pinned float32 buffers of ``BAND_BYTES``, each with the
    event recorded after the last copy that read it, handed out in turn."""

    def __init__(self):
        # Normal tensors, not inference tensors: a caller outside
        # inference mode may fill them too.
        with torch.inference_mode(False):
            self.slots = [(torch.empty(BAND_BYTES // 4, dtype=torch.float32, pin_memory=True),
                           torch.cuda.Event()) for _ in range(RING_SLOTS)]
        self.turn = 0

    def take(self) -> Tuple[torch.Tensor, torch.cuda.Event]:
        """The next slot, once the copy that last read it has finished (an
        event never recorded returns at once)."""
        buf, done = self.slots[self.turn]
        self.turn = (self.turn + 1) % RING_SLOTS
        done.synchronize()
        return buf, done


class _Rings(threading.local):
    def __init__(self):
        self.by_device = {}


_rings = _Rings()


def _ring(dev: torch.device) -> _Ring:
    index = torch.cuda.current_device() if dev.index is None else dev.index
    ring = _rings.by_device.get(index)
    if ring is None:
        ring = _rings.by_device[index] = _Ring()
    return ring


def stage_to_device(a, dev: torch.device) -> torch.Tensor:
    """``a`` on ``dev`` as float32, equal to ``torch.as_tensor(a,
    dtype=torch.float32, device=dev)``. Where ``staged_source`` takes ``a``,
    a new contiguous tensor filled band by band through this thread's ring,
    and the bytes read from ``a`` are added to counter ``staged_bytes`` of
    the innermost open span (``utils.profiling.count``); otherwise
    ``torch.as_tensor``'s result."""
    src = staged_source(a, dev)
    if src is None:
        return torch.as_tensor(a, dtype=torch.float32, device=dev)
    out = torch.empty(src.shape, dtype=torch.float32, device=dev)
    ring, stream = _ring(dev), torch.cuda.current_stream(dev)
    row = math.prod(src.shape[1:])
    for start, stop in plan_bands(src.shape):
        buf, done = ring.take()
        band = buf[: (stop - start) * row].view(stop - start, *src.shape[1:])
        band.copy_(src[start:stop])
        out[start:stop].copy_(band, non_blocking=True)
        done.record(stream)
    count("staged_bytes", src.nbytes)
    return out
