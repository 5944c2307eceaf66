"""Host arrays to the card through reused pinned buffers: the one upload
mechanism of the entry, the serving reader and the batch prefetch.

``PinnedRing`` holds pinned host buffers of one shape and dtype, handed out
in turn; a buffer is written again only once the event recorded after the
copy that last read it has completed. A buffer is filled by torch's CPU
copy, or, in the batch prefetch, read into by the chip loader itself
(``data.datamodule.BatchIterator.slot``). ``upload`` and ``hand_over`` move a
dict of host arrays on a side stream (``serve.pipeline.Uploader``,
``data.datamodule.prefetch_to_device``); an array that already is a buffer
of its ring is copied to the device from where it lies.

``stage_to_device`` moves one large array on the current stream (the
entry's granule upload). ``torch.as_tensor(a, device="cuda")`` on
caller-owned (pageable) numpy has CUDA bounce the copy through its own
small staging buffers, and the host waits for all of it. Instead the array
is split along its leading axis into row bands of at most ``BAND_BYTES`` as
float32; band i fills the next of a ring of ``RING_SLOTS`` pinned buffers
(the CPU copy casts to float32 and gathers a strided view in the same pass)
and the buffer's copy to the device is enqueued, so the host copy of band
i+1 overlaps the DMA of band i. The stream orders the tensor before later
work; the host does not wait on the last band.
That ring belongs to one device and one thread, pinned at its first use.
Nothing of the caller's array is kept: every call reads all its bytes.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional, Tuple

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


class PinnedRing:
    """``slots`` host buffers of one shape and dtype, pinned wherever torch
    has a card, handed out in turn. Each slot is a [buffer, event] pair,
    the event recorded after the last copy that read the buffer (None
    before the first); a buffer is written again only once that event has
    completed, so it always outlives the copy that reads it."""

    def __init__(self, shape, dtype: torch.dtype, slots: int):
        # Normal tensors, not inference tensors: a caller outside
        # inference mode may fill them too.
        with torch.inference_mode(False):
            self.slots = [[torch.empty(shape, dtype=dtype, pin_memory=torch.cuda.is_available()),
                           None] for _ in range(slots)]
        self.turn = 0

    def take(self) -> list:
        """The next [buffer, event] slot, once the copy that last read it has
        finished. The caller sets the slot's event after its own copy."""
        slot = self.slots[self.turn]
        self.turn = (self.turn + 1) % len(self.slots)
        if slot[1] is not None:
            slot[1].synchronize()
        return slot

    def holding(self, t: torch.Tensor) -> Optional[list]:
        """The slot whose buffer ``t`` is (taken and written by the caller),
        or None."""
        return next((s for s in self.slots if s[0].data_ptr() == t.data_ptr()), None)


def upload(host: Dict[str, torch.Tensor], dev: torch.device, stream, rings: Dict,
           slots: int) -> Tuple[Dict[str, torch.Tensor], torch.cuda.Event]:
    """The CPU tensors ``host`` on ``dev``, copied on the side ``stream``
    through pinned buffers. Each array fills the next buffer of its ring in
    ``rings`` (one per (name, shape, dtype), of ``slots`` buffers, made at
    its first use) with torch's CPU copy, unless it already is one of that
    ring's buffers (``PinnedRing.holding``: taken and written by the
    caller), and a non-blocking copy from the buffer is enqueued. One event
    recorded after all the copies becomes every used buffer's event.
    Returns the device tensors and that event, which the consumer's stream
    waits on (``hand_over``) before it reads them.

    Keying by name matters: two arrays of one call can share shape and
    dtype (a wire's ``q_lo`` and ``q_scale``), and a ring keyed by shape
    alone would fill the second over the first while its copy is queued."""
    used, out = [], {}
    with torch.cuda.stream(stream):
        for k, t in host.items():
            key = (k, tuple(t.shape), t.dtype)
            if key not in rings:
                rings[key] = PinnedRing(t.shape, t.dtype, slots)
            slot = rings[key].holding(t)
            if slot is None:
                slot = rings[key].take()
                slot[0].copy_(t)
            out[k] = slot[0].to(dev, non_blocking=True)
            used.append(slot)
        ready = torch.cuda.Event()
        ready.record(stream)
    for slot in used:
        slot[1] = ready
    return out, ready


def hand_over(tensors: Dict[str, torch.Tensor], ready: torch.cuda.Event, stream) -> None:
    """Make ``stream`` wait for ``ready`` before it reads ``tensors`` (an
    ``upload``'s result), and keep their device memory from being reused
    before ``stream``'s work on them has run."""
    stream.wait_event(ready)
    for t in tensors.values():
        t.record_stream(stream)


class _Rings(threading.local):
    def __init__(self):
        self.by_device = {}


_rings = _Rings()


def _ring(dev: torch.device) -> PinnedRing:
    """This thread's ring of ``RING_SLOTS`` float32 bands for ``dev``."""
    index = torch.cuda.current_device() if dev.index is None else dev.index
    ring = _rings.by_device.get(index)
    if ring is None:
        ring = _rings.by_device[index] = PinnedRing(BAND_BYTES // 4, torch.float32, RING_SLOTS)
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
        slot = ring.take()
        band = slot[0][: (stop - start) * row].view(stop - start, *src.shape[1:])
        band.copy_(src[start:stop])
        out[start:stop].copy_(band, non_blocking=True)
        slot[1] = torch.cuda.Event()
        slot[1].record(stream)
    count("staged_bytes", src.nbytes)
    return out
