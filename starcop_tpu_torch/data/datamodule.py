"""Tiling, weighted sampling, batch iteration and the host-to-device feed
(counterpart of starcop_tpu/data/datamodule.py):

  * ``tile_rows``: 512 x 512 index rows -> training windows with their
    plume fraction and the has_plume > 10 / 64^2 rule;
  * ``sample_weights``: balanced plume / background sampling weights;
  * ``BatchLoader``: batches of the (B, C, H, W) dict protocol, sequential,
    shuffled or weighted with replacement, chip reads on a thread pool;
  * ``prefetch_to_device``: pinned host buffers and a side stream, so the
    next batches' copies overlap the current batch's compute.

Everything but ``prefetch_to_device`` is numpy and gives the JAX package's
rows, weights and batches for the same seed.
"""

from __future__ import annotations

import collections
import concurrent.futures
from typing import Dict, Iterator, List, Sequence

import numpy as np
import torch

from starcop_tpu_torch.data.dataset import ChipDataset, _read_product
from starcop_tpu_torch.device import DeviceLike, resolve_device


def sliding_window_offsets(height: int, width: int, size: int = 512, overlap: int = 256):
    """Top-left offsets of sliding windows (stride = size - overlap); the
    tail window is added only where it fits, so a raster smaller than the
    window gives the one offset (0, 0)."""
    stride = size - overlap
    rows = list(range(0, max(height - size, 0) + 1, stride))
    cols = list(range(0, max(width - size, 0) + 1, stride))
    if rows and rows[-1] + size < height:
        rows.append(height - size)
    if cols and cols[-1] + size < width:
        cols.append(width - size)
    return [(r, c) for r in (rows or [0]) for c in (cols or [0])]


def create_windows(height: int, width: int, size: int, overlap: int) -> List[Dict[str, int]]:
    """Sliding windows covering (height, width) with the given overlap."""
    return [
        {"window_row_off": r, "window_col_off": c, "window_width": size, "window_height": size}
        for r, c in sliding_window_offsets(height, width, size, overlap)
    ]


def tile_rows(
    rows: Sequence[Dict],
    training_size: int = 128,
    overlap: int = 64,
    label_product: str = "labelbinary",
) -> List[Dict]:
    """Expand chip rows into training-window rows with plume statistics:
    frac_positives = mean(label), has_plume = frac > 10 / 64^2."""
    out = []
    threshold_frac = 10.0 / (64.0**2)
    for row in rows:
        base_c = row.get("window_col_off", 0)
        base_r = row.get("window_row_off", 0)
        h = row.get("window_height", 512)
        w = row.get("window_width", 512)
        label = _read_product(row["folder"], label_product, (base_c, base_r, w, h))
        for win in create_windows(h, w, training_size, overlap):
            sub = label[
                win["window_row_off"]:win["window_row_off"] + training_size,
                win["window_col_off"]:win["window_col_off"] + training_size,
            ]
            frac = float(sub.mean())
            new_row = dict(row)
            new_row.update(
                window_col_off=base_c + win["window_col_off"],
                window_row_off=base_r + win["window_row_off"],
                window_width=training_size,
                window_height=training_size,
                frac_positives=frac,
                has_plume=frac > threshold_frac,
                id=f"{row.get('id', '')}_r{win['window_row_off']}_c{win['window_col_off']}",
            )
            out.append(new_row)
    return out


def sample_weights(rows: Sequence[Dict]) -> np.ndarray:
    """Balanced sampling weights: plume tiles 1 / plume_fraction, background
    tiles 1 / (1 - plume_fraction)."""
    has_plume = np.asarray([bool(r.get("has_plume", False)) for r in rows])
    plume_fraction = max(float(has_plume.mean()), 1e-9)
    return np.where(has_plume, 1.0 / plume_fraction, 1.0 / max(1.0 - plume_fraction, 1e-9))


class BatchLoader:
    """Batches a ChipDataset into the (B, C, H, W) dict protocol.

    ``weighted=True`` draws indices with replacement in proportion to
    ``sample_weights``; ``shuffle`` permutes them; otherwise they run in
    order (eval). ``num_workers > 0`` reads chips on a thread pool (np.load
    releases the GIL), at most 2 x num_workers batches ahead.
    """

    def __init__(
        self,
        dataset: ChipDataset,
        batch_size: int = 32,
        weighted: bool = False,
        shuffle: bool = False,
        drop_last: bool = False,
        seed: int = 0,
        num_workers: int = 0,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.weighted = weighted
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = num_workers
        self._rng = np.random.default_rng(seed)

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        if self.weighted:
            w = sample_weights(self.dataset.rows)
            return self._rng.choice(n, size=n, replace=True, p=w / w.sum())
        idx = np.arange(n)
        if self.shuffle:
            self._rng.shuffle(idx)
        return idx

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[Dict]:
        idx = self._indices()
        batches = [idx[i:i + self.batch_size] for i in range(0, len(idx), self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]
        if self.num_workers > 0:
            window = 2 * self.num_workers
            with concurrent.futures.ThreadPoolExecutor(self.num_workers) as pool:
                inflight = collections.deque()
                for b in batches:
                    inflight.append(pool.submit(self._collate, b))
                    if len(inflight) > window:
                        yield inflight.popleft().result()
                while inflight:
                    yield inflight.popleft().result()
        else:
            for b in batches:
                yield self._collate(b)

    def _collate(self, indices: np.ndarray) -> Dict:
        samples = [self.dataset[int(i)] for i in indices]
        batch: Dict = {}
        for key in samples[0]:
            vals = [s[key] for s in samples]
            if isinstance(vals[0], np.ndarray):
                batch[key] = np.stack(vals)
            elif isinstance(vals[0], (int, float, bool, np.floating)):
                batch[key] = np.asarray(vals, np.float32)
            else:
                batch[key] = vals
        return batch


def _numeric(v):
    """``v`` as a numeric numpy array, or None (ids, strings, bool flags
    pass through as the JAX package's feed passes them)."""
    if isinstance(v, torch.Tensor):
        return None
    arr = np.asarray(v)
    return arr if np.issubdtype(arr.dtype, np.number) else None


class _PinnedRing:
    """Pinned host buffers for one (key, shape, dtype), reused in turn. A
    buffer is refilled only after the event recorded behind its last copy
    has completed: a copy still queued on the side stream would otherwise
    read the next batch's values."""

    def __init__(self, shape, dtype: torch.dtype, slots: int):
        self.buffers = [torch.empty(shape, dtype=dtype, pin_memory=True) for _ in range(slots)]
        self.events: List = [None] * slots
        self.next = 0

    def fill(self, arr: np.ndarray):
        """A pinned buffer holding ``arr``, and its slot."""
        slot = self.next
        self.next = (slot + 1) % len(self.buffers)
        if self.events[slot] is not None:
            self.events[slot].synchronize()
        buf = self.buffers[slot]
        buf.numpy()[...] = arr
        return buf, slot


def prefetch_to_device(iterator, device: DeviceLike = None, size: int = 2) -> Iterator[Dict]:
    """Host-to-device prefetch of batch dicts: numeric arrays become tensors
    on ``device`` (None: the CUDA card; raises here without one), the rest
    (ids, bool flags) passes through. On the card each array goes through a
    pinned host buffer and a side stream, ``size`` batches ahead of the one
    yielded, and the consumer's stream waits on each batch's copy event
    before the batch is yielded. With ``device="cpu"`` the arrays become
    CPU tensors."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return ({k: v if (a := _numeric(v)) is None else torch.as_tensor(a)
                 for k, v in batch.items()} for batch in iterator)
    return _prefetch_cuda(iterator, dev, size)


def _prefetch_cuda(iterator, dev: torch.device, size: int) -> Iterator[Dict]:
    stream = torch.cuda.Stream(dev)
    rings: Dict[tuple, _PinnedRing] = {}

    def place(batch):
        out, filled = {}, []
        with torch.cuda.stream(stream):
            for k, v in batch.items():
                arr = _numeric(v)
                if arr is None:
                    out[k] = v
                    continue
                arr = np.ascontiguousarray(arr)
                host = torch.from_numpy(arr)
                key = (k, host.shape, host.dtype)
                if key not in rings:
                    # size + 1 batches are queued at most, one more is being filled.
                    rings[key] = _PinnedRing(host.shape, host.dtype, size + 2)
                buf, slot = rings[key].fill(arr)
                out[k] = buf.to(dev, non_blocking=True)
                filled.append((rings[key], slot))
            event = torch.cuda.Event()
            event.record(stream)
        for ring, slot in filled:
            ring.events[slot] = event
        return out, event

    def hand_over(placed):
        out, event = placed
        current = torch.cuda.current_stream(dev)
        current.wait_event(event)
        for v in out.values():
            if isinstance(v, torch.Tensor):
                v.record_stream(current)
        return out

    queue = collections.deque()
    for batch in iterator:
        queue.append(place(batch))
        if len(queue) > size:
            yield hand_over(queue.popleft())
    while queue:
        yield hand_over(queue.popleft())
