"""Tiling, weighted sampling, batch iteration and the host-to-device feed
(counterpart of starcop_tpu/data/datamodule.py):

  * ``tile_rows``: 512 x 512 index rows -> training windows with their
    plume fraction and the has_plume > 10 / 64^2 rule;
  * ``sample_weights``: balanced plume / background sampling weights;
  * ``BatchLoader``: batches of the (B, C, H, W) dict protocol, sequential,
    shuffled or weighted with replacement, assembled by the dataset's
    ``read_batch`` (optionally on a thread pool);
  * ``prefetch_to_device``: pinned host buffers and a side stream, so the
    next batches' copies overlap the current batch's compute; on the card
    a ``BatchLoader``'s natively read batches land straight in those
    buffers, and the copies leave from there;
  * ``DataModule``: an index CSV -> the five dataset views and the train /
    test loaders, with the tiled training rows cached next to the CSV.

Everything but ``prefetch_to_device`` is numpy and gives the JAX package's
rows, weights and batches for the same seed.
"""

from __future__ import annotations

import collections
import concurrent.futures
import csv
import os
import threading
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from starcop_tpu_torch.data.dataset import (ChipDataset, _read_product, read_index_csv,
                                            stack_samples)
from starcop_tpu_torch.device import DeviceLike, resolve_device
from starcop_tpu_torch.utils import staging
from starcop_tpu_torch.utils.profiling import carry, span


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
    order (eval). A batch comes from the dataset's ``read_batch`` where it
    has one (``ChipDataset``: one threaded native read of every product
    straight into the batch arrays, where no sample draws anything of its
    own), else from stacking its samples. The batch arrays are fresh, or,
    for a whole batch where the consumer set the iterator's ``slot``
    (``prefetch_to_device`` on the card), the buffers ``slot`` hands out
    (see ``BatchIterator``). ``num_workers > 0`` assembles batches on a
    thread pool, at most 2 x num_workers batches ahead. Traced
    (``utils.profiling``; the pool's reads take the iterating thread's
    tracing state), a batch's assembly is span ``data.load``, with
    ``read_batch``'s counters ``chips``, ``native_chips`` and
    ``pinned_chips``.
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

    def __iter__(self) -> "BatchIterator":
        return BatchIterator(self)

    def _batches(self, slot: Optional[Callable]) -> Iterator[Dict]:
        idx = self._indices()
        batches = [idx[i:i + self.batch_size] for i in range(0, len(idx), self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]
        if self.num_workers > 0:
            window = 2 * self.num_workers
            with concurrent.futures.ThreadPoolExecutor(self.num_workers) as pool:
                inflight = collections.deque()
                for b in batches:
                    inflight.append(pool.submit(carry(self._collate), b, slot))
                    if len(inflight) > window:
                        yield inflight.popleft().result()
                while inflight:
                    yield inflight.popleft().result()
        else:
            for b in batches:
                yield self._collate(b, slot)

    def _collate(self, indices: np.ndarray, slot: Optional[Callable] = None) -> Dict:
        with span("data.load"):
            read_batch = getattr(self.dataset, "read_batch", None)
            if read_batch is None:
                return stack_samples([self.dataset[int(i)] for i in indices])
            if slot is None or len(indices) != self.batch_size:
                return read_batch(indices)
            return read_batch(indices, slot)


class BatchIterator:
    """What ``iter(BatchLoader)`` returns: the loader's batches, in order.

    A consumer may set ``slot`` before its first ``next()``: a callable
    ``(key, shape, dtype)`` giving the C-contiguous host array to read a
    whole batch's numeric array ``key`` into (a partial last batch, a
    dataset without ``read_batch`` and ``read_batch``'s per-chip path keep
    fresh arrays). Its arrays outlive the batch: the consumer hands one out
    again only once it is done with the batch that last held it, and may
    be called from the pool's threads. ``ahead`` bounds how many other
    batches may ask ``slot`` for an array between one batch's asking and
    the consumer's next ``next()`` after that batch: none without a pool;
    with one, the 2 x num_workers batches submitted behind it and the
    num_workers - 1 before it that may still be reading when it asks.
    """

    def __init__(self, loader: BatchLoader):
        self.slot: Optional[Callable] = None
        self.ahead = max(0, 3 * loader.num_workers - 1)
        self._loader, self._batches = loader, None

    def __iter__(self) -> "BatchIterator":
        return self

    def __next__(self) -> Dict:
        if self._batches is None:
            self._batches = self._loader._batches(self.slot)
        return next(self._batches)


def _numeric(v):
    """``v`` as a numeric numpy array, or None (ids, strings, bool flags
    pass through as the JAX package's feed passes them)."""
    if isinstance(v, torch.Tensor):
        return None
    arr = np.asarray(v)
    return arr if np.issubdtype(arr.dtype, np.number) else None


def prefetch_to_device(iterator, device: DeviceLike = None, size: int = 2,
                       mesh=None) -> Iterator[Dict]:
    """Host-to-device prefetch of batch dicts: numeric arrays become tensors
    on ``device`` (None: the CUDA card; raises here without one), the rest
    (ids, bool flags) passes through. On the card each array goes through a
    pinned host buffer and a side stream (``utils.staging.upload``, ``size +
    2`` buffers an array, and ``ahead`` more for a ``BatchIterator``),
    ``size`` batches ahead of the one yielded, and the consumer's stream
    waits on each batch's copy event before the batch is yielded. Given a
    ``BatchIterator``, it sets the iterator's ``slot`` to hand out those
    buffers (``PinnedRing.take``), so the loader reads a batch straight
    into them and the copy leaves from there with no host copy; any other
    array is copied into its buffer first. With ``device="cpu"`` the arrays become
    CPU tensors. With a ``mesh`` (``parallel.Mesh``) each numeric array is
    cut to the rank's contiguous rows first (a batch that does not divide by
    the world raises, as ``parallel.shard_batch``), on the mesh's device."""
    if mesh is not None:
        from starcop_tpu_torch.parallel.mesh import local_rows, mesh_device

        device = mesh_device(mesh, device)
        iterator = ({k: v if (a := _numeric(v)) is None else a[local_rows(mesh, len(a))]
                     for k, v in batch.items()} for batch in iterator)
    dev = resolve_device(device)
    if dev.type != "cuda":
        return ({k: v if (a := _numeric(v)) is None else torch.as_tensor(a)
                 for k, v in batch.items()} for batch in iterator)
    return _prefetch_cuda(iterator, dev, size)


def _prefetch_cuda(iterator, dev: torch.device, size: int) -> Iterator[Dict]:
    stream = torch.cuda.Stream(dev)
    rings: Dict[tuple, staging.PinnedRing] = {}
    # size + 1 batches are queued at most, one more is being filled, and a
    # loader's pool may read `ahead` more before that one is placed.
    slots = size + 2
    lock = threading.Lock()  # the rings' turns, taken by the loader's threads too
    if isinstance(iterator, BatchIterator):
        slots += iterator.ahead

        def slot(key, shape, dtype):
            ring_key = (key, tuple(map(int, shape)), torch.from_numpy(np.empty(0, dtype)).dtype)
            with lock:
                if ring_key not in rings:
                    rings[ring_key] = staging.PinnedRing(*ring_key[1:], slots)
                return rings[ring_key].take()[0].numpy()

        iterator.slot = slot

    def place(batch):
        host = {k: torch.from_numpy(np.ascontiguousarray(a)) for k, v in batch.items()
                if (a := _numeric(v)) is not None}
        with lock:
            return batch, *staging.upload(host, dev, stream, rings, slots)

    def hand_over(placed):
        batch, out, ready = placed
        staging.hand_over(out, ready, torch.cuda.current_stream(dev))
        return {**batch, **out}

    queue = collections.deque()
    for batch in iterator:
        queue.append(place(batch))
        if len(queue) > size:
            yield hand_over(queue.popleft())
    while queue:
        yield hand_over(queue.popleft())


class DataModule:
    """Dataset assembly from an index CSV (starcop_tpu/data/datamodule.py:214-330):
    the five views of the reference datamodule, tiled train, non-tiled
    train, train-plot, test and test-plot (sorted by (has_plume, qplume),
    descending), and the loaders over them."""

    def __init__(
        self,
        train_csv: str,
        test_csv: Optional[str] = None,
        input_products: Sequence[str] = (
            "mag1c",
            "TOA_AVIRIS_640nm",
            "TOA_AVIRIS_550nm",
            "TOA_AVIRIS_460nm",
        ),
        output_products: Sequence[str] = ("labelbinary",),
        weight_loss_product: Optional[str] = "weight_mag1c",
        training_size: int = 128,
        training_overlap: int = 64,
        batch_size: int = 32,
        weight_sampling: bool = True,
        num_workers: int = 0,
        seed: int = 42,
        augment_rotation: str = "continuous",
    ):
        self.train_csv_path = train_csv
        self.train_rows = read_index_csv(train_csv)
        self.test_rows = read_index_csv(test_csv) if test_csv else []
        self.input_products = list(input_products)
        self.output_products = list(output_products)
        self.weight_loss_product = weight_loss_product
        self.training_size = training_size
        self.training_overlap = training_overlap
        self.batch_size = batch_size
        self.weight_sampling = weight_sampling
        self.num_workers = num_workers
        self.seed = seed
        self.augment_rotation = augment_rotation
        self._tiled_train_rows: Optional[List[Dict]] = None

    @property
    def tiled_train_rows(self) -> List[Dict]:
        """Training windows, written to ``{train}_tiled_{size}_{overlap}.csv``
        beside the train CSV and read from there on later runs (the label
        statistics pass is skipped)."""
        if self._tiled_train_rows is None:
            cache = self._tiled_cache_path()
            if cache and os.path.exists(cache):
                rows = read_index_csv(cache)
                for r in rows:
                    if "frac_positives" in r and r["frac_positives"] != "":
                        r["frac_positives"] = float(r["frac_positives"])
                self._tiled_train_rows = rows
            else:
                self._tiled_train_rows = tile_rows(
                    self.train_rows, self.training_size, self.training_overlap,
                    label_product=self.output_products[0],
                )
                if cache:
                    self._write_rows_csv(cache, self._tiled_train_rows)
        return self._tiled_train_rows

    def _tiled_cache_path(self) -> Optional[str]:
        if not self.train_csv_path:
            return None
        base, ext = os.path.splitext(self.train_csv_path)
        return f"{base}_tiled_{self.training_size}_{self.training_overlap}{ext or '.csv'}"

    @staticmethod
    def _write_rows_csv(path: str, rows: List[Dict]):
        if not rows:
            return
        keys = sorted({k for r in rows for k in r}, key=lambda k: (k != "id", k))
        with open(path, "w", newline="") as fh:
            writer = csv.DictWriter(fh, fieldnames=keys)
            writer.writeheader()
            writer.writerows(rows)

    def train_dataset(self, augment: bool = True) -> ChipDataset:
        return ChipDataset(
            self.tiled_train_rows,
            self.input_products,
            self.output_products,
            self.weight_loss_product,
            augment=augment,
            augment_rotation=self.augment_rotation,
            seed=self.seed,
        )

    def test_dataset(self, sort_plot: bool = False, **kw) -> ChipDataset:
        rows = list(self.test_rows)
        if sort_plot:
            rows.sort(key=lambda r: (bool(r.get("has_plume")), r.get("qplume", 0.0)), reverse=True)
        return ChipDataset(
            rows, self.input_products, self.output_products, self.weight_loss_product, **kw
        )

    def train_loader(self) -> BatchLoader:
        """Weighted sampling with replacement (or a shuffle), whole batches
        only; a new loader from ``seed`` on each call, as in JAX."""
        return BatchLoader(
            self.train_dataset(),
            batch_size=self.batch_size,
            weighted=self.weight_sampling,
            shuffle=not self.weight_sampling,
            drop_last=True,
            seed=self.seed,
            num_workers=self.num_workers,
        )

    def test_loader(self, batch_size: int = 1, **kw) -> BatchLoader:
        return BatchLoader(self.test_dataset(**kw), batch_size=batch_size)
