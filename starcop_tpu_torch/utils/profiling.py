"""Profiling and tracing hooks (counterpart of starcop_tpu/utils/profiling.py).

``trace`` is a context manager around ``torch.profiler`` (the host and,
where there is one, the CUDA card) that writes a Chrome trace, viewable in
Perfetto or ``chrome://tracing``, into a directory; ``StageTimer`` takes
named host-clock stages with the device synchronised at their edges.

Spans mark the package's layer boundaries. They record only while
``torch.profiler`` records on the calling thread, or on a thread the package
started from such a thread (``carry``); otherwise ``span`` hands back one
shared no-op context. A recorded span keeps its name, key, thread, parent and
``time.time_ns`` stamps in a bounded in-process log (``spans``), and marks the
profiler's trace with a host event ``starcop.<name>`` (an operator's record,
not a ``record_function`` annotation: the profiler copies an annotation onto
the device's timeline as a range over the kernels launched inside it, which
would read as device work). The stamps are on the clock the profiler gives
its host events (Unix-epoch nanoseconds), so a span can be joined with the
trace's launches and device activity. The spans:

  * ``entry.upload`` (counter ``bytes``: the bytes handed in from host
    memory; counter ``staged_bytes``: those of them that
    ``utils.staging.stage_to_device`` copied through its pinned ring, absent
    when none were), ``entry.filter``:
    ``scenes.emit_pipeline.emit_granule_to_mask``;
  * ``mag1c.base`` (counters ``blocks``: the column blocks; ``kernel``: 1
    when the CUDA kernel ran, 0 for the plain twin):
    ``ops.mag1c_kernels.woodbury_base``, once a filter on every route but
    ``acrwl1mf_fused(glue="cholesky")``;
  * ``serve.read``, ``serve.compute``, ``serve.write`` (key: the granule's
    name), ``serve.get_wait`` (the compute worker waiting on the reader),
    ``serve.put_wait`` (the reader waiting on the compute worker):
    ``serve.pipeline.ScenePipeline``; ``serve.encode``:
    ``serve.pipeline.encode_payload``;
  * ``data.load``: ``data.datamodule.BatchLoader``, a batch's chip reads and
    stack;
  * ``validation.rows``: ``eval.validation.run_validation``, a batch's
    per-tile rows on the host;
  * ``segformer.stage`` (key: the stage, 0-3), ``segformer.attention``
    (counters ``queries``, ``keys``, ``heads``), ``segformer.mixffn``,
    ``segformer.decode``: ``models.segformer``;
  * ``swin.stage`` (key: the stage, 0-3), ``swin.attention`` (counters
    ``windows``, ``window_tokens``, ``heads``, ``shifted``: 1 on a shifted
    block), ``swin.mlp``, ``swin.merge``, and ``upernet.head`` with
    ``upernet.ppm``, ``upernet.fpn`` and ``upernet.fuse`` inside it:
    ``models.swin``.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import logging
import os
import threading
import time
from typing import Callable, Dict, List

import torch
from torch.autograd import _profiler_enabled

from starcop_tpu_torch.device import DeviceLike, resolve_device

logger = logging.getLogger("starcop_tpu_torch.profiling")


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler trace scope: ``with trace('/tmp/trace'): step()``
    writes ``log_dir/trace_{pid}.json``. Where the installed torch can, the
    trace holds every thread's host events, the spans of the threads that
    the package starts inside the block among them."""
    from torch.profiler import profile, supported_activities

    os.makedirs(log_dir, exist_ok=True)
    config = _all_threads_config()
    kw = {} if config is None else {"experimental_config": config}
    prof = profile(activities=supported_activities(), **kw)
    prof.start()
    # A profile of every thread leaves the calling thread's own profiler
    # state off: the spans are turned on here as ``carry`` turns them on.
    was, _local.carried = _local.carried, True
    try:
        yield
    finally:
        _local.carried = was
        prof.stop()
        path = os.path.join(log_dir, f"trace_{os.getpid()}.json")
        prof.export_chrome_trace(path)
        logger.info("profiler trace written to %s", path)


def _all_threads_config():
    """The profiler configuration that records every thread's host events
    (the pipeline's and the loader's worker threads), where the installed
    torch has it; else None."""
    try:
        return torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    except (AttributeError, TypeError):
        return None


# ---------------------------------------------------------------------------
# Spans and counters
# ---------------------------------------------------------------------------

SPAN_LOG_MAX = 65536  # closed spans kept; the oldest go first
SPAN_PREFIX = "starcop."

_LOG: collections.deque = collections.deque(maxlen=SPAN_LOG_MAX)
_IDS = itertools.count(1)
_ROOT_KEYS = itertools.count(1)
_OFF = contextlib.nullcontext()


class _ThreadState(threading.local):
    """A thread's open spans, and whether ``carry`` turned its spans on (a
    class default: a lookup that misses costs far more than one that hits)."""

    carried = False

    def __init__(self):
        self.stack: List["Span"] = []


_local = _ThreadState()


class Span:
    """One span: ``name``, ``key`` (given, else the parent's, else a fresh
    integer), ``thread`` (``threading.get_ident``), ``id``, ``parent`` (the id
    of the innermost span open on the thread when it opened, or None),
    ``start`` and ``end`` (``time.time_ns``) and ``counts`` ({counter: total}).
    Entered, it returns itself and opens the profiler's host event
    ``starcop.<name>``; it is appended to the log when it closes."""

    __slots__ = ("name", "key", "thread", "id", "parent", "start", "end", "counts", "_rf")

    def __init__(self, name: str, key=None):
        self.name, self.key, self.counts = name, key, {}
        self.parent = self.start = self.end = None

    @property
    def seconds(self) -> float:
        return (self.end - self.start) / 1e9

    def __enter__(self) -> "Span":
        stack = _local.stack
        outer = stack[-1] if stack else None
        if outer is not None:
            self.parent = outer.id
        if self.key is None:
            self.key = outer.key if outer is not None else next(_ROOT_KEYS)
        self.id = next(_IDS)
        self.thread = threading.get_ident()
        self._rf = torch._C._profiler._RecordFunctionFast(SPAN_PREFIX + self.name)
        self._rf.__enter__()
        stack.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.end = time.time_ns()
        _local.stack.pop()
        rf, self._rf = self._rf, None
        rf.__exit__(*exc)
        _LOG.append(self)


def span(name: str, key=None):
    """A ``Span`` named ``name`` while tracing is on for this thread (the
    profiler records on it, or ``carry`` started it so); else the shared
    no-op context, which enters as None."""
    if _local.carried or _profiler_enabled():
        return Span(name, key)
    return _OFF


def count(name: str, n) -> None:
    """Add ``n`` to counter ``name`` of the innermost span open on this
    thread (nothing when none is)."""
    stack = _local.stack
    if stack:
        counts = stack[-1].counts
        counts[name] = counts.get(name, 0) + n


def carry(fn: Callable) -> Callable:
    """``fn`` to run on a thread the caller starts, with the calling
    thread's tracing state: while this thread traces, ``fn``'s spans record
    too (the profiler's own state belongs to the thread that started it).
    ``fn`` itself when this thread does not trace."""
    if not (_local.carried or _profiler_enabled()):
        return fn

    @functools.wraps(fn)
    def carried(*args, **kwargs):
        was = _local.carried
        _local.carried = True
        try:
            return fn(*args, **kwargs)
        finally:
            _local.carried = was

    return carried


def spans() -> List[Span]:
    """The closed spans in the log, oldest first."""
    return list(_LOG)


def clear_spans() -> None:
    _LOG.clear()


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
