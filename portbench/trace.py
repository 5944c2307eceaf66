"""The traced run's reading: torch.profiler's raw (kineto) events reduced to
device operations, host spans and the device's busy time.

A device operation (kernel, copy, set) is tied to the host through its
correlation id: the runtime call that launched it (``cudaLaunchKernel``,
``cudaMemcpyAsync``, ...) lies inside the harness's host spans (``pb.*``,
``Context.span``), so the device time that a span caused is the device time
of the operations launched inside it, whenever they ran.

Two readings of the device's time: ``busy_s`` counts every operation, copies
and sets included (the result line's ``device``); the idle share and the idle
gaps count kernels alone, since a pageable copy's span is mostly the host
staging it, so a device that only waits on an upload reads idle.
"""

from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict
from typing import Dict, List, Tuple

SPAN_PREFIX = "pb."
COPY_PREFIXES = ("Memcpy", "Memset")


def is_copy(name: str) -> bool:
    """A copy or a set, not a kernel."""
    return name.startswith(COPY_PREFIXES)


def _ns(ev, what: str) -> int:
    fn = getattr(ev, f"{what}_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(ev, f"{what}_us")() * 1000)


class TraceView:
    """Device operations and host spans of one traced window (times in ns)."""

    def __init__(self, raw_events):
        from torch.autograd import DeviceType

        spans: List[Tuple[int, int, str]] = []
        launches: Dict[int, int] = {}
        device: List[Tuple[int, int, str, int]] = []
        for ev in raw_events:
            name = ev.name()
            start, dur = _ns(ev, "start"), _ns(ev, "duration")
            corr = int(ev.correlation_id())
            if ev.device_type() == DeviceType.CPU:
                if name.startswith(SPAN_PREFIX):
                    spans.append((start, start + dur, name[len(SPAN_PREFIX):]))
                elif corr:
                    launches[corr] = start
            elif not name.startswith(SPAN_PREFIX) and dur > 0 and not name.startswith(
                    "ProfilerStep"):
                device.append((start, start + dur, name, corr))
        self.spans = sorted(spans)
        windows = [s for s in self.spans if s[2] == "window"]
        if windows:
            self.t_start, self.t_end = windows[0][0], windows[0][1]
        else:
            self.t_start = min(s[0] for s in self.spans + [(e[0], 0, "") for e in device])
            self.t_end = max(e[1] for e in device)
        self.ops = sorted((s, e, n, launches.get(c)) for s, e, n, c in device)

    # -- the device ------------------------------------------------------
    def _busy_intervals(self, kernels_only: bool = False) -> List[Tuple[int, int]]:
        merged: List[List[int]] = []
        for s, e, name, _ in self.ops:
            if kernels_only and is_copy(name):
                continue
            s, e = max(s, self.t_start), min(e, self.t_end)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    @property
    def window_s(self) -> float:
        return (self.t_end - self.t_start) / 1e9

    @property
    def busy_s(self) -> float:
        """Seconds in which any operation ran on the device."""
        return sum(e - s for s, e in self._busy_intervals()) / 1e9

    @property
    def kernel_busy_s(self) -> float:
        """Seconds in which a kernel ran on the device."""
        return sum(e - s for s, e in self._busy_intervals(kernels_only=True)) / 1e9

    def idle_share(self) -> float:
        """Share of the window with no kernel running."""
        return 1.0 - self.kernel_busy_s / self.window_s

    def idle_gaps(self) -> List[Tuple[int, int]]:
        """The stretches of the window with no kernel running."""
        busy = self._busy_intervals(kernels_only=True)
        edges = [self.t_start] + [x for iv in busy for x in iv] + [self.t_end]
        return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]

    # -- host spans ------------------------------------------------------
    def spans_named(self, name: str) -> List[Tuple[int, int]]:
        return [(s, e) for s, e, n in self.spans if n == name]

    def span_at(self, t: int) -> str:
        """The innermost span open at host time ``t`` ('' when none)."""
        best = None
        for s, e, n in self.spans:
            if s > t:
                break
            if e >= t and (best is None or s >= best[0]):
                best = (s, n)
        return best[1] if best else ""

    def device_ns_launched_in(self, name: str, kernels_only: bool = False) -> int:
        """Device time of the operations launched inside spans ``name``."""
        spans = sorted(self.spans_named(name))
        starts = [s for s, _ in spans]
        total = 0
        for s, e, op, launch in self.ops:
            if launch is None or (kernels_only and is_copy(op)):
                continue
            i = bisect.bisect_right(starts, launch) - 1
            if i >= 0 and launch <= spans[i][1]:
                total += e - s
        return total

    def breakdown(self) -> Dict[str, List]:
        by_op: Dict[str, int] = defaultdict(int)
        for s, e, name, _ in self.ops:
            s, e = max(s, self.t_start), min(e, self.t_end)
            if e > s:
                by_op[name[:96]] += e - s
        top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.idle_gaps(), key=lambda g: g[0] - g[1])[:10]
        return {"device_ops": [[n, ns / 1e9] for n, ns in top],
                "idle_gaps": [[self.span_at((s + e) // 2) or "outside spans", (e - s) / 1e9]
                              for s, e in gaps]}


class _Holder:
    def __init__(self):
        self.prof = None

    def view(self) -> TraceView:
        return TraceView(self.prof.profiler.kineto_results.events())


@contextlib.contextmanager
def traced():
    """torch.profiler over the block (host and CUDA activity); yields a
    holder whose ``view()`` reads the trace once the block has closed."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    holder = _Holder()
    with profile(activities=activities) as prof:
        holder.prof = prof
        yield holder
