"""The program's own spans in a traced run, joined with the trace.

``starcop_tpu_torch.utils.profiling`` logs a span (name, key, thread,
parent, ``time.time_ns`` stamps, counters) at each layer boundary while the
profiler records, on the pipeline's and the loader's worker threads too.
Kineto stamps host events in Unix-epoch nanoseconds and puts device activity
on that clock, so a span's stamps compare directly with ``TraceView``'s
window, launch times and idle gaps:

* ``spans(trace, name)``: the program's spans ``name`` that lie inside the
  traced window;
* ``device_ns_launched_in``: device time of the operations whose launch
  lies inside those spans, whenever they ran;
* ``idle_ns_in``: the window's kernel-idle time that falls inside them.

A program that keeps no span log gives None, and the metrics that read it
then print nothing.
"""

from __future__ import annotations

import bisect
from typing import List, Optional, Tuple

from portbench.trace import is_copy


def program_spans():
    """The program's span log, or None when it keeps none."""
    try:
        from starcop_tpu_torch.utils import profiling
    except ImportError:
        return None
    log = getattr(profiling, "spans", None)
    return None if log is None else log()


def spans(trace, name: str, log=None) -> Optional[List]:
    """The spans ``name`` inside the traced window, oldest first (None when
    the program keeps no span log). ``log`` stands in for the program's."""
    log = program_spans() if log is None else log
    if log is None:
        return None
    return sorted((s for s in log if s.name == name and s.start >= trace.t_start
                   and s.end <= trace.t_end), key=lambda s: s.start)


def host_ns(found) -> int:
    """The spans' summed host time."""
    return sum(s.end - s.start for s in found)


def union(found) -> List[Tuple[int, int]]:
    """The spans' [start, end] intervals merged (spans of several threads
    overlap)."""
    merged: List[List[int]] = []
    for s, e in sorted((s.start, s.end) for s in found):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def device_ns_launched_in(trace, found, kernels_only: bool = False) -> int:
    """Device time of the operations launched inside the spans ``found``
    (copies and sets left out with ``kernels_only``)."""
    merged = union(found)
    starts = [s for s, _ in merged]
    total = 0
    for s, e, op, launch in trace.ops:
        if launch is None or (kernels_only and is_copy(op)):
            continue
        i = bisect.bisect_right(starts, launch) - 1
        if i >= 0 and launch <= merged[i][1]:
            total += e - s
    return total


def idle_ns_in(trace, found) -> int:
    """The window's kernel-idle time (``TraceView.idle_gaps``) inside the
    spans ``found``."""
    merged = union(found)
    total = 0
    for gs, ge in trace.idle_gaps():
        for s, e in merged:
            total += max(0, min(ge, e) - max(gs, s))
    return total


def idle_ns(trace) -> int:
    return sum(e - s for s, e in trace.idle_gaps())
