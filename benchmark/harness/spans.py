"""The port's own spans, as the per-layer metrics read them.

The port records spans inside its training loop
(``seqrec_tpu_torch/utils/tracing.py``) when ``train`` starts under a
profiler, as the traced calls do. The main thread's spans open a
``record_function`` range of the same name, so they are ranges of the
host-traced call's trace (``Trace.ranges``); the batcher's assembly and
transfer threads' spans are in the port's buffer alone
(``program_spans``). Where the port has no such spans, every reader here
finds nothing and returns None.

A device operation is launched *during* a span when its launch's host time
falls inside the span's interval and the launch came from the span's own
thread or from a thread that ran a backward node: the autograd engine's
thread launches the backward's kernels while the main thread waits inside
``seqrec::backward``. The other threads' launches (the transfer thread's
copies) are left out.
"""

from __future__ import annotations

import bisect

STEP = "seqrec::step"


def program_spans():
    """The port's spans of its last recorded ``train`` call, or None."""
    try:
        from seqrec_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing.spans() or None


def mean_ms(recorded, name: str):
    """Mean milliseconds of the recorded spans named ``name``, or None."""
    ns = [s.end_ns - s.start_ns for s in recorded or () if s.name == name]
    return sum(ns) / len(ns) / 1e6 if ns else None


def durations(trace, name: str) -> list:
    """Seconds of each range named ``name`` in the trace, in start order."""
    return [e - s for s, e in sorted(iv for lst in trace.ranges.get(name, {}).values() for iv in lst)]


def launched_during(trace, name: str) -> list:
    """The device operations ``(start, end, kernel, launch)`` launched
    during the ranges named ``name``."""
    by_tid = trace.ranges.get(name)
    if not by_tid:
        return []
    backward = {tid for n, lst in trace.ranges.items() if "Backward" in n for tid in lst}
    found = []
    for op in trace.device:
        launch = op[3]
        if launch is None:
            continue
        tid, t = launch
        for own, intervals in by_tid.items():  # a span's ranges never overlap on one thread
            if tid != own and tid not in backward:
                continue
            i = bisect.bisect_right(intervals, (t, float("inf"))) - 1
            if i >= 0 and t <= intervals[i][1]:
                found.append(op)
                break
    return found


def device_ms_per_step(trace, name: str):
    """Device milliseconds a ``seqrec::step`` of the operations launched
    during the ranges named ``name``, or None."""
    steps, ops = trace.count(STEP), launched_during(trace, name)
    if not steps or not ops:
        return None
    return 1e3 * sum(e - s for s, e, *_ in ops) / steps
