"""Reduction of a ``torch.profiler`` trace (its Chrome trace export).

Device operations are the events of category ``kernel``, ``gpu_memcpy``
and ``gpu_memset``. Each is tied to the host call that launched it (a
``cuda_runtime`` or ``cuda_driver`` event with the same ``correlation``),
and through that call's thread and time to every host range open around
it: PyTorch's ops (``cpu_op``), an autograd Function's forward (its class
name), a backward node (``<Name>Backward``) and the benchmark's own
``record_function`` ranges (``user_annotation``). A metric names the
ranges of its work (its entries); the device time of the work is that of
the operations launched inside them, whatever kernels those are.
"""

from __future__ import annotations

import bisect
import collections
import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
RANGE_CATS = ("cpu_op", "user_annotation")


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Trace:
    """The events of one profiled segment, times in seconds."""

    def __init__(self, events: list):
        self.device = []  # (start, end, name, launch (tid, ts) or None)
        self.kernel_starts = []  # of the kernels alone (no copies or sets)
        self.ranges = collections.defaultdict(lambda: collections.defaultdict(list))  # name -> tid -> [(s, e)]
        self.host = collections.defaultdict(list)  # tid -> [(s, e, name)]
        launches = {}
        for ev in events:
            if ev.get("ph") != "X":
                continue
            cat = ev.get("cat", "")
            s = float(ev["ts"]) * 1e-6
            e = s + float(ev.get("dur", 0.0)) * 1e-6
            if cat in LAUNCH_CATS and "correlation" in ev.get("args", {}):
                launches[ev["args"]["correlation"]] = (ev["tid"], s)
            elif cat in RANGE_CATS:
                self.ranges[ev["name"]][ev["tid"]].append((s, e))
                self.host[ev["tid"]].append((s, e, ev["name"]))
        for ev in events:
            if ev.get("ph") == "X" and ev.get("cat") in DEVICE_CATS:
                s = float(ev["ts"]) * 1e-6
                corr = ev.get("args", {}).get("correlation")
                self.device.append((s, s + float(ev.get("dur", 0.0)) * 1e-6, ev["name"], launches.get(corr)))
                if ev["cat"] == "kernel":
                    self.kernel_starts.append(s)
        for by_tid in self.ranges.values():
            for lst in by_tid.values():
                lst.sort()
        for lst in self.host.values():
            lst.sort()

    @classmethod
    def from_file(cls, path: str) -> "Trace":
        with open(path) as f:
            data = json.load(f)
        return cls(data["traceEvents"] if isinstance(data, dict) else data)

    def _inside(self, name: str, tid, t: float) -> bool:
        lst = self.ranges.get(name, {}).get(tid)
        if not lst:
            return False
        i = bisect.bisect_right(lst, (t, float("inf"))) - 1
        return i >= 0 and lst[i][1] >= t

    def count(self, name: str) -> int:
        return sum(len(v) for v in self.ranges.get(name, {}).values())

    def device_seconds_under(self, entries) -> float:
        """Device time of the operations launched inside any range named in
        ``entries``."""
        total = 0.0
        for s, e, _, launch in self.device:
            if launch is not None and any(self._inside(n, launch[0], launch[1]) for n in entries):
                total += e - s
        return total

    def busy(self, start: float, end: float) -> list:
        """Merged intervals of device operations inside [start, end]."""
        return _merge((max(s, start), min(e, end)) for s, e, _, _ in self.device if e > start and s < end)

    def top_device_ops(self, start: float, end: float, n: int = 10) -> list:
        totals = collections.Counter()
        for s, e, name, _ in self.device:
            if e > start and s < end:
                totals[name] += min(e, end) - max(s, start)
        return [[name[:160], sec] for name, sec in totals.most_common(n)]

    def _innermost(self, tid):
        """(times, labels): from each time on, the innermost host range open
        on ``tid`` (None: none), by a sweep over its nested ranges."""
        points, stack = [], []
        for s, e, name in self.host.get(tid, []):
            while stack and stack[-1][0] < s:  # ranges that closed before s
                end = stack.pop()[0]
                points.append((end, stack[-1][1] if stack else None))
            stack.append((e, name))
            points.append((s, name))
        while stack:
            end = stack.pop()[0]
            points.append((end, stack[-1][1] if stack else None))
        return [t for t, _ in points], [label for _, label in points]

    def idle_gaps(self, start: float, end: float, threads, n: int = 10) -> list:
        """The device's idle gaps inside [start, end], summed by what the
        host was doing at the middle of each: the innermost range open then
        on ``threads`` (the threads that launch device work), the one that
        opened last where several threads have one open."""
        busy = self.busy(start, end)
        edges = [start] + [x for iv in busy for x in iv] + [end]
        sweeps = {tid: self._innermost(tid) for tid in threads}
        totals = collections.Counter()
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid, label, latest = (a + b) / 2, "no host range open", -1.0
            for tid, (times, labels) in sweeps.items():
                i = bisect.bisect_right(times, mid) - 1
                if i >= 0 and labels[i] is not None and times[i] > latest:
                    label, latest = labels[i], times[i]
            totals[label[:160]] += b - a
        return [[name, sec] for name, sec in totals.most_common(n)]

    def launch_threads(self) -> set:
        return {launch[0] for *_, launch in self.device if launch is not None}
