"""``g1_roofline``: the one-hot input product's least time over its
device time. Device time: the operations launched under the gather-sum's
autograd Function forward (``ops/gather_sum.py:_GatherSum``) and its
backward node. Work: ``counts.gather_sum`` over the valid slots and the
distinct rows of every traced step's batch."""

from __future__ import annotations

from benchmark.harness import counts

ENTRIES = ("_GatherSum", "_GatherSumBackward")


def read(run):
    c = run.cell
    seconds = run.trace.device_seconds_under(ENTRIES)
    if seconds <= 0:
        return None
    D = counts.GATES[c["cell"]] * c["H"]
    work = counts.Work()
    for s in run.step_stats:
        work = work + counts.gather_sum(D, s["valid"], s["unique_rows"])
    return 100.0 * work.least_seconds(run.peaks, run.precision) / seconds
