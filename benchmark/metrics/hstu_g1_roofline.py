"""``hstu_g1_roofline``: the HSTU tower's item-table gather (G1 at the
model's width d) over its device time: ``g1_roofline`` for the HSTU cell,
whose input table is one row of d a step in place of the RNN's gates.
Device time: the operations launched under the gather-sum's autograd
Function forward (``ops/gather_sum.py:_GatherSum``) and its backward node.
Work: ``counts.gather_sum`` at D = d over the valid slots and the distinct
rows of every traced step's batch."""

from __future__ import annotations

from benchmark.harness import counts

ENTRIES = ("_GatherSum", "_GatherSumBackward")


def read(run):
    seconds = run.trace.device_seconds_under(ENTRIES)
    if seconds <= 0:
        return None
    work = counts.Work()
    for s in run.step_stats:
        work = work + counts.gather_sum(run.cell["H"], s["valid"], s["unique_rows"])
    return 100.0 * work.least_seconds(run.peaks, run.precision) / seconds
