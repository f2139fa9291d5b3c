"""``k5_roofline``: the peephole LSTM recurrence's least time over its device
time. Device time: the operations launched under the scan's autograd
Function forward (``ops/lstm_scan_train.py:_LSTMScanTrain``) and its
backward node. Work: ``counts.recurrence`` over the valid steps of every
traced step's batch."""

from __future__ import annotations

from benchmark.harness import counts

ENTRIES = ("_LSTMScanTrain", "_LSTMScanTrainBackward")
CELL = "LSTM"


def read(run):
    c = run.cell
    if c["cell"] != CELL:
        return None
    seconds = run.trace.device_seconds_under(ENTRIES)
    if seconds <= 0:
        return None
    work = counts.Work()
    for s in run.step_stats:
        work = work + counts.recurrence(CELL, c["H"], c["B"], s["valid"])
    return 100.0 * work.least_seconds(run.peaks, run.precision) / seconds
