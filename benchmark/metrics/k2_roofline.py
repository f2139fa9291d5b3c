"""``k2_roofline``: the CCE head's least time over its device time.
Device time: the operations launched under the streaming CCE's autograd
Function forward (``ops/streaming_cce.py:_StreamingCCE``: K2's statistics
and the target logits) and its backward node (K2's gradients). Work:
``counts.cce_head`` once a traced step."""

from __future__ import annotations

from benchmark.harness import counts

ENTRIES = ("_StreamingCCE", "_StreamingCCEBackward")


def read(run):
    c = run.cell
    seconds = run.trace.device_seconds_under(ENTRIES)
    if seconds <= 0:
        return None
    least = len(run.step_stats) * counts.cce_head(c["B"], c["H"], c["N"]).least_seconds(run.peaks, run.precision)
    return 100.0 * least / seconds
