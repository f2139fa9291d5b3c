"""``hstu_attn_roofline``: HSTU's attention's least time over its device
time. Device time: the operations launched under the attention's autograd
Function forward (``ops/hstu_attention.py:_HSTUAttention``: the bias
lookup and the forward kernel) and its backward node (the dQ and dK/dV
kernels, the dbias sums). Work: ``counts_hstu.attention`` over the rows of
every traced step's batch, the sizes from the run's configuration
(``runners/train_lengths.py``)."""

from __future__ import annotations

from benchmark.harness import counts_hstu

ENTRIES = ("_HSTUAttention", "_HSTUAttentionBackward")


def read(run):
    m = getattr(run.step_stats, "model", None)
    if not m or not run.step_stats:
        return None
    seconds = run.trace.device_seconds_under(ENTRIES)
    if seconds <= 0:
        return None
    work = counts_hstu.Work()
    for s in run.step_stats:
        work = work + counts_hstu.attention(s["lengths"], m["blocks"], m["heads"], m["dqk"], m["dv"],
                                            run.cell["L"])
    return 100.0 * work.least_seconds(run.peaks, run.precision) / seconds
