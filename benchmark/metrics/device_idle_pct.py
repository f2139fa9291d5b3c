"""``device_idle_pct``: the share of the traced window in which no device
operation runs, 1 - (union of kernel, copy and set intervals) / window,
from the traced call that records device activity alone
(``torch.profiler``): the window runs from its first kernel to the end of
its last device operation. Host ops are not recorded there, since
recording them slows the host and idles the card."""

from __future__ import annotations


def read(run):
    start, end = run.window
    if end <= start or run.busy_s <= 0:
        return None
    return 100.0 * (1.0 - run.busy_s / (end - start))
