"""``dispatch_ms_p95``: the 95th percentile (nearest rank) of the host time
between successive returns of ``train_function_stacked`` over every
dispatch of the timed window (``runners/train.py``'s wrap). Layer: the
train loop (``models/base.py:train``, ``_payload_pipeline``). A long
dispatch is a stall of the loop: the batcher, the upload or the host's
launches falling behind the card."""

from __future__ import annotations

import math


def read(run):
    values = sorted(run.dispatch_s)
    if len(values) < 20:
        return None
    return values[math.ceil(0.95 * len(values)) - 1] * 1e3
