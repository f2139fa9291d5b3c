"""``adam_ms_per_step``: device milliseconds an optimizer step of the
operations launched inside the instance's ``updater.step``
(``models/updates.py:Adam.step``), which the traced run wraps in the
benchmark's ``bench::adam`` range."""

from __future__ import annotations

ENTRIES = ("bench::adam",)


def read(run):
    n = run.trace.count(ENTRIES[0])
    seconds = run.trace.device_seconds_under(ENTRIES)
    return 1e3 * seconds / n if n and seconds > 0 else None
