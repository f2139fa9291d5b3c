"""``update_ms_per_step``: device milliseconds an optimizer step of the
operations launched during the port's ``seqrec::update`` spans: the
optimizer (``models/updates.py:UpdateManager.step``, ``Adam.step``; the
lazy Adam), the calls ``adam_ms_per_step`` times from outside; launched by
the main thread or by the autograd engine's (``harness/spans.py``), over
the ``seqrec::step`` spans of the host-traced call. Layer: the optimizer."""

from __future__ import annotations

from benchmark.harness import spans


def read(run):
    return spans.device_ms_per_step(run.trace, "seqrec::update")
