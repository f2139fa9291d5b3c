"""``launches_per_step``: device operations (kernels, copies, sets)
launched during the port's ``seqrec::step`` spans by the main thread or
the autograd engine's (``harness/spans.py``), over the ``seqrec::step``
spans of the host-traced call: the host's launches an optimizer step. A
count, the same on every run of a cell. Layer: the model step."""

from __future__ import annotations

from benchmark.harness import spans


def read(run):
    steps = run.trace.count(spans.STEP)
    ops = spans.launched_during(run.trace, spans.STEP)
    return len(ops) / steps if steps and ops else None
