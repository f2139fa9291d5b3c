"""``expand_ms_per_step``: device milliseconds an optimizer step of the
operations launched during the port's ``seqrec::expand`` spans: the step's
batch assembled on the device (``_expand_index_wire``,
``_finish_device_batch``); launched by the main thread or by the autograd
engine's (``harness/spans.py``), over the ``seqrec::step`` spans of the
host-traced call. Layer: the model step."""

from __future__ import annotations

from benchmark.harness import spans


def read(run):
    return spans.device_ms_per_step(run.trace, "seqrec::expand")
