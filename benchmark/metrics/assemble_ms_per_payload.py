"""``assemble_ms_per_payload``: mean host milliseconds of the port's
``seqrec::assemble`` span, one payload's assembly on the batcher's
assembly thread (the cut sampler and the model's extras,
``models/base.py:_assembled``), over the payloads of the host-traced call.
The span is in the port's buffer (``utils/tracing.py:spans``), not in the
trace. Layer: the batcher's assembly thread; against the dispatch's time,
how near the batcher is to pacing the loop."""

from __future__ import annotations

from benchmark.harness import spans


def read(run):
    return spans.mean_ms(spans.program_spans(), "seqrec::assemble")
