"""``transfer_ms_per_payload``: mean host milliseconds of the port's
``seqrec::transfer`` span, one payload's upload on the batcher's transfer
thread (the mesh's row slicing, the pinning and the non-blocking copies'
enqueue, ``models/base.py:_payload_pipeline``), over the payloads of the
host-traced call. The span is in the port's buffer
(``utils/tracing.py:spans``), not in the trace. Layer: the batcher's
transfer thread."""

from __future__ import annotations

from benchmark.harness import spans


def read(run):
    return spans.mean_ms(spans.program_spans(), "seqrec::transfer")
