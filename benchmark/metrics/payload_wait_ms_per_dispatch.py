"""``payload_wait_ms_per_dispatch``: host milliseconds the training loop
waits for its next payload a dispatch, in the host-traced call: the port's
``seqrec::wait_payload`` spans (``next(batch_generator)`` in
``models/base.py:train``) after the first, which is the pipeline's fill,
over the ``seqrec::dispatch`` spans after the first. Layer: the train loop.
Near 0 while the batcher keeps ahead of the card; it grows where the
batcher paces the loop."""

from __future__ import annotations

from benchmark.harness import spans


def read(run):
    waits = spans.durations(run.trace, "seqrec::wait_payload")
    n = run.trace.count("seqrec::dispatch")
    if n < 2 or len(waits) < 2:
        return None
    return 1e3 * sum(waits[1:]) / (n - 1)
