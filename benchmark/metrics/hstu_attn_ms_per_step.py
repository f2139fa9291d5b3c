"""``hstu_attn_ms_per_step``: device milliseconds an optimizer step of the
operations launched under HSTU's attention (its autograd Function forward,
``ops/hstu_attention.py:_HSTUAttention``, and its backward node), over the
traced steps: eight blocks' attention forward and backward. Layer: HSTU's
attention."""

from __future__ import annotations

ENTRIES = ("_HSTUAttention", "_HSTUAttentionBackward")


def read(run):
    seconds = run.trace.device_seconds_under(ENTRIES)
    if seconds <= 0 or not run.step_stats:
        return None
    return 1e3 * seconds / len(run.step_stats)
