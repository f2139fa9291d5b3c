"""Loss functions of the CCE head (counterpart of
``seqrec_tpu/ops/losses.py:log_softmax_cce`` and ``diversity_biased_cce``),
in plain PyTorch: the JAX package leaves them to XLA, not to Pallas."""

from __future__ import annotations

import torch


def log_softmax_cce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-example categorical cross-entropy [B] from raw logits [B, N] and
    int targets [B]."""
    logz = torch.logsumexp(logits, dim=-1)
    return logz - logits.gather(-1, targets.long()[:, None])[:, 0]


def diversity_biased_cce(logits, targets, target_pop) -> torch.Tensor:
    """mean(CCE / pop^db); ``target_pop`` is already ``pop**db``."""
    return (log_softmax_cce(logits, targets) / target_pop).mean()
