"""Loss functions of the RNN heads (counterpart of
``seqrec_tpu/ops/losses.py``), in plain PyTorch: the JAX package leaves
them to XLA, not to Pallas.

- CCE with diversity bias: ``mean(CCE / target_popularity^db)``.
- Sampled losses over a score matrix ``[B, B+S]`` whose first ``B``
  columns score each example's own target (the diagonal of the left
  block) and whose last ``S`` columns score shared negative samples; the
  cluster models' set (``CLUSTER_LOSSES``) adds a sampled CCE, a linear
  loss and a leaky-relu BPR.
- Margin losses over dense target and weight matrices, summed over the
  catalog.

Each keeps the JAX package's expression (``log1p(-exp(logp))`` for
Blackout, ``-log_sigmoid`` for BPR and logsig), so values and gradients
agree to the last bits of f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def log_softmax_cce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-example categorical cross-entropy [B] from raw logits [B, N] and
    int targets [B]."""
    logz = torch.logsumexp(logits, dim=-1)
    return logz - logits.gather(-1, targets.long()[:, None])[:, 0]


def diversity_biased_cce(logits, targets, target_pop) -> torch.Tensor:
    """mean(CCE / pop^db); ``target_pop`` is already ``pop**db``."""
    return (log_softmax_cce(logits, targets) / target_pop).mean()


def l1_penalty(x: torch.Tensor) -> torch.Tensor:
    """sum |x| with JAX's derivative of |x| at 0, which is +1 (``torch.abs``
    gives 0 there, and parameters such as ``b_out`` start at exactly 0)."""
    return torch.sum(torch.where(x >= 0, x, -x))


# ----------------------------------------------------------------------
# sampled losses (scores: [B, B+S], diagonal of the left block = own target)
# ----------------------------------------------------------------------
def blackout_loss(scores: torch.Tensor, batch_size: int) -> torch.Tensor:
    """BlackOut: softmax over [B, B+S]; CCE of the own target minus the sum
    over the samples of log(1 - p)."""
    logp = torch.log_softmax(scores, dim=-1)
    diag = torch.diagonal(logp[:, :batch_size])
    log1m = torch.log1p(-torch.exp(logp[:, batch_size:]))
    return -diag - log1m.sum(dim=-1)


def bpr_loss(scores: torch.Tensor, batch_size: int) -> torch.Tensor:
    """BPR: -mean_s log sigma(target - sample)."""
    diag = torch.diagonal(scores[:, :batch_size])
    diff = scores[:, batch_size:] - diag[:, None]
    return -F.logsigmoid(-diff).mean(dim=-1)


def top1_loss(scores: torch.Tensor, batch_size: int) -> torch.Tensor:
    """TOP1: mean_s sigma(sample - target) + sigma(sample^2)."""
    diag = torch.diagonal(scores[:, :batch_size])
    diff = scores[:, batch_size:] - diag[:, None]
    reg = torch.square(scores[:, batch_size:])
    return (torch.sigmoid(diff) + torch.sigmoid(reg)).mean(dim=-1)


def cce_sampled_loss(scores: torch.Tensor, batch_size: int) -> torch.Tensor:
    """CCE over the sampled score matrix: -log softmax of the own target."""
    logp = torch.log_softmax(scores, dim=-1)
    return -torch.diagonal(logp[:, :batch_size])


def lin_loss(scores: torch.Tensor, batch_size: int) -> torch.Tensor:
    """Linear loss: the sum over the samples minus the own target."""
    diag = torch.diagonal(scores[:, :batch_size])
    return scores[:, batch_size:].sum(dim=-1) - diag


def bprelu_loss(scores: torch.Tensor, batch_size: int) -> torch.Tensor:
    """Leaky-relu approximation of BPR: mean_s leaky_relu(sample - target +
    0.5), slope 0.01. Written as JAX's ``where(x >= 0, x, 0.01 x)``, whose
    derivative at 0 is 1 (``F.leaky_relu``'s is the slope)."""
    diag = torch.diagonal(scores[:, :batch_size])
    x = scores[:, batch_size:] - diag[:, None] + 0.5
    return torch.where(x >= 0, x, 0.01 * x).mean(dim=-1)


SAMPLED_LOSSES = {"Blackout": blackout_loss, "BPR": bpr_loss, "TOP1": top1_loss}

# the cluster models' item and cluster objectives (one loss serves both)
CLUSTER_LOSSES = {
    "Blackout": blackout_loss,
    "CCE": cce_sampled_loss,
    "lin": lin_loss,
    "BPR": bpr_loss,
    "BPRelu": bprelu_loss,
    "TOP1": top1_loss,
}


# ----------------------------------------------------------------------
# margin losses (multi-target; summed over the last axis)
# ----------------------------------------------------------------------
def hinge_loss(predictions, targets, weights):
    return torch.relu((predictions - targets) * weights).sum(dim=-1)


def logit_loss(predictions, targets, weights):
    return (torch.sigmoid(predictions - targets) * weights).sum(dim=-1)


def logsig_loss(predictions, targets, weights):
    return -F.logsigmoid((targets - predictions) * weights).sum(dim=-1)


MARGIN_LOSSES = {"hinge": hinge_loss, "logit": logit_loss, "logsig": logsig_loss}
