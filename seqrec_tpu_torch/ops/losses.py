"""Loss functions of the RNN heads (counterpart of
``seqrec_tpu/ops/losses.py``), in plain PyTorch: the JAX package leaves
them to XLA, not to Pallas.

- CCE with diversity bias: ``mean(CCE / target_popularity^db)``.
- Sampled losses over a score matrix ``[b, B+S]`` whose first ``B``
  columns score the batch's targets and whose last ``S`` columns score
  shared negative samples; row ``i``'s own target is column
  ``offset + i`` (``offset`` 0 and ``b = B``: the diagonal of the left
  block; under a mesh a data rank holds rows ``offset ...`` of the global
  batch and scores them against all ``B`` targets, as the JAX package's
  global program does). The cluster models' set (``CLUSTER_LOSSES``) adds
  a sampled CCE, a linear loss and a leaky-relu BPR.
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
# sampled losses (scores: [b, B+S]; row i's own target at column offset + i)
# ----------------------------------------------------------------------
def _own(x: torch.Tensor, offset: int) -> torch.Tensor:
    """Each row's own-target entry: the diagonal of the [b, b] block from
    column ``offset``."""
    return torch.diagonal(x[:, offset : offset + x.shape[0]])


def blackout_loss(scores: torch.Tensor, batch_size: int, offset: int = 0) -> torch.Tensor:
    """BlackOut: softmax over [b, B+S]; CCE of the own target minus the sum
    over the samples of log(1 - p)."""
    logp = torch.log_softmax(scores, dim=-1)
    diag = _own(logp, offset)
    log1m = torch.log1p(-torch.exp(logp[:, batch_size:]))
    return -diag - log1m.sum(dim=-1)


def bpr_loss(scores: torch.Tensor, batch_size: int, offset: int = 0) -> torch.Tensor:
    """BPR: -mean_s log sigma(target - sample)."""
    diag = _own(scores, offset)
    diff = scores[:, batch_size:] - diag[:, None]
    return -F.logsigmoid(-diff).mean(dim=-1)


def top1_loss(scores: torch.Tensor, batch_size: int, offset: int = 0) -> torch.Tensor:
    """TOP1: mean_s sigma(sample - target) + sigma(sample^2)."""
    diag = _own(scores, offset)
    diff = scores[:, batch_size:] - diag[:, None]
    reg = torch.square(scores[:, batch_size:])
    return (torch.sigmoid(diff) + torch.sigmoid(reg)).mean(dim=-1)


def cce_sampled_loss(scores: torch.Tensor, batch_size: int, offset: int = 0) -> torch.Tensor:
    """CCE over the sampled score matrix: -log softmax of the own target."""
    logp = torch.log_softmax(scores, dim=-1)
    return -_own(logp, offset)


def lin_loss(scores: torch.Tensor, batch_size: int, offset: int = 0) -> torch.Tensor:
    """Linear loss: the sum over the samples minus the own target."""
    diag = _own(scores, offset)
    return scores[:, batch_size:].sum(dim=-1) - diag


def bprelu_loss(scores: torch.Tensor, batch_size: int, offset: int = 0) -> torch.Tensor:
    """Leaky-relu approximation of BPR: mean_s leaky_relu(sample - target +
    0.5), slope 0.01. Written as JAX's ``where(x >= 0, x, 0.01 x)``, whose
    derivative at 0 is 1 (``F.leaky_relu``'s is the slope)."""
    diag = _own(scores, offset)
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


# ----------------------------------------------------------------------
# the dense CCE over a catalog sharded over the mesh's "model" axis
# ----------------------------------------------------------------------
class _VocabParallelCCE(torch.autograd.Function):
    """Per-example CCE [B] of local logits [B, N/M] (the rank's columns,
    from ``col0`` on) and global targets [B]: the max, the sum of exp and
    the target logit combined over "model"; the backward is the local
    softmax minus the local one-hot, with no collective (the cotangent of
    ``h`` is summed over "model" by ``copy_to_model``)."""

    @staticmethod
    def forward(ctx, logits, targets, mesh, col0):
        from seqrec_tpu_torch.parallel.collectives import all_reduce

        t_rel = targets.long() - col0
        owned = (t_rel >= 0) & (t_rel < logits.shape[1])
        m = all_reduce(logits.max(dim=1).values, mesh, "model", op="max")
        e = torch.exp(logits - m[:, None])
        s = all_reduce(e.sum(dim=1), mesh, "model")
        tl = torch.where(owned, logits.gather(1, t_rel.clamp(0, logits.shape[1] - 1)[:, None])[:, 0], 0.0)
        tl = all_reduce(tl, mesh, "model")
        ctx.save_for_backward(e, s, t_rel)
        return torch.log(s) + m - tl

    @staticmethod
    def backward(ctx, g):
        e, s, t_rel = ctx.saved_tensors
        cols = torch.arange(e.shape[1], device=e.device)
        onehot = (cols[None, :] == t_rel[:, None]).to(e.dtype)
        return g[:, None] * (e / s[:, None] - onehot), None, None, None


def sharded_out_matmul(h, w_out, b_out, mesh, compute_dtype: str = "float32") -> torch.Tensor:
    """The local logits h W_out + b_out [B, N/M] of this rank's columns of a
    column-sharded output layer, h replicated over "model": f32
    (``copy_to_model``), or with ``compute_dtype="bfloat16"`` bf16 operands
    and an f32 result (``ops.core.matmul_bf16`` on the shard, its
    cotangents summed over the mesh before their rounding), as
    ``models/base.py:_out_matmul`` computes the whole product."""
    from seqrec_tpu_torch.ops.core import matmul_bf16
    from seqrec_tpu_torch.parallel.collectives import copy_to_model

    if compute_dtype == "bfloat16":
        return matmul_bf16(h, w_out, mesh, b_sharded=True) + b_out
    return copy_to_model(h, mesh) @ w_out + b_out


def vocab_parallel_cce(h, w_out, b_out, targets, target_pop, mesh, col0: int,
                       compute_dtype: str = "float32") -> torch.Tensor:
    """``diversity_biased_cce(h @ W_out + b_out, targets, target_pop)`` with
    W_out [H, N/M] and b_out [N/M] this rank's columns (from ``col0``) of a
    column-sharded output layer, h [B, H] the rank's rows (the same on
    every model rank): the local logits from ``torch.matmul`` in the
    compute dtype (:func:`sharded_out_matmul`; the JAX package computes
    this product outside any Pallas kernel), the CCE combined over
    "model". The loss is the same on every model rank."""
    logits = sharded_out_matmul(h, w_out, b_out, mesh, compute_dtype)
    return (_VocabParallelCCE.apply(logits, targets, mesh, col0) / target_pop).mean()
