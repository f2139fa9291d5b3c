"""Catalog scoring and top-k over a column-sharded output table.

Counterpart of ``seqrec_tpu/parallel/topk.py``. With ``W_out``'s columns
sharded over "model", each rank scores only its slice of the catalog with
the fused score + seen-mask + top-k kernel (K4,
``ops/score_topk.py:fused_score_topk``; ``ops/pallas_topk.py:17-20`` names
K4 the per-shard kernel of this path), on the seen ids that fall in its
range; only its ``[B, k]`` candidates cross to the other model ranks (an
all-gather), and a merge keeps the k best. The order is K4's, (value
descending, id ascending), with (-inf, INT32_MAX) for empty slots, so the
merged list is exactly the unsharded K4's: every item of the global top k
is in the top k of its own shard under that order.

A list longer than K4's ``MAX_K`` (``--save_rank`` ranks the whole
catalog) takes the two-pass route of ``models/base.py:_topk``: the masked
local scores, all-gathered over "model", sorted.

:func:`sharded_top_k` is the same merge for scores a model computes
itself on its columns (the cluster models' validation, the autoencoder):
each shard's ``top_k_sorted`` with global ids, merged in the same order.
"""

from __future__ import annotations

import torch

from seqrec_tpu_torch.ops.core import mask_seen, top_k_sorted
from seqrec_tpu_torch.ops.score_topk import MAX_K, fused_score_topk
from seqrec_tpu_torch.parallel.collectives import all_gather

_EMPTY_ID = torch.iinfo(torch.int32).max


def merge_topk(values, ids, k: int):
    """The k best of candidate (values, ids) [B, C] by value descending,
    then id ascending (two stable sorts: ``torch.topk`` keeps no tie
    order)."""
    by_id = torch.argsort(ids, dim=1, stable=True)
    values, ids = values.gather(1, by_id), ids.gather(1, by_id)
    by_value = torch.argsort(values, dim=1, descending=True, stable=True)[:, :k]
    return values.gather(1, by_value), ids.gather(1, by_value)


def sharded_score_topk(mesh, h, w_out, b_out, seen_ids=None, seen_mask=None, k: int = 10):
    """Global top-k (values f32 [B, k], ids int32 [B, k], best first) of
    h [B, H] · W_out + b_out with the seen ids masked, where w_out [H, N/M]
    and b_out [N/M] are this rank's columns of a table sharded evenly over
    "model" and seen_ids/seen_mask [B, S] hold global ids. The same on
    every model rank."""
    n_local = w_out.shape[1]
    col0 = mesh.coords["model"] * n_local
    if seen_ids is not None:
        seen_ids, seen_mask = local_seen(seen_ids, seen_mask, col0, n_local)
        seen_ids, seen_mask = seen_ids.to(torch.int32).contiguous(), seen_mask.contiguous()
    if k > MAX_K:
        scores = mask_seen(h @ w_out + b_out, seen_ids, seen_mask)
        return top_k_sorted(all_gather(scores, mesh, "model", dim=1), k)
    values, ids = fused_score_topk(h, w_out, b_out, seen_ids, seen_mask, k=k)
    ids = torch.where(ids == _EMPTY_ID, ids, ids + col0)
    if mesh.groups["model"] is None:
        return values, ids
    return merge_topk(all_gather(values, mesh, "model", dim=1), all_gather(ids, mesh, "model", dim=1), k)


def local_seen(seen_ids, seen_mask, col0: int, n_local: int):
    """Global seen ids [B, S] as columns of the shard [col0, col0 +
    n_local): another shard's item becomes a slot whose mask is 0, at a
    valid column."""
    local = seen_ids - col0
    owned = (local >= 0) & (local < n_local)
    if seen_mask is None:
        seen_mask = torch.ones(seen_ids.shape, dtype=torch.float32, device=seen_ids.device)
    return torch.where(owned, local, 0), torch.where(owned, seen_mask, 0.0)


def sharded_top_k(mesh, scores, col0: int, k: int):
    """Global top-k (values [B, k], ids int32 [B, k]) in (value descending,
    id ascending) order of scores [B, N/M], this rank's columns from
    ``col0`` on of a catalog sharded evenly over "model": each shard's k
    best (``top_k_sorted``, empty slots (-inf, INT32_MAX)) with global ids,
    all-gathered over "model" and merged. Any k, up to the whole catalog.
    The same on every model rank."""
    values, ids = top_k_sorted(scores, k)
    ids = torch.where(ids == _EMPTY_ID, ids, ids + col0)
    return merge_topk(all_gather(values, mesh, "model", dim=1), all_gather(ids, mesh, "model", dim=1), k)
