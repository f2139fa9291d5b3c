"""Column and row gathers of the tables sharded over the mesh's "model"
axis, for the heads that score a few catalog items a step (the sampled
and cluster heads, the streaming margin's special columns).

The JAX package leaves these gathers of a sharded table to GSPMD
(``seqrec_tpu/ops/streaming_margin.py:sharded_streaming_margin`` names the
access pattern); here they are written out:

- :func:`gather_columns`: the full columns ``W[:, cols]`` and entries
  ``b[cols]`` of a column-sharded output layer, the same on every model
  rank. Each column comes from the shard that owns it, zeros from the
  others, summed over "model" (``reduce_from_model``): exact, since every
  column has one nonzero term;
- :func:`gather_rows`: the full rows ``T[ids]`` of a row-sharded table
  (the cluster tables), through the sharded gather-sum
  (``ops/gather_sum.py:sharded_gather_sum``, G1 on each shard) with one
  slot a row.

The gradient rule: the gathered columns (rows) are replicated over
"model", so every model rank computes the same cotangent for them;
``reduce_from_model``'s backward hands that cotangent to each shard
unchanged, and each shard scatters it into the columns (rows) it owns
alone (``index_select``'s backward, G1's backward), the others' entries
masked to 0. An activation that multiplies the gathered columns (``h``)
is replicated over "model" and gets its full gradient on every model
rank, so it needs no ``copy_to_model``.
"""

from __future__ import annotations

import torch

from seqrec_tpu_torch.parallel.collectives import reduce_from_model


def gather_columns(w, b, cols, mesh, col0: int):
    """(``W[:, cols]`` [H, C], ``b[cols]`` [C]) of the full output layer,
    where ``w`` [H, N/M] and ``b`` [N/M] are this rank's columns, from
    ``col0`` on, and ``cols`` [C] global column ids. The same on every
    model rank; one all-reduce over "model". Differentiable in ``w`` and
    ``b`` (the module docstring's gradient rule)."""
    n_local = w.shape[1]
    local = cols.long() - col0
    owned = (local >= 0) & (local < n_local)
    safe = torch.where(owned, local, 0)
    wb = torch.cat([w.index_select(1, safe), b.index_select(0, safe)[None, :]])
    wb = reduce_from_model(torch.where(owned[None, :], wb, 0.0), mesh)
    return wb[:-1], wb[-1]


def gather_rows(table, ids, mesh, row0: int):
    """``T[ids]`` [C, D] of the full table, where ``table`` [N/M, D] holds
    this rank's rows, from ``row0`` on, and ``ids`` [C] global row ids: G1
    on the shard with one slot a row (another shard's row: a pad slot),
    summed over "model". Differentiable in ``table``."""
    from seqrec_tpu_torch.ops.gather_sum import sharded_gather_sum

    return sharded_gather_sum(table, ids[:, None], None, mesh, row0)
