"""The training batches, worked out again from the dataset and the seed.

A frozen copy of the arithmetic of the port's cut sampler
(``seqrec_tpu_torch/models/base.py:_gen_cut_indices``, no shuffling) as the
K-step index wire draws it (``_gen_index_mini_batch`` with ``n_stack=K``:
one super-batch of K*B cuts at a time, split into K steps of B rows), and
of the wire's expansion on the device (``_expand_index_wire``): each row a
prefix of at most L items ending before its cut, left-aligned, pad id 0,
and the item at the cut as its target. The batch generator is
``np.random.default_rng(seed + 77)``, as the port's training loop seeds it.
"""

from __future__ import annotations

import numpy as np


def cut_indices(lengths: np.ndarray, seed: int, n: int):
    """Yields ``(rows, cuts)`` int64 [n]: cuts of the sequences in store
    order, several a sequence, each super-batch filled in draw order."""
    rng = np.random.default_rng(seed + 77)
    order = np.where(lengths >= 3)[0]
    if len(order) == 0:
        raise ValueError("no trainable sequences (all shorter than 3)")
    pos = len(order)
    while True:
        rows = np.empty(n, dtype=np.int64)
        cuts = np.empty(n, dtype=np.int64)
        j = 0
        while j < n:
            if pos >= len(order):
                pos = 0
            r = order[pos]
            pos += 1
            k = int(min(n - j, lengths[r] - 2))
            if k == lengths[r] - 2:
                cuts[j : j + k] = np.arange(2, lengths[r])
            else:
                cuts[j : j + k] = np.sort(rng.choice(np.arange(2, lengths[r]), size=k, replace=False))
            rows[j : j + k] = r
            j += k
        yield rows, cuts


def steps(items: np.ndarray, offsets: np.ndarray, seed: int, B: int, K: int, L: int):
    """Yields each step's ``(ids int64 [B, L], lengths int64 [B], targets
    int64 [B])`` in training order."""
    lengths = np.diff(offsets)
    for rows, cuts in cut_indices(lengths, seed, K * B):
        for k in range(K):
            r, c = rows[k * B : (k + 1) * B], cuts[k * B : (k + 1) * B]
            start = np.maximum(c - L, 0)
            m = c - start
            t = np.arange(L)[None, :]
            valid = t < m[:, None]
            flat = np.where(valid, offsets[r][:, None] + start[:, None] + t, 0)
            ids = np.where(valid, items[flat], 0)
            yield ids, m, items[offsets[r] + c]


def step_stats(items: np.ndarray, offsets: np.ndarray, seed: int, B: int, K: int, L: int, n_steps: int) -> list:
    """Per step of the first ``n_steps``: the valid positions (the sum of
    the prefix lengths) and the distinct items among them."""
    out = []
    for i, (ids, m, _) in enumerate(steps(items, offsets, seed, B, K, L)):
        if i == n_steps:
            break
        valid = np.arange(L)[None, :] < m[:, None]
        out.append({"valid": int(m.sum()), "unique_rows": int(len(np.unique(ids[valid])))})
    return out
