"""Operations and bytes of HSTU's attention and the model flops of an HSTU
training sequence, counted as ``counts.py`` counts (the work, not an
implementation; padding is no work) and held to its peaks.

A row of m valid steps has m (m + 1) / 2 causal pairs in each block but
the last; the last block's output is read at step m - 1 alone, so there
only that row's m pairs (and its query, output and their gradients) are
work. Forward, a pair is 2 (dqk + dv) matrix flops a head (Q K^T and A V);
backward twice that (dA = dO V^T and dV = A^T dO; dQ = dS K and
dK = dS^T Q). Other arithmetic a pair and head: forward the rab lookup
and add, the sigmoid, x sigmoid(x) and the 1/n scale (4); backward the
recomputed x, its sigmoid, SiLU' = s (1 + x (1 - s)) (3), the products by
dA and the scale, and the rab gradient's add (8).
"""

from __future__ import annotations

import numpy as np

from benchmark.harness.counts import F32, Work

OTHER_OPS_PER_PAIR = 12  # a pair and head, forward and backward
RAB_BINS = 129  # the time term's table (HSTU's 128 buckets and the last)


def _pairs(m: np.ndarray, blocks: int) -> float:
    return (blocks - 1) * float((m * (m + 1) / 2).sum()) + float(m.sum())


def attention(lengths, blocks: int, heads: int, dqk: int, dv: int, L: int) -> Work:
    """One training step's attention, forward and backward, over rows of
    ``lengths`` valid steps (padded length L): the matrix flops and other
    arithmetic of its pairs; Q, K, V, O, dO, dQ, dK and dV each read or
    written once at the steps whose work it is, each block's bias tables
    (2 L - 1 position and 129 time entries) read and their gradients
    written once, the row lengths read."""
    m = np.asarray(lengths, dtype=np.float64)
    pairs = _pairs(m, blocks)
    steps, rows = float(m.sum()), len(m)
    per_step = 4 * dqk + 4 * dv  # Q, K, dQ, dK and V, O, dO, dV
    full = heads * steps * per_step
    last = heads * (steps * (2 * dqk + 2 * dv) + rows * (2 * dqk + 2 * dv))  # K, V and grads at m; Q, O at one
    tables = 2 * ((2 * L - 1) + RAB_BINS)
    moved = (blocks - 1) * full + last + blocks * (tables + rows)
    return Work(6 * heads * (dqk + dv) * pairs, OTHER_OPS_PER_PAIR * heads * pairs, F32 * moved)


def model_flops_per_sequence(m: float, d: int, blocks: int, heads: int, dqk: int, dv: int, N: int) -> float:
    """Matrix flops of a training sequence of m valid steps, forward and
    backward (3 times the forward): in each block but the last the U, V, Q,
    K projection and the output projection at every step and the
    attention's pairs; in the last the K and V columns at every step, U, Q,
    the attention and the output projection at step m - 1; the output
    layer's 2 d N."""
    proj = 2 * d * heads * (2 * dv + 2 * dqk)
    kv = 2 * d * heads * (dv + dqk)
    out = 2 * heads * dv * d
    pair = 2 * heads * (dqk + dv)
    full = m * (proj + out) + m * (m + 1) / 2 * pair
    last = m * kv + (proj - kv) + out + m * pair
    return 3 * ((blocks - 1) * full + last + 2 * d * N)
