"""The port's input gather-sum (``seqrec_tpu_torch/ops/gather_sum.py``) on
the CPU against the JAX package's ``seqrec_tpu/ops/core.py:gather_sum``
(an XLA gather and scatter-add; no Pallas kernel): the wrapper's forward
and its table gradient against ``jax.vjp``, and a numpy emulation of the
CUDA backward (``csrc/gather_sum.cu``) against the plain gradient and
``jax.vjp``: its order kernel's stable sort by row as its clusters, CTAs
and warps compute it (at the kernel's two shapes and at small ones, so that
rows fall in several clusters and runs across several warps' shares of the
slots), the places of the chunk partials, and every sum in the documented
order.

Tolerances: f32 on both sides. The forward adds at most fourteen slots,
so it agrees to rtol 1e-6 (atol 1e-6). Gradients sum up to a few hundred
rows in another order: rtol 1e-5, atol 1e-5 times the largest entry.

The CUDA kernels themselves need a card; chip_smoke.py holds them against
the plain version there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seqrec_tpu.ops.core import gather_sum as jax_gather_sum
from seqrec_tpu_torch.ops.core import gather_sum as gather_sum_plain
from seqrec_tpu_torch.ops.core import gather_sum_table_grad as gather_sum_table_grad_plain
from seqrec_tpu_torch.ops.gather_sum import (
    SEGMENT,
    bwd_scratch_bytes,
    gather_sum,
    gather_sum_bwd,
    gather_sum_fwd,
    gather_sum_table_grad,
)

N_ROWS, D = 40, 7
# csrc/gather_sum.cu's order kernel: (rows a cluster, warps a CTA, CTAs a cluster) up to 8,192 rows, and above
ORDER_NARROW, ORDER_WIDE = (256, 32, 8), (1024, 8, 8)
DENSE_WARPS = 8  # csrc/gather_sum.cu: kWarps, the warps of a dense-rows block


def _case(name, seed=0):
    """(table [N, D], ids [..., F], id_mask or None) for one case."""
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(N_ROWS, D)).astype(np.float32)
    B, L = 6, 30
    if name == "skewed":  # half the positions at id 0, as the compact wire pads; the rest Zipf-like
        ids = np.minimum(rng.zipf(1.3, size=(B, L, 1)), N_ROWS - 1).astype(np.int32)
        ids[:, L // 2 :, 0] = 0
        return table, ids, None
    if name == "pad_slots":  # negative ids add 0 and get no gradient
        ids = rng.integers(-1, N_ROWS, size=(B, L, 3)).astype(np.int32)
        return table, ids, None
    if name == "two_slots_masked":  # F=2 with pad slots and an id_mask
        ids = rng.integers(0, N_ROWS, size=(B, L, 2)).astype(np.int32)
        ids[:, ::4, 1] = -1
        id_mask = (rng.random(size=(B, L, 2)) < 0.8).astype(np.float32) * rng.uniform(0.5, 2.0, size=(B, L, 2))
        return table, ids, id_mask.astype(np.float32)
    if name == "single_and_empty":  # id 3 appears once, rows 5.. never: an empty row of the gradient
        ids = rng.integers(0, 3, size=(B, L, 1)).astype(np.int32)
        ids[2, 7, 0] = 3
        return table, ids, None
    if name == "int16_wire":  # the compact wire's int16 ids
        ids = rng.integers(0, N_ROWS, size=(B, L, 1)).astype(np.int16)
        ids[:, 20:, 0] = 0
        return table, ids, None
    if name == "ltm_contexts":  # LTM's syn0 update: [positions, 2 x window] contexts, -1 pads with mask 0
        ids = rng.integers(0, N_ROWS, size=(64, 10)).astype(np.int32)
        ids[rng.random(size=ids.shape) < 0.2] = -1
        return table, ids, (ids >= 0).astype(np.float32)
    if name == "featured_int16":  # F=14 side-feature ids, int16, -1 pads; a user-block id at every step
        ids = rng.integers(0, N_ROWS - 1, size=(4, L, 14)).astype(np.int16)
        ids[..., 13] = N_ROWS - 1
        ids[..., 5:9][rng.random(size=(4, L, 4)) < 0.5] = -1
        return table, ids, None
    if name == "i_concat_j":  # BPRMF's H scatter: the users' i, then their j, as one F=1 column (int64)
        i, j = rng.integers(0, N_ROWS, size=64), rng.integers(0, N_ROWS, size=64)
        return table, np.concatenate([i, j])[:, None].astype(np.int64), None
    if name == "long_run":  # one id at 150 scattered slots: a run of several chunks across warps' shares
        ids = rng.integers(0, N_ROWS, size=(B, L, 1)).astype(np.int32)
        ids.reshape(-1)[rng.choice(B * L, size=150, replace=False)] = 11
        return table, ids, None
    if name == "adjacent_long_runs":  # rows 7 and 8 both past S: a later chunk and a first one in one window
        ids = np.concatenate([np.full(33, 7), np.full(40, 8), rng.choice(np.r_[0:7, 9:N_ROWS], size=107)])
        return table, rng.permutation(ids).reshape(B, L, 1).astype(np.int32), None
    raise ValueError(name)


CASES = ["skewed", "pad_slots", "two_slots_masked", "single_and_empty", "int16_wire",
         "ltm_contexts", "featured_int16", "i_concat_j", "long_run", "adjacent_long_runs"]


def _jax_value_and_grad(table, ids, id_mask, ct):
    m = None if id_mask is None else jnp.asarray(id_mask)
    fn = lambda tb: jax_gather_sum(tb, jnp.asarray(ids.astype(np.int32)), m)  # noqa: E731
    out, vjp = jax.vjp(fn, jnp.asarray(table))
    return np.asarray(out), np.asarray(vjp(jnp.asarray(ct))[0])


def _plain_grad(table, ids, id_mask, ct):
    tt = torch.tensor(table, requires_grad=True)
    m = None if id_mask is None else torch.from_numpy(id_mask)
    out = gather_sum_plain(tt, torch.from_numpy(ids), m)
    return torch.autograd.grad(out, tt, torch.from_numpy(ct))[0].numpy()


def _cotangent(ids, seed):
    return np.random.default_rng(seed).normal(size=(*ids.shape[:-1], D)).astype(np.float32)


@pytest.mark.parametrize("case", CASES)
def test_gather_sum_wrapper_matches_jax_value_and_table_gradient(case):
    table, ids, id_mask = _case(case)
    ct = _cotangent(ids, 9)
    want_out, want_grad = _jax_value_and_grad(table, ids, id_mask, ct)
    tt = torch.tensor(table, requires_grad=True)
    out = gather_sum(tt, torch.from_numpy(ids), None if id_mask is None else torch.from_numpy(id_mask))
    got_grad = torch.autograd.grad(out, tt, torch.from_numpy(ct))[0].numpy()
    np.testing.assert_allclose(out.detach().numpy(), want_out, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got_grad, want_grad, rtol=1e-5, atol=1e-5 * np.abs(want_grad).max())
    seen = np.unique(ids[ids >= 0])
    unseen = np.setdiff1d(np.arange(N_ROWS), seen)
    assert not got_grad[unseen].any() and not want_grad[unseen].any()  # rows no slot names get 0


def _order(ids, n_rows, rows_per_cluster, warps, ctas):
    """csrc/gather_sum.cu:order_kernel in numpy: (row_start [N + 1], perm,
    srow). A cluster of ``ctas`` CTAs owns ``rows_per_cluster`` rows; CTA q
    of it reads the q-th share of the slots and its warp w the w-th share
    of that, twice: the (row, CTA, warp) counts, their exclusive scan in
    (row, CTA, warp) order from the count of real slots of lower rows, then
    each slot at its triple's next position in slot order. Unwritten
    positions stay -1."""
    flat = ids.reshape(-1).astype(np.int64)
    P = flat.size
    cta_share = -(-P // ctas)
    share = -(-cta_share // warps)
    workers = []  # (first slot, end) of each (CTA, warp), in (CTA, warp) order
    for q in range(ctas):
        cta_hi = min(P, (q + 1) * cta_share)
        for w in range(warps):
            lo = min(cta_hi, q * cta_share + w * share)
            workers.append((lo, min(cta_hi, lo + share)))
    perm, srow = np.full(P, -1, np.int64), np.full(P, -1, np.int64)
    row_start = np.full(n_rows + 1, -1, np.int64)
    for r0 in range(0, n_rows, rows_per_cluster):
        rows = min(rows_per_cluster, n_rows - r0)
        cnt = np.zeros((rows, len(workers)), np.int64)
        below = 0
        for k, (lo, hi) in enumerate(workers):
            part = flat[lo:hi]
            below += int(((part >= 0) & (part < r0)).sum())
            np.add.at(cnt[:, k], part[(part >= r0) & (part < r0 + rows)] - r0, 1)
        start = (below + np.cumsum(cnt.reshape(-1)) - cnt.reshape(-1)).reshape(cnt.shape)
        row_start[r0 : r0 + rows] = start[:, 0]
        if r0 + rows == n_rows:
            row_start[n_rows] = below + cnt.sum()
        for k, (lo, hi) in enumerate(workers):
            for s in range(lo, hi):
                u = flat[s] - r0
                if 0 <= u < rows:
                    perm[start[u, k]], srow[start[u, k]] = s, r0 + u
                    start[u, k] += 1
    assert sum(hi - lo for lo, hi in workers) == P  # the shares cover every slot once
    return row_start, perm, srow


def _chunks(row_start, srow):
    """chunk_sums_kernel's chunks, window by window: [(partial index, first
    sorted position, end)] for each row of more than S slots."""
    n_sorted = row_start[-1]
    out = []
    for w in range(-(-n_sorted // SEGMENT)):
        for pos in range(w * SEGMENT, min((w + 1) * SEGMENT, n_sorted)):
            rs, re = row_start[srow[pos]], row_start[srow[pos] + 1]
            if re - rs > SEGMENT and (pos - rs) % SEGMENT == 0:
                out.append((2 * w + (pos == rs), pos, min(pos + SEGMENT, re)))
    return out


def _emulate_backward(ct, ids, id_mask, n_rows, order=ORDER_NARROW):
    """The CUDA backward's arithmetic in numpy f32, step by step: the order
    kernel's sort, each chunk's rows in slot order into its partial (launch
    2), then each row its short run in slot order, or zeros, or, for a row
    of K chunks, warp j of DENSE_WARPS the partials of chunks j, j +
    DENSE_WARPS, ... in order and the row those sums in warp order (launch
    3)."""
    row_start, perm, srow = _order(ids, n_rows, *order)
    F = ids.shape[-1]
    g = ct.reshape(-1, ct.shape[-1])
    m = np.ones(ids.size, np.float32) if id_mask is None else id_mask.reshape(-1)

    def run(s0, s1):
        acc = np.zeros(g.shape[1], np.float32)
        for j in range(s0, s1):
            acc = acc + g[perm[j] // F] * m[perm[j]]
        return acc

    part = {at: run(s0, s1) for at, s0, s1 in _chunks(row_start, srow)}
    out = np.zeros((n_rows, g.shape[1]), np.float32)
    for i in range(n_rows):
        s0, s1 = row_start[i], row_start[i + 1]
        if s1 - s0 > SEGMENT:
            starts = range(s0, s1, SEGMENT)
            acc = np.zeros(g.shape[1], np.float32)
            for j in range(DENSE_WARPS):
                warp_sum = np.zeros(g.shape[1], np.float32)
                for at in starts[j::DENSE_WARPS]:
                    warp_sum = warp_sum + part[2 * (at // SEGMENT) + (at == s0)]
                acc = acc + warp_sum
            out[i] = acc
        else:
            out[i] = run(s0, s1)
    return out


@pytest.mark.parametrize("case", CASES)
def test_backward_order_gives_the_plain_and_jax_gradient_and_the_same_bits_twice(case):
    table, ids, id_mask = _case(case, seed=3)
    ct = _cotangent(ids, 4)
    got = _emulate_backward(ct, ids, id_mask, N_ROWS)
    for want in (_plain_grad(table, ids, id_mask, ct), _jax_value_and_grad(table, ids, id_mask, ct)[1]):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    again = _emulate_backward(ct, ids, id_mask, N_ROWS)
    np.testing.assert_array_equal(got.view(np.int32), again.view(np.int32))


@pytest.mark.parametrize("order", [ORDER_NARROW, ORDER_WIDE, (8, 4, 3), (3, 7, 2)],
                         ids=["narrow", "wide", "r8w4c3", "r3w7c2"])
@pytest.mark.parametrize("case", CASES)
def test_order_kernel_sorts_stably_and_sums_each_slot_once_whatever_its_shape(case, order):
    """The order kernel's sort is the stable sort by row with pad slots
    left out, at any rows a cluster, warps a CTA and CTAs a cluster (the
    kernel's two shapes and small ones); each real slot is
    summed exactly once, by a chunk of at most S slots of one row (rows of
    more than S) or by its row's short run; the chunk partials' places are
    distinct and inside the scratch (bwd_scratch_bytes); and the gradient
    has the same bits as at the kernel's narrow shape: the ids alone fix
    the order."""
    _, ids, id_mask = _case(case, seed=5)
    row_start, perm, srow = _order(ids, N_ROWS, *order)
    flat = ids.reshape(-1).astype(np.int64)
    real = np.flatnonzero(flat >= 0)
    n_sorted = real.size
    np.testing.assert_array_equal(perm[:n_sorted], real[np.argsort(flat[real], kind="stable")])
    np.testing.assert_array_equal(srow[:n_sorted], flat[perm[:n_sorted]])
    assert not (perm[n_sorted:] + 1).any()  # pad slots are placed nowhere
    np.testing.assert_array_equal(row_start, np.searchsorted(flat[perm[:n_sorted]], np.arange(N_ROWS + 1)))

    chunks = _chunks(row_start, srow)
    n_windows = -(-ids.size // SEGMENT)
    places = [at for at, _, _ in chunks]
    assert len(set(places)) == len(places) and all(0 <= at < 2 * n_windows for at in places)
    assert bwd_scratch_bytes(ids.size, N_ROWS, D) == 4 * (2 * n_windows * D + N_ROWS + 1 + 2 * ids.size)
    covered = np.zeros(ids.size, np.int64)
    for i in range(N_ROWS):
        s0, s1 = row_start[i], row_start[i + 1]
        mine = [(p0, p1) for _, p0, p1 in chunks if s0 <= p0 < s1]
        if s1 - s0 <= SEGMENT:
            assert not mine
            covered[perm[s0:s1]] += 1
            continue
        assert [p0 for p0, _ in mine] == list(range(s0, s1, SEGMENT)) and mine[-1][1] == s1
        for p0, p1 in mine:
            assert 0 < p1 - p0 <= SEGMENT
            covered[perm[p0:p1]] += 1
    np.testing.assert_array_equal(covered[real], 1)
    assert not np.delete(covered, real).any()  # pad slots: nobody sums them

    ct = _cotangent(ids, 6)
    got = _emulate_backward(ct, ids, id_mask, N_ROWS, order)
    np.testing.assert_array_equal(got.view(np.int32), _emulate_backward(ct, ids, id_mask, N_ROWS).view(np.int32))


def test_gather_sum_runs_plain_on_cpu_and_its_kernels_refuse_cpu_tensors():
    gather_sum_fwd.launches = gather_sum_bwd.launches = 0
    table, ids, id_mask = (torch.from_numpy(a) for a in _case("two_slots_masked"))
    torch.testing.assert_close(gather_sum(table, ids, id_mask), gather_sum_plain(table, ids, id_mask), rtol=0, atol=0)
    g = torch.zeros(*ids.shape[:-1], D)
    torch.testing.assert_close(gather_sum_table_grad(g + 1, ids, id_mask, N_ROWS),
                               gather_sum_table_grad_plain(g + 1, ids, id_mask, N_ROWS), rtol=0, atol=0)
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        gather_sum_fwd(table, ids, id_mask)
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        gather_sum_bwd(g, ids, id_mask, N_ROWS)
    assert gather_sum_fwd.launches == gather_sum_bwd.launches == 0

