"""The port's input gather-sum (``seqrec_tpu_torch/ops/gather_sum.py``) on
the CPU against the JAX package's ``seqrec_tpu/ops/core.py:gather_sum``
(an XLA gather and scatter-add; no Pallas kernel): the wrapper's forward
and its table gradient against ``jax.vjp``, and a numpy emulation of the
CUDA backward's summation order (the sort, ``segment_plan``'s chunks,
then each row's chunk partials in chunk order) against the plain
gradient.

Tolerances: f32 on both sides. The forward adds at most two slots, so it
agrees to rtol 1e-6 (atol 1e-6). Gradients sum up to a few hundred rows
in another order: rtol 1e-5, atol 1e-5 times the largest entry.

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
from seqrec_tpu_torch.ops.gather_sum import (
    SEGMENT,
    chunk_bound,
    gather_sum,
    gather_sum_bwd,
    gather_sum_fwd,
    segment_order,
    segment_plan,
)

N_ROWS, D = 40, 7


def _case(name, seed=0):
    """(table [N, D], ids [B, L, F], id_mask or None) for one case."""
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
    raise ValueError(name)


CASES = ["skewed", "pad_slots", "two_slots_masked", "single_and_empty", "int16_wire"]


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


@pytest.mark.parametrize("case", CASES)
def test_gather_sum_wrapper_matches_jax_value_and_table_gradient(case):
    table, ids, id_mask = _case(case)
    ct = np.random.default_rng(9).normal(size=(*ids.shape[:-1], D)).astype(np.float32)
    want_out, want_grad = _jax_value_and_grad(table, ids, id_mask, ct)
    tt = torch.tensor(table, requires_grad=True)
    out = gather_sum(tt, torch.from_numpy(ids), None if id_mask is None else torch.from_numpy(id_mask))
    got_grad = torch.autograd.grad(out, tt, torch.from_numpy(ct))[0].numpy()
    np.testing.assert_allclose(out.detach().numpy(), want_out, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got_grad, want_grad, rtol=1e-5, atol=1e-5 * np.abs(want_grad).max())
    seen = np.unique(ids[ids >= 0])
    unseen = np.setdiff1d(np.arange(N_ROWS), seen)
    assert not got_grad[unseen].any() and not want_grad[unseen].any()  # rows no slot names get 0


def _chunks(row_start, row_chunk, segment):
    """[(first slot, end slot)] of every chunk of segment_plan's output, in
    chunk order: as csrc/gather_sum.cu's pass 1 finds them."""
    out = []
    for i in range(len(row_start) - 1):
        for k in range(row_chunk[i + 1] - row_chunk[i]):
            s0 = row_start[i] + k * segment
            out.append((s0, min(s0 + segment, row_start[i + 1])))
    return out


def _emulate_backward(ct, ids, id_mask, n_rows, segment):
    """The CUDA backward's arithmetic in numpy f32, step by step: the slots
    sorted by segment_order, chunks of segment_plan summed in slot order
    (pass 1), each row its chunk partials in chunk order, or its short run
    in slot order, or zeros (pass 2)."""
    sorted_ids, perm = segment_order(torch.from_numpy(ids), n_rows)
    row_start, row_chunk = (t.numpy() for t in segment_plan(sorted_ids, n_rows, segment))
    perm = perm.numpy()
    F = ids.shape[-1]
    g = ct.reshape(-1, ct.shape[-1])
    m = np.ones(ids.size, np.float32) if id_mask is None else id_mask.reshape(-1)

    def run(s0, s1):
        acc = np.zeros(g.shape[1], np.float32)
        for j in range(s0, s1):
            acc = acc + g[perm[j] // F] * m[perm[j]]
        return acc

    part = [run(s0, s1) for s0, s1 in _chunks(row_start, row_chunk, segment)]
    out = np.zeros((n_rows, g.shape[1]), np.float32)
    for i in range(n_rows):
        if row_chunk[i + 1] > row_chunk[i]:
            acc = np.zeros(g.shape[1], np.float32)
            for k in range(row_chunk[i], row_chunk[i + 1]):
                acc = acc + part[k]
            out[i] = acc
        else:
            out[i] = run(row_start[i], row_start[i + 1])
    return out


@pytest.mark.parametrize("segment", [1, 4, 16, SEGMENT])
@pytest.mark.parametrize("case", CASES)
def test_segment_sum_order_gives_the_plain_gradient_and_the_same_bits_twice(case, segment):
    table, ids, id_mask = _case(case, seed=3)
    ct = np.random.default_rng(4).normal(size=(*ids.shape[:-1], D)).astype(np.float32)
    want = _plain_grad(table, ids, id_mask, ct)
    got = _emulate_backward(ct, ids, id_mask, N_ROWS, segment)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    again = _emulate_backward(ct, ids, id_mask, N_ROWS, segment)
    np.testing.assert_array_equal(got.view(np.int32), again.view(np.int32))


@pytest.mark.parametrize("segment", [1, 3, 16, SEGMENT])
@pytest.mark.parametrize("case", CASES)
def test_segment_plan_covers_each_slot_once_in_id_then_slot_order(case, segment):
    """Every non-pad slot is summed exactly once: by a chunk of at most
    ``segment`` slots of one id (ids of longer runs) or by its row's short
    run; the sort is stable and puts pad slots last; chunks fit the
    kernel's scratch bound (chunk_bound) and are numbered in id, then
    slot, order."""
    _, ids, _ = _case(case, seed=5)
    sorted_ids, perm = segment_order(torch.from_numpy(ids), N_ROWS)
    sorted_ids, perm = sorted_ids.numpy(), perm.numpy()
    flat = ids.reshape(-1).astype(np.int64)
    keys = np.where(flat >= 0, flat, N_ROWS)
    np.testing.assert_array_equal(perm, np.argsort(keys, kind="stable"))
    np.testing.assert_array_equal(sorted_ids, keys[perm])
    row_start, row_chunk = (t.numpy() for t in segment_plan(torch.from_numpy(sorted_ids), N_ROWS, segment))
    chunks = _chunks(row_start, row_chunk, segment)
    assert len(chunks) == row_chunk[-1] <= chunk_bound(ids.size, segment)
    assert row_start[0] == 0 and row_start[-1] == (flat >= 0).sum()
    covered = np.zeros(ids.size, np.int64)
    for i in range(N_ROWS):
        s0, s1 = row_start[i], row_start[i + 1]
        assert (sorted_ids[s0:s1] == i).all()
        k0, k1 = row_chunk[i], row_chunk[i + 1]
        if s1 - s0 <= segment:
            assert k0 == k1
            covered[s0:s1] += 1
            continue
        assert k1 - k0 == -(-(s1 - s0) // segment)
        assert chunks[k0][0] == s0 and chunks[k1 - 1][1] == s1
        for k in range(k0, k1):
            assert 0 < chunks[k][1] - chunks[k][0] <= segment
            assert k == k0 or chunks[k][0] == chunks[k - 1][1]
            covered[chunks[k][0] : chunks[k][1]] += 1
    np.testing.assert_array_equal(covered[: row_start[-1]], 1)
    assert not covered[row_start[-1] :].any()  # pad slots: nobody sums them


def test_gather_sum_runs_plain_on_cpu_and_its_kernels_refuse_cpu_tensors():
    gather_sum_fwd.launches = gather_sum_bwd.launches = 0
    table, ids, id_mask = (torch.from_numpy(a) for a in _case("two_slots_masked"))
    torch.testing.assert_close(gather_sum(table, ids, id_mask), gather_sum_plain(table, ids, id_mask), rtol=0, atol=0)
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        gather_sum_fwd(table, ids, id_mask)
    sorted_ids, perm = segment_order(ids, N_ROWS)
    plan = segment_plan(sorted_ids, N_ROWS)
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        gather_sum_bwd(torch.zeros(*ids.shape[:-1], D), perm, id_mask, plan, N_ROWS, ids.shape[-1])
    assert gather_sum_fwd.launches == gather_sum_bwd.launches == 0
