"""The port's kernel modules (plain versions, on the CPU) against the JAX
package: the GRU eval scan (K3), the fused score + seen-mask + top-k (K4,
the Pallas kernels run in interpret mode), the tower's forward for the
GRU, LSTM and Vanilla cells, masked_top_k and gather_sum (the plain version,
and the dispatching wrapper the towers call).

The CUDA kernels themselves need a card; chip_smoke.py holds them against
these plain versions there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seqrec_tpu.models.recurrent import RecurrentLayers as JaxRecurrentLayers
from seqrec_tpu.ops.core import gather_sum as jax_gather_sum
from seqrec_tpu.ops.core import masked_top_k as jax_masked_top_k
from seqrec_tpu.ops.pallas_rnn import gru_scan as jax_gru_scan
from seqrec_tpu.ops.pallas_topk import fused_score_topk as jax_fused_score_topk
from seqrec_tpu_torch.models.recurrent import RecurrentLayers
from seqrec_tpu_torch.ops.core import gather_sum, masked_top_k
from seqrec_tpu_torch.ops.rnn_scan import (
    gru_cluster_smem,
    gru_cluster_units,
    gru_scan,
    gru_scan_plain,
    gru_scan_plan,
)
from seqrec_tpu_torch.ops.score_topk import (
    MAX_CANDIDATES,
    MAX_K,
    TILE,
    fused_score_topk,
    fused_score_topk_plain,
    partial_smem,
    split_plan,
)

B, L, H = 9, 7, 12  # ragged: no size is a power of two


def _gru_inputs(seed):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, L + 1, size=B)
    lengths[0] = 0  # an empty sequence keeps h0
    return (
        rng.normal(size=(B, L, 3 * H)).astype(np.float32),
        (np.arange(L)[None, :] < lengths[:, None]).astype(np.float32),
        rng.normal(0, 0.1, size=(H, 3 * H)).astype(np.float32),
        rng.normal(size=(B, H)).astype(np.float32),
    )


@pytest.mark.parametrize("seed", [0, 1])
def test_gru_scan_plain_matches_pallas_interpret(seed):
    x, m, w, h0 = _gru_inputs(seed)
    want = np.asarray(jax_gru_scan(*map(jnp.asarray, (x, m, w, h0)), block_b=8, interpret=True))
    got = gru_scan(*map(torch.from_numpy, (x, m, w, h0))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got[0], h0[0])


_TOWERS = [([12], False, 0), ([10, 12], True, 0), ([12], False, 6)]


@pytest.mark.parametrize(
    "cell,layers,bidirectional,embedding",
    [(cell, *case) for cell in ("GRU", "LSTM", "Vanilla") for case in _TOWERS],
    # the GRU cases keep the ids they had before the LSTM and Vanilla towers
    ids=[f"{pre}layers{i}-{case[1]}-{case[2]}" for pre in ("", "LSTM-", "Vanilla-") for i, case in enumerate(_TOWERS)],
)
def test_tower_matches_jax_recurrent_layers(cell, layers, bidirectional, embedding):
    """The port's tower (gather-sum input, plain scan for earlier layers,
    gru_scan or lstm_scan for the last; the plain scan throughout for
    Vanilla) against RecurrentLayers.apply, same params."""
    n_ids = 40
    jax_tower = JaxRecurrentLayers(cell, layers, bidirectional, embedding)
    tower = RecurrentLayers(cell, layers, bidirectional, embedding)
    params = jax_tower.init_params(np.random.default_rng(5), n_ids)
    tower.build(n_ids, "cpu")
    flat = {}
    for key, val in params.items():
        for name, arr in (val.items() if isinstance(val, dict) else [(None, val)]):
            flat[key if name is None else f"{key}.{name}"] = torch.from_numpy(arr)
    tower.load_state_dict(flat, strict=True)

    rng = np.random.default_rng(6)
    ids = rng.integers(0, n_ids, size=(B, L, 2)).astype(np.int32)
    ids[:, :, 1] = -1  # pad slot
    ids[::3, 2, 1] = 7
    lengths = rng.integers(1, L + 1, size=B)
    mask = (np.arange(L)[None, :] < lengths[:, None]).astype(np.float32)
    id_mask = np.broadcast_to(mask[:, :, None], ids.shape).astype(np.float32)
    want = np.asarray(jax_tower.apply(params, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(id_mask)))
    with torch.inference_mode():
        got = tower(torch.from_numpy(ids), torch.from_numpy(mask), torch.from_numpy(id_mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _topk_inputs(N, S, seed):
    rng = np.random.default_rng(seed)
    Bq, Hq = 11, 8
    seen = rng.integers(0, N, size=(Bq, S)).astype(np.int32)
    seen_mask = (np.arange(S)[None, :] < rng.integers(0, S + 1, size=(Bq, 1))).astype(np.float32)
    if S > 2:
        seen[1, 2] = seen[1, 0]  # a duplicate seen id
    return (
        rng.normal(size=(Bq, Hq)).astype(np.float32),
        rng.normal(size=(Hq, N)).astype(np.float32),
        rng.normal(size=N).astype(np.float32),
        seen,
        seen_mask,
    )


@pytest.mark.parametrize("N", [100, 513])
def test_fused_score_topk_plain_matches_jax(N):
    h, w, b, seen, sm = _topk_inputs(N, 6, seed=N)
    k = 10
    want_v, want_i = jax_fused_score_topk(*map(jnp.asarray, (h, w, b, seen, sm)), k=k, interpret=True)
    scores = jnp.asarray(h) @ jnp.asarray(w) + jnp.asarray(b)
    want_masked = np.asarray(jax_masked_top_k(scores, k, jnp.asarray(seen), jnp.asarray(sm)))
    got_v, got_i = fused_score_topk(*map(torch.from_numpy, (h, w, b, seen, sm)), k=k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_i.numpy(), want_masked)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=1e-5)
    got_masked = masked_top_k(torch.from_numpy(h @ w + b), k, torch.from_numpy(seen), torch.from_numpy(sm))
    np.testing.assert_array_equal(got_masked.numpy(), want_masked)


def test_topk_rows_with_fewer_than_k_unmasked_match_lax_top_k():
    """Rows with every item seen, or fewer than k unseen, keep masked items
    as -inf candidates with their own ids, in id order (lax.top_k's)."""
    N, S, k = 12, 12, 10
    h, w, b, seen, sm = _topk_inputs(N, S, seed=3)
    seen[0] = np.arange(N)  # all seen
    sm[0] = 1.0
    seen[1, :6], sm[1] = [11, 0, 5, 3, 9, 7], 0.0
    sm[1, :6] = 1.0  # 6 unmasked < k
    scores = h @ w + b
    want = np.asarray(jax_masked_top_k(jnp.asarray(scores), k, jnp.asarray(seen), jnp.asarray(sm)))
    got_v, got_i = fused_score_topk_plain(*map(torch.from_numpy, (h, w, b, seen, sm)), k=k)
    np.testing.assert_array_equal(got_i.numpy(), want)
    np.testing.assert_array_equal(got_i[0].numpy(), np.arange(k))
    assert np.all(np.isneginf(got_v[0].numpy()))
    assert np.isneginf(got_v[1, 6:].numpy()).all() and np.isfinite(got_v[1, :6].numpy()).all()
    np.testing.assert_array_equal(got_i[1, 6:].numpy(), [0, 3, 5, 7])
    finite = np.isfinite(got_v.numpy())
    np.testing.assert_allclose(
        got_v.numpy()[finite], np.take_along_axis(scores, want, 1)[finite], rtol=1e-5
    )


def test_topk_without_seen_ids_and_small_catalog_sentinel():
    h, w, b, _, _ = _topk_inputs(7, 1, seed=4)
    v, i = fused_score_topk(*map(torch.from_numpy, (h, w, b)), k=10)
    scores = h @ w + b
    np.testing.assert_array_equal(i[:, :7].numpy(), np.argsort(-scores, axis=1, kind="stable"))
    assert (i[:, 7:] == np.iinfo(np.int32).max).all() and torch.isneginf(v[:, 7:]).all()


def test_gather_sum_with_pad_slots_matches_jax():
    rng = np.random.default_rng(0)
    table = rng.normal(size=(20, 5)).astype(np.float32)
    ids = rng.integers(-1, 20, size=(4, 6, 3)).astype(np.int32)
    id_mask = (rng.random(size=(4, 6, 3)) < 0.7).astype(np.float32)
    for m in (None, id_mask):
        want = np.asarray(jax_gather_sum(jnp.asarray(table), jnp.asarray(ids), None if m is None else jnp.asarray(m)))
        got = gather_sum(torch.from_numpy(table), torch.from_numpy(ids), None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_towers_and_the_ops_package_use_the_dispatching_gather_sum():
    """The towers' input layer and ``seqrec_tpu_torch.ops.gather_sum`` are
    ops/gather_sum.py's wrapper (the CUDA kernel pair on the card); on CPU
    tensors it is the plain version, values and table gradient alike."""
    import seqrec_tpu_torch.models.recurrent as recurrent
    import seqrec_tpu_torch.ops as ops
    from seqrec_tpu_torch.ops import gather_sum as ops_gather_sum
    from seqrec_tpu_torch.ops.gather_sum import gather_sum as wrapper

    assert recurrent.gather_sum is wrapper and ops.gather_sum is wrapper and ops_gather_sum is wrapper
    rng = np.random.default_rng(3)
    table = torch.tensor(rng.normal(size=(20, 5)).astype(np.float32), requires_grad=True)
    ids = torch.from_numpy(rng.integers(-1, 20, size=(4, 6, 2)).astype(np.int32))
    ct = torch.from_numpy(rng.normal(size=(4, 6, 5)).astype(np.float32))
    got = wrapper(table, ids)
    want = gather_sum(table, ids)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(torch.autograd.grad(got, table, ct)[0], torch.autograd.grad(want, table, ct)[0],
                               rtol=0, atol=0)


def test_wrappers_on_cpu_tensors_run_the_plain_version_and_count_no_launch():
    gru_scan.launches = fused_score_topk.launches = 0
    x, m, w, h0 = map(torch.from_numpy, _gru_inputs(2))
    torch.testing.assert_close(gru_scan(x, m, w, h0), gru_scan_plain(x, m, w, h0), rtol=0, atol=0)
    args = tuple(map(torch.from_numpy, _topk_inputs(50, 4, seed=5)))
    for got, want in zip(fused_score_topk(*args, k=5), fused_score_topk_plain(*args, k=5)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert gru_scan.launches == 0 and gru_scan.cluster_launches == 0 and fused_score_topk.launches == 0


@pytest.mark.parametrize(
    "B,N,k",
    [(64, 3706, 10), (512, 200_000, 10), (5, 100, 64), (1, 10, 1), (512, 49_999, 10), (129, 3706, 10),
     (6, 25, 10), (64, 3706, 64), (40, 200_001, 10), (4096, 3706, 10)],
)
def test_split_plan_covers_the_catalog_in_whole_tiles(B, N, k):
    """K4's plan: whole 128-column tiles per split, no split empty, the
    merge's candidate cap, one block per SM at most, row groups of at
    least 8 rows only where the logits tiles leave most SMs idle, and a
    partial kernel that fits an H100 block for every k up to 64 (the seen
    ids, S of them a row, stay in device memory); past that it raises."""
    n_splits, cols, groups = split_plan(B, N, k, n_sm=132)
    assert cols % TILE == 0 and (n_splits - 1) * cols < N <= n_splits * cols
    assert n_splits * k <= MAX_CANDIDATES
    row_tiles = -(-B // TILE)
    assert row_tiles * n_splits * groups <= 132 or n_splits == 1
    assert groups in (1, 2, 4, 8)
    if groups > 1:
        assert -(-min(B, TILE) // groups) >= 8 and 2 * row_tiles * -(-N // TILE) < 132
    assert partial_smem(k) <= partial_smem(MAX_K) <= H100_SMEM_OPTIN
    with pytest.raises(ValueError, match="1 <= k"):
        split_plan(B, N, MAX_K + 1, n_sm=132)
    with pytest.raises(ValueError, match="shared memory"):
        split_plan(B, N, k, n_sm=132, smem_optin=partial_smem(k) - 1)


def _tf32(x):
    """x with the low 13 mantissa bits cleared: a TF32 value, as the
    tensor cores read an f32 register (and as split_tf32 masks the head)."""
    return (x.view(torch.int32) & -0x2000).view(torch.float32)


def _mma_3xtf32(a, b):
    """a [M, K] @ b [K, N] in f32 as block_mma.cuh's mma_slice runs it:
    each operand split into head = tf32(x) and tail = x - head (read
    truncated to TF32), and per 8-deep k step three m16n8k8 products
    (tail*head, head*tail, head*head) added to the f32 sum."""
    a_big, b_big = _tf32(a), _tf32(b)
    a_small, b_small = _tf32(a - a_big), _tf32(b - b_big)
    acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32)
    for k0 in range(0, a.shape[1], 8):
        ks = slice(k0, k0 + 8)
        for x, y in ((a_small, b_big), (a_big, b_small), (a_big, b_big)):
            acc = acc + x[:, ks] @ y[ks]
    return acc


@pytest.mark.parametrize(
    "B,H,N",
    # K4 at the flagship's serving chunk and at GRU-256 serving (rows cut
    # to 16), K2's stats at the large-catalog training shape (rows cut to 16)
    [(64, 50, 3706), (16, 256, 49_999), (16, 128, 50_000)],
    ids=["k4-B64-H50-N3706", "k4-H256-N49999", "k2-H128-N50000"],
)
def test_3xtf32_products_stay_inside_the_kernel_tolerances(B, H, N):
    """The 3xTF32 split of block_mma.cuh, emulated on the CPU, against
    float64: scores within K4's value tolerance (rtol 1e-5, atol 1e-6),
    top-10 ids equal wherever the 10th/11th gap exceeds 1e-4 max|score|,
    and log-sum-exp stats (m, s) within K2's (rtol 1e-4 + atol 1e-5
    max|s|). One TF32 pass alone would miss the score tolerance."""
    rng = np.random.default_rng(H + N)
    limit = np.sqrt(6.0 / (H + N))
    h = rng.uniform(-1, 1, (B, H)).astype(np.float32)
    w = rng.uniform(-limit, limit, (H, N)).astype(np.float32)
    b = rng.normal(0.0, 0.1, N).astype(np.float32)
    ref = h.astype(np.float64) @ w.astype(np.float64) + b
    got = (_mma_3xtf32(torch.from_numpy(h), torch.from_numpy(w)) + torch.from_numpy(b)).double().numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    one_pass = (_tf32(torch.from_numpy(h)) @ _tf32(torch.from_numpy(w)) + torch.from_numpy(b)).double().numpy()
    assert not np.allclose(one_pass, ref, rtol=1e-5, atol=1e-6)

    k = 10
    order = np.argsort(-ref, axis=1, kind="stable")
    top_ref = np.take_along_axis(ref, order[:, : k + 1], 1)
    clean = top_ref[:, k - 1] - top_ref[:, k] > 1e-4 * np.abs(ref).max()
    assert clean.any()
    got_ids = np.sort(np.argsort(-got, axis=1, kind="stable")[:, :k], axis=1)
    np.testing.assert_array_equal(got_ids[clean], np.sort(order[:, :k], axis=1)[clean])

    m_ref = ref.max(axis=1)
    s_ref = np.exp(ref - m_ref[:, None]).sum(axis=1)
    got = got.astype(np.float32)
    m = got.max(axis=1)
    s = np.exp(got - m[:, None]).sum(axis=1, dtype=np.float32)
    np.testing.assert_allclose(m, m_ref, rtol=1e-4, atol=1e-5 * np.abs(m_ref).max())
    np.testing.assert_allclose(s, s_ref, rtol=1e-4, atol=1e-5 * s_ref.max())


H100_SMS, H100_SMEM_OPTIN = 132, 232_448


@pytest.mark.parametrize("B,H", [(64, 50), (512, 256), (1, 256), (513, 256), (1024, 250), (64, 256)])
def test_gru_scan_plan_splits_w_hid_over_a_cluster_where_it_does_not_fit(B, H):
    path, C, R = gru_scan_plan(B, H, H100_SMS, H100_SMEM_OPTIN)
    w_fits = min(8, -(-B // H100_SMS)) * 16 * H + 12 * H * H <= H100_SMEM_OPTIN
    assert path == ("shared" if w_fits else "cluster")
    if path == "shared":
        assert C == 1 and 1 <= R <= 8
        return
    assert 2 <= C <= 8
    units = gru_cluster_units(H, C)
    assert [u for q0, q1 in units for u in range(q0, q1)] == list(range(H))
    assert max(q1 - q0 for q0, q1 in units) - min(q1 - q0 for q0, q1 in units) <= 1
    tiles = [range(r0, min(B, r0 + R)) for r0 in range(0, B, R)]
    assert [b for tile in tiles for b in tile] == list(range(B))
    assert gru_cluster_smem(H, C, R) <= H100_SMEM_OPTIN


def test_gru_scan_plan_follows_the_cards_cluster_capacity():
    """The card holds 15 clusters of 8 at the serving shape: 16 tiles of 32
    rows would take two waves, so the plan takes 13 tiles of 40; past the
    reach of a cluster slice it keeps the single-block L2 kernel."""
    held = {64: 15, 48: 15, 40: 15, 32: 15, 16: 15, 8: 30}
    assert gru_scan_plan(512, 256, H100_SMS, H100_SMEM_OPTIN) == ("cluster", 8, 32)
    assert gru_scan_plan(512, 256, H100_SMS, H100_SMEM_OPTIN, held) == ("cluster", 8, 40)
    assert gru_scan_plan(64, 256, H100_SMS, H100_SMEM_OPTIN, held) == ("cluster", 8, 8)
    assert gru_scan_plan(512, 512, H100_SMS, H100_SMEM_OPTIN)[0] == "l2"
