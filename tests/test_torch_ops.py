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
from seqrec_tpu_torch.ops import rnn_scan, rnn_scan_train
from seqrec_tpu_torch.ops.rnn_scan import (
    CLUSTER_ROWS,
    GRU_PATHS,
    gru_cluster_smem,
    gru_cluster_tile,
    gru_cluster_units,
    gru_scan,
    gru_scan_plain,
    gru_scan_plan,
)
from seqrec_tpu_torch.ops.rnn_scan_train import train_scan_smem
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


def _gru_inputs(seed, b=B, l=L, h=H, holes=False):
    """x_pre, mask, w_hid, h0; row 0 has length 0 (an empty sequence keeps
    h0), and with ``holes`` steps 3 and 7 are masked in every row (h is
    carried through)."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, l + 1, size=b)
    lengths[0] = 0
    mask = np.arange(l)[None, :] < lengths[:, None]
    if holes:
        mask[:, [3, 7]] = False
    return (
        rng.normal(size=(b, l, 3 * h)).astype(np.float32),
        mask.astype(np.float32),
        rng.normal(0, 0.1, size=(h, 3 * h)).astype(np.float32),
        rng.normal(size=(b, h)).astype(np.float32),
    )


@pytest.mark.parametrize(
    "seed,shape,holes",
    # the first two keep their ids; then H=128 (K3's cluster path on the card) with holes
    [pytest.param(0, (B, L, H), False, id="0"), pytest.param(1, (B, L, H), False, id="1"),
     pytest.param(2, (6, 10, 128), True, id="H128-holes")],
)
def test_gru_scan_plain_matches_pallas_interpret(seed, shape, holes):
    x, m, w, h0 = _gru_inputs(seed, *shape, holes=holes)
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
    assert gru_scan.reg_launches == 0 and gru_scan.gru_cluster_launches == 0


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


# K3's path by (B, H) at the H100's limits: the training forward's reg (H <= 50) and cluster (up to
# 32 units a CTA of 8) kernels, gru_cluster.cuh from H=256 (where it measured faster) to its reach
# (64 units a CTA), l2 past both
K3_PATHS = {(64, 50): "reg", (512, 256): "gru_cluster", (1, 256): "gru_cluster", (513, 256): "gru_cluster",
            (1024, 250): "cluster", (64, 256): "gru_cluster", (1024, 128): "cluster", (1, 128): "cluster",
            (64, 130): "cluster", (64, 300): "gru_cluster", (64, 512): "l2"}


@pytest.mark.parametrize("B,H", list(K3_PATHS))
def test_gru_scan_plan_splits_w_hid_over_a_cluster_where_it_does_not_fit(B, H):
    """K3's plan on an H100: W_hid in registers at H <= 50, else split over
    a cluster whose CTAs own every unit once (any H: the split may be
    uneven) and whose tiles cover every row once, within a block's
    shared memory; past every cluster slice the single-block L2 kernel."""
    path, C, R = gru_scan_plan(B, H, H100_SMS, H100_SMEM_OPTIN)
    assert path == K3_PATHS[B, H]
    if path == "reg":
        assert C == 1 and R == min(16, -(-B // H100_SMS))
        assert train_scan_smem("gru", "reg", H, C, R, backward=False) <= H100_SMEM_OPTIN
        return
    if path == "l2":
        assert C == 1 and R == min(8, -(-B // H100_SMS))
        assert gru_cluster_tile(B, H, H100_SMS, H100_SMEM_OPTIN) is None
        return
    units = gru_cluster_units(H, C)
    assert [u for q0, q1 in units for u in range(q0, q1)] == list(range(H))
    assert max(q1 - q0 for q0, q1 in units) - min(q1 - q0 for q0, q1 in units) <= 1
    tiles = [range(r0, min(B, r0 + R)) for r0 in range(0, B, R)]
    assert [b for tile in tiles for b in tile] == list(range(B))
    if path == "cluster":
        assert C in (2, 4, 8) and -(-H // C) <= 32 and R in (8, 16, 24, 32)
        assert train_scan_smem("gru", "cluster", H, C, R, backward=False) <= H100_SMEM_OPTIN
    else:
        assert C == 8 and -(-H // C) <= 64 and R in CLUSTER_ROWS
        assert gru_cluster_smem(H, C, R) <= H100_SMEM_OPTIN


def test_gru_scan_plan_follows_the_cards_cluster_capacity():
    """The card holds 15 clusters of 8: at GRU-256's serving chunk 16 tiles
    of 32 rows would take two waves, so the plan takes 13 tiles of 40 on
    gru_cluster.cuh's kernel, and at H=192 the training forward's kernel
    22 tiles of 24 (the tile with the fewest rows-steps over its waves);
    at H=300 a 40-row tile no longer fits a block; at GRU-128 the training
    forward's kernel takes C = 4 where the card holds two clusters an SM
    pair; past every cluster slice the plan keeps the single-block L2
    kernel."""
    held = {(C, R): 15 if C == 8 else 66 for C in (2, 4, 8) for R in (8, 16, 24, 32)}
    held_gru_cluster = {64: 15, 48: 15, 40: 15, 32: 15, 16: 15, 8: 30}
    assert gru_scan_plan(512, 256, H100_SMS, H100_SMEM_OPTIN) == ("gru_cluster", 8, 32)
    assert gru_scan_plan(512, 256, H100_SMS, H100_SMEM_OPTIN, held, held_gru_cluster) == ("gru_cluster", 8, 40)
    assert gru_scan_plan(512, 192, H100_SMS, H100_SMEM_OPTIN, held) == ("cluster", 8, 24)
    # at H=300 the 40-row tile no longer fits a block: 480 rows in one wave of 32-row tiles
    assert gru_scan_plan(480, 300, H100_SMS, H100_SMEM_OPTIN, None, held_gru_cluster) == ("gru_cluster", 8, 32)
    assert gru_scan_plan(64, 300, H100_SMS, H100_SMEM_OPTIN, None, held_gru_cluster) == ("gru_cluster", 8, 8)
    assert gru_scan_plan(1024, 128, H100_SMS, H100_SMEM_OPTIN, held) == ("cluster", 4, 16)
    assert gru_scan_plan(512, 512, H100_SMS, H100_SMEM_OPTIN)[0] == "l2"


class _FakeGruScanLibrary:
    """The queries K3's plan makes of csrc/gru_scan.cu's library
    (seqrec_gru_scan_capacity and seqrec_gru_cluster_capacity,
    seqrec_gru_scan_smem), answered from the plan's own numbers; the smem
    answer is off by ``smem_off``."""

    def __init__(self, held, held_gru_cluster, smem_off=0):
        self.held, self.held_gru_cluster, self.smem_off, self.calls = held, held_gru_cluster, smem_off, []

    def seqrec_gru_scan_capacity(self, backward, H, C, R, n):
        self.calls.append(("capacity", backward, H, C, R))
        n._obj.value = self.held[C, R]
        return 0

    def seqrec_gru_cluster_capacity(self, H, C, R, n):
        self.calls.append(("gru_cluster capacity", H, C, R))
        n._obj.value = self.held_gru_cluster[R]
        return 0

    def seqrec_gru_scan_smem(self, backward, path, H, C, R):
        self.calls.append(("smem", backward, path, H, C, R))
        name = {code: p for p, code in GRU_PATHS.items()}[path]
        if name == "gru_cluster":
            return gru_cluster_smem(H, C, R) + self.smem_off
        return train_scan_smem("gru", name, H, C, R, bool(backward)) + self.smem_off


def test_k3_device_plan_reads_the_eval_kernels_capacity_and_checks_their_smem(monkeypatch):
    """On the card, gru_scan's plan asks K3's own library for the clusters
    the card holds (the eval form of the training forward's cluster
    kernel, forward only; gru_cluster.cuh's past its reach), keeps the
    plan of a shape (a second call asks nothing), and raises where the
    plan's shared-memory count differs from the kernel's."""
    import contextlib

    for module in (rnn_scan, rnn_scan_train):
        monkeypatch.setattr(module, "_plans", {})
        monkeypatch.setattr(module, "device_limits", lambda index: (H100_SMS, H100_SMEM_OPTIN))
    monkeypatch.setattr(torch.cuda, "device", lambda index: contextlib.nullcontext())
    device = torch.device("cuda", 0)
    # two CTAs an SM at C = 4: 64-row-tile waves favour R = 16
    lib = _FakeGruScanLibrary({(C, R): (66 if C == 4 else 33) for C in (4, 8) for R in (8, 16, 24, 32)},
                              {R: 15 for R in CLUSTER_ROWS})
    monkeypatch.setattr(rnn_scan, "_library", lambda: lib)
    assert rnn_scan.gru_scan_device_plan(1024, 128, device) == ("cluster", 4, 16)
    assert {c[1] for c in lib.calls if c[0] == "capacity"} == {0}  # forward only
    assert lib.calls[-1] == ("smem", 0, GRU_PATHS["cluster"], 128, 4, 16)
    n_calls = len(lib.calls)
    assert rnn_scan.gru_scan_device_plan(1024, 128, device) == ("cluster", 4, 16)
    assert len(lib.calls) == n_calls
    assert rnn_scan.gru_scan_device_plan(512, 300, device) == ("gru_cluster", 8, 32)
    assert any(c[0] == "gru_cluster capacity" for c in lib.calls[n_calls:])
    assert lib.calls[-1] == ("smem", 0, GRU_PATHS["gru_cluster"], 300, 8, 32)
    bad = _FakeGruScanLibrary(lib.held, lib.held_gru_cluster, smem_off=4)
    monkeypatch.setattr(rnn_scan, "_library", lambda: bad)
    for B_, H_ in ((64, 50), (64, 300)):
        with pytest.raises(RuntimeError, match="bytes of shared memory"):
            rnn_scan.gru_scan_device_plan(B_, H_, device)
