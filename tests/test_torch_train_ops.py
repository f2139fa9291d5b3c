"""The port's training ops (plain versions, on the CPU) against the JAX
package: the GRU training scan (K1) and the streaming CCE (K2) against
their Pallas kernels in interpret mode, the streaming op against JAX's and
against the dense loss, grad_clip, the CCE losses the five optimizers
against optax, and the plan of the GRU and LSTM training scans' kernels.

Tolerances: f32 on both sides, sums taken in other orders. Values and
per-element products agree to rtol 1e-5; sums over B*L (dW) or over the
catalog get rtol 1e-4 with atol 1e-6, and the optimizers, whose 50 steps
compound rounding, rtol 1e-5 with atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seqrec_tpu.models import updates as jax_updates
from seqrec_tpu.ops.core import gather_sum as jax_gather_sum
from seqrec_tpu.ops.core import grad_clip as jax_grad_clip
from seqrec_tpu.ops.losses import diversity_biased_cce as jax_diversity_biased_cce
from seqrec_tpu.ops.pallas_rnn_train import gru_scan_train as jax_gru_scan_train
from seqrec_tpu.ops.pallas_streaming_cce import grads_pallas, stats_pallas
from seqrec_tpu.ops.streaming_cce import _pad_cols
from seqrec_tpu.ops.streaming_cce import streaming_cce as jax_streaming_cce
from seqrec_tpu_torch.models import updates
from seqrec_tpu_torch.ops import losses
from seqrec_tpu_torch.ops import rnn_scan_train
from seqrec_tpu_torch.ops.core import gather_sum, grad_clip, rows_16b
from seqrec_tpu_torch.ops.rnn_scan import gru_scan_plan
from seqrec_tpu_torch.ops.rnn_scan_train import (
    CLUSTER_ROWS,
    CLUSTER_UNITS,
    L2_MAX_ROWS,
    REG_MAX_ROWS,
    WIDE_ROWS,
    backward_scratch,
    dw_split_plan,
    gru_scan_train,
    gru_scan_train_bwd,
    gru_scan_train_fwd,
    gru_scan_train_plain,
    train_scan_plan,
    train_scan_smem,
)
from seqrec_tpu_torch.ops.streaming_cce import (
    MAX_H,
    STATS_SMEM,
    TILE,
    cce_grads,
    cce_grads_plain,
    cce_stats,
    cce_stats_plain,
    grads_plan,
    split_plan,
    streaming_cce,
)

B, L, H = 9, 7, 12  # ragged: L is not a multiple of the TPU's time chunk (8), H not of a lane


def _gru_inputs(seed):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, L + 1, size=B)
    lengths[0], lengths[1] = 1, L  # rows of length 1 and L
    return (
        rng.normal(size=(B, L, 3 * H)).astype(np.float32),
        (np.arange(L)[None, :] < lengths[:, None]).astype(np.float32),
        rng.normal(0, 0.3, size=(H, 3 * H)).astype(np.float32),
        rng.normal(size=(B, H)).astype(np.float32),
        rng.normal(size=(B, H)).astype(np.float32),  # upstream cotangent
    )


@pytest.mark.parametrize("clip", [100.0, 0.05, 0.0])
def test_gru_scan_train_plain_matches_pallas_interpret(clip):
    x, m, w, h0, dh = _gru_inputs(int(clip * 100) + 1)
    fn = lambda x_, w_, h0_: jax_gru_scan_train(x_, jnp.asarray(m), w_, h0_, clip, 8, True)  # noqa: E731
    want_h, vjp = jax.vjp(fn, *map(jnp.asarray, (x, w, h0)))
    want_dx, want_dw, want_dh0 = vjp(jnp.asarray(dh))

    leaves = [torch.tensor(a, requires_grad=True) for a in (x, w, h0)]
    got_h = gru_scan_train(leaves[0], torch.from_numpy(m), leaves[1], leaves[2], clip)
    got_dx, got_dw, got_dh0 = torch.autograd.grad(got_h, leaves, torch.from_numpy(dh))
    np.testing.assert_allclose(got_h.detach().numpy(), np.asarray(want_h), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_dx.numpy(), np.asarray(want_dx), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got_dh0.numpy(), np.asarray(want_dh0), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got_dw.numpy(), np.asarray(want_dw), rtol=1e-4, atol=1e-6)
    # masked steps leave no gradient: dx is 0 past each row's length
    assert not got_dx.numpy()[~m.astype(bool)].any()
    if clip == 0.05:  # the clip binds: dW moves against the unclipped one
        free = gru_scan_train_plain(leaves[0], torch.from_numpy(m), leaves[1], leaves[2], 0.0)
        got_free = torch.autograd.grad(free, leaves[1], torch.from_numpy(dh))[0]
        assert (got_free - got_dw).abs().max() > 1e-2


def test_gru_train_wrappers_run_plain_on_cpu_and_refuse_cpu_kernels():
    gru_scan_train_fwd.launches = gru_scan_train_bwd.launches = 0
    x, m, w, h0, dh = map(torch.from_numpy, _gru_inputs(5))
    torch.testing.assert_close(gru_scan_train(x, m, w, h0, 1.0), gru_scan_train_plain(x, m, w, h0, 1.0))
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        gru_scan_train_fwd(x, m, w, h0)
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        gru_scan_train_bwd(x, m, w, torch.zeros(L, B, H), dh, 1.0)
    assert gru_scan_train_fwd.launches == 0 and gru_scan_train_bwd.launches == 0


def _cce_inputs(seed, Bq=10, Hq=12, N=300):
    rng = np.random.default_rng(seed)
    return (
        rng.normal(size=(Bq, Hq)).astype(np.float32),
        rng.normal(0, 0.5, size=(Hq, N)).astype(np.float32),
        rng.normal(0, 0.5, size=N).astype(np.float32),
        rng.integers(0, N, size=Bq).astype(np.int32),
        rng.uniform(0.5, 1.5, size=Bq).astype(np.float32),
    )


@pytest.mark.parametrize("N", [300, 128])
def test_cce_stats_and_grads_plain_match_pallas_interpret(N):
    h, w, b, t, g = _cce_inputs(N, N=N)
    g[3] = 0.0  # a row without cotangent
    Wp, bp, _ = _pad_cols(jnp.asarray(w), jnp.asarray(b), 128)
    want_m, want_s = stats_pallas(jnp.asarray(h), Wp, bp, block_b=8, chunk=128, interpret=True)
    got_m, got_s = cce_stats(*map(torch.from_numpy, (h, w, b)))
    np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-4)
    logz = np.array(want_m + jnp.log(want_s))
    want = grads_pallas(jnp.asarray(h), Wp, bp, jnp.asarray(t), jnp.asarray(logz), jnp.asarray(g),
                        block_b=8, chunk=128, interpret=True)
    got = cce_grads(*map(torch.from_numpy, (h, w, b, t, logz, g)))
    for name, gt, wt in zip(("dh", "dW", "db"), got, (want[0], want[1][:, :N], want[2][:N])):
        np.testing.assert_allclose(gt.numpy(), np.asarray(wt), rtol=1e-4, atol=1e-6, err_msg=name)
    np.testing.assert_array_equal(got[0].numpy()[3], 0.0)
    assert cce_stats.launches == 0 and cce_grads.launches == 0


@pytest.mark.parametrize(
    "B,H,N", [(1024, 128, 50_000), (1024, 256, 50_000), (1000, 100, 50_001), (16, 50, 3706), (5, 256, 300), (70, 12, 1000)]
)
def test_grads_plan_covers_the_catalog_in_whole_tiles(B, H, N):
    """The gradient kernels' plan: whole 128-column tiles per split, no
    split empty, H in at most two 128-wide chunks, about one dh block per
    SM, and a dh scratch of n_splits [B, H] partials."""
    n_splits, cols, h_chunks = grads_plan(B, H, N, n_sm=132)
    assert cols % TILE == 0 and (n_splits - 1) * cols < N <= n_splits * cols
    assert h_chunks == -(-H // TILE) and h_chunks * TILE >= H and H <= MAX_H
    dh_blocks = -(-B // TILE) * n_splits * h_chunks
    assert dh_blocks <= 132 or n_splits == 1
    assert n_splits * B * H * 4 <= 16 * 1024 * 1024 * h_chunks  # the scratch stays small
    if (B, H, N) == (1024, 128, 50_000):
        assert (n_splits, cols, h_chunks) == (16, 3200, 1)


@pytest.mark.parametrize("B,N", [(1024, 50_000), (1024, 49_999), (1000, 50_001), (16, 3706), (1, 300), (5000, 200_000)])
def test_stats_split_plan_fills_the_card_in_whole_tiles(B, N):
    """K2 stats' plan: whole 128-column tiles per split, no split empty,
    one block per SM at most and at least half the card unless every tile
    has its own split; the kernel's shared memory fits an H100 block."""
    n_splits, cols = split_plan(B, N, n_sm=132)
    assert cols % TILE == 0 and (n_splits - 1) * cols < N <= n_splits * cols
    blocks = -(-B // TILE) * n_splits
    assert blocks <= 132 or n_splits == 1
    assert blocks >= 66 or n_splits == -(-N // TILE)
    assert STATS_SMEM <= 232_448
    if (B, N) == (1024, 50_000):
        assert (n_splits, cols) == (16, 3200)


@pytest.mark.parametrize("C", [128, 3706, 49_999])
def test_gradient_operands_are_padded_to_16_byte_rows(C):
    x = torch.from_numpy(np.random.default_rng(C).normal(size=(3, C)).astype(np.float32))
    rows = rows_16b(x)
    ld = rows.stride(0)
    assert ld % 4 == 0 and ld >= C and rows.stride(1) == 1 and rows.data_ptr() % 16 == 0
    assert (rows is x) == (C % 4 == 0)
    torch.testing.assert_close(rows, x, rtol=0, atol=0)
    assert not rows.as_strided((3, ld), (ld, 1))[:, C:].any()
    assert rows_16b(rows) is rows  # padded once, passed through after


@pytest.mark.parametrize("B,H,N", [(64, 50, 3706), (512, 256, 49_999)])
def test_score_topk_operands_are_padded_to_16_byte_rows(B, H, N):
    """K4's operands at its path shapes: h [B, H] and W_out [H, N] get
    rows of a multiple of 4 floats (H=50 -> 52, N=3,706 -> 3,708 and
    49,999 -> 50,000, H=256 as it is), the values unchanged."""
    rng = np.random.default_rng(N)
    h = torch.from_numpy(rng.random((B, H), dtype=np.float32))
    w = torch.from_numpy(rng.random((H, N), dtype=np.float32))
    for x, C in ((h, H), (w, N)):
        rows = rows_16b(x)
        assert rows.stride(0) == -(-C // 4) * 4 and rows.data_ptr() % 16 == 0
        assert (rows is x) == (C % 4 == 0)
        torch.testing.assert_close(rows, x, rtol=0, atol=0)
    torch.testing.assert_close(rows_16b(h) @ rows_16b(w), h @ w, rtol=0, atol=0)


def test_streaming_cce_matches_jax_and_the_dense_loss():
    h, w, b, t, g = _cce_inputs(7, N=1000)
    fn = lambda h_, w_, b_: jax_streaming_cce(h_, w_, b_, jnp.asarray(t), 256)  # noqa: E731
    want_loss, vjp = jax.vjp(fn, *map(jnp.asarray, (h, w, b)))
    want_grads = vjp(jnp.asarray(g))

    def port(loss_fn):
        leaves = [torch.tensor(a, requires_grad=True) for a in (h, w, b)]
        loss = loss_fn(*leaves)
        return loss.detach().numpy(), torch.autograd.grad(loss, leaves, torch.from_numpy(g))

    got_loss, got_grads = port(lambda h_, w_, b_: streaming_cce(h_, w_, b_, torch.from_numpy(t)))
    dense_loss, dense_grads = port(lambda h_, w_, b_: losses.log_softmax_cce(h_ @ w_ + b_, torch.from_numpy(t)))
    np.testing.assert_allclose(got_loss, np.asarray(want_loss), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_loss, dense_loss, rtol=1e-5, atol=1e-6)
    for gt, wt, dn in zip(got_grads, want_grads, dense_grads):
        np.testing.assert_allclose(gt.numpy(), np.asarray(wt), rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(gt.numpy(), dn.numpy(), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("bad", [-1, 1000])
def test_streaming_cce_rejects_targets_outside_the_catalog(bad):
    h, w, b, t, _ = map(torch.from_numpy, _cce_inputs(8, N=1000))
    t[2] = bad
    with pytest.raises(ValueError, match="outside the catalog"):
        streaming_cce(h, w, b, t)


def test_cce_losses_match_jax():
    h, w, b, t, g = _cce_inputs(9, N=50)
    logits = h @ w + b
    want = jax_diversity_biased_cce(jnp.asarray(logits), jnp.asarray(t), jnp.asarray(g))
    got = losses.diversity_biased_cce(torch.from_numpy(logits), torch.from_numpy(t), torch.from_numpy(g))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def test_grad_clip_matches_jax():
    rng = np.random.default_rng(0)
    x, ct = rng.normal(size=(5, 7)).astype(np.float32), rng.normal(0, 2, size=(5, 7)).astype(np.float32)
    _, vjp = jax.vjp(lambda a: jax_grad_clip(a, 0.7), jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    y = grad_clip(xt, 0.7)
    torch.testing.assert_close(y.detach(), xt.detach(), rtol=0, atol=0)
    got = torch.autograd.grad(y, xt, torch.from_numpy(ct))[0]
    np.testing.assert_array_equal(got.numpy(), np.asarray(vjp(jnp.asarray(ct))[0]))


def test_gather_sum_gives_pad_slots_no_gradient():
    rng = np.random.default_rng(1)
    table = rng.normal(size=(20, 5)).astype(np.float32)
    ids = rng.integers(-1, 20, size=(4, 6, 3)).astype(np.int32)
    ids[ids == 0] = -1  # row 0 is referenced only by pad slots (clamped to 0)
    ct = rng.normal(size=(4, 6, 5)).astype(np.float32)
    want = jax.vjp(lambda tb: jax_gather_sum(tb, jnp.asarray(ids)), jnp.asarray(table))[1](jnp.asarray(ct))[0]
    tt = torch.tensor(table, requires_grad=True)
    got = torch.autograd.grad(gather_sum(tt, torch.from_numpy(ids)), tt, torch.from_numpy(ct))[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    assert not got[0].any()


@pytest.mark.parametrize(
    "make",
    [
        lambda m: m.Adagrad(learning_rate=0.1),
        lambda m: m.Adadelta(learning_rate=1.0, rho=0.9),
        lambda m: m.RMSProp(learning_rate=0.01, rho=0.9),
        lambda m: m.NesterovMomentum(learning_rate=0.05, momentum=0.9),
        lambda m: m.Adam(learning_rate=0.01, beta1=0.9, beta2=0.999),
    ],
    ids=["adagrad", "adadelta", "rmsprop", "nesterov", "adam"],
)
def test_optimizer_steps_follow_optax(make):
    rng = np.random.default_rng(2)
    params = [rng.normal(size=(6, 4)).astype(np.float32), rng.normal(size=5).astype(np.float32)]
    grads = [[rng.normal(0, s, size=p.shape).astype(np.float32) for p in params] for s in np.geomspace(1, 1e-3, 50)]
    grads[3][0][0] = 0.0  # an exact zero (Adagrad's where(acc > 0) branch)

    opt = make(jax_updates).make()
    jp = [jnp.asarray(p) for p in params]
    state = opt.init(jp)
    mine = make(updates)
    tp = [torch.from_numpy(p.copy()) for p in params]
    tstate = mine.init(tp)
    assert mine.name == make(jax_updates).name
    for g in grads:
        upd, state = opt.update([jnp.asarray(x) for x in g], state, jp)
        jp = [p + u for p, u in zip(jp, upd)]
        mine.step(tp, [torch.from_numpy(x) for x in g], tstate)
    for got, want in zip(tp, jp):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_bf16_adam_moments_raise_later_slice():
    """--u_moments bfloat16 is ported now (tests/test_torch_bf16.py holds it
    to the JAX package): its state keeps both moments in bf16 and its step
    count, where it once raised."""
    state = updates.Adam(moment_dtype="bfloat16").init([torch.zeros(3), torch.zeros(2, 2)])
    assert state["count"] == 0
    assert {m.dtype for slot in ("mu", "nu") for m in state[slot]} == {torch.bfloat16}
    with pytest.raises(ValueError, match="moment_dtype"):
        updates.Adam(moment_dtype="float16")


H100_SMS, H100_SMEM_OPTIN = 132, 232_448
# (cell, B, H) -> (path, C) of the forward and of the backward on an H100
TRAIN_PLANS = {
    ("gru", 16, 50): (("reg", 1), ("reg", 1)),  # the flagship
    ("gru", 1024, 128): (("cluster", 4), ("cluster", 4)),  # GRU-128
    ("lstm", 1024, 128): (("cluster", 4), ("cluster", 4)),  # LSTM-128
    ("lstm", 16, 50): (("reg", 1), ("reg", 1)),
    ("gru", 9, 12): (("reg", 1), ("reg", 1)),
    ("lstm", 1025, 130): (("cluster", 8), ("cluster", 8)),  # a ragged tile, 130 units over 8 CTAs
    ("gru", 1024, 256): (("cluster", 8), ("l2", 1)),  # the backward's two slices outgrow a CTA
    ("gru", 4096, 50): (("wide", 1), ("wide", 1)),  # the benchmark's GRU-50 at B 4096: 32 rows an SM
    ("lstm", 4096, 50): (("wide", 1), ("wide", 1)),  # the benchmark's LSTM-50 at B 4096: 32 rows an SM
    ("gru", 2112, 50): (("reg", 1), ("reg", 1)),  # 16 rows an SM: the reg path's last batch
    ("gru", 2113, 50): (("wide", 1), ("wide", 1)),  # 17 rows an SM: the wide path's first
    ("gru", 4096, 51): (("cluster", 2), ("cluster", 2)),  # past the wide path's H
    ("lstm", 1716, 50): (("reg", 1), ("reg", 1)),  # 13 rows an SM: K5's last reg batch
    ("lstm", 1717, 50): (("wide", 1), ("wide", 1)),  # 14 rows an SM: K5's first wide batch
    ("lstm", 4096, 51): (("cluster", 2), ("cluster", 2)),  # past the wide path's H
}


@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("cell,B,H", list(TRAIN_PLANS))
def test_train_scan_plan_covers_rows_and_units_within_shared_memory(cell, B, H, backward):
    """K1's and K5's plan: the path and cluster size at the paths' shapes
    and the edge shapes; every row in one tile, every unit in one CTA, no
    CTA without units, each CTA's (block's) shared memory within an H100's
    232,448 bytes."""
    path, C, R = train_scan_plan(cell, B, H, H100_SMS, H100_SMEM_OPTIN, backward)
    assert (path, C) == TRAIN_PLANS[cell, B, H][backward]
    assert R in {"reg": range(1, REG_MAX_ROWS + 1), "cluster": CLUSTER_ROWS, "l2": range(1, L2_MAX_ROWS + 1),
                 "wide": (WIDE_ROWS[backward],)}[path]
    tiles = -(-B // R)
    assert tiles * R >= B and B - (tiles - 1) * R >= 1  # every row in a tile, the last tile not empty
    assert train_scan_smem(cell, path, H, C, R, backward) <= H100_SMEM_OPTIN
    # CTA q of C owns the units [q H // C, (q + 1) H // C) (csrc/cluster_common.cuh unit_begin)
    begins = [q * H // C for q in range(C + 1)]
    assert begins[0] == 0 and begins[-1] == H
    assert all(1 <= q1 - q0 <= (CLUSTER_UNITS if path == "cluster" else H) for q0, q1 in zip(begins, begins[1:]))
    assert (C > 1) == (path == "cluster")
    if (cell, B, H) == ("gru", 16, 50):
        assert R == 1  # 16 blocks of one row: the shortest step


# (cell, path, H, C, R, backward) -> bytes of one block, counted by hand from
# the buffer layouts in the comments of csrc/scan_train_reg.cuh,
# scan_train_cluster.cuh, scan_train_wide.cuh (both cells) and
# scan_train.cuh:l2_train_floats
TRAIN_SMEM_BY_HAND = {
    # W[:, cols(q)] 128 x 96 + W[units(q), :]^T 384 x 32 + h 2 x 24 x 128 + dhid 2 x 24 x 384
    ("gru", "cluster", 128, 4, 24, True): 4 * (12_288 + 12_288 + 6_144 + 18_432),
    # 128 x 128 + 512 x 32 + 2 x 16 x 128 + 2 x 16 x 512
    ("lstm", "cluster", 128, 4, 16, True): 4 * (16_384 + 16_384 + 4_096 + 16_384),
    # W[:, cols(q)] 128 x 96 + h 2 x 32 x 128
    ("gru", "cluster", 128, 4, 32, False): 4 * (12_288 + 8_192),
    # 17 units a CTA, H padded to 132: 132 x 68 + h 2 x 8 x 132
    ("lstm", "cluster", 130, 8, 8, False): 4 * (8_976 + 2_112),
    # hp, cp [3, 1, 52] + dh, dc, dd [1, 52] + hid [2, 1, 208] + x [3, 1, 150] + mask [3, 1] + dpeep [1, 150]
    ("gru", "reg", 50, 1, 1, True): 4 * (312 + 156 + 416 + 450 + 3 + 150),
    # h, c [1, 52] + hid [1, 208] + x [2, 1, 150] + mask [2, 1]
    ("gru", "reg", 50, 1, 1, False): 4 * (104 + 208 + 300 + 2),
    # 16 rows of 3 x 52 x 3 + 3 x 52 + 2 x 208 + 3 x 200 + 3 + 150
    ("lstm", "reg", 50, 1, 16, True): 4 * 16 * (468 + 416 + 600 + 3 + 150),
    # hp, dh, dd [8, 256] + hid [8, 768]
    ("gru", "l2", 256, 1, 8, True): 4 * (3 * 2_048 + 6_144),
    # units padded to 52: h^T [3, 52, 36] + dhid^T [2, 160, 36] + W [52, 26, 8] + W^T [160, 13, 4] + mask [2, 32]
    # + x [2, 32, 150]
    ("gru", "wide", 50, 1, 32, True): 4 * (5_616 + 11_520 + 10_816 + 8_320 + 64 + 9_600),
    # 16 rows: h^T [2, 52, 20] + W [52, 26, 8] + mask [2, 16] + x [2, 16, 150]
    ("gru", "wide", 50, 1, 16, False): 4 * (2_080 + 10_816 + 32 + 4_800),
    # odd H, units padded to 28: h^T [3, 28, 36], dhid^T [2, 80, 36], W [28, 14, 8], W^T [80, 7, 4], mask, x [2, 32, 75]
    ("gru", "wide", 25, 1, 32, True): 4 * (3_024 + 5_760 + 3_136 + 2_240 + 64 + 4_800),
    # K5's wide path, 4H = 200 columns to 208: h^T [3, 52, 36] + dpre^T [2, 208, 36] + W [52, 26, 8]
    # + W^T [208, 13, 4] + mask [2, 32] + x [2, 32, 200]
    ("lstm", "wide", 50, 1, 32, True): 4 * (5_616 + 14_976 + 10_816 + 10_816 + 64 + 12_800),
    # 16 rows: h^T [2, 52, 20] + W [52, 26, 8] + mask [2, 16] + x [2, 16, 200]
    ("lstm", "wide", 50, 1, 16, False): 4 * (2_080 + 10_816 + 32 + 6_400),
    # odd H, units padded to 28: h^T [3, 28, 36], dpre^T [2, 112, 36], W [28, 14, 8], W^T [112, 7, 4], mask,
    # x [2, 32, 100]
    ("lstm", "wide", 25, 1, 32, True): 4 * (3_024 + 8_064 + 3_136 + 3_136 + 64 + 6_400),
    # hp, cp, dh, dc [8, 128] + hid [8, 512] + dp [8, 384] + pacc [384] + keep [8]
    ("lstm", "l2", 128, 1, 8, True): 4 * (4 * 1_024 + 4_096 + 3_072 + 384 + 8),
}


@pytest.mark.parametrize("cell,path,H,C,R,backward", list(TRAIN_SMEM_BY_HAND))
def test_train_scan_smem_matches_the_kernels_layouts(cell, path, H, C, R, backward):
    """The plan's copy of each kernel's shared-memory size equals the
    bytes counted by hand from the kernel's buffer layout (on the card the
    plan also holds it against the kernel's own count)."""
    assert train_scan_smem(cell, path, H, C, R, backward) == TRAIN_SMEM_BY_HAND[cell, path, H, C, R, backward]


@pytest.mark.parametrize("path,B,R,n_gates", [
    ("reg", 16, 16, 3), ("reg", 64, 1, 4), ("wide", 4096, 32, 3), ("wide", 1717, 32, 4), ("wide", 32, 32, 4),
    ("cluster", 1024, 24, 3), ("cluster", 1024, 16, 4), ("l2", 1024, 8, 3), ("l2", 1024, 8, 4),
])
def test_backward_scratch_follows_each_paths_rule(monkeypatch, path, B, R, n_gates):
    """K1's and K5's backward scratch, one rule for both cells: per-block dW
    partials on the reg and wide paths where there is more than one block;
    the dhid (dpre) rows and the dW splits on the cluster and l2 paths; W^T
    on the l2 path alone."""
    monkeypatch.setattr(rnn_scan_train, "device_limits", lambda index: (H100_SMS, H100_SMEM_OPTIN))
    L, H = 30, 50
    G = n_gates * H
    w = torch.randn(H, G)
    part, split, w_t, n_splits, per_split = backward_scratch(path, B, L, R, w)
    if path in ("reg", "wide"):
        assert split is None and w_t is None and (n_splits, per_split) == (0, 0)
        assert (None if B <= R else (-(-B // R), H, G)) == (None if part is None else tuple(part.shape))
    else:
        assert (n_splits, per_split) == dw_split_plan(L * B, H, G, H100_SMS)
        assert tuple(split.shape) == (L, B, G) and tuple(part.shape) == (n_splits, H, G)
        assert (w_t is not None) == (path == "l2")
        if w_t is not None:
            assert w_t.is_contiguous() and torch.equal(w_t, w.t())


@pytest.mark.parametrize("cell,B,H", [("gru", 0, 50), ("lstm", 16, 0), ("gru", 1024, 5000), ("lstm", 1024, 4000)])
def test_train_scan_plan_raises_where_no_kernel_fits(cell, B, H):
    with pytest.raises(ValueError, match="no"):
        train_scan_plan(cell, B, H, H100_SMS, H100_SMEM_OPTIN, backward=True)


def test_train_scan_plan_follows_the_cards_cluster_capacity():
    """Where the card holds two 80 KB CTAs an SM, GRU-128's forward takes
    64 clusters of 16 rows in one wave rather than 32 of 32."""
    assert train_scan_plan("gru", 1024, 128, H100_SMS, H100_SMEM_OPTIN, False) == ("cluster", 4, 32)
    held = {(C, R): (66 if C == 4 else 33) for C in (4, 8) for R in (8, 16, 24, 32)}
    assert train_scan_plan("gru", 1024, 128, H100_SMS, H100_SMEM_OPTIN, False, held) == ("cluster", 4, 16)


@pytest.mark.parametrize("B", [16, 64, 1024, 1717, 2112, 2113, 4096])
def test_eval_scan_plans_never_take_the_wide_path(B):
    """K3 and K6 plan their forward on the training scans' kernels without
    the wide path: the reg path at H 50 whatever the batch, as before it."""
    rows = min(REG_MAX_ROWS, -(-B // H100_SMS))
    assert gru_scan_plan(B, 50, H100_SMS, H100_SMEM_OPTIN) == ("reg", 1, rows)
    assert train_scan_plan("lstm", B, 50, H100_SMS, H100_SMEM_OPTIN, False, kernels="scan") == ("reg", 1, rows)
    assert train_scan_plan("gru", B, 50, H100_SMS, H100_SMEM_OPTIN, False, kernels="scan") == ("reg", 1, rows)
