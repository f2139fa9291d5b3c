"""The port's LSTM scans (plain versions, on the CPU) against the JAX
package's Pallas kernels in interpret mode: the eval scan (K6) and the
training scan with its five gradients (K5); the tower's gradients against
``jax.vjp`` of ``RecurrentLayers.apply`` for the GRU, LSTM and Vanilla
cells, stacked, bidirectional and with an embedding; the dW split plan;
K6's plan (the training forward's, asked of K6's own library); the lag-2
generator.

Tolerances: f32 on both sides, sums taken in other orders. Values agree to
rtol 1e-5 (atol 1e-6); gradients that sum over B*L (dW, dpeep, the tower's
input table) and the per-element ones alike to rtol 1e-4 with atol 1e-6.

The CUDA kernels themselves need a card; chip_smoke.py holds them against
these plain versions there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seqrec_tpu.data.synthetic import generate_interactions_lag2 as jax_generate_interactions_lag2
from seqrec_tpu.models.recurrent import RecurrentLayers as JaxRecurrentLayers
from seqrec_tpu.ops.pallas_lstm_train import lstm_scan_train as jax_lstm_scan_train
from seqrec_tpu.ops.pallas_rnn import lstm_scan as jax_lstm_scan
from seqrec_tpu_torch.data.synthetic import generate_interactions_lag2
from seqrec_tpu_torch.models.recurrent import RecurrentLayers
from seqrec_tpu_torch.ops.lstm_scan_train import (
    lstm_scan_train,
    lstm_scan_train_bwd,
    lstm_scan_train_fwd,
    lstm_scan_train_plain,
)
from seqrec_tpu_torch.ops import rnn_scan_train
from seqrec_tpu_torch.ops.rnn_scan import PATHS, lstm_scan, lstm_scan_plain
from seqrec_tpu_torch.ops.rnn_scan_train import TILE, dw_split_plan, train_scan_plan, train_scan_smem

B, L, H = 9, 7, 12  # ragged: L is not a multiple of the TPU's time chunk (8), H not of a lane


def _lstm_inputs(seed, empty_row=False):
    """x_pre, mask, w_hid, peepholes, h0, c0 and an upstream cotangent; rows
    of length 1 and L (or 0 and L)."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, L + 1, size=B)
    lengths[0], lengths[1] = (0 if empty_row else 1), L
    return (
        rng.normal(size=(B, L, 4 * H)).astype(np.float32),
        (np.arange(L)[None, :] < lengths[:, None]).astype(np.float32),
        rng.normal(0, 0.3, size=(H, 4 * H)).astype(np.float32),
        rng.normal(0, 0.5, size=(3, H)).astype(np.float32),
        rng.normal(size=(B, H)).astype(np.float32),
        rng.normal(size=(B, H)).astype(np.float32),
        rng.normal(size=(B, H)).astype(np.float32),
    )


@pytest.mark.parametrize("seed", [0, 1])
def test_lstm_scan_plain_matches_pallas_interpret(seed):
    x, m, w, p, h0, c0, _ = _lstm_inputs(seed, empty_row=True)
    want = np.asarray(jax_lstm_scan(*map(jnp.asarray, (x, m, w, p, h0, c0)), block_b=8, interpret=True))
    got = lstm_scan(*map(torch.from_numpy, (x, m, w, p, h0, c0))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got[0], h0[0])  # a row of length 0 keeps h0


@pytest.mark.parametrize("clip", [100.0, 0.05, 0.0])
def test_lstm_scan_train_plain_matches_pallas_interpret(clip):
    x, m, w, p, h0, c0, dh = _lstm_inputs(int(clip * 100) + 3)
    fn = lambda *a: jax_lstm_scan_train(a[0], jnp.asarray(m), *a[1:], clip, 8, True)  # noqa: E731
    want_h, vjp = jax.vjp(fn, *map(jnp.asarray, (x, w, p, h0, c0)))
    want = vjp(jnp.asarray(dh))

    leaves = [torch.tensor(a, requires_grad=True) for a in (x, w, p, h0, c0)]
    got_h = lstm_scan_train(leaves[0], torch.from_numpy(m), *leaves[1:], clip)
    got = torch.autograd.grad(got_h, leaves, torch.from_numpy(dh))
    np.testing.assert_allclose(got_h.detach().numpy(), np.asarray(want_h), rtol=1e-5, atol=1e-6)
    for name, g, wg in zip(("dx", "dW", "dpeep", "dh0", "dc0"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wg), rtol=1e-4, atol=1e-6, err_msg=name)
    # masked steps leave no gradient: dx is 0 past each row's length
    assert not got[0].numpy()[~m.astype(bool)].any()
    if clip == 0.05:  # the clip binds: dx is clipped, dW and dpeep move against the unclipped ones
        assert np.abs(got[0].numpy()).max() <= clip
        free = lstm_scan_train_plain(leaves[0], torch.from_numpy(m), *leaves[1:], 0.0)
        free_dw, free_dpeep = torch.autograd.grad(free, leaves[1:3], torch.from_numpy(dh))
        assert (free_dw - got[1]).abs().max() > 1e-2
        assert (free_dpeep - got[2]).abs().max() > 1e-2


def test_lstm_wrappers_run_plain_on_cpu_and_refuse_cpu_kernels():
    lstm_scan.launches = lstm_scan_train_fwd.launches = lstm_scan_train_bwd.launches = 0
    lstm_scan.reg_launches = lstm_scan.cluster_launches = 0
    x, m, w, p, h0, c0, dh = map(torch.from_numpy, _lstm_inputs(5))
    torch.testing.assert_close(lstm_scan(x, m, w, p, h0, c0), lstm_scan_plain(x, m, w, p, h0, c0), rtol=0, atol=0)
    torch.testing.assert_close(
        lstm_scan_train(x, m, w, p, h0, c0, 1.0), lstm_scan_train_plain(x, m, w, p, h0, c0, 1.0), rtol=0, atol=0
    )
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        lstm_scan_train_fwd(x, m, w, p, h0, c0)
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        lstm_scan_train_bwd(x, m, w, p, torch.zeros(L, B, H), torch.zeros(L, B, H), dh, 1.0)
    assert lstm_scan.launches == lstm_scan_train_fwd.launches == lstm_scan_train_bwd.launches == 0
    assert lstm_scan.reg_launches == lstm_scan.cluster_launches == 0


H100_SMS, H100_SMEM_OPTIN = 132, 232_448
# (B, H) -> K6's (path, C, R) on an H100 (the training forward's plan, with
# one cluster a C SMs) and its block's shared memory counted by hand from
# the buffer layouts of csrc/scan_train_reg.cuh, scan_train_cluster.cuh
# and lstm_forward.cuh
K6_PLANS = {
    # the serving chunk at H=50: h, c [1, 52] + hid [1, 208] + x [2, 1, 200] + mask [2, 1]
    (64, 50): ("reg", 1, 1, 4 * (104 + 208 + 400 + 2)),
    # a ragged small shape: h, c [1, 52] + hid [1, 208] + x [2, 1, 48] + mask [2, 1]
    (9, 12): ("reg", 1, 1, 4 * (104 + 208 + 96 + 2)),
    # LSTM-128's eval chunk: W[:, cols(q)] 128 x (4 x 32) + h [2, 32, 128]
    (1024, 128): ("cluster", 4, 32, 4 * (16_384 + 8_192)),
    # H=300 (38 units a CTA of 8, past a lane each): h, c [8, 300] + hid [8, 1200]
    (1024, 300): ("l2", 1, 8, 4 * 8 * 6 * 300),
}


@pytest.mark.parametrize("B,H_", list(K6_PLANS))
def test_k6_plan_is_the_training_forwards_plan(B, H_):
    """K6 runs K5's forward kernels without their state stores, so its plan
    is train_scan_plan's forward plan: reg at H=50 and H=12, a 4-CTA
    cluster at H=128, the l2 kernel at H=300; its shared memory is the
    forward's."""
    path, C, R, smem = K6_PLANS[B, H_]
    assert train_scan_plan("lstm", B, H_, H100_SMS, H100_SMEM_OPTIN, backward=False) == (path, C, R)
    assert train_scan_smem("lstm", path, H_, C, R, backward=False) == smem <= H100_SMEM_OPTIN


class _FakeScanLibrary:
    """The two queries device_train_plan makes of csrc/lstm_scan.cu's
    library (seqrec_lstm_scan_capacity, seqrec_lstm_scan_smem), answered
    from the plan's own numbers; the smem answer is off by ``smem_off``."""

    def __init__(self, held, smem_off=0):
        self.held, self.smem_off, self.calls = held, smem_off, []

    def seqrec_lstm_scan_capacity(self, backward, H, C, R, n):
        self.calls.append(("capacity", backward, H, C, R))
        n._obj.value = self.held[C, R]
        return 0

    def seqrec_lstm_scan_smem(self, backward, path, H, C, R):
        self.calls.append(("smem", backward, path, H, C, R))
        name = {code: p for p, code in PATHS.items()}[path]
        return train_scan_smem("lstm", name, H, C, R, bool(backward)) + self.smem_off


def test_k6_device_plan_reads_the_eval_kernels_capacity_and_checks_their_smem(monkeypatch):
    """On the card, lstm_scan's plan asks K6's own library (the eval form of
    the cluster kernel) for the clusters the card holds, forward only, and
    raises where the plan's shared-memory count differs from the kernel's."""
    import contextlib

    monkeypatch.setattr(rnn_scan_train, "_plans", {})
    monkeypatch.setattr(rnn_scan_train, "device_limits", lambda index: (H100_SMS, H100_SMEM_OPTIN))
    monkeypatch.setattr(torch.cuda, "device", lambda index: contextlib.nullcontext())
    device = torch.device("cuda", 0)
    # two CTAs an SM: 64-row-tile waves favour R = 16
    lib = _FakeScanLibrary({(C, R): (66 if C == 4 else 33) for C in (4, 8) for R in (8, 16, 24, 32)})
    plan = rnn_scan_train.device_train_plan("lstm", 1024, 128, device, False, lambda: lib, kernels="scan")
    assert plan == ("cluster", 4, 16)
    assert {c[1] for c in lib.calls} == {0}  # forward only
    assert lib.calls[-1] == ("smem", 0, PATHS["cluster"], 128, 4, 16)
    bad = _FakeScanLibrary(lib.held, smem_off=4)
    with pytest.raises(RuntimeError, match="bytes of shared memory"):
        rnn_scan_train.device_train_plan("lstm", 64, 50, device, False, lambda: bad, kernels="scan")


@pytest.mark.parametrize(
    "K,H_,G",
    [(30 * 1024, 128, 512), (30 * 1024, 128, 384), (30 * 16, 50, 200), (63, 12, 48), (30 * 1025, 130, 520),
     (30 * 1024, 256, 768)],
)
def test_dw_split_plan_covers_the_rows_in_whole_tiles(K, H_, G):
    n_splits, per_split = dw_split_plan(K, H_, G, n_sm=132)
    assert per_split % TILE == 0 and (n_splits - 1) * per_split < K <= n_splits * per_split


def test_port_lag2_generator_draws_the_jax_interactions():
    kwargs = dict(n_users=60, n_items=90, min_len=5, max_len=30, markov_strength=0.6, seed=4)
    np.testing.assert_array_equal(generate_interactions_lag2(**kwargs), jax_generate_interactions_lag2(**kwargs))


# ----------------------------------------------------------------------
# the tower: values and gradients against RecurrentLayers.apply
# ----------------------------------------------------------------------
TOWERS = [([12], False, 0), ([10, 12], True, 0), ([12], False, 6)]
N_IDS = 40


def tower_pair(cell, layers, bidirectional, embedding, grad_clip=100):
    """The JAX tower, the port's tower and one numpy parameter tree loaded
    into the port's."""
    jax_tower = JaxRecurrentLayers(cell, layers, bidirectional, embedding, grad_clip)
    tower = RecurrentLayers(cell, layers, bidirectional, embedding, grad_clip)
    params = jax_tower.init_params(np.random.default_rng(5), N_IDS)
    tower.build(N_IDS, "cpu")
    flat = {}
    for key, val in params.items():
        for name, arr in (val.items() if isinstance(val, dict) else [(None, val)]):
            flat[key if name is None else f"{key}.{name}"] = torch.from_numpy(arr)
    tower.load_state_dict(flat, strict=True)
    return jax_tower, tower, params


def tower_inputs(seed=6):
    """Ragged ids [B, L, 2] with pad slots, mask and id_mask."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, N_IDS, size=(B, L, 2)).astype(np.int32)
    ids[:, :, 1] = -1  # pad slot
    ids[::3, 2, 1] = 7
    lengths = rng.integers(1, L + 1, size=B)
    lengths[1] = L
    mask = (np.arange(L)[None, :] < lengths[:, None]).astype(np.float32)
    id_mask = np.broadcast_to(mask[:, :, None], ids.shape).astype(np.float32)
    return ids, mask, id_mask


def _case_id(case):
    layers, bidirectional, embedding = case
    return "-".join(map(str, layers)) + ("-bi" if bidirectional else "") + (f"-emb{embedding}" if embedding else "")


@pytest.mark.parametrize("grad_clip", [100, 0.05])
@pytest.mark.parametrize("case", TOWERS, ids=_case_id)
@pytest.mark.parametrize("cell", ["GRU", "LSTM", "Vanilla"])
def test_tower_gradients_match_jax(cell, case, grad_clip):
    """train=True (K1/K5's plain versions for the last layer, the plain
    step for the others) against jax.vjp of apply(fast=False), for one
    random cotangent of the final state, w.r.t. every parameter."""
    jax_tower, tower, params = tower_pair(cell, *case, grad_clip=grad_clip)
    ids, mask, id_mask = tower_inputs()
    ct = np.random.default_rng(8).normal(size=(B, tower.output_size)).astype(np.float32)
    fn = lambda p: jax_tower.apply(p, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(id_mask))  # noqa: E731
    want_out, vjp = jax.vjp(fn, jax.tree_util.tree_map(jnp.asarray, params))
    (want,) = vjp(jnp.asarray(ct))

    out = tower(torch.from_numpy(ids), torch.from_numpy(mask), torch.from_numpy(id_mask), train=True)
    names = [name for name, _ in tower.named_parameters()]
    grads = torch.autograd.grad(out, list(tower.parameters()), torch.from_numpy(ct))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), rtol=1e-5, atol=1e-6)
    assert len(names) == len(jax.tree_util.tree_leaves(want))
    for name, g in zip(names, grads):
        node = want
        for part in name.split("."):
            node = node[part]
        np.testing.assert_allclose(g.numpy(), np.asarray(node), rtol=1e-4, atol=1e-6, err_msg=name)
