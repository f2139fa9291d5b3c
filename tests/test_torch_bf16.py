"""--bf16 and --u_moments bfloat16 in the port against the JAX package on
the CPU.

--bf16: the catalog-sized products take bf16 operands and sum in f32, with
an f32 result (``base.py:_out_matmul``; the streaming CCE's and streaming
margin's chunk scans). The port's CCE costs and gradients, dense and
streaming, and the margin head's, equal the JAX package's within 1e-4 of
each tensor's largest magnitude: the products of bf16 values are exact in
f32, so only the order of the f32 sums differs, and a gradient the JAX
package rounds to bf16 may round the other way where that sum sits on a
rounding boundary. At 16,384 items the port routes the bf16 loss to its
chunk loop, never to K2 (f32 only, as the JAX package's kernel).

--u_moments bfloat16: the port's moments are bf16 tensors with stochastic
rounding from a seeded torch.Generator, so the bits are not the JAX
package's; held to its law as ``tests/test_optimizers.py`` holds the JAX
package's: costs within 5e-3 and parameters within rtol 0.05 / atol 2e-3
of f32 Adam over 10 steps, the EMA of 1,500 steps tracked within 10%, and
non-finite values passed through. Small sizes: GRU-16, L=10, B=8.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import seqrec_tpu.utils.command_parser as jax_parse
import seqrec_tpu_torch.cli.train as torch_train_cli
import seqrec_tpu_torch.utils.command_parser as parse
from seqrec_tpu.ops import streaming_cce as jax_cce
from seqrec_tpu.ops import streaming_margin as jax_margin
from seqrec_tpu_torch.models import updates
from seqrec_tpu_torch.ops import streaming_cce, streaming_margin
from seqrec_tpu_torch.ops.core import matmul_bf16

TOL = 1e-4
BASE = ["-m", "RNN", "--r_l", "16", "--max_length", "10", "-b", "8", "--bf16"]


def assert_close(got, want, what=""):
    """max |got - want| <= TOL * max |want| (module docstring)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() / scale
    assert err <= TOL, f"{what}: max error {err:.3g} of the largest magnitude"


def _problem(B=16, H=24, N=2500, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, H)).astype(np.float32), (0.3 * rng.normal(size=(H, N))).astype(np.float32),
            (0.1 * rng.normal(size=N)).astype(np.float32), rng.integers(0, N, B).astype(np.int32),
            rng.uniform(0.5, 1.5, B).astype(np.float32))


def _torch_grads(fn, *arrays):
    leaves = [torch.tensor(a, requires_grad=True) for a in arrays]
    out = fn(*leaves)
    out.sum().backward()
    return out.detach().numpy(), [leaf.grad.numpy() for leaf in leaves]


@pytest.mark.parametrize("chunk", [512, None], ids=["chunk512-padded", "pick_chunk"])
def test_streaming_cce_bf16_equals_jax(chunk):
    h, W, b, t, g = _problem()
    jchunk = chunk or jax_cce.pick_chunk(W.shape[1])

    def jax_loss(h, W, b):
        return jax_cce.streaming_cce(h, W, b, jnp.asarray(t), jchunk, jnp.bfloat16) * g

    want = jax_loss(h, W, b)
    want_grads = jax.grad(lambda *a: jax_loss(*a).sum(), (0, 1, 2))(h, W, b)
    got, got_grads = _torch_grads(
        lambda h, W, b: streaming_cce.streaming_cce(h, W, b, torch.tensor(t), "bfloat16", chunk) * torch.tensor(g),
        h, W, b,
    )
    assert_close(got, want, "loss")
    for name, a, w in zip(("dh", "dW", "db"), got_grads, want_grads):
        assert_close(a, w, name)


def test_dense_bf16_product_and_cce_equal_jax():
    """``_out_matmul``'s product (JAX: jnp.dot of bf16 casts, f32 result)
    under the diversity-biased CCE: loss, dh, dW, db."""
    from seqrec_tpu.ops import losses as jax_losses
    from seqrec_tpu_torch.ops import losses

    h, W, b, t, g = _problem(N=300)

    def jax_loss(h, W, b):
        logits = jnp.dot(h.astype(jnp.bfloat16), W.astype(jnp.bfloat16), preferred_element_type=jnp.float32) + b
        return jax_losses.diversity_biased_cce(logits, jnp.asarray(t), jnp.asarray(g))

    want, want_grads = jax.value_and_grad(jax_loss, (0, 1, 2))(h, W, b)
    got, got_grads = _torch_grads(
        lambda h, W, b: losses.diversity_biased_cce(matmul_bf16(h, W) + b, torch.tensor(t).long(), torch.tensor(g)),
        h, W, b,
    )
    assert_close(got, want, "loss")
    for name, a, w in zip(("dh", "dW", "db"), got_grads, want_grads):
        assert_close(a, w, name)
    # the result is f32 but its operands were bf16: it differs from the f32 product
    prod = matmul_bf16(torch.tensor(h), torch.tensor(W))
    assert prod.dtype == torch.float32
    assert not torch.equal(prod, torch.tensor(h) @ torch.tensor(W))


@pytest.mark.parametrize("loss_name", ["hinge", "logsig"])
def test_streaming_margin_bf16_equals_jax(loss_name):
    h, W, b, _, _ = _problem(B=8, N=1100)
    rng = np.random.default_rng(3)
    N = W.shape[1]
    tgt = rng.integers(0, N, (8, 2)).astype(np.int32)
    seen = rng.integers(0, N + 1, (8, 5)).astype(np.int32)  # N pads
    seen[:, 0] = tgt[:, 0]  # a seen id overrides a target
    w_neg = rng.uniform(0.001, 0.01, 8).astype(np.float32)
    default = rng.uniform(0, 0.1, N).astype(np.float32)

    def jax_loss(h, W, b):
        return jax_margin.streaming_margin(h, W, b, jnp.asarray(tgt), jnp.asarray(seen), jnp.asarray(w_neg),
                                           jnp.asarray(default), loss_name, True, 512, jnp.bfloat16)

    want = jax_loss(h, W, b)
    want_grads = jax.grad(lambda *a: jax_loss(*a).sum(), (0, 1, 2))(h, W, b)
    got, got_grads = _torch_grads(
        lambda h, W, b: streaming_margin.streaming_margin(
            h, W, b, torch.tensor(tgt).long(), torch.tensor(seen).long(), torch.tensor(w_neg),
            torch.tensor(default), loss_name, True, 512, compute_dtype="bfloat16"),
        h, W, b,
    )
    assert_close(got, want, "loss")
    for name, a, w in zip(("dh", "dW", "db"), got_grads, want_grads):
        assert_close(a, w, name)


def _model_pair(flags, n_items=None, dataset_dir=None):
    argv = BASE + flags
    jax_args = jax_parse.command_parser(jax_parse.predictor_command_parser, argv=argv)
    args = parse.command_parser(parse.predictor_command_parser, argv=argv)
    args.device = "cpu"
    jm, tm = jax_parse.get_predictor(jax_args), parse.get_predictor(args)
    assert tm.compute_dtype == "bfloat16" and jm.compute_dtype == jnp.bfloat16
    for m in (jm, tm):
        m._prepare_networks(n_items)
    return jm, tm


def _model_loss_and_grads(flags, n_items, batch, seed=0):
    """The JAX model's ``_loss`` and its gradient against the port's, from
    one init (the model's own, seeded), on one device batch."""
    jm, tm = _model_pair(flags, n_items)
    tree = jm._init_params()
    tm.params_from_numpy(copy.deepcopy(tree))
    want, want_grads = jax.value_and_grad(jm._loss)(jax.tree_util.tree_map(jnp.asarray, tree), batch)
    dev = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    for key in ("targets", "target_ids", "seen_ids", "samples"):
        if key in dev:
            dev[key] = dev[key].long()
    got = tm._loss(dev)
    got.backward()
    grads = {name: p.grad.numpy() for name, p in tm.net.named_parameters()}
    assert_close(got.item(), float(want), "cost")
    flat = dict(jax.tree_util.tree_flatten_with_path(want_grads)[0])
    for path, w in flat.items():
        name = ".".join(k.key for k in path)
        assert_close(grads[name], w, name)
    return tm


def _batch(n_items, B=8, L=10, seed=0, margin=False):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, L + 1, B)
    mask = (np.arange(L)[None, :] < lengths[:, None]).astype(np.float32)
    ids = rng.integers(0, n_items, (B, L, 1)).astype(np.int32)
    batch = {"ids": ids, "mask": mask}
    targets = rng.integers(0, n_items, B).astype(np.int32)
    if margin:
        batch.update(target_ids=targets[:, None], t_count=np.ones(B, np.float32),
                     seen_ids=np.where(mask > 0, ids[:, :, 0], n_items).astype(np.int32))
    else:
        batch.update(targets=targets, target_pop=rng.uniform(0.5, 2.0, B).astype(np.float32))
    return batch


@pytest.mark.parametrize("n_items", [60, 16384], ids=["dense", "streaming"])
def test_bf16_cce_model_cost_and_grads_equal_jax(n_items):
    """RNNOneHot with --bf16: the dense head at 60 items, the streaming
    CCE's bf16 chunk loop at 16,384 (the port's K2 counters stay at 0)."""
    streaming_cce.cce_stats.launches = streaming_cce.cce_grads.launches = 0
    tm = _model_loss_and_grads(["--loss", "CCE", "--db", "0.2"], n_items, _batch(n_items))
    assert tm._use_streaming_head() == (n_items == 16384)
    assert streaming_cce.cce_stats.launches == streaming_cce.cce_grads.launches == 0


@pytest.mark.parametrize("n_items", [60, 16384], ids=["dense", "streaming"])
def test_bf16_margin_model_cost_and_grads_equal_jax(n_items):
    jm, tm = _model_pair(["--loss", "hinge"], n_items)
    default = np.zeros(n_items, np.float32)
    jm._default_target, tm._default_target, tm._default_target_dev = default, default, None
    batch = _batch(n_items, margin=True)
    tree = jm._init_params()
    tm.params_from_numpy(copy.deepcopy(tree))
    want, want_grads = jax.value_and_grad(jm._loss)(jax.tree_util.tree_map(jnp.asarray, tree), batch)
    dev = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    dev["target_ids"], dev["seen_ids"] = dev["target_ids"].long(), dev["seen_ids"].long()
    got = tm._loss(dev)
    got.backward()
    assert_close(got.item(), float(want), "cost")
    assert_close(tm.net.W_out.grad.numpy(), want_grads["W_out"], "W_out")
    assert_close(tm.net.b_out.grad.numpy(), want_grads["b_out"], "b_out")


def test_bf16_rank_scores_equal_jax(synthetic_dataset):
    """The scores --save_rank ranks (``_rank_scores``) and the softmax
    scores of the sampled head, through the bf16 product."""
    from seqrec_tpu.data import DataHandler as JaxDataHandler
    from seqrec_tpu_torch.data import DataHandler

    for flags in (["--loss", "CCE"], ["--loss", "BPR"]):
        argv = BASE + flags
        jm = jax_parse.get_predictor(jax_parse.command_parser(jax_parse.predictor_command_parser, argv=argv))
        args = parse.command_parser(parse.predictor_command_parser, argv=argv)
        args.device = "cpu"
        tm = parse.get_predictor(args)
        jm.prepare_model(JaxDataHandler(synthetic_dataset))
        tm.prepare_model(DataHandler(synthetic_dataset))
        tree = jm._init_params()
        tm.params_from_numpy(copy.deepcopy(tree))
        ids, id_mask, mask = _batch(tm.n_items)["ids"], None, _batch(tm.n_items)["mask"]
        params = jax.tree_util.tree_map(jnp.asarray, tree)
        with torch.inference_mode():
            t_in = (torch.from_numpy(ids), None, torch.from_numpy(mask))
            assert_close(tm._rank_scores(*t_in).numpy(), jm._rank_scores(params, ids, id_mask, mask), "rank")
            assert_close(tm._scores(*t_in).numpy(), jm._scores(params, ids, id_mask, mask), "scores")


# ----------------------------------------------------------------------
# --u_moments bfloat16
# ----------------------------------------------------------------------
def _adam_run(moment_dtype, steps=10, seed=0):
    rng = np.random.default_rng(seed)
    params = [torch.tensor(rng.normal(size=(12, 6)), dtype=torch.float32),
              torch.tensor(rng.normal(size=6), dtype=torch.float32)]
    opt = updates.Adam(0.01, moment_dtype=moment_dtype)
    state = opt.init(params)
    for _ in range(steps):
        grads = [torch.tensor(rng.normal(size=p.shape), dtype=torch.float32) for p in params]
        opt.step(params, grads, state)
    return params, state


def test_bf16_moment_adam_tracks_f32_adam():
    """tests/test_optimizers.py's law on the port's RNNOneHot: 10 steps,
    costs within 5e-3, W_out and b_out within rtol 0.05 / atol 2e-3."""
    from seqrec_tpu_torch.models.recurrent import RecurrentLayers
    from seqrec_tpu_torch.models.rnn_one_hot import RNNOneHot

    def model(moments):
        m = RNNOneHot(recurrent_layer=RecurrentLayers("GRU", [6]), updater=updates.Adam(0.01, moment_dtype=moments),
                      max_length=4, batch_size=4, seed=0, device="cpu")
        m._prepare_networks(12)
        m.params_from_numpy(m._init_params())
        return m

    f32, bf16 = model("float32"), model("bfloat16")
    rng = np.random.default_rng(0)
    for _ in range(10):
        ids = rng.integers(0, 12, size=(4, 4)).astype(np.int32)
        batch = {"ids": ids[..., None], "mask": np.ones((4, 4), np.float32),
                 "targets": rng.integers(0, 12, size=4).astype(np.int32), "target_pop": np.ones(4, np.float32)}
        np.testing.assert_allclose(float(f32.train_function(dict(batch))), float(bf16.train_function(dict(batch))),
                                   rtol=5e-3)
    for name in ("W_out", "b_out"):
        np.testing.assert_allclose(getattr(bf16.net, name).detach().numpy(), getattr(f32.net, name).detach().numpy(),
                                   rtol=0.05, atol=2e-3)
    assert {m.dtype for slot in ("mu", "nu") for m in bf16.opt_state[slot]} == {torch.bfloat16}
    assert {m.dtype for slot in ("mu", "nu") for m in f32.opt_state[slot]} == {torch.float32}


def test_bf16_moments_track_small_ema_increments():
    """The absorption regression of tests/test_optimizers.py: nu decays over
    1,500 zero-gradient steps and grows toward g^2 under g = 2, in
    expectation, where round-to-nearest would freeze it."""
    p = [torch.ones(64)]
    opt = updates.Adam(0.0, moment_dtype="bfloat16")
    state = opt.init(p)
    state["nu"][0] = torch.ones(64, dtype=torch.bfloat16)
    for _ in range(1500):
        opt.step(p, [torch.zeros(64)], state)
    decayed = state["nu"][0].float().mean().item()
    want = 0.999**1500
    assert abs(decayed - want) < 0.1 * want + 0.02, decayed
    for _ in range(1500):
        opt.step(p, [torch.full((64,), 2.0)], state)
    grown = state["nu"][0].float().mean().item()
    want = 4.0 - (4.0 - decayed) * 0.999**1500
    assert abs(grown - want) < 0.1 * want, (grown, want)


def test_stochastic_rounding_is_unbiased_and_passes_non_finite_values():
    x = torch.full((20000,), 1.0 + 2.0**-10)  # 1/8 of a bf16 ulp above 1
    r = updates.stochastic_round_bf16(x, torch.Generator().manual_seed(1)).float()
    assert set(r.unique().tolist()) == {1.0, 1.0 + 2.0**-7}
    assert abs(r.mean().item() - x[0].item()) < 2e-4
    special = torch.tensor([float("inf"), float("-inf"), float("nan"), -3.0])
    out = updates.stochastic_round_bf16(special, torch.Generator().manual_seed(2)).float()
    assert out[0] == float("inf") and out[1] == float("-inf") and torch.isnan(out[2]) and out[3] == -3.0


def test_bf16_moment_steps_seeded_per_step():
    """The same step count draws the same noise: two runs give the same
    bits; the moments are stored as bf16."""
    (pa, sa), (pb, sb) = _adam_run("bfloat16"), _adam_run("bfloat16")
    for a, b in zip(pa + sa["mu"] + sa["nu"], pb + sb["mu"] + sb["nu"]):
        assert torch.equal(a, b)
    assert sa["count"] == 10 and sa["mu"][0].dtype == torch.bfloat16


def test_bf16_cli_trains_and_names_like_jax(synthetic_dataset, tmp_path):
    """The train CLI takes --bf16 --u_moments bfloat16 (and --lazy_updates)
    on the CPU and names the checkpoint as the JAX package does."""
    import os
    import shutil

    d = str(tmp_path / "ds") + "/"
    # the dataset alone: earlier tests may have written checkpoints into the shared fixture's models/
    shutil.copytree(synthetic_dataset, d, ignore=shutil.ignore_patterns("models"))
    flags = BASE + ["--loss", "CCE", "--u_moments", "bfloat16", "--lazy_updates"]
    torch_train_cli.main(["-d", d, *flags, "--max_iter", "6", "--progress", "6", "--save", "All", "--device", "cpu"])
    jax_args = jax_parse.command_parser(jax_parse.predictor_command_parser, argv=flags)
    name = jax_parse.get_predictor(jax_args)._get_model_filename(0)
    files = os.listdir(d + "models/")
    assert len(files) == 1 and files[0].startswith(name.split("_ne")[0]) and "_mbf16_lu" in files[0]
