"""The port's sampled heads (BPR, TOP1, Blackout), margin heads (hinge,
logit, logsig; dense and streaming) and ``--lazy_updates`` against the JAX
package on the CPU: the losses and the streaming margin against ``jax.vjp``
of the JAX functions, batches (negative samples included) equal to the JAX
package's for one seed, 20 training steps of each head from the same
parameters, the lazy Adam's frozen slices and refusals, and train-CLI
checkpoints that the JAX test CLI reads. Small sizes throughout (GRU and
LSTM towers of widths 6 to 16, L=10).

Tolerances: the losses rtol 1e-6 (the same f32 expressions; atol 1e-7
times the largest entry for the entries that round to nearly 0); the
streaming margin rtol 1e-5, atol 1e-6 (chunked sums in another order);
training as ``tests/test_torch_train.py``: costs rtol 1e-5, parameters
after 20 Adam steps rtol 1e-4 with atol 5e-5.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import seqrec_tpu.cli.test as jax_test_cli
import seqrec_tpu.utils.command_parser as jax_parse
import seqrec_tpu_torch.cli.test as torch_test_cli
import seqrec_tpu_torch.cli.train as torch_train_cli
import seqrec_tpu_torch.utils.command_parser as parse
from seqrec_tpu.data import DataHandler as JaxDataHandler
from seqrec_tpu.models.recurrent import RecurrentLayers as JaxRecurrentLayers
from seqrec_tpu.models.rnn_margin import RNNMargin as JaxRNNMargin
from seqrec_tpu.models.rnn_one_hot import RNNOneHot as JaxRNNOneHot
from seqrec_tpu.models.rnn_sampling import RNNSampling as JaxRNNSampling
from seqrec_tpu.models.updates import Adam as JaxAdam
from seqrec_tpu.ops import losses as jax_losses
from seqrec_tpu.ops.streaming_margin import streaming_margin as jax_streaming_margin
from seqrec_tpu_torch.data import DataHandler
from seqrec_tpu_torch.data.synthetic import make_dataset
from seqrec_tpu_torch.models.recurrent import RecurrentLayers
from seqrec_tpu_torch.models.rnn_margin import RNNMargin, dense_margin
from seqrec_tpu_torch.models.rnn_one_hot import RNNOneHot
from seqrec_tpu_torch.models.rnn_sampling import RNNSampling
from seqrec_tpu_torch.models.updates import Adam, RMSProp
from seqrec_tpu_torch.ops import losses
from seqrec_tpu_torch.ops.streaming_margin import streaming_margin


def _close(got, want, rtol, atol_rel=0.0, err_msg=""):
    want = np.asarray(want)
    atol = atol_rel * float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol, atol=atol, err_msg=err_msg)


# ----------------------------------------------------------------------
# the losses
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", ["BPR", "TOP1", "Blackout", "hinge", "logit", "logsig"])
def test_loss_values_and_gradients_match_jax(name):
    rng = np.random.default_rng(1)
    B = 8
    g = rng.normal(size=B).astype(np.float32)
    if name in losses.SAMPLED_LOSSES:
        x = rng.normal(0, 2, size=(B, B + 24)).astype(np.float32)
        args = ()
        jax_fn = lambda s: jax_losses.SAMPLED_LOSSES[name](s, B)  # noqa: E731
        fn = lambda s: losses.SAMPLED_LOSSES[name](s, B)  # noqa: E731
    else:
        x = rng.normal(0, 2, size=(B, 40)).astype(np.float32)
        Y = rng.uniform(0, 1, size=x.shape).astype(np.float32)
        Wt = rng.choice([-1.0, 0.0, 0.05], size=x.shape).astype(np.float32)
        args = (Y, Wt)
        jax_fn = lambda p: jax_losses.MARGIN_LOSSES[name](p, *args)  # noqa: E731
        fn = lambda p: losses.MARGIN_LOSSES[name](p, *map(torch.from_numpy, args))  # noqa: E731
    want, pull = jax.vjp(jax_fn, jnp.asarray(x))
    (want_g,) = pull(jnp.asarray(g))
    t = torch.tensor(x, requires_grad=True)
    got = fn(t)
    (got_g,) = torch.autograd.grad(got, t, torch.from_numpy(g))
    _close(got.detach(), want, rtol=1e-6, atol_rel=1e-7, err_msg="value")
    _close(got_g, want_g, rtol=1e-6, atol_rel=1e-7, err_msg="gradient")


# ----------------------------------------------------------------------
# the streaming margin
# ----------------------------------------------------------------------
def _margin_case(seed=0, B=8, H=8, N=1000, T=2, L=6):
    """(h, W, b, target ids, seen ids, w_neg, default target) as numpy, with
    padded slots (id N) among the targets and the seen items."""
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(B, H)).astype(np.float32)
    W = (rng.normal(size=(H, N)) * 0.1).astype(np.float32)
    b = (rng.normal(size=N) * 0.1).astype(np.float32)
    tgt = rng.integers(0, N, size=(B, T)).astype(np.int32)
    tgt[::3, -1] = N
    seen = rng.integers(0, N, size=(B, L)).astype(np.int32)
    seen[::2, -2:] = N
    w_neg = (rng.random(B) * 0.01 + 0.001).astype(np.float32)
    dt = (rng.random(N) * 0.3).astype(np.float32)
    return h, W, b, tgt, seen, w_neg, dt


def _check_streaming_margin(case, loss_name, unique, chunk):
    """The port's streaming margin against JAX's: per-example values and the
    gradients of h, W and b for a random cotangent; and against the port's
    dense margin on the same inputs."""
    h, W, b, tgt, seen, w_neg, dt = case
    g = np.random.default_rng(9).normal(size=h.shape[0]).astype(np.float32)

    def jax_fn(h, W, b):
        return jax_streaming_margin(h, W, b, jnp.asarray(tgt), jnp.asarray(seen), jnp.asarray(w_neg),
                                    jnp.asarray(dt), loss_name, unique, chunk)

    @jax.jit
    def jax_vjp(h, W, b, g):
        out, pull = jax.vjp(jax_fn, h, W, b)
        return out, pull(g)

    want, want_g = jax_vjp(*map(jnp.asarray, (h, W, b, g)))
    leaves = [torch.tensor(a, requires_grad=True) for a in (h, W, b)]
    ids = [torch.from_numpy(a).long() for a in (tgt, seen)]
    consts = [torch.from_numpy(a) for a in (w_neg, dt)]
    got = streaming_margin(*leaves, *ids, *consts, loss_name, unique, chunk)
    got_g = torch.autograd.grad(got, leaves, torch.from_numpy(g))
    _close(got.detach(), want, rtol=1e-5, atol_rel=1e-6, err_msg="value")
    for name, a, c in zip("hWb", got_g, want_g):
        _close(a, c, rtol=1e-5, atol_rel=1e-6, err_msg="d" + name)

    dense = dense_margin(leaves[0] @ leaves[1] + leaves[2], *ids, *consts, loss_name, unique)
    dense_g = torch.autograd.grad(dense, leaves, torch.from_numpy(g))
    _close(got.detach(), dense.detach(), rtol=1e-5, atol_rel=1e-6, err_msg="value against the dense margin")
    for name, a, c in zip("hWb", got_g, dense_g):
        _close(a, c, rtol=1e-5, atol_rel=1e-6, err_msg="d" + name + " against the dense margin")


@pytest.mark.parametrize("loss_name", ["hinge", "logit", "logsig"])
@pytest.mark.parametrize("unique", [True, False])
@pytest.mark.parametrize("chunk", [250, 300])  # dividing, and a ragged last chunk
def test_streaming_margin_matches_jax(loss_name, unique, chunk):
    _check_streaming_margin(_margin_case(), loss_name, unique, chunk)


@pytest.mark.parametrize("loss_name", ["hinge", "logsig"])
@pytest.mark.parametrize("unique", [True, False])
def test_streaming_margin_duplicate_and_overriding_ids_match_jax(loss_name, unique):
    """Duplicate targets and seen items count once; a seen item overrides a
    target (the dense scatters' idempotence and precedence)."""
    h, W, b, _, _, w_neg, dt = _margin_case(seed=3, B=6, N=400, T=3, L=5)
    N = 400
    tgt = np.array([[5, 5, 17], [10, 11, 10], [N, N, 3], [7, 8, 9], [50, 50, 50], [0, 1, 2]], dtype=np.int32)
    seen = np.array([[5, 30, 31, 32, N], [10, 10, 40, N, N], [3, 3, 3, 3, 3], [60, 61, 62, 63, 64],
                     [50, N, N, N, N], [70, 71, 72, 73, 74]], dtype=np.int32)
    _check_streaming_margin((h, W, b, tgt, seen, w_neg, dt), loss_name, unique, 128)


# ----------------------------------------------------------------------
# batches and 20 training steps against the JAX package
# ----------------------------------------------------------------------
def _pair(dataset_dir, jax_cls, cls, cell="GRU", layers=(16,), updater=(JaxAdam, Adam), **kwargs):
    kwargs = dict(max_length=10, batch_size=8, seed=4, **kwargs)
    jm = jax_cls(recurrent_layer=JaxRecurrentLayers(cell, list(layers)), updater=updater[0](0.01), **kwargs)
    tm = cls(recurrent_layer=RecurrentLayers(cell, list(layers)), updater=updater[1](0.01), device="cpu", **kwargs)
    for model, handler in ((jm, JaxDataHandler(dataset_dir)), (tm, DataHandler(dataset_dir))):
        model.prepare_model(handler)
        model.set_dataset(handler)
    return jm, tm


def _assert_same_batches(want, got):
    assert want.keys() == got.keys()
    for key in want:
        assert np.asarray(want[key]).dtype == np.asarray(got[key]).dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def _start_both(jm, tm):
    """The same initial parameters in both packages (each drawn from its own
    generator, which the batches then continue)."""
    tree, jax_tree = tm._init_params(), jm._init_params()
    for key, want in _leaves(jax_tree):
        np.testing.assert_array_equal(dict(_leaves(tree))[key], want, err_msg=key)
    tm.params_from_numpy(copy.deepcopy(tree))
    jm.params = jax.tree_util.tree_map(jnp.asarray, tree)
    jm._build_functions()
    jm.opt_state = jm._opt.init(jm.params)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + "/")
        else:
            yield prefix + k, v


def _packed_batches(jm, tm, n=20):
    """n packed batches of each package's batcher (generator seed 4 + 77),
    checked equal: the same rows, targets and negative samples."""
    jh, th = jm.dataset, tm.dataset
    want = jm._gen_packed_mini_batch(jh.training_set, np.random.default_rng(4 + 77))
    got = tm._gen_packed_mini_batch(th.training_set, np.random.default_rng(4 + 77))
    batches = []
    for _ in range(n):
        a, b = next(want), next(got)
        _assert_same_batches(a, b)
        batches.append(b)
    return batches


def _train_both(jm, tm, batches):
    want, got = [], []
    for batch in batches:
        want.append(float(jm.train_function(dict(batch))))
        got.append(float(tm.train_function(dict(batch))))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    _assert_same_params(tm.params_to_numpy(), jax.tree_util.tree_map(np.asarray, jm.params))
    return got


def _assert_same_params(got, want, prefix=""):
    assert got.keys() == want.keys()
    for key in want:
        if isinstance(want[key], dict):
            _assert_same_params(got[key], want[key], prefix + key + "/")
        else:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=5e-5, err_msg=prefix + key)


def _twenty_steps(dataset_dir, jax_cls, cls, cell="GRU", updater=(JaxAdam, Adam), **kwargs):
    jm, tm = _pair(dataset_dir, jax_cls, cls, cell=cell, updater=updater, **kwargs)
    assert jm._fast_batching_ok() and tm._fast_batching_ok()
    _start_both(jm, tm)
    return jm, tm, _train_both(jm, tm, _packed_batches(jm, tm))


@pytest.mark.parametrize(
    "kwargs",
    [dict(loss_function="BPR", sampling=20), dict(loss_function="TOP1", sampling=0.3, diversity_bias=0.3),
     dict(loss_function="Blackout", sampling=24, sampling_bias=0.5)],
    ids=["bpr", "top1-fractional-db", "blackout-bias"],
)
def test_sampled_heads_twenty_steps_match_jax(synthetic_dataset, kwargs):
    """Samples drawn from the model's generator after the init, in the JAX
    package's order; uniform, pop^bias, and a fractional --sampling."""
    jm, tm, costs = _twenty_steps(synthetic_dataset, JaxRNNSampling, RNNSampling, **kwargs)
    assert tm.effective_sampling == jm.effective_sampling
    assert costs[-1] < costs[0]


@pytest.mark.parametrize(
    "kwargs",
    [dict(loss_function="hinge"), dict(loss_function="logit", popularity_based=True),
     dict(loss_function="logsig", balance=2.0, interactions_are_unique=False)],
    ids=["hinge", "logit-pb", "logsig-repeated"],
)
def test_dense_margin_heads_twenty_steps_match_jax(synthetic_dataset, kwargs):
    _twenty_steps(synthetic_dataset, JaxRNNMargin, RNNMargin, **kwargs)


def test_lstm_sampled_head_twenty_steps_match_jax(synthetic_dataset):
    """The BPR head on an LSTM tower (K5's plain version)."""
    _twenty_steps(synthetic_dataset, JaxRNNSampling, RNNSampling, cell="LSTM", loss_function="BPR", sampling=20)


class _Catalog:
    """The dataset fields the margin head reads, for a synthetic catalog."""

    def __init__(self, n):
        self.item_popularity = np.arange(1, n + 1, dtype=np.float64)

        class _Train:
            n_users = 3 * n

        self.training_set = _Train()


def test_streaming_margin_head_twenty_steps_match_jax():
    """At 16,384 items both packages route the margin through the streaming
    op; two stacked layers, popularity-based default targets."""
    N, B, L = 16384, 16, 10
    kwargs = dict(max_length=L, batch_size=B, seed=6, loss_function="logsig", popularity_based=True)
    jm = JaxRNNMargin(recurrent_layer=JaxRecurrentLayers("GRU", [6, 8]), updater=JaxAdam(0.01), **kwargs)
    tm = RNNMargin(recurrent_layer=RecurrentLayers("GRU", [6, 8]), updater=Adam(0.01), device="cpu", **kwargs)
    for m in (jm, tm):
        m._prepare_networks(N)
        m.set_dataset(_Catalog(N))
    assert jm._use_streaming_head() and tm._use_streaming_head()
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(20):
        ids = rng.integers(0, N, size=(B, L, 1)).astype(np.int32)
        lengths = rng.integers(1, L + 1, size=B).astype(np.int32)
        valid = np.arange(L)[None, :] < lengths[:, None]
        batches.append({
            "ids": ids, "lengths": lengths, "t_count": np.ones(B, np.float32),
            "target_ids": rng.integers(0, N, size=(B, 1)).astype(np.int32),
            "seen_ids": np.where(valid, ids[:, :, 0], N).astype(np.int32),
        })
    _start_both(jm, tm)
    _train_both(jm, tm, batches)


@pytest.mark.parametrize(
    "cls_pair,flags",
    [((JaxRNNMargin, RNNMargin), dict(loss_function="hinge")),
     ((JaxRNNSampling, RNNSampling), dict(loss_function="Blackout", sampling=12))],
    ids=["margin-n-targets", "sampling-noise"],
)
def test_slow_path_batches_equal_jax(synthetic_dataset, cls_pair, flags):
    """The per-sequence batcher (sequence noise, several targets) gives the
    same batches, samples and default targets included."""
    from seqrec_tpu.data.noise import SequenceNoise as JaxNoise
    from seqrec_tpu.data.targets import SelectTargets as JaxTargets
    from seqrec_tpu_torch.data.noise import SequenceNoise
    from seqrec_tpu_torch.data.targets import SelectTargets

    jm, tm = _pair(synthetic_dataset, *cls_pair, **flags)
    for m, noise, targets in ((jm, JaxNoise, JaxTargets), (tm, SequenceNoise, SelectTargets)):
        m.sequence_noise = noise(dropout=0.2, rng=np.random.default_rng(13))
        m.target_selection = targets(n_targets=3, rng=np.random.default_rng(29))
        m.set_dataset(m.dataset)
        m._init_params()
    want = jm._gen_mini_batch(jm.sequence_noise(jm.dataset.training_set()))
    got = tm._gen_mini_batch(tm.sequence_noise(tm.dataset.training_set()))
    for _ in range(5):
        _assert_same_batches(next(want), next(got))


# ----------------------------------------------------------------------
# lazy updates
# ----------------------------------------------------------------------
@pytest.mark.parametrize(
    "cls_pair,kwargs",
    [((JaxRNNOneHot, RNNOneHot), dict(diversity_bias=0.3)),
     ((JaxRNNSampling, RNNSampling), dict(loss_function="BPR", sampling=20)),
     ((JaxRNNMargin, RNNMargin), dict(loss_function="hinge"))],
    ids=["cce-input-table", "bpr-head", "hinge-input-table"],
)
def test_lazy_updates_twenty_steps_match_jax(synthetic_dataset, cls_pair, kwargs):
    """The input table's rows (CCE, margin) or the sampled head's columns
    and bias entries (BPR) on the lazy Adam, the rest on dense Adam."""
    jm, tm, _ = _twenty_steps(synthetic_dataset, *cls_pair, lazy_updates=True, **kwargs)
    lazy = [".".join(sp["spec"]["path"]) for sp in tm.opt_state["lazy"]]
    assert lazy == (["W_out", "b_out"] if cls_pair[1] is RNNSampling else ["tower.layer0_fwd.W_in"])


N_ITEMS = 8


def _lazy_model(lazy, cls=RNNOneHot, updater=None, **kwargs):
    model = cls(recurrent_layer=kwargs.pop("recurrent_layer", RecurrentLayers("GRU", [6])),
                updater=updater or Adam(0.01), max_length=4, batch_size=4, seed=0, lazy_updates=lazy,
                device="cpu", **kwargs)
    model._prepare_networks(N_ITEMS)
    model.params_from_numpy(model._init_params())
    return model


def _batch(ids, **extra):
    ids = np.asarray(ids, dtype=np.int32)
    B, L = ids.shape
    return {"ids": ids[..., None], "mask": np.ones((B, L), np.float32),
            "targets": np.arange(B, dtype=np.int32) % N_ITEMS, "target_pop": np.ones(B, np.float32), **extra}


def test_lazy_freezes_untouched_rows_where_dense_adam_moves_them():
    """TF LazyAdam: rows no batch names keep their value and moments, while
    dense Adam moves them on decayed momentum."""
    touch_all = _batch(np.arange(N_ITEMS).reshape(4, 2).repeat(2, axis=1))
    only01 = _batch(np.array([[0, 1, 0, 1]] * 4))
    moved = {}
    for lazy in (True, False):
        model = _lazy_model(lazy)
        model.train_function(touch_all)
        first = model.net.tower.layer0_fwd["W_in"].detach().clone()
        for _ in range(3):
            model.train_function(only01)
        after = model.net.tower.layer0_fwd["W_in"].detach()
        assert (after[:2] - first[:2]).abs().max() > 0
        moved[lazy] = (after[2:] - first[2:]).abs().max().item()
    assert moved[True] == 0.0 and moved[False] > 0


def test_lazy_sampled_head_freezes_unsampled_columns_and_drops_padded_ids():
    model = _lazy_model(True, RNNSampling, loss_function="BPR", sampling=2)
    w0 = model.net.W_out.detach().clone()
    batch = _batch(np.random.default_rng(1).integers(0, N_ITEMS, size=(4, 4)),
                   targets=np.array([0, 1, 0, 1], np.int32), samples=np.array([2, 3], np.int32))
    for _ in range(2):
        model.train_function(dict(batch))
    w = model.net.W_out.detach()
    assert torch.equal(w[:, 4:], w0[:, 4:]) and (w[:, :4] - w0[:, :4]).abs().max() > 0
    # the input table stays on dense Adam
    assert [".".join(e["spec"]["path"]) for e in model.opt_state["lazy"]] == ["W_out", "b_out"]
    assert len(model.opt_state["inner"]["mu"]) == len(list(model.net.parameters())) - 2

    # padded slots (id -1) touch nothing
    entry = model.opt_state["lazy"][0]
    before = [t.clone() for t in (model.net.W_out.detach(), entry["m"], entry["v"])]
    model._lazy_adam_update(model.net.W_out, entry, torch.ones_like(model.net.W_out), torch.tensor([-1, 5, -1, 5]), 1)
    for t, t0 in zip((model.net.W_out.detach(), entry["m"], entry["v"]), before):
        changed = (t - t0).abs().amax(dim=0) > 0
        assert changed.tolist() == [c == 5 for c in range(N_ITEMS)]


def test_lazy_matches_dense_when_every_row_is_touched():
    full = np.arange(N_ITEMS).reshape(4, 2)
    batch = _batch(np.concatenate([full, full[:, ::-1]], axis=1))
    dense, lazy = _lazy_model(False), _lazy_model(True)
    for _ in range(4):
        np.testing.assert_allclose(float(lazy.train_function(batch)), float(dense.train_function(batch)), rtol=1e-6)
    for key, want in _leaves(dense.params_to_numpy()):
        np.testing.assert_allclose(dict(_leaves(lazy.params_to_numpy()))[key], want, rtol=2e-5, atol=1e-6,
                                   err_msg=key)


@pytest.mark.parametrize(
    "updater,tower,match",
    [(RMSProp(0.01), RecurrentLayers("GRU", [6]), "adam"),
     (None, RecurrentLayers("GRU", [6], bidirectional=True), "bidirectional")],
    ids=["rmsprop", "bidirectional"],
)
def test_lazy_refuses_non_adam_and_bidirectional_towers(updater, tower, match):
    model = _lazy_model(True, updater=updater, recurrent_layer=tower)
    with pytest.raises(ValueError, match=match):
        model.train_function(_batch(np.zeros((4, 4))))


def test_lazy_embedding_of_a_bidirectional_tower():
    """--r_emb puts the lazy Adam on the embedding table, which a
    bidirectional tower shares."""
    model = _lazy_model(True, recurrent_layer=RecurrentLayers("GRU", [6], bidirectional=True, embedding_size=5))
    table0 = model.net.tower.embedding.detach().clone()
    model.train_function(_batch(np.array([[0, 1, 0, 1]] * 4)))
    assert [".".join(e["spec"]["path"]) for e in model.opt_state["lazy"]] == ["tower.embedding"]
    moved = (model.net.tower.embedding.detach() - table0).abs().amax(dim=1) > 0
    assert moved.tolist() == [True, True] + [False] * (N_ITEMS - 2)


# ----------------------------------------------------------------------
# the CLIs
# ----------------------------------------------------------------------
@pytest.mark.parametrize(
    "flags",
    [["--loss", "BPR", "--sampling", "20"], ["--loss", "hinge"],
     ["--loss", "Blackout", "--sampling", "16", "--lazy_updates"]],
    ids=["bpr", "hinge", "blackout-lazy"],
)
def test_train_cli_checkpoints_of_the_new_heads_read_by_jax(tmp_path, capsys, flags):
    d = make_dataset(str(tmp_path / "ds"), n_users=120, n_items=60, min_len=8, max_len=24, seed=3)
    base = ["-m", "RNN", "--r_l", "16", "--max_length", "10", "-b", "8", *flags]
    torch_train_cli.main(["-d", d, *base, "--max_iter", "20", "--progress", "20", "--save", "All",
                          "--dir", "port/", "--device", "cpu"])
    names = os.listdir(os.path.join(d, "models", "port"))
    assert len(names) == 1 and names[0].startswith("rnn_sampling_" if "--sampling" in flags else "rnn_multitarget_")
    capsys.readouterr()
    test_argv = ["-d", d, *base, "--dir", "port/"]
    jax_test_cli.main(test_argv)
    want = [line for line in capsys.readouterr().out.splitlines() if "@10:" in line]
    torch_test_cli.main(test_argv + ["--device", "cpu"])
    got = [line for line in capsys.readouterr().out.splitlines() if "@10:" in line]
    assert len(want) == 5 and got == want


@pytest.mark.parametrize(
    "flags",
    [["--loss", "TOP1", "--sampling", "0.5", "--sampling_bias", "0.5", "--db", "0.2"],
     ["--loss", "logit", "--pb", "--min_access", "0.1", "--balance", "2", "--lazy_updates"]],
)
def test_predictor_of_the_new_heads_matches_jax(flags):
    argv = ["-m", "RNN", *flags]
    jax_model = jax_parse.get_predictor(jax_parse.command_parser(jax_parse.predictor_command_parser, argv=argv))
    args = parse.command_parser(parse.predictor_command_parser, argv=argv)
    args.device = "cpu"
    model = parse.get_predictor(args)
    assert type(model).__name__ == type(jax_model).__name__
    assert model._get_model_filename(3) == jax_model._get_model_filename(3)
