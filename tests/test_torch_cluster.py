"""The port's cluster models (RNNCluster, FISMCluster) against the JAX
package on the CPU: the cluster losses against ``jax.vjp`` of the JAX
functions, initial parameters, memberships, batches (samples, cluster
samples, scale, noise seed) equal to the JAX package's for one seed, 20
training steps of each model from the same parameters, the gradient
partition of the two objectives, the temperature schedule, the validation
metrics (ties at 0 of a cluster with fewer than 10 items included), the
selection noise's statistics, the refusals, and the test CLIs on one
checkpoint. Small sizes throughout (GRU and LSTM towers of width 16 at
L=10, FISM at H=8).

Tolerances: the losses rtol 1e-6 (the same f32 expressions; atol 1e-7
times the largest entry); costs rtol 1e-5; parameters after 20 Adam steps
rtol 1e-4 with atol 5e-5; ASSR rtol 1e-5 (a float sum of used-item counts
in another order); the other metrics exactly. The linear loss ("lin") is
held to JAX's by the loss test alone: unbounded below, its training cost
crosses 0, where a relative tolerance on the cost says nothing.
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
from seqrec_tpu.models.cluster import FISMCluster as JaxFISMCluster
from seqrec_tpu.models.cluster import RNNCluster as JaxRNNCluster
from seqrec_tpu.models.recurrent import RecurrentLayers as JaxRecurrentLayers
from seqrec_tpu.models.updates import Adam as JaxAdam
from seqrec_tpu.ops import losses as jax_losses
from seqrec_tpu_torch.data import DataHandler
from seqrec_tpu_torch.data.synthetic import make_dataset
from seqrec_tpu_torch.models.cluster import FISMCluster, RNNCluster
from seqrec_tpu_torch.models.recurrent import RecurrentLayers
from seqrec_tpu_torch.models.updates import Adam
from seqrec_tpu_torch.ops import losses


def _close(got, want, rtol, atol_rel=0.0, err_msg=""):
    want = np.asarray(want)
    atol = atol_rel * float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol, atol=atol, err_msg=err_msg)


# ----------------------------------------------------------------------
# the losses
# ----------------------------------------------------------------------
def test_cluster_loss_set_matches_jax():
    assert list(losses.CLUSTER_LOSSES) == list(jax_losses.CLUSTER_LOSSES)


@pytest.mark.parametrize("name", list(jax_losses.CLUSTER_LOSSES))
def test_cluster_loss_values_and_gradients_match_jax(name):
    rng = np.random.default_rng(2)
    B = 8
    x = rng.normal(0, 2, size=(B, B + 24)).astype(np.float32)
    x[0, B] = x[0, 0] - 0.5  # BPRelu's kink: leaky_relu at exactly 0
    g = rng.normal(size=B).astype(np.float32)
    want, pull = jax.vjp(lambda s: jax_losses.CLUSTER_LOSSES[name](s, B), jnp.asarray(x))
    (want_g,) = pull(jnp.asarray(g))
    t = torch.tensor(x, requires_grad=True)
    got = losses.CLUSTER_LOSSES[name](t, B)
    (got_g,) = torch.autograd.grad(got, t, torch.from_numpy(g))
    _close(got.detach(), want, rtol=1e-6, atol_rel=1e-7, err_msg="value")
    _close(got_g, want_g, rtol=1e-6, atol_rel=1e-7, err_msg="gradient")


# ----------------------------------------------------------------------
# models from one seed in both packages
# ----------------------------------------------------------------------
def _pair(dataset_dir, fism=False, cell="GRU", **kwargs):
    kwargs = dict(batch_size=8, seed=4, n_clusters=4, sampling=16, **kwargs)
    if fism:
        kwargs = dict(h=8, alpha=0.3, **kwargs)
        jm = JaxFISMCluster(updater=JaxAdam(0.01), **kwargs)
        tm = FISMCluster(updater=Adam(0.01), device="cpu", **kwargs)
    else:
        kwargs = dict(max_length=10, **kwargs)
        jm = JaxRNNCluster(recurrent_layer=JaxRecurrentLayers(cell, [16]), updater=JaxAdam(0.01), **kwargs)
        tm = RNNCluster(recurrent_layer=RecurrentLayers(cell, [16]), updater=Adam(0.01), device="cpu", **kwargs)
    for model, handler in ((jm, JaxDataHandler(dataset_dir)), (tm, DataHandler(dataset_dir))):
        model.prepare_model(handler)
        model.set_dataset(handler)
    return jm, tm


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + "/")
        else:
            yield prefix + k, v


def _start_both(jm, tm):
    """The same initial parameters in both packages, each drawn from its
    own generator (which the batches then continue)."""
    tree, jax_tree = tm._init_params(), jm._init_params()
    got = dict(_leaves(tree))
    assert got.keys() == dict(_leaves(jax_tree)).keys()
    for key, want in _leaves(jax_tree):
        np.testing.assert_array_equal(got[key], want, err_msg=key)
    tm.params_from_numpy(copy.deepcopy(tree))
    jm.params = jax.tree_util.tree_map(jnp.asarray, tree)
    jm._build_functions()
    jm.opt_state = jm._opt.init(jm.params)
    return tree


def _assert_same_batches(want, got):
    assert want.keys() == got.keys()
    for key in want:
        assert np.asarray(want[key]).dtype == np.asarray(got[key]).dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def _batches(jm, tm, n=20):
    """n batches of each package's batcher (the packed one with generator
    seed 4 + 77 where it applies, else the per-sequence one), checked
    equal."""
    if tm._fast_batching_ok():
        assert jm._fast_batching_ok()
        want = jm._gen_packed_mini_batch(jm.dataset.training_set, np.random.default_rng(4 + 77))
        got = tm._gen_packed_mini_batch(tm.dataset.training_set, np.random.default_rng(4 + 77))
    else:
        assert not jm._fast_batching_ok()
        want = jm._gen_mini_batch(jm.sequence_noise(jm.dataset.training_set()))
        got = tm._gen_mini_batch(tm.sequence_noise(tm.dataset.training_set()))
    batches = []
    for _ in range(n):
        a, b = next(want), next(got)
        _assert_same_batches(a, b)
        batches.append(b)
    return batches


def _assert_same_params(got, want, prefix=""):
    assert got.keys() == want.keys()
    for key in want:
        if isinstance(want[key], dict):
            _assert_same_params(got[key], want[key], prefix + key + "/")
        else:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=5e-5, err_msg=prefix + key)


def _train_both(jm, tm, batches):
    want = [float(jm.train_function(dict(b))) for b in batches]
    got = [float(tm.train_function(dict(b))) for b in batches]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    _assert_same_params(tm.params_to_numpy(), jax.tree_util.tree_map(np.asarray, jm.params))
    return got


def _metrics(model):
    return model._compute_validation_metrics({m: [] for m in model.metrics})


def _assert_same_metrics(got, want):
    assert got.keys() == want.keys()
    for key in want:
        (w,), (g,) = want[key], got[key]
        if key == "assr":
            np.testing.assert_allclose(g, w, rtol=1e-5)
        else:
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=key)


@pytest.mark.parametrize("fism", [False, True], ids=["rnn", "fism"])
def test_initial_params_match_jax(synthetic_dataset, fism):
    jm, tm = _pair(synthetic_dataset, fism=fism)
    tree = _start_both(jm, tm)
    assert set(tree) >= {"W_out", "b_out", "W_cs", "cluster_repartition"}
    _assert_same_params(tm.params_to_numpy(), tree)


@pytest.mark.parametrize("cluster_type", ["softmax", "mix", "sigmoid"])
def test_membership_and_hard_clusters_match_jax(synthetic_dataset, cluster_type):
    jm, tm = _pair(synthetic_dataset, cluster_type=cluster_type)
    rng = np.random.default_rng(5)
    logits = (0.1 * rng.standard_normal((12, 4))).astype(np.float32)
    for scale in (1.0, 7.5):
        _close(tm._membership(torch.from_numpy(logits), scale), jm._membership(jnp.asarray(logits), scale),
               rtol=1e-6, atol_rel=1e-7)
    _close(tm._hard_clusters(torch.from_numpy(logits)), jm._hard_clusters(jnp.asarray(logits)),
           rtol=1e-5, atol_rel=1e-6)


@pytest.mark.parametrize(
    "kwargs",
    [dict(), dict(cluster_sampling=12), dict(sampling_bias=0.5), dict(sampling_bias=0.5, cluster_sampling=12)],
    ids=["uniform", "uniform-cs", "bias", "bias-cs"],
)
def test_fast_batches_equal_jax(synthetic_dataset, kwargs):
    """Targets, samples, cluster samples (drawn, or the samples again), the
    scale and the noise seed of the packed batcher."""
    jm, tm = _pair(synthetic_dataset, **kwargs)
    _start_both(jm, tm)
    batches = _batches(jm, tm, n=5)
    assert [int(b["noise_seed"]) for b in batches] == [1, 2, 3, 4, 5]
    if "cluster_sampling" in kwargs:
        assert batches[0]["cluster_samples"].shape == (12,)
    else:
        assert batches[0]["cluster_samples"] is batches[0]["samples"]


# ----------------------------------------------------------------------
# twenty training steps, then the validation metrics
# ----------------------------------------------------------------------
@pytest.mark.parametrize(
    "kwargs",
    [dict(cluster_type="mix"), dict(cluster_type="softmax", loss="BPR", cluster_sampling=12),
     dict(cluster_type="sigmoid", loss="BPRelu", sampling_bias=0.5),
     dict(cell="LSTM", loss="CCE"), dict(lazy_updates=True, loss="TOP1", cluster_type="softmax")],
    ids=["gru-mix", "gru-softmax", "gru-sigmoid", "lstm", "lazy"],
)
def test_rnn_cluster_twenty_steps_and_metrics_match_jax(synthetic_dataset, kwargs):
    jm, tm = _pair(synthetic_dataset, **kwargs)
    _start_both(jm, tm)
    _train_both(jm, tm, _batches(jm, tm))
    if kwargs.get("lazy_updates"):
        assert [".".join(e["spec"]["path"]) for e in tm.opt_state["lazy"]] == ["tower.layer0_fwd.W_in"]
    _assert_same_metrics(_metrics(tm), _metrics(jm))


@pytest.mark.parametrize("reg", [0.01, -0.01], ids=["l2", "l1"])
def test_fism_cluster_twenty_steps_and_metrics_match_jax(synthetic_dataset, reg):
    """The per-sequence batcher (shuffled targets, the whole history as a
    bag); L1 with JAX's derivative of |x| at 0 on b_out, which starts at 0."""
    jm, tm = _pair(synthetic_dataset, fism=True, reg=reg)
    assert tm._get_model_filename(1) == jm._get_model_filename(1)
    _start_both(jm, tm)
    _train_both(jm, tm, _batches(jm, tm))
    _assert_same_metrics(_metrics(tm), _metrics(jm))


def test_cluster_eval_ties_at_zero_match_jax(synthetic_dataset):
    """A cluster of 5 items holds every user: the restricted top-10 fills
    with items at exactly 0 (outside the cluster or seen), by id ascending
    as lax.top_k orders them."""
    jm, tm = _pair(synthetic_dataset, cluster_type="mix")
    tree = _start_both(jm, tm)
    n = tree["cluster_repartition"].shape[0]
    rep = np.full((n, 4), -5.0, dtype=np.float32)
    rep[:5, 0] = 5.0
    rep[5:, 1 + np.arange(n - 5) % 3] = 5.0
    tree["W_cs"][:] = 0.0  # argmax of a zero row: cluster 0 for everyone
    tree["cluster_repartition"] = rep
    tm.params_from_numpy(copy.deepcopy(tree))
    jm.params = jax.tree_util.tree_map(jnp.asarray, tree)
    instances = list(tm._iter_test_instances(tm.dataset.validation_set(epochs=1)))
    seqs = [s for s, _, _ in instances]
    ids, id_mask, mask = tm._encode_sequences(seqs)
    S = max(len(s) for s in seqs)
    seen = np.zeros((len(seqs), S), np.int32)
    seen_mask = np.zeros((len(seqs), S), np.float32)
    for row, s in enumerate(seqs):
        seen[row, : len(s)] = [int(i[0]) for i in s]
        seen_mask[row, : len(s)] = 1.0
    want = jax.jit(jm._cluster_eval_topk)(jm.params, ids, id_mask, mask, seen, seen_mask)
    assert id_mask is None
    got = tm._cluster_eval_topk(torch.from_numpy(ids), None, *map(torch.from_numpy, (mask, seen, seen_mask)))
    for a, b, name in zip(got, want, ("top1", "top2", "c_sel", "used")):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    # after the cluster's items (unseen by score, then seen at 0), items 5-9 at 0 by id
    assert (got[3] == 5).all() and (got[1][:, 5:] == torch.arange(5, 10)).all()
    metrics = _metrics(tm)
    _assert_same_metrics(metrics, _metrics(jm))
    assert metrics["assr"][0] == n / 5


# ----------------------------------------------------------------------
# the gradient partition, the temperature schedule, the selection noise
# ----------------------------------------------------------------------
def test_each_objective_leaves_the_other_parameters_without_gradient(synthetic_dataset):
    jm, tm = _pair(synthetic_dataset, cluster_selection_noise=0.5)
    _start_both(jm, tm)
    batch = tm._device_batch(_batches(jm, tm, n=1)[0])
    cost, cost_clusters = tm._objectives(batch)
    names = [name for name, _ in tm.net.named_parameters()]
    params = list(tm.net.parameters())
    cluster_params = {"W_cs", "cluster_repartition"}
    for objective, moves in ((cost, lambda n: n not in cluster_params), (cost_clusters, lambda n: n in cluster_params)):
        grads = torch.autograd.grad(objective, params, allow_unused=True)
        for name, g in zip(names, grads):
            if moves(name):
                assert g is not None and g.abs().max() > 0, name
            else:
                assert g is None or not g.any(), name


def test_temperature_schedule_matches_jax(synthetic_dataset):
    """x2 at each epoch boundary, clamped at 5: 1, 2, 4, 5, 5 over the first
    five epochs, at the same batches as the JAX package."""
    jm, tm = _pair(synthetic_dataset, init_scale=1.0, scale_growing_rate=2.0, max_scale=5.0)
    want = jm._gen_packed_mini_batch(jm.dataset.training_set, np.random.default_rng(81))
    got = tm._gen_packed_mini_batch(tm.dataset.training_set, np.random.default_rng(81))
    scales, epochs = [], []
    while tm.dataset.training_set.epochs < 5:
        a, b = next(want), next(got)
        assert a["scale"] == b["scale"]
        scales.append(float(b["scale"]))
        epochs.append(int(tm.dataset.training_set.epochs))
    assert tm._get_model_filename(1) == jm._get_model_filename(1)
    for epoch, scale in zip(epochs, scales):
        assert scale == min(5.0, 2.0**epoch)


def test_selection_noise_draws(synthetic_dataset):
    """--csn 0.5: the same seed draws the same noise, the next step's seed
    another; standard normal draws (mean within 0.05 of 0 and std within
    0.05 of 1 over 64,000 values). The cost differs from the noiseless one."""
    jm, tm = _pair(synthetic_dataset, cluster_selection_noise=0.5)
    _start_both(jm, tm)
    like = torch.zeros((1000, 64))
    a, b = RNNCluster._selection_noise(7, like), RNNCluster._selection_noise(7, like)
    c = RNNCluster._selection_noise(8, like)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert abs(float(a.mean())) < 0.05 and abs(float(a.std()) - 1.0) < 0.05
    batches = _batches(jm, tm, n=2)
    costs = [float(tm._loss(tm._device_batch(dict(batches[0]))).detach()) for _ in range(2)]
    assert costs[0] == costs[1]
    tm.cluster_selection_noise = 0.0
    assert float(tm._loss(tm._device_batch(dict(batches[0]))).detach()) != costs[0]


# ----------------------------------------------------------------------
# refusals and the CLIs
# ----------------------------------------------------------------------
def test_lazy_updates_refused_on_fism_as_in_jax(synthetic_dataset):
    jm, tm = _pair(synthetic_dataset, fism=True, lazy_updates=True)
    with pytest.raises(ValueError, match="no recurrent-tower input table"):
        jm._build_functions()
    with pytest.raises(ValueError, match="no recurrent-tower input table"):
        tm.params_from_numpy(tm._init_params())
        tm._init_opt_state()


def test_fism_without_clusters_is_not_ported():
    """Without --clusters, -m FISM is the factorization model, not
    FISMCluster: with the default --loss (CCE) it raises as the JAX
    package's does, with --loss BPR it is built."""
    args = parse.command_parser(parse.predictor_command_parser, argv=["-m", "FISM"])
    args.device = "cpu"
    with pytest.raises(ValueError, match="Unknown loss for FISM"):
        parse.get_predictor(args)
    args = parse.command_parser(parse.predictor_command_parser, argv=["-m", "FISM", "--loss", "BPR"])
    args.device = "cpu"
    model = parse.get_predictor(args)
    assert type(model).__name__ == "FISM" and type(model).__module__.endswith("factorization")


@pytest.mark.parametrize(
    "argv",
    [["-m", "RNN", "--clusters", "10", "--loss", "Blackout", "--sampling", "256", "--c_sampling", "256"],
     ["-m", "RNN", "--clusters", "4", "--loss", "TOP1", "--sampling_bias", "0.5", "--csn", "0.1",
      "--cluster_type", "softmax", "--init_scale", "2", "--scale_growing_rate", "1.5", "--lazy_updates"],
     ["-m", "FISM", "--clusters", "10", "-H", "50", "--fism_alpha", "0.2", "--loss", "Blackout", "-r", "-0.001",
      "--cluster_type", "sigmoid"]],
    ids=["rnn", "rnn-options", "fism"],
)
def test_predictor_matches_jax(argv):
    jax_model = jax_parse.get_predictor(jax_parse.command_parser(jax_parse.predictor_command_parser, argv=argv))
    args = parse.command_parser(parse.predictor_command_parser, argv=argv)
    args.device = "cpu"
    model = parse.get_predictor(args)
    assert type(model).__name__ == type(jax_model).__name__
    assert model._get_model_filename(3) == jax_model._get_model_filename(3)
    for attr in ("n_clusters", "n_samples", "n_cluster_samples", "cluster_selection_noise", "max_length"):
        assert getattr(model, attr) == getattr(jax_model, attr), attr


@pytest.mark.parametrize(
    "flags,test_flags",
    [(["-m", "RNN", "--r_l", "16", "--max_length", "10"], []),
     (["-m", "RNN", "--r_l", "16", "--max_length", "10"], ["--ignore_clusters"]),
     (["-m", "FISM", "-H", "8", "--fism_alpha", "0.3", "-r", "0.001"], [])],
    ids=["rnn", "rnn-ignore-clusters", "fism"],
)
def test_train_cli_checkpoint_and_test_clis_match_jax(tmp_path, capsys, flags, test_flags):
    """The port's train CLI writes a JAX-named checkpoint with the JAX keys;
    the JAX test CLI and the port's print the same metrics on it."""
    d = make_dataset(str(tmp_path / "ds"), n_users=120, n_items=60, min_len=8, max_len=24, seed=3)
    base = [*flags, "--clusters", "4", "--loss", "Blackout", "--sampling", "16", "-b", "8"]
    torch_train_cli.main(["-d", d, *base, "--max_iter", "20", "--progress", "20", "--save", "All",
                          "--dir", "port/", "--device", "cpu"])
    names = os.listdir(os.path.join(d, "models", "port"))
    assert len(names) == 1 and names[0].startswith(flags[1].lower() + "_clusters4_")
    with np.load(os.path.join(d, "models", "port", names[0])) as archive:
        assert {"params/W_cs", "params/cluster_repartition", "params/W_out", "params/b_out"} <= set(archive.files)
    capsys.readouterr()
    test_argv = ["-d", d, *base, *test_flags, "--dir", "port/", "--metrics", "sps,recall,item_coverage,assr"]
    jax_test_cli.main(test_argv)
    want = [line for line in capsys.readouterr().out.splitlines() if "@10:" in line]
    torch_test_cli.main(test_argv + ["--device", "cpu"])
    got = [line for line in capsys.readouterr().out.splitlines() if "@10:" in line]
    assert len(want) == 4 and got == want
