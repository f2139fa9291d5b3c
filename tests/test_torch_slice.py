"""The port's serving slice against the JAX package on one dataset: the same
seed gives the same parameters, a JAX checkpoint loads in the port and
gives the same logits and the same test-CLI metrics, and the port's own
synthetic dataset reads the same through both packages' DataHandler.
An LSTM checkpoint round-trips between the packages and gives the same
metrics. Everything runs on the CPU (GRU-16 and small LSTM towers,
max_length 10).
"""

import ml_dtypes
import numpy as np
import pytest
import torch

import seqrec_tpu.cli.test as jax_test_cli
import seqrec_tpu.utils.command_parser as jax_parse
import seqrec_tpu_torch.cli.test as torch_test_cli
from seqrec_tpu.data import DataHandler as JaxDataHandler
from seqrec_tpu.data.synthetic import generate_interactions as jax_generate_interactions
from seqrec_tpu.models.base import pytree_save as jax_pytree_save
from seqrec_tpu.models.recurrent import RecurrentLayers as JaxRecurrentLayers
from seqrec_tpu.models.rnn_one_hot import RNNOneHot as JaxRNNOneHot
from seqrec_tpu_torch.data import DataHandler
from seqrec_tpu_torch.data.synthetic import generate_interactions, make_dataset
from seqrec_tpu_torch.models.base import pytree_load
from seqrec_tpu_torch.models.recurrent import RecurrentLayers
from seqrec_tpu_torch.models.rnn_one_hot import RNNOneHot

CLI_ARGS = ["-m", "RNN", "--loss", "CCE", "--r_t", "GRU", "--r_l", "16", "--max_length", "10", "-b", "8"]


def _models(dataset_dir, seed=3, layers=(16,), cell="GRU", bidirectional=False):
    tower = (cell, list(layers), bidirectional)
    jax_model = JaxRNNOneHot(recurrent_layer=JaxRecurrentLayers(*tower), max_length=10, seed=seed)
    model = RNNOneHot(recurrent_layer=RecurrentLayers(*tower), max_length=10, seed=seed, device="cpu")
    jax_model.prepare_model(JaxDataHandler(dataset_dir))
    model.prepare_model(DataHandler(dataset_dir))
    return jax_model, model


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + "/")
        else:
            yield prefix + k, v


@pytest.mark.parametrize("seed,layers", [(3, (16,)), (11, (8, 16))])
def test_init_params_bit_identical_to_jax(synthetic_dataset, seed, layers):
    jax_model, model = _models(synthetic_dataset, seed, layers)
    want, got = dict(_leaves(jax_model._init_params())), dict(_leaves(model._init_params()))
    assert want.keys() == got.keys()
    for key in want:
        assert want[key].dtype == got[key].dtype
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_params_from_numpy_gives_jax_logits(synthetic_dataset):
    import jax
    import jax.numpy as jnp

    jax_model, model = _models(synthetic_dataset)
    params = jax.tree_util.tree_map(jnp.asarray, jax_model._init_params())
    model.params_from_numpy(jax.tree_util.tree_map(np.asarray, params), "cpu")
    dataset = DataHandler(synthetic_dataset)
    seqs = [seq for seq, _, _ in model._iter_test_instances(dataset.test_set(epochs=1))]
    ids, id_mask, mask = model._encode_sequences(seqs)
    want = np.asarray(jax_model._logits(params, jnp.asarray(ids), None, jnp.asarray(mask), fast=True))
    with torch.inference_mode():
        got = model._logits(torch.from_numpy(ids), None, torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_jax_checkpoint_loads_in_port(synthetic_dataset, tmp_path):
    jax_model, model = _models(synthetic_dataset)
    tree = jax_model._init_params()
    path = str(tmp_path / "ckpt.npz")
    # an extension-dtype leaf (bf16 Adam moments) is stored as a uint view and
    # read back as a torch bf16 tensor (an opt leaf the model's optimizer
    # does not hold is refused by load, as by the JAX package's)
    moments = np.linspace(-1, 1, 6, dtype=np.float32).astype(ml_dtypes.bfloat16)
    jax_pytree_save(str(tmp_path / "moments.npz"), {"params": tree, "opt": {"0": moments}})
    loaded = pytree_load(str(tmp_path / "moments.npz"))["opt"]["0"]
    assert loaded.dtype == torch.bfloat16
    np.testing.assert_array_equal(loaded.float().numpy(), moments.astype(np.float32))
    jax_pytree_save(path, {"params": tree})
    model.load(path)
    state = model.net.state_dict()
    leaves = dict(_leaves(tree))
    assert set(state) == {key.replace("/", ".") for key in leaves}
    for key, arr in leaves.items():
        np.testing.assert_array_equal(state[key.replace("/", ".")].numpy(), arr)

    # per-user recommendations (softmax scores path) agree too
    jax_model.params = tree
    jax_model._build_functions()
    jax_model.set_dataset(JaxDataHandler(synthetic_dataset))
    for seq, _ in list(DataHandler(synthetic_dataset).test_set(epochs=1))[:3]:
        assert [int(i) for i in model.top_k_recommendations(seq, k=10)] == [
            int(i) for i in jax_model.top_k_recommendations(seq, k=10)
        ]


def test_lstm_checkpoint_round_trips_between_the_packages(synthetic_dataset, tmp_path):
    """A bidirectional LSTM's tree (c0 and the peepholes included) goes
    from a JAX checkpoint into the port and back through the port's save
    unchanged, and params_from_numpy gives the JAX package's logits."""
    import jax
    import jax.numpy as jnp

    from seqrec_tpu.models.base import pytree_load as jax_pytree_load

    jax_model, model = _models(synthetic_dataset, seed=4, layers=(8, 12), cell="LSTM", bidirectional=True)
    tree = jax_model._init_params()
    leaves = dict(_leaves(tree))
    assert {"tower/layer1_bwd/c0", "tower/layer1_bwd/w_ci", "tower/layer0_fwd/w_co"} <= leaves.keys()
    path = str(tmp_path / "jax.npz")
    jax_pytree_save(path, {"params": tree})
    model.load(path)
    back = str(tmp_path / "port.npz")
    model.save(back)
    for got in (dict(_leaves(model.params_to_numpy())), dict(_leaves(jax_pytree_load(back)["params"]))):
        assert got.keys() == leaves.keys()
        for key, arr in leaves.items():
            np.testing.assert_array_equal(got[key], arr, err_msg=key)

    params = jax.tree_util.tree_map(jnp.asarray, tree)
    model.params_from_numpy(jax.tree_util.tree_map(np.asarray, params), "cpu")
    seqs = [seq for seq, _, _ in model._iter_test_instances(DataHandler(synthetic_dataset).test_set(epochs=1))]
    ids, _, mask = model._encode_sequences(seqs)
    want = np.asarray(jax_model._logits(params, jnp.asarray(ids), None, jnp.asarray(mask), fast=True))
    with torch.inference_mode():
        got = model._logits(torch.from_numpy(ids), None, torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _cli_metric_lines_agree(synthetic_dataset, capsys, cli_args, sub):
    argv = ["-d", synthetic_dataset, *cli_args, "--dir", sub, "-i", "1"]
    args = jax_parse.command_parser(jax_parse.predictor_command_parser, jax_test_cli.test_command_parser, argv=argv)
    jax_model = jax_parse.get_predictor(args)
    jax_model.prepare_model(JaxDataHandler(synthetic_dataset))
    name = jax_model._get_model_filename(1)
    jax_pytree_save(synthetic_dataset + "models/" + sub + name, {"params": jax_model._init_params()})

    def metric_lines():
        return [line for line in capsys.readouterr().out.splitlines() if "@10:" in line]

    capsys.readouterr()
    jax_test_cli.main(argv)
    want = metric_lines()
    evaluator = torch_test_cli.main(argv + ["--device", "cpu"])
    got = metric_lines()
    assert len(want) == 5 and got == want
    assert len(evaluator.instances) == JaxDataHandler(synthetic_dataset).test_set.n_users


def test_test_cli_prints_jax_metrics_on_the_same_checkpoint(synthetic_dataset, capsys):
    _cli_metric_lines_agree(synthetic_dataset, capsys, CLI_ARGS, "torchparity/")


def test_test_cli_prints_jax_metrics_on_an_lstm_checkpoint(synthetic_dataset, capsys):
    """The LSTM path's serving at a small size: K6's plain version for the
    final state of a stacked LSTM tower."""
    lstm_args = ["-m", "RNN", "--loss", "CCE", "--r_t", "LSTM", "--r_l", "8-12", "--max_length", "10", "-b", "8"]
    _cli_metric_lines_agree(synthetic_dataset, capsys, lstm_args, "torchparity_lstm/")


def test_port_synthetic_generator_draws_the_jax_interactions():
    kwargs = dict(n_users=40, n_items=70, min_len=5, max_len=30, markov_strength=0.45, seed=9)
    np.testing.assert_array_equal(generate_interactions(**kwargs), jax_generate_interactions(**kwargs))


def test_port_synthetic_dataset_reads_the_same_in_both_packages(tmp_path):
    d = make_dataset(str(tmp_path / "ds"), n_users=90, n_items=50, min_len=6, max_len=20,
                     n_val_users=10, n_test_users=12, seed=4)
    ours, theirs = DataHandler(d), JaxDataHandler(d)
    for attr in ("n_users", "n_items", "n_interactions", "longest_sequence"):
        assert getattr(ours, attr) == getattr(theirs, attr)
    for split in ("training_set", "validation_set", "test_set"):
        a, b = getattr(ours, split), getattr(theirs, split)
        assert (a.n_users, a.n_items, a.n_interactions) == (b.n_users, b.n_items, b.n_interactions)
        assert list(a(epochs=1)) == list(b(epochs=1))
    np.testing.assert_array_equal(ours.item_popularity, theirs.item_popularity)
    assert (ours.validation_set.n_users, ours.test_set.n_users) == (10, 12)
    assert ours.item_popularity.sum() == ours.training_set.n_interactions


@pytest.mark.parametrize(
    "flags",
    [[], ["--rf"], ["--repeated_interactions"], ["--u_m", "adagrad", "--u_l", "0.1"],
     ["--r_bi", "--r_emb", "8", "--r_l", "32-16"], ["--n_dropout", "0.1", "--target_bias", "0.5"],
     ["--u_moments", "bfloat16", "--lazy_updates", "--db", "0.3", "-r", "0.01"],
     ["--r_t", "LSTM"], ["--r_t", "LSTM", "--r_bi", "--r_emb", "8", "--r_l", "32-16"],
     ["--r_t", "Vanilla", "--r_bi"],
     ["--loss", "BPR", "--sampling", "256"], ["--loss", "TOP1", "--sampling", "0.5", "--db", "0.2"],
     ["--loss", "Blackout", "--sampling_bias", "0.5", "--lazy_updates"],
     ["--loss", "hinge"], ["--loss", "logit", "--balance", "2"],
     ["--loss", "logsig", "--pb", "--min_access", "0.1", "--lazy_updates"]],
)
def test_model_filename_matches_jax(flags):
    """The checkpoint lookup of the test CLI depends on the filename scheme."""
    import seqrec_tpu_torch.utils.command_parser as parse

    argv = ["-m", "RNN", "--loss", "CCE", *flags]
    jax_args = jax_parse.command_parser(jax_parse.predictor_command_parser, argv=argv)
    args = parse.command_parser(parse.predictor_command_parser, argv=argv)
    args.device = "cpu"
    want = jax_parse.get_predictor(jax_args)._get_model_filename(3.5)
    assert parse.get_predictor(args)._get_model_filename(3.5) == want
