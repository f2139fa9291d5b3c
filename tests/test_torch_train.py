"""The port's training slice against the JAX package on the CPU: the same
seed gives the same batches (exactly), the same train steps give the same
costs and parameters (dense head, and the streaming head at a 16,384-item
catalog), and the train CLI writes the checkpoint the JAX CLI would name,
which the JAX test CLI reads; a JAX checkpoint resumes in the port.
Under a mesh of two ranks, the models and flags of later mesh slices
raise, also beside --spd. Small sizes throughout (GRU and LSTM towers
of widths 6 to 16, L=10).

Tolerances: costs rtol 1e-5 (the same f32 math, summed in other orders);
parameters after 20 Adam steps at lr 0.01 rtol 1e-4 with atol 5e-5, half
a percent of one step: Adam divides by sqrt(nu), which magnifies the
rounding of tiny gradient entries (a few of the input table's rows).
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import seqrec_tpu.cli.test as jax_test_cli
import seqrec_tpu.cli.train as jax_train_cli
import seqrec_tpu.utils.command_parser as jax_parse
import seqrec_tpu_torch.cli.test as torch_test_cli
import seqrec_tpu_torch.cli.train as torch_train_cli
import seqrec_tpu_torch.utils.command_parser as parse
from seqrec_tpu.data import DataHandler as JaxDataHandler
from seqrec_tpu.models.recurrent import RecurrentLayers as JaxRecurrentLayers
from seqrec_tpu.models.rnn_one_hot import RNNOneHot as JaxRNNOneHot
from seqrec_tpu.models.updates import Adam as JaxAdam
from seqrec_tpu_torch.data import DataHandler
from seqrec_tpu_torch.data.synthetic import make_dataset
from seqrec_tpu_torch.models.base import pytree_load
from seqrec_tpu_torch.models.recurrent import RecurrentLayers
from seqrec_tpu_torch.models.rnn_one_hot import RNNOneHot
from seqrec_tpu_torch.models.updates import Adam

BASE = ["-m", "RNN", "--loss", "CCE", "--r_l", "16", "--max_length", "10", "-b", "8"]


def _predictors(dataset_dir, flags):
    argv = BASE + flags
    jax_args = jax_parse.command_parser(jax_parse.predictor_command_parser, argv=argv)
    args = parse.command_parser(parse.predictor_command_parser, argv=argv)
    args.device = "cpu"
    pair = []
    for model, handler in ((jax_parse.get_predictor(jax_args), JaxDataHandler(dataset_dir)),
                           (parse.get_predictor(args), DataHandler(dataset_dir))):
        model.prepare_model(handler)
        model.set_dataset(handler)
        pair.append((model, handler))
    return pair


@pytest.mark.parametrize("flags", [[], ["--rf"], ["--rf", "--db", "0.4"]])
def test_packed_batches_equal_jax(synthetic_dataset, flags):
    (jm, jh), (tm, th) = _predictors(synthetic_dataset, flags)
    assert jm._fast_batching_ok() and tm._fast_batching_ok()
    want = jm._gen_packed_mini_batch(jh.training_set, np.random.default_rng(77))
    got = tm._gen_packed_mini_batch(th.training_set, np.random.default_rng(77))
    for _ in range(12):  # past the first epoch of this dataset at B=8
        a, b = next(want), next(got)
        assert a.keys() == b.keys()
        for key in a:
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(b[key], a[key], err_msg=key)
        assert jh.training_set.epochs == th.training_set.epochs


@pytest.mark.parametrize("flags", [["--n_dropout", "0.2", "--target_bias", "0.5"], ["--n_swap", "0.3", "--rf"]])
def test_slow_batches_equal_jax(synthetic_dataset, flags):
    (jm, jh), (tm, th) = _predictors(synthetic_dataset, flags)
    assert not jm._fast_batching_ok() and not tm._fast_batching_ok()
    jm._init_params(), tm._init_params()  # train() draws the init from the same generator first
    want = jm._gen_mini_batch(jm.sequence_noise(jh.training_set()))
    got = tm._gen_mini_batch(tm.sequence_noise(th.training_set()))
    for _ in range(6):
        a, b = next(want), next(got)
        assert a.keys() == b.keys()
        for key in a:
            np.testing.assert_array_equal(b[key], a[key], err_msg=key)


def _train_both(jax_model, model, batches):
    """Same init, then one train_function step per batch in each package;
    returns (jax costs, port costs, jax params, port params)."""
    tree = jax_model._init_params()
    model.params_from_numpy(copy.deepcopy(tree))
    jax_model.params = jax.tree_util.tree_map(jnp.asarray, tree)
    jax_model._build_functions()
    jax_model.opt_state = jax_model._opt.init(jax_model.params)
    want, got = [], []
    for batch in batches:
        want.append(float(jax_model.train_function(dict(batch))))
        got.append(float(model.train_function(dict(batch))))
    return want, got, jax.tree_util.tree_map(np.asarray, jax_model.params), model.params_to_numpy()


def _assert_same_params(got, want, prefix=""):
    assert got.keys() == want.keys()
    for key in want:
        if isinstance(want[key], dict):
            _assert_same_params(got[key], want[key], prefix + key + "/")
        else:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=5e-5, err_msg=prefix + key)


def _twenty_dense_steps(dataset_dir, cell):
    kwargs = dict(max_length=10, batch_size=8, seed=4, regularization=0.01, diversity_bias=0.3)
    jm = JaxRNNOneHot(recurrent_layer=JaxRecurrentLayers(cell, [16]), updater=JaxAdam(0.01), **kwargs)
    tm = RNNOneHot(recurrent_layer=RecurrentLayers(cell, [16]), updater=Adam(0.01), device="cpu", **kwargs)
    handler = DataHandler(dataset_dir)
    jm.prepare_model(JaxDataHandler(dataset_dir))
    tm.prepare_model(handler)
    jm.set_dataset(JaxDataHandler(dataset_dir))
    tm.set_dataset(handler)
    gen = tm._gen_packed_mini_batch(handler.training_set, np.random.default_rng(4 + 77))
    batches = [next(gen) for _ in range(20)]
    want, got, jp, tp = _train_both(jm, tm, batches)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[-1] < got[0]
    _assert_same_params(tp, jp)


def test_twenty_steps_dense_head_match_jax(synthetic_dataset):
    """The flagship's layout, small: one GRU layer, the dense CCE head with
    a diversity bias, L2 on b_out, Adam."""
    _twenty_dense_steps(synthetic_dataset, "GRU")


def test_twenty_lstm_steps_dense_head_match_jax(synthetic_dataset):
    """The same with one LSTM layer (K5's plain version; c0 and the
    peepholes are trained)."""
    _twenty_dense_steps(synthetic_dataset, "LSTM")


class _Popularity:
    def __init__(self, n):
        self.item_popularity = np.arange(1, n + 1, dtype=np.float64)


def _twenty_streaming_steps(cell):
    N, Bq, Lq = 16384, 16, 10
    kwargs = dict(max_length=Lq, batch_size=Bq, seed=6, regularization=-0.001, diversity_bias=0.2)
    jm = JaxRNNOneHot(recurrent_layer=JaxRecurrentLayers(cell, [6, 8]), updater=JaxAdam(0.01), **kwargs)
    tm = RNNOneHot(recurrent_layer=RecurrentLayers(cell, [6, 8]), updater=Adam(0.01), device="cpu", **kwargs)
    for m in (jm, tm):
        m._prepare_networks(N)
        m.dataset = _Popularity(N)
    assert jm._use_streaming_head() and tm._use_streaming_head()
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(20):
        batch = {
            "ids": rng.integers(0, N, size=(Bq, Lq, 1)).astype(np.int32),
            "lengths": rng.integers(1, Lq + 1, size=Bq).astype(np.int32),
            "targets": rng.integers(0, N, size=Bq).astype(np.int32),
        }
        batch["target_pop"] = (tm.dataset.item_popularity[batch["targets"]] ** 0.2).astype(np.float32)
        batches.append(batch)
    want, got, jp, tp = _train_both(jm, tm, batches)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    _assert_same_params(tp, jp)


def test_twenty_steps_streaming_head_match_jax():
    """At 16,384 items both packages switch to the streaming CCE (the port's
    plain K2 on the CPU, JAX's chunk scan); two stacked layers (the first
    on the plain scan, the last on K1's plain version), L1 on b_out."""
    _twenty_streaming_steps("GRU")


def test_twenty_lstm_steps_streaming_head_match_jax():
    """The same with two stacked LSTM layers (the last on K5's plain
    version): the LSTM path's head at a small size."""
    _twenty_streaming_steps("LSTM")


TRAIN_FLAGS = BASE + ["--max_iter", "20", "--progress", "10", "--save", "All"]


def _models_in(dataset_dir, sub):
    return sorted(os.listdir(os.path.join(dataset_dir, "models", sub)))


def test_train_cli_writes_jax_checkpoints_that_jax_reads(tmp_path, capsys):
    d = make_dataset(str(tmp_path / "ds"), n_users=120, n_items=60, min_len=8, max_len=24, seed=3)
    torch_train_cli.main(["-d", d, *TRAIN_FLAGS, "--dir", "port/", "--device", "cpu"])
    jax_train_cli.main(["-d", d, *TRAIN_FLAGS, "--dir", "jax/"])
    names = _models_in(d, "port")
    assert len(names) == 2 and names == _models_in(d, "jax")

    def metric_lines():
        return [line for line in capsys.readouterr().out.splitlines() if "@10:" in line or "results on" in line]

    capsys.readouterr()
    test_argv = ["-d", d, *BASE, "--dir", "port/"]
    jax_test_cli.main(test_argv)
    want = metric_lines()
    torch_test_cli.main(test_argv + ["--device", "cpu"])
    assert len(want) == 12 and metric_lines() == want


@pytest.mark.parametrize(
    "tower",
    [["--r_t", "LSTM", "--r_l", "8-12", "--r_bi"], ["--r_t", "Vanilla", "--r_bi", "--r_emb", "6"],
     ["--r_t", "LSTM", "--r_emb", "6"]],
    ids=["lstm-stacked-bi", "vanilla-bi-emb", "lstm-emb"],
)
def test_train_cli_trains_lstm_and_vanilla_towers_that_jax_reads(tmp_path, capsys, tower):
    """The train CLI takes the other towers; the JAX test CLI names, reads
    and scores its checkpoint as the port's test CLI does."""
    d = make_dataset(str(tmp_path / "ds"), n_users=120, n_items=60, min_len=8, max_len=24, seed=3)
    flags = BASE + tower
    torch_train_cli.main(["-d", d, *flags, "--max_iter", "20", "--progress", "20", "--save", "All",
                          "--dir", "port/", "--device", "cpu"])
    assert len(_models_in(d, "port")) == 1
    capsys.readouterr()
    test_argv = ["-d", d, *flags, "--dir", "port/"]
    jax_test_cli.main(test_argv)
    want = [line for line in capsys.readouterr().out.splitlines() if "@10:" in line]
    torch_test_cli.main(test_argv + ["--device", "cpu"])
    got = [line for line in capsys.readouterr().out.splitlines() if "@10:" in line]
    assert len(want) == 5 and got == want


def test_load_last_model_resumes_a_jax_checkpoint(tmp_path, capsys):
    d = make_dataset(str(tmp_path / "ds"), n_users=120, n_items=60, min_len=8, max_len=24, seed=5)
    jax_train_cli.main(["-d", d, *TRAIN_FLAGS, "--dir", "run/"])
    jax_files = _models_in(d, "run")
    last = max(jax_files, key=torch_test_cli.extract_number_of_epochs)

    args = parse.command_parser(parse.predictor_command_parser, argv=BASE)
    args.device = "cpu"
    model = parse.get_predictor(args)
    model.prepare_model(DataHandler(d))
    epochs = model.load_last(d + "models/run/")
    assert epochs == torch_test_cli.extract_number_of_epochs(last)
    want = pytree_load(d + "models/run/" + last)["params"]
    _assert_exact(model.params_to_numpy(), want)

    capsys.readouterr()
    torch_train_cli.main(["-d", d, *BASE, "--max_iter", "10", "--progress", "10", "--save", "All",
                          "--dir", "run/", "--load_last_model", "--device", "cpu"])
    assert "Starting from model " + d + "models/run/" + last in capsys.readouterr().out
    new = sorted(set(_models_in(d, "run")) - set(jax_files))
    assert len(new) == 1
    assert torch_test_cli.extract_number_of_epochs(new[0]) > epochs


def _assert_exact(got, want):
    assert got.keys() == want.keys()
    for key in want:
        if isinstance(want[key], dict):
            _assert_exact(got[key], want[key])
        else:
            np.testing.assert_array_equal(got[key], want[key])


def test_train_cli_without_device_cpu_raises_when_no_gpu(synthetic_dataset):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the CLI runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_train_cli.main(["-d", synthetic_dataset, *BASE, "--max_iter", "2"])


# the flags whose --mesh came with the last mesh slice (--lazy_updates,
# --bf16), and the model that now takes the mesh with them (each case's id
# names its model or flag)
LATER_SLICE = {
    "RNNSampling": (["-m", "RNN", "--loss", "BPR", "--sampling", "8", "--lazy_updates"], "RNNSampling"),
    "RNNMargin": (["-m", "RNN", "--loss", "hinge", "--lazy_updates"], "RNNMargin"),
    "--lazy_updates": (["-m", "RNN", "--loss", "CCE", "--lazy_updates"], "RNNOneHot"),
    "--bf16": (["-m", "RNN", "--loss", "CCE", "--bf16"], "RNNOneHot"),
    "RNNCluster": (["-m", "RNN", "--clusters", "4", "--loss", "Blackout", "--sampling", "8", "--bf16"], "RNNCluster"),
    "FISMCluster": (["-m", "FISM", "--clusters", "4", "--loss", "Blackout", "--sampling", "8", "--bf16"],
                    "FISMCluster"),
    # the autoencoder's CLI passes neither flag on (as in the JAX package)
    "StackedDenoisingAutoencoder": (["-m", "SDA", "-L", "8", "--bf16", "--lazy_updates"],
                                    "StackedDenoisingAutoencoder"),
}
LATER_SLICE_IDS = [f"flags{i}-{name}" for i, name in enumerate(LATER_SLICE)]


class _TookMesh(Exception):
    pass


def _assert_takes_mesh(monkeypatch, run, model: str) -> None:
    """The CLI's model takes the two-rank mesh: stopped right after
    ``set_mesh`` returns, with the mesh set."""
    from seqrec_tpu_torch.models.base import RNNBase

    set_mesh = RNNBase.set_mesh

    def took(self, mesh):
        set_mesh(self, mesh)
        raise _TookMesh(type(self).__name__, self.mesh is mesh)

    monkeypatch.setattr(RNNBase, "set_mesh", took)
    with pytest.raises(_TookMesh) as exc:
        run()
    assert exc.value.args == (model, True)


def two_rank_mesh(spec, device="cuda"):
    """A 2x1 mesh as rank 0 of two would build it, without a process group:
    a model refuses such a mesh before any collective."""
    from seqrec_tpu_torch.parallel import Mesh

    return Mesh(2, 1, 0, torch.device(device), {"data": None, "model": None})


@pytest.mark.parametrize("flags, model", list(LATER_SLICE.values()), ids=LATER_SLICE_IDS)
def test_train_cli_raises_not_implemented_outside_the_slice(synthetic_dataset, monkeypatch, flags, model):
    """The train CLI under a mesh of two ranks once refused --lazy_updates
    and --bf16; every model that takes a mesh now takes it with them, also
    beside --spd."""
    monkeypatch.setattr(torch_train_cli, "make_cli_mesh", two_rank_mesh)
    argv = ["-d", synthetic_dataset, "--r_l", "8", "-b", "8", "--max_iter", "2", "--save", "None", "--device", "cpu",
            "--spd", "2", *flags, "--mesh", "2,1"]
    _assert_takes_mesh(monkeypatch, lambda: torch_train_cli.main(argv), model)
