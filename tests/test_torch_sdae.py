"""The port's stacked denoising autoencoder against the JAX package on the
CPU: initial parameters, the multi-hot bag, batches (input dropout drawn
from the model's generator) equal to the JAX package's for one seed, 20
training steps from the same parameters and the validation metrics after
them, the layer dropout's statistics, the refusal of ``--lazy_updates``,
the predictor's flags and filename, and the test CLIs on a checkpoint of
the port's train CLI. Small sizes (``-L 16-8`` and ``-L 12`` over the
60-item synthetic catalog).

Tolerances: costs rtol 1e-5; parameters after 20 Adam steps rtol 1e-4
with atol 5e-5; the bag and the batches exactly; the metrics exactly.
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
from seqrec_tpu.models.sdae import StackedDenoisingAutoencoder as JaxSDAE
from seqrec_tpu.models.updates import Adam as JaxAdam
from seqrec_tpu_torch.data import DataHandler
from seqrec_tpu_torch.data.synthetic import make_dataset
from seqrec_tpu_torch.models.sdae import StackedDenoisingAutoencoder
from seqrec_tpu_torch.models.updates import Adam


def _pair(dataset_dir, **kwargs):
    kwargs = {**dict(batch_size=8, seed=4, layers=[16, 8], dropout=0.0, input_dropout=0.2), **kwargs}
    jm = JaxSDAE(updater=JaxAdam(0.01), **kwargs)
    tm = StackedDenoisingAutoencoder(updater=Adam(0.01), device="cpu", **kwargs)
    for model, handler in ((jm, JaxDataHandler(dataset_dir)), (tm, DataHandler(dataset_dir))):
        model.prepare_model(handler)
        model.set_dataset(handler)
    return jm, tm


def _start_both(jm, tm):
    tree, jax_tree = tm._init_params(), jm._init_params()
    assert list(tree) == list(jax_tree)
    for key, want in jax_tree.items():
        np.testing.assert_array_equal(tree[key], want, err_msg=key)
    tm.params_from_numpy(copy.deepcopy(tree))
    jm.params = jax.tree_util.tree_map(jnp.asarray, tree)
    jm._build_functions()
    jm.opt_state = jm._opt.init(jm.params)
    return tree


def _batches(jm, tm, n=20):
    want = jm._gen_mini_batch(jm.sequence_noise(jm.dataset.training_set()))
    got = tm._gen_mini_batch(tm.sequence_noise(tm.dataset.training_set()))
    batches = []
    for _ in range(n):
        a, b = next(want), next(got)
        assert a.keys() == b.keys()
        for key in a:
            assert np.asarray(a[key]).dtype == np.asarray(b[key]).dtype, key
            np.testing.assert_array_equal(b[key], a[key], err_msg=key)
        batches.append(b)
    return batches


def _metrics(model):
    return model._compute_validation_metrics({m: [] for m in model.metrics})


def test_initial_params_match_jax(synthetic_dataset):
    jm, tm = _pair(synthetic_dataset)
    tree = _start_both(jm, tm)
    assert list(tree) == ["W0", "b0", "W1", "b1", "W_out", "b_out"]
    for key, val in tm.params_to_numpy().items():
        np.testing.assert_array_equal(val, tree[key], err_msg=key)


def test_bag_matches_jax(synthetic_dataset):
    """Masked slots (a duplicate among them) are swallowed by the pad column."""
    jm, tm = _pair(synthetic_dataset)
    ids = np.array([[1, 3, 0, 59], [2, 2, 0, 7]], dtype=np.int32)
    mask = np.array([[1, 1, 0, 1], [1, 0, 0, 0]], dtype=np.float32)
    got = tm._bag(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jm._bag(jnp.asarray(ids), jnp.asarray(mask))))
    assert got.shape == (2, tm.n_items) and got.sum() == 4


@pytest.mark.parametrize("input_dropout", [0.2, 0.0])
def test_batches_equal_jax(synthetic_dataset, input_dropout):
    jm, tm = _pair(synthetic_dataset, input_dropout=input_dropout)
    _start_both(jm, tm)
    batches = _batches(jm, tm, n=5)
    assert [int(b["dropout_seed"]) for b in batches] == [1, 2, 3, 4, 5]
    dropped = sum(b["y_mask"].sum() - b["x_mask"].sum() for b in batches)
    assert (dropped > 0) == (input_dropout > 0)


@pytest.mark.parametrize(
    "kwargs", [dict(), dict(layers=[12], interactions_are_unique=False)], ids=["16-8", "12-repeated"]
)
def test_twenty_steps_and_metrics_match_jax(synthetic_dataset, kwargs):
    """At --do 0 (the layer dropout's bits differ between the packages);
    the input dropout is in the batches, so it is covered."""
    jm, tm = _pair(synthetic_dataset, **kwargs)
    _start_both(jm, tm)
    batches = _batches(jm, tm)
    want = [float(jm.train_function(dict(b))) for b in batches]
    got = [float(tm.train_function(dict(b))) for b in batches]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[-1] < got[0]
    jax_params = jax.tree_util.tree_map(np.asarray, jm.params)
    for key, val in tm.params_to_numpy().items():
        np.testing.assert_allclose(val, jax_params[key], rtol=1e-4, atol=5e-5, err_msg=key)
    assert _metrics(tm) == _metrics(jm)


def test_layer_dropout_draws(synthetic_dataset):
    """--do 0.5 on one layer whose ReLU output is 1 everywhere: after the
    dropout it is 0 or 2, which W_out's identity block shows as sigmoid 0.5
    or sigmoid 2. The same seed draws the same mask, the next seed another;
    the keep rate over 8,000 units lies within 0.03 of 0.5 (5 standard
    errors)."""
    _, tm = _pair(synthetic_dataset, layers=[16], dropout=0.5)
    tree = tm._init_params()
    tree["W0"][:] = 0.0
    tree["b0"][:] = 1.0
    tree["W_out"][:] = 0.0
    tree["W_out"][:, :16] = np.eye(16, dtype=np.float32)
    tm.params_from_numpy(tree)
    x = torch.zeros((500, tm.n_items))
    with torch.no_grad():
        a, b, c = (tm._forward(x, dropout_seed=s)[:, :16] for s in (3, 3, 4))
        plain = tm._forward(x)[:, :16]
    assert torch.equal(a, b) and not torch.equal(a, c)
    kept = a > 0.6
    assert torch.all(kept | (a == 0.5)) and torch.allclose(a[kept], torch.sigmoid(torch.tensor(2.0)))
    assert abs(float(kept.float().mean()) - 0.5) < 0.03
    assert torch.allclose(plain, torch.sigmoid(torch.tensor(1.0)).expand_as(plain))


def test_lazy_updates_refused_as_in_jax(synthetic_dataset):
    jm, tm = _pair(synthetic_dataset, lazy_updates=True)
    with pytest.raises(ValueError, match="no recurrent-tower input table"):
        jm._build_functions()
    tm.params_from_numpy(tm._init_params())
    with pytest.raises(ValueError, match="no recurrent-tower input table"):
        tm._init_opt_state()


def test_predictor_matches_jax():
    argv = ["-m", "SDA", "-L", "64-32-64", "--do", "0.3", "--in_do", "0.2", "-b", "64", "--u_m", "adam",
            "--u_l", "0.001", "--lazy_updates"]
    jax_model = jax_parse.get_predictor(jax_parse.command_parser(jax_parse.predictor_command_parser, argv=argv))
    args = parse.command_parser(parse.predictor_command_parser, argv=argv)
    args.device = "cpu"
    model = parse.get_predictor(args)
    assert type(model).__name__ == type(jax_model).__name__
    assert model._get_model_filename(3) == jax_model._get_model_filename(3)
    for attr in ("layers", "dropout", "input_dropout", "batch_size", "max_length", "lazy_updates"):
        assert getattr(model, attr) == getattr(jax_model, attr), attr


def test_train_cli_checkpoint_and_test_clis_match_jax(tmp_path, capsys):
    d = make_dataset(str(tmp_path / "ds"), n_users=120, n_items=60, min_len=8, max_len=24, seed=3)
    base = ["-m", "SDA", "-L", "16-8", "--do", "0.3", "--in_do", "0.2", "-b", "8"]
    torch_train_cli.main(["-d", d, *base, "--max_iter", "20", "--progress", "20", "--save", "All",
                          "--dir", "port/", "--device", "cpu"])
    names = os.listdir(os.path.join(d, "models", "port"))
    assert len(names) == 1 and names[0].startswith("sda_bs8_ne")
    capsys.readouterr()
    test_argv = ["-d", d, *base, "--dir", "port/"]
    jax_test_cli.main(test_argv)
    want = [line for line in capsys.readouterr().out.splitlines() if "@10:" in line]
    torch_test_cli.main(test_argv + ["--device", "cpu"])
    got = [line for line in capsys.readouterr().out.splitlines() if "@10:" in line]
    assert len(want) == 5 and got == want
