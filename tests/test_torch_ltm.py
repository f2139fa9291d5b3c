"""The port's LTM against the JAX package's on the CPU: the initial table,
the noise distribution, every epoch's positions (equal where the mask is
set; the port's pad slots carry id -1) and negatives bit for bit; the
tables and the epoch costs after 1 and 2 epochs; top-k lists with and
without the trajectory; a checkpoint saved by each package and loaded by
the other; and the train and test CLIs of both packages. Small sizes
(k=8, window 3, 256 positions a step over the 60-item synthetic catalog).

Tolerances: the tables and the epoch costs rtol 1e-5 with atol 1e-7 (the
scatters sum duplicate ids in another order: JAX's ``.at[].add`` against
``index_add_``); the draws, the lists and the metrics exactly. Queries
whose features are all zero (fewer than 2 items with the trajectory)
score every item 0: the JAX package's ``argpartition`` leaves their order
open, the port's is the k lowest unseen ids (K4's ties by id); those rows
are checked for that.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest

import seqrec_tpu.cli.test as jax_test_cli
import seqrec_tpu.cli.train as jax_train_cli
import seqrec_tpu.utils.command_parser as jax_parse
import seqrec_tpu_torch.cli.test as torch_test_cli
import seqrec_tpu_torch.cli.train as torch_train_cli
import seqrec_tpu_torch.utils.command_parser as parse
from seqrec_tpu.data import DataHandler as JaxDataHandler
from seqrec_tpu.models.ltm import LTM as JaxLTM
from seqrec_tpu_torch.data import DataHandler
from seqrec_tpu_torch.models.ltm import LTM

TABLES = dict(rtol=1e-5, atol=1e-7)


def _pair(dataset_dir, **kwargs):
    kwargs = {**dict(k=8, window=3, seed=5, batch_positions=256, learning_rate=0.05), **kwargs}
    jm, tm = JaxLTM(**kwargs), LTM(device="cpu", **kwargs)
    for model, handler in ((jm, JaxDataHandler(dataset_dir)), (tm, DataHandler(dataset_dir))):
        model.prepare_model(handler)
        model.set_dataset(handler)
        model._init_w2v()
        model._init_training_aux()
    return jm, tm


def _tables(model):
    return np.asarray(model.syn0), np.asarray(model.syn1neg)


def test_init_and_epoch_draws_equal_jax(synthetic_dataset):
    jm, tm = _pair(synthetic_dataset)
    np.testing.assert_array_equal(tm.syn0.numpy(), np.asarray(jm.syn0))
    np.testing.assert_array_equal(tm._noise_cdf, jm._noise_cdf)
    for _ in range(2):
        n_chunks = 0
        for want, got in zip(jm._epoch_positions(), tm._epoch_positions(), strict=True):
            (ctx_w, mask_w, center_w, rows_w), (ctx_g, mask_g, center_g, rows_g) = want, got
            for a, b in ((mask_w, mask_g), (center_w, center_g), (rows_w, rows_g)):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(b, a)
            assert ctx_g.dtype == ctx_w.dtype
            np.testing.assert_array_equal(np.where(mask_g > 0, ctx_g, 0), ctx_w)
            assert (ctx_g[mask_g == 0] == -1).all()
            u_w, u_g = jm.rng.random((len(center_w), jm.negative)), tm.rng.random((len(center_g), tm.negative))
            np.testing.assert_array_equal(u_g, u_w)
            n_chunks += 1
        assert n_chunks > 2
    assert tm.rng.bit_generator.state == jm.rng.bit_generator.state


@pytest.mark.parametrize("use_trajectory", [True, False])
def test_tables_and_costs_after_one_and_two_epochs(synthetic_dataset, use_trajectory):
    jm, tm = _pair(synthetic_dataset, use_trajectory=use_trajectory)
    start = _tables(tm)[0].copy()
    for lr in (0.05, 0.025):
        want, got = jm._train_one_epoch(lr), tm._train_one_epoch(lr)
        np.testing.assert_allclose(got, want, rtol=1e-5)
        for g, w, name in zip(_tables(tm), _tables(jm), ("syn0", "syn1neg")):
            np.testing.assert_allclose(g, w, err_msg=name, **TABLES)
    assert np.abs(_tables(tm)[0] - start).max() > 1e-4 and np.abs(_tables(tm)[1]).max() > 1e-3
    assert tm.rng.bit_generator.state == jm.rng.bit_generator.state
    _assert_same_lists(jm, tm, _instances(tm))


def _instances(model):
    """Every validation user's first half, plus queries of one item (all-zero
    trajectory features) and of two."""
    out = [(s[: len(s) // 2], u) for s, u in model.dataset.validation_set(epochs=1)]
    return out + [([[7, 1.0]], 0), ([[3, 1.0], [9, 4.0]], 1), ([[0, 5.0]], 2)]


def _assert_same_lists(jm, tm, instances, k=10):
    """Load the port's tables into the JAX model and compare the lists."""
    jm.syn0, jm.syn1neg = (jnp.asarray(t) for t in _tables(tm))
    want, got = jm.top_k_batch(instances, k=k), tm.top_k_batch(instances, k=k)
    syn0 = _tables(tm)[0]
    n_zero = 0
    for (seq, _), w, g in zip(instances, want, got):
        seen = {int(i[0]) for i in seq}
        if np.any(tm._query_features(seq, syn0)):
            assert g.tolist() == [int(i) for i in w], seq
        else:  # every score 0: any k unseen items are right; the port's are the lowest ids
            n_zero += 1
            assert not {int(i) for i in w} & seen and len(set(map(int, w))) == k
            assert g.tolist() == [i for i in range(tm.n_items) if i not in seen][:k]
        single = tm.top_k_recommendations(seq, k=k, exclude=[int(g[0])])
        assert single == g.tolist()[1:] + single[-1:] and int(g[0]) not in single
    assert n_zero == (2 if tm.use_trajectory else 0)


def test_checkpoints_load_in_the_other_package(synthetic_dataset, tmp_path):
    jm, tm = _pair(synthetic_dataset)
    tm._train_one_epoch(0.05)
    jm._train_one_epoch(0.05)
    for saver, loader in ((tm, jm), (jm, tm)):
        path = str(tmp_path / saver._get_model_filename(1))
        saver.save(path)
        loader.load(path)
        for g, w in zip(_tables(loader), _tables(saver)):
            np.testing.assert_array_equal(g, w)
    instances = _instances(tm)
    assert [list(map(int, r)) for r in jm.top_k_batch(instances[:-3])] == tm.top_k_batch(instances[:-3]).tolist()


def test_predictor_matches_jax():
    argv = ["-m", "LTM", "-H", "32", "--ltm_window", "5", "--ltm_damping", "0.7", "-l", "0.01"]
    for extra in ([], ["--ltm_no_trajectory"]):
        jax_model = jax_parse.get_predictor(
            jax_parse.command_parser(jax_parse.predictor_command_parser, argv=argv + extra)
        )
        args = parse.command_parser(parse.predictor_command_parser, argv=argv + extra)
        args.device = "cpu"
        model = parse.get_predictor(args)
        assert type(model).__name__ == type(jax_model).__name__
        assert model._get_model_filename(3) == jax_model._get_model_filename(3)
        for attr in ("k", "alpha", "window", "learning_rate", "use_trajectory", "negative", "batch_positions"):
            assert getattr(model, attr) == getattr(jax_model, attr), attr


def _progress(text, key):
    return [float(ln.split(":", 1)[1].split()[0]) for ln in text.splitlines() if ln.startswith(key + " :")]


def test_train_and_test_clis_match_jax(synthetic_dataset, capsys):
    base = ["-d", synthetic_dataset, "-m", "LTM", "-H", "8", "--ltm_window", "3", "-l", "0.05"]
    train = ["--max_iter", "2", "--progress", "1", "--save", "All"]
    jax_train_cli.main(base + train + ["--dir", "ltm_jax/"])
    want = capsys.readouterr().out
    torch_train_cli.main(base + train + ["--dir", "ltm_port/", "--device", "cpu"])
    got = capsys.readouterr().out
    np.testing.assert_allclose(_progress(got, "Last train cost"), _progress(want, "Last train cost"), rtol=1e-5)
    for m in ("sps", "recall", "item_coverage"):
        assert _progress(got, m) == _progress(want, m), m
    names = sorted(os.listdir(os.path.join(synthetic_dataset, "models", "ltm_port")))
    assert names == sorted(os.listdir(os.path.join(synthetic_dataset, "models", "ltm_jax")))
    assert names == ["ltm_ne1_lr0.05_k8_w3_ut0.8.npz", "ltm_ne2_lr0.05_k8_w3_ut0.8.npz"]
    test_argv = base + ["--dir", "ltm_port/"]
    jax_test_cli.main(test_argv)
    want = [line for line in capsys.readouterr().out.splitlines() if "@10:" in line or "results on" in line]
    torch_test_cli.main(test_argv + ["--device", "cpu"])
    got = [line for line in capsys.readouterr().out.splitlines() if "@10:" in line or "results on" in line]
    assert len(want) == 12 and got == want
