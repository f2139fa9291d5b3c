"""The side features (--mf/--uf) of the port against the JAX package on the
CPU: the same tables from the same files, the same feature ids from the
encoder and from both batchers for one seed, the same 20 train steps with
--rf --mf --uf, the same CLI metrics, the same checkpoint names, and the
same error for a missing file.

The side tables are made from a seed with numpy in the on-disk contract of
``data/features.py``, as ``tests/test_features.py`` makes them (G = 4
genre columns). Small sizes: GRU-16, L=10, B=8.

Tolerances: ids, tables and filenames exactly; costs rtol 1e-5 (the same
f32 math summed in other orders); parameters after 20 Adam steps at lr
1e-3 rtol 1e-5 with atol 1e-6 (differences of a few f32 ulps through
Adam's division by sqrt(nu)).
"""

import copy
import os

import jax
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
from seqrec_tpu.data.features import load_feature_tables as jax_load_feature_tables
from seqrec_tpu.data.synthetic import make_dataset
from seqrec_tpu_torch.data import DataHandler
from seqrec_tpu_torch.data.features import load_feature_tables, year_to_decade_idx

BASE = ["-m", "RNN", "--loss", "CCE", "--r_l", "16", "--max_length", "10", "-b", "8"]
G = 4


def write_side_tables(dirname, n_items, n_users, seed=9):
    """movie_features (item, year, G genre flags) and user_features (user,
    sex, age, occupation) as tests/test_features.py writes them."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n_items):
        year = int(rng.integers(1940, 2016))
        rows.append([i, year] + (rng.random(G) < 0.4).astype(int).tolist())
    np.savetxt(os.path.join(dirname, "data", "movie_features"), np.array(rows, dtype=np.int64),
               fmt="%d", delimiter="\t")
    urows = [[u, int(rng.integers(0, 2)), int(rng.integers(0, 7)), int(rng.integers(0, 21))] for u in range(n_users)]
    np.savetxt(os.path.join(dirname, "data", "user_features"), np.array(urows, dtype=np.int64),
               fmt="%d", delimiter="\t")


@pytest.fixture(scope="module")
def featured_dataset(tmp_path_factory):
    d = make_dataset(str(tmp_path_factory.mktemp("featured")), n_users=120, n_items=60, min_len=8, max_len=24, seed=3)
    handler = DataHandler(d)
    write_side_tables(d, handler.n_items, handler.n_users)
    return d


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


def test_year_to_decade_equals_jax():
    from seqrec_tpu.data.features import year_to_decade_idx as jax_decade

    years = np.arange(1890, 2030)
    np.testing.assert_array_equal(year_to_decade_idx(years), jax_decade(years))


@pytest.mark.parametrize("movies,users", [(True, False), (False, True), (True, True)])
def test_feature_tables_equal_jax(featured_dataset, movies, users):
    got = load_feature_tables(DataHandler(featured_dataset), movies, users)
    want = jax_load_feature_tables(JaxDataHandler(featured_dataset), movies, users)
    assert (got.n_movie_feats, got.n_user_feats) == (want.n_movie_feats, want.n_user_feats)
    assert (got.item_slots, got.user_slots) == (want.item_slots, want.user_slots)
    for name in ("item_ids", "user_ids"):
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None) == (b is None)
        if a is not None:
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("flags", [["--mf"], ["--uf"], ["--rf", "--mf", "--uf"]])
def test_encoded_feature_ids_equal_jax(featured_dataset, flags):
    """Slots, input size, block offsets, and the encoder's ids with user ids
    (-1 in every slot past the item's at invalid steps) bit for bit."""
    (jm, jh), (tm, th) = _predictors(featured_dataset, flags)
    assert tm.n_feature_slots == jm.n_feature_slots > 1
    assert tm._input_size() == jm._input_size()
    assert tm._feature_offsets() == jm._feature_offsets()
    instances = list(tm._iter_test_instances(th.test_set(epochs=1)))
    seqs, users = [s for s, _, _ in instances], [u for _, _, u in instances]
    got = tm._encode_sequences(seqs, user_ids=users)
    want = jm._encode_sequences(seqs, user_ids=users)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    ids, _, mask = got
    assert (ids[:, :, 1:][mask == 0] == -1).all()
    if "--uf" in flags:
        with pytest.raises(ValueError, match="user ids"):
            tm._encode_sequences(seqs[:2])


@pytest.mark.parametrize("flags", [["--mf"], ["--uf"], ["--rf", "--mf", "--uf"]])
def test_packed_featured_batches_equal_jax(featured_dataset, flags):
    """The packed batcher's compact wire with the feature slots (int16 ids
    with -1 pads), past the first epoch."""
    (jm, jh), (tm, th) = _predictors(featured_dataset, flags)
    want = jm._gen_packed_mini_batch(jh.training_set, np.random.default_rng(77))
    got = tm._gen_packed_mini_batch(th.training_set, np.random.default_rng(77))
    for _ in range(12):
        a, b = next(want), next(got)
        assert a.keys() == b.keys()
        for key in a:
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(b[key], a[key], err_msg=key)
    assert (b["ids"] < 0).any()


def test_slow_featured_batches_equal_jax(featured_dataset):
    """The per-sequence batcher (sequence noise on) carries the user ids."""
    (jm, jh), (tm, th) = _predictors(featured_dataset, ["--rf", "--mf", "--uf", "--n_dropout", "0.2"])
    assert not tm._fast_batching_ok()
    jm._init_params(), tm._init_params()
    want = jm._gen_mini_batch(jm.sequence_noise(jh.training_set()))
    got = tm._gen_mini_batch(tm.sequence_noise(th.training_set()))
    for _ in range(4):
        a, b = next(want), next(got)
        assert a.keys() == b.keys()
        for key in a:
            np.testing.assert_array_equal(b[key], a[key], err_msg=key)


def _assert_close_params(got, want, prefix=""):
    assert got.keys() == want.keys()
    for key in want:
        if isinstance(want[key], dict):
            _assert_close_params(got[key], want[key], prefix + key + "/")
        else:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-5, atol=1e-6, err_msg=prefix + key)


@pytest.mark.parametrize("head", [["--loss", "CCE", "--db", "0.3"], ["--loss", "BPR", "--sampling", "16"]],
                         ids=["cce", "bpr"])
def test_twenty_featured_steps_match_jax(featured_dataset, head):
    """--rf --mf --uf, Adam 1e-3: the same init, the same packed batches
    (the sampled head's negatives from the model generator), 20 steps."""
    (jm, jh), (tm, th) = _predictors(featured_dataset, ["--rf", "--mf", "--uf", *head, "--u_l", "0.001"])
    tree = jm._init_params()
    tm._init_params()  # the init draws from the model generator, as the negatives do after it
    tm.params_from_numpy(copy.deepcopy(tree))
    jm.params = jax.tree_util.tree_map(jnp.asarray, tree)
    jm._build_functions()
    jm.opt_state = jm._opt.init(jm.params)
    batches_j = jm._gen_packed_mini_batch(jh.training_set, np.random.default_rng(81))
    batches_t = tm._gen_packed_mini_batch(th.training_set, np.random.default_rng(81))
    want, got = [], []
    for _ in range(20):
        want.append(float(jm.train_function(next(batches_j))))
        got.append(float(tm.train_function(next(batches_t))))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    _assert_close_params(tm.params_to_numpy(), jax.tree_util.tree_map(np.asarray, jm.params))


def test_featured_cli_metrics_and_filenames_equal_jax(featured_dataset, capsys):
    """Both train CLIs with --rf --mf --uf write the same ``_rf_mf_uf``
    checkpoint names; the JAX test CLI and the port's, each on the port's
    checkpoints, print the same metrics."""
    flags = BASE + ["--rf", "--mf", "--uf"]
    train = ["-d", featured_dataset, *flags, "--max_iter", "20", "--progress", "10", "--save", "All"]
    torch_train_cli.main(train + ["--dir", "port/", "--device", "cpu"])
    jax_train_cli.main(train + ["--dir", "jax/"])
    names = sorted(os.listdir(os.path.join(featured_dataset, "models", "port")))
    assert len(names) == 2 and names == sorted(os.listdir(os.path.join(featured_dataset, "models", "jax")))
    assert all("_rf_mf_uf" in n for n in names)

    def metric_lines():
        return [line for line in capsys.readouterr().out.splitlines() if "@10:" in line or "results on" in line]

    capsys.readouterr()
    test_argv = ["-d", featured_dataset, *flags, "--dir", "port/"]
    jax_test_cli.main(test_argv)
    want = metric_lines()
    torch_test_cli.main(test_argv + ["--device", "cpu"])
    assert len(want) == 12 and metric_lines() == want


@pytest.mark.parametrize("flags", [["--mf"], ["--uf"], ["--rf", "--uf"], ["--mf", "--uf", "--loss", "hinge"]])
def test_featured_filenames_equal_jax(flags):
    argv = BASE + flags
    jax_args = jax_parse.command_parser(jax_parse.predictor_command_parser, argv=argv)
    args = parse.command_parser(parse.predictor_command_parser, argv=argv)
    args.device = "cpu"
    want = jax_parse.get_predictor(jax_args)._get_model_filename(2.5)
    assert parse.get_predictor(args)._get_model_filename(2.5) == want


@pytest.mark.parametrize("flag,name", [("--mf", "movie_features"), ("--uf", "user_features")])
def test_missing_side_file_raises_as_jax(tmp_path, flag, name):
    d = make_dataset(str(tmp_path / "ds"), n_users=40, n_items=20, min_len=8, max_len=12, seed=2)
    argv = BASE + [flag]
    jax_args = jax_parse.command_parser(jax_parse.predictor_command_parser, argv=argv)
    args = parse.command_parser(parse.predictor_command_parser, argv=argv)
    args.device = "cpu"
    with pytest.raises(FileNotFoundError) as want:
        jax_parse.get_predictor(jax_args).prepare_model(JaxDataHandler(d))
    with pytest.raises(FileNotFoundError) as got:
        parse.get_predictor(args).prepare_model(DataHandler(d))
    assert str(got.value) == str(want.value) and name in str(got.value)
