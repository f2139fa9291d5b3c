"""The port's prefetch threads, stacked batcher, index wire and K-step
dispatch (``--spd``) against the JAX package on the CPU, at a small size
(GRU-16, L=10, B=8, K=4; 120 users, 60 items):

- ``_prefetch`` yields its generator's items, forwards a producer's error,
  ends cleanly, and releases its thread (and its upstream's) when closed;
  the training loop leaves no thread behind;
- the stacked packed batcher (``n_stack=K``) equals the JAX package's
  array for array: CCE, BPR (fresh samples a step), RNNCluster (sample
  sets and noise seeds advanced a step) and ``--rf --mf --uf``;
- the index wire: the same store and (rows, cuts, extras) payloads, and
  ``_expand_index_wire`` equal to the JAX package's for the CCE head with a
  diversity bias, BPR, hinge, RNNCluster and the featured model;
  FISMCluster and the autoencoder stay off it;
- ``train_function_stacked`` on one index-wire payload from one set of
  parameters against the JAX package's (summed cost rtol 1e-5, parameters
  at ``tests/test_torch_train.py``'s tolerance: rtol 1e-4, atol 5e-5), and
  against K single port steps on the packed wire's batches (rtol 1e-6:
  the same math on the same values);
- both train CLIs at ``--spd 4``: the same progress costs (rtol 1e-5) and
  the same checkpoint names (epoch stamps); at ``--spd 1`` the loop's
  batches, costs and names equal a synchronous replay of the batcher (the
  loop before the prefetch thread); ``--spd`` with sequence noise counts
  real steps; MF and LTM ignore ``--spd``; every host draw of a training
  run happens off the main thread.
"""

import copy
import io
import os
import re
import threading
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import seqrec_tpu.cli.train as jax_train_cli
import seqrec_tpu.utils.command_parser as jax_parse
import seqrec_tpu_torch.cli.train as torch_train_cli
import seqrec_tpu_torch.utils.command_parser as parse
from seqrec_tpu.data import DataHandler as JaxDataHandler
from seqrec_tpu_torch.data import DataHandler
from seqrec_tpu_torch.data.noise import SequenceNoise
from seqrec_tpu_torch.data.synthetic import make_dataset, write_side_features
from seqrec_tpu_torch.models.base import RNNBase

BASE = ["-m", "RNN", "--r_l", "16", "--max_length", "10", "-b", "8"]
K = 4
HEADS = {
    "cce": ["--loss", "CCE", "--db", "0.3"],
    "bpr": ["--loss", "BPR", "--sampling", "16"],
    "hinge": ["--loss", "hinge"],
    "cluster": ["--clusters", "4", "--loss", "Blackout", "--sampling", "16", "--c_sampling", "12",
                "--scale_growing_rate", "1.5"],
    "featured": ["--loss", "CCE", "--rf", "--mf", "--uf"],
}


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """The session dataset's shape, with side tables for --mf/--uf."""
    d = make_dataset(str(tmp_path_factory.mktemp("dispatch")), n_users=120, n_items=60, min_len=8, max_len=24,
                     seed=3)
    handler = DataHandler(d)
    write_side_features(d, handler.n_items, handler.n_users, seed=9)
    return d


def _predictors(dataset_dir, flags):
    """(JAX model, handler), (port model, handler), prepared, with their
    generators advanced past the parameter draw, as ``train`` leaves them."""
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
    pair[0][0].params = pair[0][0]._init_params()
    pair[1][0].params_from_numpy(pair[1][0]._init_params())
    return pair


def _assert_same_arrays(got: dict, want: dict, skip=()):
    assert set(got) - set(skip) == set(want) - set(skip)
    for key in want:
        if key in skip:
            continue
        g = got[key].cpu().numpy() if isinstance(got[key], torch.Tensor) else np.asarray(got[key])
        w = np.asarray(want[key])
        assert g.shape == w.shape, key
        np.testing.assert_array_equal(g, w, err_msg=key)


# ----------------------------------------------------------------------
# the prefetch threads
# ----------------------------------------------------------------------
def test_prefetch_yields_every_item_in_order():
    assert list(RNNBase._prefetch(iter(range(100)), depth=3)) == list(range(100))


def test_prefetch_forwards_producer_errors():
    """An assembly error reaches the consumer: it must not look like the
    end of the data (a run would then return after 0 steps)."""

    def boom():
        yield 1
        raise ValueError("assembly failed")

    gen = RNNBase._prefetch(boom(), depth=2)
    assert next(gen) == 1
    with pytest.raises(ValueError, match="assembly failed"):
        list(gen)


def test_prefetch_clean_exhaustion():
    gen = RNNBase._prefetch(iter([1, 2, 3]), depth=2)
    assert list(gen) == [1, 2, 3]
    assert list(gen) == []


def _new_threads(before):
    return [t for t in threading.enumerate() if t.ident not in before]


def test_closing_the_prefetch_releases_its_thread():
    closed = threading.Event()

    def endless():
        try:
            i = 0
            while True:
                yield i
                i += 1
        finally:
            closed.set()

    before = {t.ident for t in threading.enumerate()}
    gen = RNNBase._prefetch(endless(), depth=2)
    assert next(gen) == 0
    threads = _new_threads(before)
    assert len(threads) == 1
    gen.close()
    assert closed.wait(5)  # the producer closed its upstream generator
    threads[0].join(5)
    assert not threads[0].is_alive()


@pytest.mark.parametrize("head", ["cce", "bpr"])
def test_closing_the_payload_pipeline_releases_both_stages(dataset, head):
    """The K-step pipeline nests two prefetch stages (assembly, transfer):
    closing the outer one ends both threads."""
    (_, _), (tm, th) = _predictors(dataset, HEADS[head])
    before = {t.ident for t in threading.enumerate()}
    gen = tm._payload_pipeline(th.training_set, np.random.default_rng(0), K)
    p = next(gen)
    assert set(p) == {"dev", "host", "ready", "_epochs"} and p["ready"] is None
    threads = _new_threads(before)
    assert len(threads) == 2
    gen.close()
    for t in threads:
        t.join(5)
        assert not t.is_alive()


@pytest.mark.parametrize("spd", [1, K])
def test_training_leaves_no_thread_and_draws_off_the_main_thread(dataset, spd):
    """``train`` closes its prefetch threads before it returns, and every
    host draw of the run (here BPR's negative samples) happens on the
    assembly thread, never on the main thread (the cut sampler's generator
    and the model's are the assembly thread's alone)."""
    (_, _), (tm, th) = _predictors(dataset, HEADS["bpr"])
    tm.steps_per_dispatch = spd
    where = []
    draw = tm._draw_samples

    def recorded():
        where.append(threading.current_thread() is threading.main_thread())
        return draw()

    tm._draw_samples = recorded
    before = {t.ident for t in threading.enumerate()}
    tm.train(th, max_iter=16, progress=100, autosave="None")
    for t in _new_threads(before):
        t.join(5)
        assert not t.is_alive()
    assert len(where) >= 16 and not any(where)


# ----------------------------------------------------------------------
# the stacked packed batcher
# ----------------------------------------------------------------------
@pytest.mark.parametrize("head", ["cce", "bpr", "cluster", "featured"])
def test_stacked_packed_batches_equal_jax(dataset, head):
    (jm, jh), (tm, th) = _predictors(dataset, HEADS[head])
    assert jm._fast_batching_ok() and tm._fast_batching_ok()
    want = jm._gen_packed_mini_batch(jh.training_set, np.random.default_rng(77), n_stack=K)
    got = tm._gen_packed_mini_batch(th.training_set, np.random.default_rng(77), n_stack=K)
    for _ in range(12):  # 384 cuts: past the first epoch (309 cuts) of this dataset's training set
        a, b = next(want), next(got)
        assert a.keys() == b.keys()
        for key in a:
            assert a[key].dtype == b[key].dtype and a[key].shape[0] == K, key
            np.testing.assert_array_equal(b[key], a[key], err_msg=key)
        assert jh.training_set.epochs == th.training_set.epochs
    if head in ("bpr", "cluster"):  # a fresh draw a step
        assert len({tuple(s) for s in b["samples"]}) == K
    if head == "cluster":
        assert np.all(np.diff(b["noise_seed"]) == 1) and tm._noise_seed == jm._noise_seed
    assert tm.rng.bit_generator.state == jm.rng.bit_generator.state


# ----------------------------------------------------------------------
# the index wire
# ----------------------------------------------------------------------
@pytest.mark.parametrize("head", ["cce", "bpr", "hinge", "cluster", "featured"])
def test_index_wire_batches_equal_jax(dataset, head):
    """The same store, the same payloads, and on every step of them the
    same device batch from ``_expand_index_wire``."""
    (jm, jh), (tm, th) = _predictors(dataset, HEADS[head])
    assert jm._index_batching_ok() and tm._index_batching_ok()
    _assert_same_arrays(tm._build_index_store(th.training_set), jm._build_index_store(jh.training_set))
    jstore, tstore = jm._upload_index_store(jh.training_set), tm._upload_index_store(th.training_set)
    want = jm._gen_index_mini_batch(jh.training_set, np.random.default_rng(77), n_stack=K)
    got = tm._gen_index_mini_batch(th.training_set, np.random.default_rng(77), n_stack=K)
    for i in range(12):  # 384 cuts: past the first epoch (309 cuts)
        a, b = next(want), next(got)
        _assert_same_arrays(b, a)
        assert jh.training_set.epochs == th.training_set.epochs
        if 2 <= i < 10:
            continue  # every payload is compared, the batches of the first and last two
        p = tm._transfer(dict(b))
        for k in range(K):
            jb = jm._expand_index_wire({key: jnp.asarray(v[k]) for key, v in a.items()}, jstore)
            tb = tm._expand_index_wire({key: v[k] for key, v in p["dev"].items()}, tstore)
            _assert_same_arrays(tb, jb, skip=("targets_in_catalog", *tm._HOST_KEYS))
            for key in tm._HOST_KEYS:
                assert int(p["host"][key][k]) == int(jb[key])
            assert tb["ids"].shape[-1] == tm.n_feature_slots
    assert tm.rng.bit_generator.state == jm.rng.bit_generator.state
    if head == "cluster":
        assert tm.effective_scale == jm.effective_scale > 1.0  # the schedule grew at an epoch boundary


def test_unstacked_index_batches_equal_jax(dataset):
    """Without ``n_stack`` the extras lose their leading axis."""
    (jm, jh), (tm, th) = _predictors(dataset, HEADS["cluster"])
    a = next(jm._gen_index_mini_batch(jh.training_set, np.random.default_rng(5)))
    b = next(tm._gen_index_mini_batch(th.training_set, np.random.default_rng(5)))
    _assert_same_arrays(b, a)
    assert b["rows"].shape == (8,) and b["samples"].shape == (16,) and b["noise_seed"].shape == ()


@pytest.mark.parametrize(
    "flags",
    [["-m", "FISM", "--clusters", "4", "-H", "8", "--loss", "Blackout", "--sampling", "16"],
     ["-m", "SDA", "-L", "8-4-8"], ["--loss", "CCE", "--n_dropout", "0.2"]],
    ids=["fism-cluster", "sda", "sequence-noise"],
)
def test_models_off_the_index_wire(dataset, flags):
    """FISMCluster (an infinite max_length), the autoencoder (its own batch
    layout) and sequence noise keep off the index wire in both packages."""
    argv = BASE + flags
    jax_model = jax_parse.get_predictor(jax_parse.command_parser(jax_parse.predictor_command_parser, argv=argv))
    args = parse.command_parser(parse.predictor_command_parser, argv=argv)
    args.device = "cpu"
    model = parse.get_predictor(args)
    assert not jax_model._index_batching_ok() and not model._index_batching_ok()
    assert model._fast_batching_ok() == jax_model._fast_batching_ok() is False


def test_the_store_check_replaces_the_streaming_range_check(dataset, monkeypatch):
    """A store item outside the catalog is refused when the store is
    uploaded, with the streaming CCE's message; expanded batches then tell
    the streaming CCE that their targets are checked."""
    (_, _), (tm, th) = _predictors(dataset, HEADS["cce"])
    store = tm._upload_index_store(th.training_set)
    batch = next(tm._gen_index_mini_batch(th.training_set, np.random.default_rng(0)))
    dev = tm._expand_index_wire({k: torch.from_numpy(v) for k, v in batch.items()}, store)
    assert dev["targets_in_catalog"] is True
    build = tm._build_index_store

    def bad(training_set):
        host = build(training_set)
        host["items"][3] = tm.n_items
        return host

    monkeypatch.setattr(tm, "_build_index_store", bad)
    with pytest.raises(ValueError, match="outside the catalog"):
        tm._upload_index_store(th.training_set)


# ----------------------------------------------------------------------
# the K-step dispatch
# ----------------------------------------------------------------------
def _assert_same_params(got, want, prefix="", rtol=1e-4, atol=5e-5):
    assert got.keys() == want.keys()
    for key in want:
        if isinstance(want[key], dict):
            _assert_same_params(got[key], want[key], prefix + key + "/", rtol, atol)
        else:
            np.testing.assert_allclose(got[key], want[key], rtol=rtol, atol=atol, err_msg=prefix + key)


@pytest.mark.parametrize("head", ["cce", "bpr", "hinge", "cluster", "featured"])
def test_stacked_index_wire_steps_match_jax(dataset, head):
    """One index-wire payload of K steps from one set of parameters: the
    port's fused steps against the JAX package's scan, and against K single
    port steps on the packed wire's batches of the same cuts and draws."""
    (jm, jh), (tm, th) = _predictors(dataset, HEADS[head])
    (_, _), (single, sh) = _predictors(dataset, HEADS[head])
    tree = jax.tree_util.tree_map(np.asarray, jm.params)
    for m in (tm, single):
        m.params_from_numpy(copy.deepcopy(tree))
    jm.params = jax.tree_util.tree_map(jnp.asarray, tree)
    jm._build_functions()
    jm.opt_state = jm._opt.init(jm.params)
    jm._dev_store = jm._upload_index_store(jh.training_set)
    tm._dev_store = tm._upload_index_store(th.training_set)

    jp = next(jm._gen_index_mini_batch(jh.training_set, np.random.default_rng(77), n_stack=K))
    tp = next(tm._gen_index_mini_batch(th.training_set, np.random.default_rng(77), n_stack=K))
    _assert_same_arrays(tp, jp)
    want = float(jm.train_function_stacked(dict(jp)))
    got = float(tm.train_function_stacked(tm._transfer(dict(tp))))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    _assert_same_params(tm.params_to_numpy(), jax.tree_util.tree_map(np.asarray, jm.params))

    packed = next(single._gen_packed_mini_batch(sh.training_set, np.random.default_rng(77), n_stack=K))
    costs = [float(single.train_function({key: v[k] for key, v in packed.items()})) for k in range(K)]
    np.testing.assert_allclose(got, sum(costs), rtol=1e-6)
    _assert_same_params(tm.params_to_numpy(), single.params_to_numpy(), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("head", ["bpr", "cluster"])
def test_dispatch_payloads_equal_multi_and_single_steps(dataset, head):
    """``_gen_dispatch_payloads`` (K unstacked batches stacked and uploaded)
    trains as ``train_function_multi`` on the same K host batches, and as K
    single ``train_function`` steps on them (the same bits: the same math on
    the same values, summed in the same order)."""
    models = [_predictors(dataset, HEADS[head])[1] for _ in range(3)]
    tree = models[0][0].params_to_numpy()
    for m, _ in models[1:]:
        m.params_from_numpy(copy.deepcopy(tree))
    gens = [m._gen_packed_mini_batch(h.training_set, np.random.default_rng(9)) for m, h in models]
    (a, _), (b, _), (c, _) = models
    payload = next(a._gen_dispatch_payloads(gens[0], K))
    assert all(len(v) == K for v in payload["dev"].values())
    stacked = float(a.train_function_stacked(payload))
    multi = float(b.train_function_multi([next(gens[1]) for _ in range(K)]))
    single = 0.0
    for _ in range(K):
        single += float(c.train_function(next(gens[2])))
    assert stacked == multi and np.isclose(single, stacked, rtol=1e-6, atol=0)
    for m in (b, c):
        _assert_same_params(m.params_to_numpy(), a.params_to_numpy(), rtol=0, atol=0)


# ----------------------------------------------------------------------
# the train CLI
# ----------------------------------------------------------------------
def _cli(main, d, flags, sub, extra=()):
    out = io.StringIO()
    with redirect_stdout(out):
        main(["-d", d, *flags, "--max_iter", "40", "--progress", "16", "--save", "All", "--dir", sub, *extra])
    costs = [float(line.split(":")[1]) for line in out.getvalue().splitlines() if line.startswith("Last train cost")]
    return costs, sorted(os.listdir(os.path.join(d, "models", sub)))


@pytest.mark.parametrize("head", ["cce", "bpr", "hinge", "cluster", "featured"])
def test_train_cli_at_spd4_matches_jax(dataset, head):
    """Both CLIs at --spd 4: checkpoints at 16 and 32 steps, the same mean
    costs and the same file names (the epoch stamps of the last consumed
    payload)."""
    flags = BASE + HEADS[head] + ["--spd", str(K)]
    want_costs, want_names = _cli(jax_train_cli.main, dataset, flags, f"jax_{head}/")
    got_costs, got_names = _cli(torch_train_cli.main, dataset, flags, f"port_{head}/", ["--device", "cpu"])
    assert len(want_costs) == 2 and got_names == want_names
    np.testing.assert_allclose(got_costs, want_costs, rtol=1e-5)


def test_spd1_prefetch_loop_equals_the_synchronous_loop(dataset):
    """At --spd 1 the loop takes its batches from the prefetch thread: the
    batches it trains on, its costs and its checkpoint names equal those of
    the synchronous loop, replayed here on the batcher directly."""
    (_, _), (tm, th) = _predictors(dataset, HEADS["bpr"])
    (_, _), (replay, rh) = _predictors(dataset, HEADS["bpr"])
    replay.params_from_numpy(tm.params_to_numpy())
    seen, costs = [], []
    step = tm.train_function

    def recorded(batch):
        seen.append({key: np.array(v) for key, v in batch.items() if key != "_epochs"})
        costs.append(float(step(batch)))
        return torch.tensor(costs[-1])

    tm.train_function = recorded
    save_dir = os.path.join(dataset, "models", "spd1_loop") + "/"
    tm.train(th, max_iter=20, progress=10, autosave="All", save_dir=save_dir)
    gen = replay._gen_packed_mini_batch(rh.training_set, np.random.default_rng(replay.seed + 77))
    names = []
    for i in range(20):
        batch = next(gen)
        for key in batch:
            np.testing.assert_array_equal(seen[i][key], batch[key], err_msg=key)
        assert float(replay.train_function(batch)) == costs[i]
        if i in (9, 19):
            names.append(replay._get_model_filename(round(rh.training_set.epochs, 3)))
    assert sorted(os.listdir(save_dir)) == sorted(names)


def test_spd_with_sequence_noise_counts_real_steps(dataset):
    """Sequence noise keeps the per-sequence batcher: K = 1 a loop, so
    ``max_iter`` counts real optimizer steps, not steps_per_dispatch."""
    argv = BASE + ["--loss", "CCE"]
    args = parse.command_parser(parse.predictor_command_parser, argv=argv)
    args.device = "cpu"
    model = parse.get_predictor(args)
    model.sequence_noise = SequenceNoise(dropout=0.2)
    assert not model._fast_batching_ok()
    model.steps_per_dispatch = 4
    handler = DataHandler(dataset)
    model.prepare_model(handler)
    calls = {"n": 0}
    orig = model.train_function

    def counting(batch):
        calls["n"] += 1
        return orig(batch)

    model.train_function = counting
    model.train(handler, max_iter=4, progress=100, autosave="None", save_dir="")
    assert calls["n"] == 4


@pytest.mark.parametrize(
    "flags",
    [["-m", "BPRMF", "-H", "8", "--max_iter", "4096", "--progress", "2048"],
     ["-m", "LTM", "-H", "8", "--ltm_window", "3", "--max_iter", "2", "--progress", "1"]],
    ids=["bprmf", "ltm"],
)
def test_mf_and_ltm_take_spd_and_ignore_it(dataset, flags, tmp_path):
    """The flag is accepted and changes nothing: the same costs and files."""
    runs = []
    for sub, extra in (("plain/", []), ("spd/", ["--spd", "8"])):
        out = io.StringIO()
        with redirect_stdout(out):
            torch_train_cli.main(["-d", dataset, *flags, "--save", "All", "--dir", "ignore_" + sub, "--device", "cpu",
                                  *extra])
        costs = re.findall(r"(?:Last train cost|cost)\s*:\s*([-0-9.e]+)", out.getvalue())
        runs.append((costs, sorted(os.listdir(os.path.join(dataset, "models", "ignore_" + sub)))))
    assert runs[0][1] and runs[0] == runs[1]
