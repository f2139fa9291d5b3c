"""``--lazy_updates``, ``--bf16`` and ``--u_moments bfloat16`` on the port's
mesh, against the JAX package and the port's single-device runs on the
CPU.

The port runs in worker processes of a gloo process group
(``tests/torch_mesh_worker.py``, torch only, ``--device cpu``): one group
of 4 ranks (a 2x2 mesh) for the train steps, one of 2 ranks for the rest.
The references run here meanwhile:

- two train steps at a 2x2 mesh of each case against the JAX package's
  single-device ``_train_step`` on the same two batches (the streaming
  switches lowered on the instance and on JAX's modules): lazy
  ``RNNOneHot`` on ``W_in``'s rows with the two data halves on disjoint
  rows, lazy ``RNNOneHot --r_emb 8`` on the embedding's rows with one
  model shard untouched, lazy BPR on ``W_out``'s columns and ``b_out``,
  and ``--bf16`` ``RNNOneHot`` (dense and streaming), hinge (dense and
  streaming) and BPR. The cost, the gathered tables and the gathered
  optimizer leaves (the lazy ``m``, ``v`` and ``count`` among them) after
  each step; the slices that no step touched unchanged bit for bit;
- the same of the other models that accept a flag: lazy hinge and
  RNNCluster; ``--bf16`` RNNCluster, FISMCluster and the autoencoder,
  where the flag changes nothing, as in the JAX package;
- two ranks: one step of bf16-moment Adam at --mesh 1,2 and 2,1, whose
  gathered moments equal the single-device step's in at least 99.99% of
  entries and within one bf16 ulp everywhere (the rounding noise is drawn
  in each parameter's full shape); a lazy BPR checkpoint written at 1,2
  with its optimizer state, whose ``opt`` leaves have the single-device
  checkpoint's keys, order, shapes and dtypes, and which, loaded at 1,2,
  gives the single-device run's next step; the train CLI of each model
  with each flag at a 2-rank mesh against the single-device CLI; the
  refusal of ``--lazy_updates`` by FISMCluster and SDA at 1,2, as on one
  device.

Tolerances: the lazy steps as ``tests/test_torch_mesh_heads.py``'s (loss
rel 1e-5; parameters and moments rtol 1e-4, atol 1e-6); the ``--bf16``
steps as ``tests/test_torch_bf16.py``'s (1e-4 of each tensor's largest
magnitude; the Adam moments of a dense bf16 product, whose data ranks
round their partial dW before the mean over "data", within two bf16 ulps
of it, ``BF16_MOMENT_TOL``); the CLIs' progress costs rel 1e-4, and rel 1e-6 over the 40
steps of ``--u_moments bfloat16`` (a drift there is the noise of another
shard's draw).
"""

import contextlib
import io
import json
import re

import jax
import numpy as np
import pytest
import torch

import seqrec_tpu.ops.streaming_cce as jax_sc
import seqrec_tpu.ops.streaming_margin as jax_sm
import seqrec_tpu_torch.cli.train as torch_train_cli
from seqrec_tpu.models.cluster import FISMCluster as JaxFISMCluster
from seqrec_tpu.models.cluster import RNNCluster as JaxRNNCluster
from seqrec_tpu.models.recurrent import RecurrentLayers as JaxRecurrentLayers
from seqrec_tpu.models.rnn_margin import RNNMargin as JaxRNNMargin
from seqrec_tpu.models.rnn_one_hot import RNNOneHot as JaxRNNOneHot
from seqrec_tpu.models.rnn_sampling import RNNSampling as JaxRNNSampling
from seqrec_tpu.models.sdae import StackedDenoisingAutoencoder as JaxSDA
from seqrec_tpu.models.updates import Adam as JaxAdam
from seqrec_tpu_torch.models.base import pytree_load
from test_torch_mesh_heads import _jax_leaves, _start, _wait
from torch_mesh_worker import head_model

RNN = dict(max_length=10, batch_size=8, seed=0)
LAZY = dict(lazy_updates=True, **RNN)
BF16 = dict(compute_dtype="bfloat16", **RNN)
HALF = 30  # the first model shard of the 60-item tables: rows (columns) [0, 30)
CLUSTER = dict(n_clusters=3, loss="Blackout", sampling=8)
# the 2x2 step cases held to the JAX package: (spec, how its first batch is made)
JAX_CASES = {
    "lazy_w_in": ({"cls": "RNNOneHot", "tower": "GRU", "kw": LAZY}, "disjoint"),
    "lazy_emb": ({"cls": "RNNOneHot", "tower": "GRU", "emb": 8, "kw": LAZY}, "first_shard"),
    "lazy_bpr": ({"cls": "RNNSampling", "tower": "GRU", "kw": dict(loss_function="BPR", sampling=8, **LAZY)}, None),
    "bf16_cce": ({"cls": "RNNOneHot", "tower": "GRU", "kw": BF16}, None),
    "bf16_cce_streaming": ({"cls": "RNNOneHot", "tower": "GRU", "kw": dict(streaming=True, **BF16)}, None),
    "bf16_hinge": ({"cls": "RNNMargin", "tower": "GRU", "kw": dict(loss_function="hinge", **BF16)}, None),
    "bf16_hinge_streaming": ({"cls": "RNNMargin", "tower": "GRU",
                              "kw": dict(loss_function="hinge", streaming=True, **BF16)}, None),
    "bf16_bpr": ({"cls": "RNNSampling", "tower": "GRU", "kw": dict(loss_function="BPR", sampling=8, **BF16)}, None),
    # the other models that accept a flag (--bf16 changes nothing in the cluster models and SDA,
    # as in the JAX package)
    "lazy_hinge": ({"cls": "RNNMargin", "tower": "GRU", "kw": dict(loss_function="hinge", **LAZY)}, None),
    "lazy_cluster": ({"cls": "RNNCluster", "tower": "GRU", "kw": dict(**CLUSTER, **LAZY)}, None),
    "bf16_cluster": ({"cls": "RNNCluster", "tower": "GRU", "kw": dict(**CLUSTER, **BF16)}, None),
    "bf16_fism_cluster": ({"cls": "FISMCluster", "tower": None,
                           "kw": dict(h=12, **CLUSTER, compute_dtype="bfloat16", batch_size=8, seed=0)}, None),
    "bf16_sda": ({"cls": "SDA", "tower": None, "kw": dict(layers=[12], input_dropout=0.2, dropout=0.0,
                                                          compute_dtype="bfloat16", batch_size=8, seed=0)}, None),
}
JAX_CLASSES = {"RNNOneHot": JaxRNNOneHot, "RNNSampling": JaxRNNSampling, "RNNMargin": JaxRNNMargin,
               "RNNCluster": JaxRNNCluster, "FISMCluster": JaxFISMCluster, "SDA": JaxSDA}
BF16_TOL = 1e-4
# the Adam moments of a --bf16 step: the dense product's dW is the bf16-rounded product of each data
# rank's rows, averaged over "data" after the rounding (the one-device step rounds the sum), so a
# moment may sit a bf16 ulp of its gradient away: 2^-7 of mu's largest magnitude, 2^-6 of nu's
BF16_MOMENT_TOL = 2.0**-6


def assert_bf16_close(got, want, what="", tol=BF16_TOL):
    """max |got - want| <= tol * max |want| (``test_torch_bf16.py``'s rule
    at its 1e-4)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, f"{what}: max error {err:.3g} of the largest magnitude"


def _jax_model(spec, handler):
    kw = dict(spec["kw"])
    kw.pop("streaming", None)
    if spec["tower"]:
        kw["recurrent_layer"] = JaxRecurrentLayers(layer_type=spec["tower"], layers=[16],
                                                   embedding_size=spec.get("emb", 0))
    model = JAX_CLASSES[spec["cls"]](updater=JaxAdam(0.01), **kw)
    model.prepare_model(handler)
    model.set_dataset(handler)
    model.params = model._init_params()
    model._build_functions()
    model.opt_state = model._opt.init(model.params)
    return model


def _crafted_batch(probe, how, rng):
    """A batch of B=8 rows whose input ids lie in chosen halves of the
    60-item catalog: ``"disjoint"``, the first data rank's 4 rows in the
    first shard (pads at id 0 included) and the second's in the second
    shard, full length (no pads); ``"first_shard"``, every row in the first
    shard, so the second model shard of the input table is untouched."""
    n, L = probe.n_items, probe.max_length
    sequences = []
    for row in range(8):
        if how == "disjoint" and row >= 4:
            items = rng.choice(np.arange(HALF, n), size=L, replace=False)
        else:
            items = rng.choice(np.arange(1, HALF), size=int(rng.integers(3, L)), replace=False)
        sequences.append([row, [(int(i), 1.0) for i in items], [(int(rng.integers(0, n)), 1.0)]])
    return probe._prepare_input(sequences)


def _batches(spec, how, handler, seed):
    """Two batches of the JAX package's batcher for a case (the first one
    crafted where ``how`` says so)."""
    probe = _jax_model(spec, handler)
    gen = probe._gen_mini_batch(handler.training_set(epochs=10))
    first = _crafted_batch(probe, how, np.random.default_rng(seed)) if how else next(gen)
    return [first, next(gen)]


@contextlib.contextmanager
def _streaming_switches(spec):
    """JAX's streaming switches lowered to 1 for a streaming case."""
    saved = jax_sc.STREAMING_CCE_MIN_ITEMS, jax_sm.STREAMING_MARGIN_MIN_ITEMS
    low = 1 if spec["kw"].get("streaming") else None
    try:
        jax_sc.STREAMING_CCE_MIN_ITEMS = low or saved[0]
        jax_sm.STREAMING_MARGIN_MIN_ITEMS = low or saved[1]
        yield
    finally:
        jax_sc.STREAMING_CCE_MIN_ITEMS, jax_sm.STREAMING_MARGIN_MIN_ITEMS = saved


@pytest.fixture(scope="module")
def step_results(tmp_path_factory, synthetic_dataset, synthetic_handler):
    out = tmp_path_factory.mktemp("mesh_precision")
    cases = {name: spec for name, (spec, _) in JAX_CASES.items()}
    batches = {name: _batches(spec, how, synthetic_handler, seed=i) for i, (name, (spec, how)) in
               enumerate(JAX_CASES.items())}
    np.savez(out / "inputs.npz", **{f"batch_{name}/{s}/{k}": np.asarray(v)
                                    for name, pair in batches.items() for s, b in enumerate(pair)
                                    for k, v in b.items()})
    with open(out / "args.json", "w") as f:
        json.dump({"dataset": synthetic_dataset, "cases": cases}, f)
    ranks = _start("precision", 4, out)

    # the JAX package's two steps while the ranks run
    want = {}
    for name, (spec, _) in JAX_CASES.items():
        with _streaming_switches(spec):
            model = _jax_model(spec, synthetic_handler)
            if spec["cls"] in ("RNNOneHot", "RNNMargin"):
                assert model._use_streaming_head() == bool(spec["kw"].get("streaming"))
            params, opt_state, runs = model.params, model.opt_state, [_jax_leaves(model.params)]
            for batch in batches[name]:
                params, opt_state, cost = model._train_step(params, opt_state, batch)
                runs.append((float(cost), _jax_leaves(params),
                             [np.asarray(leaf) for leaf in jax.tree_util.tree_leaves(opt_state)]))
        want[name] = runs
    _wait("precision", ranks)
    got = []
    for r in range(4):
        with np.load(out / f"precision_rank{r}.npz") as f:
            got.append(dict(f))
    return batches, got, want


def _check_steps(got, want, name, lazy):
    """Every rank's cost, tables and optimizer leaves after each of the two
    steps against the reference's."""
    for r, res in enumerate(got):
        for step in range(2):
            cost, leaves, opt = want[name][1 + step]
            what = f"{name} rank {r} step {step}"
            if lazy:
                assert np.isclose(float(res[f"{name}/{step}/cost"]), cost, rtol=1e-5), what
            else:
                assert_bf16_close(res[f"{name}/{step}/cost"], cost, what + " cost")
            for key, value in leaves.items():
                if lazy:
                    np.testing.assert_allclose(res[f"{name}/{step}/{key}"], value, rtol=1e-4, atol=1e-6,
                                               err_msg=f"{what} {key}")
                else:
                    assert_bf16_close(res[f"{name}/{step}/{key}"], value, f"{what} {key}")
            n_opt = len([k for k in res if k.startswith(f"{name}/{step}/opt")])
            assert n_opt == len(opt), what
            for i, value in enumerate(opt):
                leaf = res[f"{name}/{step}/opt{i}"]
                assert leaf.shape == np.shape(value), f"{what} opt{i}"
                if np.issubdtype(np.asarray(value).dtype, np.integer):
                    assert int(leaf) == int(value), f"{what} opt{i}"
                elif lazy:
                    np.testing.assert_allclose(leaf, value, rtol=1e-4, atol=1e-6, err_msg=f"{what} opt{i}")
                else:
                    assert_bf16_close(leaf, value, f"{what} opt{i}", BF16_MOMENT_TOL)


@pytest.mark.parametrize("case", [n for n in JAX_CASES if n.startswith("lazy")])
def test_mesh_lazy_steps_match_jax(step_results, case):
    """Two lazy steps at 2x2 against the JAX package's: the cost, the
    tables, every optimizer leaf (the lazy m, v and count too); the
    slices that neither batch touched keep their initial bits and zero
    moments."""
    batches, got, want = step_results
    _check_steps(got, want, case, lazy=True)
    initial = want[case][0]
    if case == "lazy_bpr":
        key, touched = "W_out", np.concatenate([np.concatenate([b["targets"], b["samples"]])
                                                for b in batches[case]])
    else:
        key = "embedding" if case == "lazy_emb" else "W_in"
        touched = np.concatenate([b["ids"].reshape(-1) for b in batches[case]])
    axis = 1 if key == "W_out" else 0
    untouched = np.setdiff1d(np.arange(initial[key].shape[axis]), touched)
    assert len(untouched) > 0
    *_, opt = want[case][2]
    n = 3 if key != "W_out" else 6  # the lazy entries' (m, v, count) come last
    lazy_m, lazy_v = opt[-n], opt[-n + 1]
    for r, res in enumerate(got):
        final = res[f"{case}/1/{key}"]
        np.testing.assert_array_equal(np.take(final, untouched, axis), np.take(initial[key], untouched, axis))
        for j in (-n, -n + 1):
            leaf = res[f"{case}/1/opt{len(opt) + j}"]
            assert leaf.shape == lazy_m.shape == lazy_v.shape
            assert not np.take(leaf, untouched, axis).any(), f"rank {r}: a moment of an untouched slice moved"
    if case == "lazy_emb":  # the first batch left the second model shard alone
        assert (batches[case][0]["ids"] < HALF).all()
    if case == "lazy_w_in":  # each data rank's rows touch one shard only
        ids = batches[case][0]["ids"][..., 0]
        assert (ids[:4] < HALF).all() and (ids[4:] >= HALF).all()


@pytest.mark.parametrize("case", [n for n in JAX_CASES if n.startswith("bf16")])
def test_mesh_bf16_steps_match_jax(step_results, case):
    """Two --bf16 steps at 2x2 against the JAX package's: the cost and the
    tables within 1e-4 of each one's largest magnitude, the Adam moments
    within ``BF16_MOMENT_TOL`` of theirs."""
    _, got, want = step_results
    _check_steps(got, want, case, lazy=False)



# ----------------------------------------------------------------------
# two ranks: bf16 moments, a lazy checkpoint, the CLIs
# ----------------------------------------------------------------------
MOMENTS_CASE = {"cls": "RNNOneHot", "tower": "GRU", "moments": "bfloat16", "kw": RNN}
LAZY_CASE = JAX_CASES["lazy_bpr"][0]
GRU = ["--r_l", "16", "--max_length", "10", "-b", "8", "--u_l", "0.01"]
SHORT = ["--max_iter", "16", "--progress", "8", "--device", "cpu"]
# name: (flags, mesh); every run at 16 steps but the bf16 moments' 40
CLI_RUNS = {
    "moments_1x2": (["-m", "RNN", "--loss", "CCE", *GRU, "--u_moments", "bfloat16", "--max_iter", "40",
                     "--progress", "10", "--device", "cpu"], "1,2"),
    "moments_2x1": (["-m", "RNN", "--loss", "CCE", *GRU, "--u_moments", "bfloat16", "--max_iter", "40",
                     "--progress", "10", "--device", "cpu"], "2,1"),
    "lazy_cce_1x2": (["-m", "RNN", "--loss", "CCE", *GRU, "--lazy_updates", *SHORT], "1,2"),
    "lazy_emb_2x1": (["-m", "RNN", "--loss", "CCE", *GRU, "--r_emb", "8", "--lazy_updates", *SHORT], "2,1"),
    "lazy_bpr_1x2": (["-m", "RNN", "--loss", "BPR", "--sampling", "8", *GRU, "--lazy_updates", "--spd", "2",
                      *SHORT], "1,2"),
    "lazy_hinge_1x2": (["-m", "RNN", "--loss", "hinge", *GRU, "--lazy_updates", *SHORT], "1,2"),
    "lazy_cluster_1x2": (["-m", "RNN", "--clusters", "3", "--loss", "Blackout", "--sampling", "8", *GRU,
                          "--lazy_updates", *SHORT], "1,2"),
    "bf16_cce_1x2": (["-m", "RNN", "--loss", "CCE", *GRU, "--bf16", "--u_moments", "bfloat16", *SHORT], "1,2"),
    "bf16_bpr_1x2": (["-m", "RNN", "--loss", "BPR", "--sampling", "8", *GRU, "--bf16", *SHORT], "1,2"),
    "bf16_hinge_1x2": (["-m", "RNN", "--loss", "hinge", *GRU, "--bf16", *SHORT], "1,2"),
    "bf16_cluster_1x2": (["-m", "RNN", "--clusters", "3", "--loss", "Blackout", "--sampling", "8", *GRU, "--bf16",
                          *SHORT], "1,2"),
    "bf16_fism_cluster_1x2": (["-m", "FISM", "--clusters", "3", "-H", "8", "--loss", "Blackout", "--sampling", "8",
                               "-b", "8", "--bf16", *SHORT], "1,2"),
    "bf16_sda_2x1": (["-m", "SDA", "-L", "12", "--in_do", "0.2", "--do", "0.3", "-b", "8", "--bf16", *SHORT], "2,1"),
}
# the models without a recurrent tower, with --lazy_updates
REFUSALS = {
    "fism_cluster": {"cls": "FISMCluster", "tower": None, "kw": dict(h=12, **CLUSTER, lazy_updates=True, batch_size=8,
                                                                     seed=0)},
    "sda": {"cls": "SDA", "tower": None, "kw": dict(layers=[12], lazy_updates=True, batch_size=8, seed=0)},
}


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = main(argv)
    return result, buf.getvalue()


def _costs(text) -> list:
    return [float(c) for c in re.findall(r"Last train cost :  (\S+)", text)]


@pytest.fixture(scope="module")
def cli_results(tmp_path_factory, synthetic_dataset, synthetic_handler):
    from seqrec_tpu_torch.data import DataHandler
    from seqrec_tpu_torch.data.synthetic import make_dataset

    out = tmp_path_factory.mktemp("mesh_precision_cli")
    ds = make_dataset(str(out / "ds"), n_users=120, n_items=60, min_len=8, max_len=24, seed=3)
    moments = next(_jax_model(MOMENTS_CASE, synthetic_handler)._gen_mini_batch(
        synthetic_handler.training_set(epochs=10)))
    lazy = _batches(LAZY_CASE, None, synthetic_handler, seed=0)
    inp = {f"moments/{k}": np.asarray(v) for k, v in moments.items()}
    inp.update({f"lazy/{s}/{k}": np.asarray(v) for s, b in enumerate(lazy) for k, v in b.items()})
    np.savez(out / "inputs.npz", **inp)
    args = {"dataset": synthetic_dataset, "moments": [[1, 2], [2, 1]], "moments_case": MOMENTS_CASE,
            "lazy_case": LAZY_CASE, "checkpoint": str(out / "lazy_mesh.npz"),
            "runs": {name: ["-d", ds, *flags, "--mesh", mesh] for name, (flags, mesh) in CLI_RUNS.items()},
            "refusals": REFUSALS}
    with open(out / "args.json", "w") as f:
        json.dump(args, f)
    ranks = _start("precision_cli", 2, out)

    # the single-device references while the ranks run
    handler = DataHandler(synthetic_dataset)
    single = {}
    model = head_model(MOMENTS_CASE, handler)
    model._step(model._device_batch(moments))
    single["moments"] = model._opt_leaves()
    model = head_model(LAZY_CASE, handler)
    model.save_optimizer_state = True
    model._step(model._device_batch(lazy[0]))
    model.save(str(out / "lazy_single.npz"))
    single["lazy_next_cost"] = float(model._step(model._device_batch(lazy[1])))
    single["runs"] = {name: _costs(_run(torch_train_cli.main, ["-d", ds, *flags, "--dir", f"single_{name}/"])[1])
                      for name, (flags, _) in CLI_RUNS.items()}
    single["refusals"] = {}
    for name, spec in REFUSALS.items():
        with pytest.raises(ValueError) as exc:
            head_model(spec, handler)._init_opt_state()
        single["refusals"][name] = str(exc.value)
    _wait("precision_cli", ranks)
    got = []
    for r in range(2):
        with open(out / f"precision_cli_rank{r}.json") as f:
            res = json.load(f)
        with np.load(out / f"precision_cli_rank{r}.npz") as f:
            res["arrays"] = dict(f)
        got.append(res)
    return out, single, got


@pytest.mark.parametrize("shape", ["1x2", "2x1"])
def test_mesh_bf16_moments_draw_the_single_device_noise(cli_results, shape):
    """One step of bf16-moment Adam: the gathered moments equal the
    single-device step's in at least 99.99% of entries and are within one
    bf16 ulp everywhere (a moment of f32 sums in another order may round
    the other way, never further)."""
    _, single, ranks = cli_results
    n_bf16 = 0
    for res in ranks:
        for i, want in enumerate(single["moments"]):
            got = res["arrays"][f"moments_{shape}/opt{i}"]
            if not isinstance(want, torch.Tensor) or want.dtype != torch.bfloat16:
                np.testing.assert_array_equal(got, np.asarray(want))
                continue
            n_bf16 += 1
            want_bits = want.view(torch.int16).numpy().astype(np.int64)
            got_bits = got.astype(np.int64)
            assert got_bits.shape == want_bits.shape
            assert (got_bits == want_bits).mean() >= 0.9999, f"opt{i}"
            # same sign and at most one step of the 16-bit pattern apart: one ulp
            assert ((got_bits < 0) == (want_bits < 0)).all() and np.abs(got_bits - want_bits).max() <= 1, f"opt{i}"
    assert n_bf16 > 0


@pytest.mark.parametrize("name", list(CLI_RUNS))
def test_two_rank_flag_cli_matches_single_device(cli_results, name):
    """The train CLI with each flag at a 2-rank mesh: both ranks' progress
    costs against the single-device CLI's (rel 1e-6 over the 40 steps of
    bf16 moments, rel 1e-4 otherwise)."""
    _, single, ranks = cli_results
    want = single["runs"][name]
    assert len(want) == (4 if name.startswith("moments") else 2)
    for res in ranks:
        np.testing.assert_allclose(res["runs"][name], want, rtol=1e-6 if name.startswith("moments") else 1e-4)


def test_lazy_mesh_checkpoint_resumes_the_single_device_run(cli_results):
    """A lazy checkpoint written at --mesh 1,2 holds the single-device
    checkpoint's optimizer leaves (keys, order, shapes, dtypes; values
    within rtol 1e-4), and loaded at 1,2 it gives the single-device run's
    next step (rel 1e-5)."""
    out, single, ranks = cli_results
    got, want = pytree_load(str(out / "lazy_mesh.npz")), pytree_load(str(out / "lazy_single.npz"))
    assert list(got["opt"]) == list(want["opt"]) == [str(i) for i in range(len(want["opt"]))]
    for key, value in want["opt"].items():
        leaf = got["opt"][key]
        assert np.shape(leaf) == np.shape(value) and np.asarray(leaf).dtype == np.asarray(value).dtype, key
        np.testing.assert_allclose(leaf, value, rtol=1e-4, atol=1e-6, err_msg=key)
    assert int(got["opt"][str(len(got["opt"]) - 1)]) == 1  # the last lazy count: one step
    for res in ranks:
        assert np.isclose(res["lazy_next_cost"], single["lazy_next_cost"], rtol=1e-5)


def test_lazy_refusals_on_the_mesh_as_on_one_device(cli_results):
    """FISMCluster and SDA refuse --lazy_updates at --mesh 1,2 with the
    single-device error."""
    _, single, ranks = cli_results
    for res in ranks:
        assert res["refusals"] == single["refusals"]
        for name in REFUSALS:
            assert "has no recurrent-tower input table" in res["refusals"][name]
