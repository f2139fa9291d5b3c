"""The port's mesh (``seqrec_tpu_torch/parallel/``, ``--mesh``) against the
JAX package on the CPU.

The port runs in 2 or 4 worker processes of a gloo process group
(``tests/torch_mesh_worker.py``, torch only, ``--device cpu``); the JAX
package runs here, on ``tests/conftest.py``'s 8 virtual devices, as
``tests/test_parallel.py`` runs it:

- the ops at a 2x2 mesh: ``sharded_streaming_cce`` (loss, dh, dW, db;
  targets in both shards, and a batch whose targets all lie in shard 0)
  against JAX's at rtol 1e-5; ``sharded_score_topk`` checked as
  ``test_sharded_topk_matches_dense`` checks JAX's, at k = 5 and past K4's
  list (k = 70), and an exact list with ties, in (value descending, id
  ascending) order; the row-sharded gather-sum and its table gradient
  against ``jax.grad`` of JAX's ``gather_sum`` (int16 ids, pad slots, a
  mask);
- one train step at a 2x2 mesh of the flagship (GRU, dense head), the
  streaming head, the LSTM tower and ``--r_emb 8`` (the embedding and the
  dense first ``W_in`` both by rows): the cost within rtol 1e-5 of the JAX
  package's single-device step (and of its mesh step, for the two heads),
  the gathered ``W_out``, ``b_out``, ``W_in`` and embedding within rtol
  1e-4, atol 1e-6 (``test_sharded_train_step_matches_single_device``);
  ``cce_grads_plain`` with targets of -1;
- the layout rules against JAX's ``param_sharding``, and the replication
  of a table that does not divide the model axis;
- two ranks: the train CLI at ``--mesh 2,1 --spd 2`` for 16 steps (progress
  costs within 1e-4 of the port's single-device CLI; only rank 0 writes
  the checkpoints, the same files and keys), the test CLI of BPRMF, FPMC,
  FISM and Fossil at ``--mesh 1,2`` (the single-device lists), the
  refusals (LTM, a mesh that is not the world), and BPR with
  ``--lazy_updates`` and with ``--bf16`` at ``--mesh 2,1``, which two
  ranks once refused and now train (costs within 1e-4 of the
  single-device CLI's).

Each spawning test waits at most ``TIMEOUT`` seconds, and kills every
worker when one fails or the time is up.
"""

import contextlib
import io
import json
import os
import re
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import seqrec_tpu_torch.cli.test as torch_test_cli
import seqrec_tpu_torch.cli.train as torch_train_cli
from seqrec_tpu.models.recurrent import RecurrentLayers as JaxRecurrentLayers
from seqrec_tpu.models.rnn_one_hot import RNNOneHot as JaxRNNOneHot
from seqrec_tpu.models.updates import Adam as JaxAdam
from seqrec_tpu.parallel import make_mesh as jax_make_mesh
from seqrec_tpu.parallel import param_sharding as jax_param_sharding
from seqrec_tpu.parallel import shard_batch, shard_params
from seqrec_tpu_torch.models.base import pytree_load
from seqrec_tpu_torch.models.recurrent import RecurrentLayers
from seqrec_tpu_torch.models.rnn_one_hot import RNNOneHot
from seqrec_tpu_torch.parallel import Mesh, param_sharding

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_mesh_worker.py")
TIMEOUT = 120


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(scenario: str, n_ranks: int, out, timeout: float = TIMEOUT) -> None:
    """Run ``n_ranks`` workers of ``scenario`` in one gloo group; fail (and
    kill them all) when one exits non-zero or the time is up."""
    port = _free_port()
    procs, logs = [], []
    for rank in range(n_ranks):
        env = {**os.environ, "RANK": str(rank), "WORLD_SIZE": str(n_ranks), "LOCAL_RANK": str(rank),
               "LOCAL_WORLD_SIZE": str(n_ranks), "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
               "OMP_NUM_THREADS": "1", "PYTHONPATH": ROOT, "GLOO_SOCKET_IFNAME": "lo"}
        log = open(os.path.join(out, f"{scenario}_rank{rank}.log"), "w+")
        logs.append(log)
        procs.append(subprocess.Popen([sys.executable, WORKER, scenario, str(out)], env=env, stdout=log,
                                      stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) or time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        text = []
        for rank, log in enumerate(logs):
            log.seek(0)
            text.append(f"--- rank {rank} (rc {procs[rank].returncode}) ---\n" + log.read()[-4000:])
            log.close()
    if any(p.returncode != 0 for p in procs):
        pytest.fail(f"{scenario}: a worker failed or timed out after {timeout} s\n" + "\n".join(text))


def _rank(d: int, m: int, n_model: int = 2) -> int:
    return d * n_model + m


@pytest.fixture(scope="module")
def devices():
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices")
    return devs


# ----------------------------------------------------------------------
# the ops at a 2x2 mesh
# ----------------------------------------------------------------------
def _op_inputs() -> dict:
    rng = np.random.default_rng(7)
    B, H, N = 16, 8, 64
    inp = {}
    for case, hi in (("cce", N), ("cce_own", N // 2)):  # cce_own: every target in shard 0
        inp[case + "_h"] = rng.normal(size=(B, H)).astype(np.float32)
        inp[case + "_w"] = (rng.normal(size=(H, N)) * 0.1).astype(np.float32)
        inp[case + "_b"] = (rng.normal(size=N) * 0.1).astype(np.float32)
        inp[case + "_t"] = rng.integers(0, hi, B).astype(np.int32)
    Bt, Ht, Nt, S = 8, 16, 128, 6
    inp["topk_h"] = rng.normal(size=(Bt, Ht)).astype(np.float32)
    inp["topk_w"] = rng.normal(size=(Ht, Nt)).astype(np.float32)
    inp["topk_b"] = rng.normal(size=Nt).astype(np.float32)
    inp["topk_seen"] = rng.integers(0, Nt, size=(Bt, S)).astype(np.int32)
    inp["topk_seen_mask"] = (rng.random((Bt, S)) > 0.5).astype(np.float32)
    # small integers: exact scores with many ties, across both shards
    inp["ties_h"] = rng.integers(0, 2, size=(Bt, 4)).astype(np.float32)
    inp["ties_w"] = rng.integers(0, 2, size=(4, 40)).astype(np.float32)
    inp["ties_b"] = np.zeros(40, np.float32)
    inp["ties_seen"] = rng.integers(0, 40, size=(Bt, S)).astype(np.int32)
    inp["ties_seen_mask"] = (rng.random((Bt, S)) > 0.3).astype(np.float32)
    ids = rng.integers(0, 64, size=(8, 5, 3))
    ids[rng.random(ids.shape) < 0.2] = -1
    inp["gs_ids"] = ids.astype(np.int16)
    inp["gs_mask"] = (rng.random(ids.shape) > 0.3).astype(np.float32)
    inp["gs_table"] = rng.normal(size=(64, 8)).astype(np.float32)
    inp["gs_cot"] = rng.normal(size=(8, 5, 8)).astype(np.float32)
    return inp


@pytest.fixture(scope="module")
def op_results(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_ops")
    inp = _op_inputs()
    np.savez(out / "inputs.npz", **inp)
    _spawn("ops", 4, out)
    ranks = []
    for r in range(4):
        with np.load(out / f"ops_rank{r}.npz") as f:
            ranks.append(dict(f))
    return inp, ranks


def _assemble_rows(ranks, key, m=0):
    return np.concatenate([ranks[_rank(d, m)][key] for d in range(2)])


@pytest.mark.parametrize("case", ["cce", "cce_own"])
def test_sharded_streaming_cce_matches_jax(op_results, devices, case):
    from jax.sharding import NamedSharding, PartitionSpec as P

    from seqrec_tpu.ops.streaming_cce import sharded_streaming_cce

    inp, ranks = op_results
    mesh = jax_make_mesh(n_data=2, n_model=2, devices=devices[:4])
    h, w, b = (jnp.asarray(inp[f"{case}_{k}"]) for k in ("h", "w", "b"))
    t = jax.device_put(jnp.asarray(inp[case + "_t"]), NamedSharding(mesh, P("data")))

    def loss(h, w, b):
        return sharded_streaming_cce(h, w, b, t, mesh).sum()

    want_loss, want = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2)))(h, w, b)
    for m in range(2):  # the loss and dh are the same on both model ranks
        np.testing.assert_array_equal(_assemble_rows(ranks, case + "_loss", m), _assemble_rows(ranks, case + "_loss"))
        np.testing.assert_array_equal(_assemble_rows(ranks, case + "_dh", m), _assemble_rows(ranks, case + "_dh"))
    got_loss = _assemble_rows(ranks, case + "_loss").sum()
    assert np.isclose(got_loss, float(want_loss), rtol=1e-5)
    # dW and db: each model rank's columns, summed over the data ranks' rows
    dW = np.concatenate([sum(ranks[_rank(d, m)][case + "_dW"] for d in range(2)) for m in range(2)], axis=1)
    db = np.concatenate([sum(ranks[_rank(d, m)][case + "_db"] for d in range(2)) for m in range(2)])
    for got, w_ in zip((_assemble_rows(ranks, case + "_dh"), dW, db), want):
        np.testing.assert_allclose(got, np.asarray(w_), rtol=1e-5, atol=1e-7)


def test_sharded_topk_matches_jax(op_results, devices):
    """As ``test_sharded_topk_matches_dense``: the scores at the port's ids
    equal those at JAX's sharded top-k ids, row by row (k = 70, past K4's
    list and past a shard's 64 columns: JAX's dense top-k)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from seqrec_tpu.ops.core import masked_top_k
    from seqrec_tpu.parallel.topk import sharded_score_topk

    inp, ranks = op_results
    mesh = jax_make_mesh(n_data=2, n_model=2, devices=devices[:4])
    h, w, b, seen, sm = (inp["topk_" + k] for k in ("h", "w", "b", "seen", "seen_mask"))
    put = lambda x, spec: jax.device_put(x, NamedSharding(mesh, spec))  # noqa: E731
    scores = h @ w + b
    masked = scores.copy()
    for i in range(len(h)):
        masked[i, seen[i][sm[i] > 0]] = -np.inf
    for k in (5, 70):
        if k <= w.shape[1] // 2:
            want = np.asarray(sharded_score_topk(mesh, put(h, P("data", None)), put(w, P(None, "model")),
                                                 put(b, P("model")), put(seen, P("data", None)),
                                                 put(sm, P("data", None)), k=k))
        else:  # more than a shard holds: JAX's dense top-k, the route of the port's two passes
            want = np.asarray(masked_top_k(jnp.asarray(scores), k, jnp.asarray(seen), jnp.asarray(sm)))
        got = _assemble_rows(ranks, f"topk_{k}_ids")
        np.testing.assert_array_equal(got, _assemble_rows(ranks, f"topk_{k}_ids", m=1))
        for i in range(len(h)):
            np.testing.assert_allclose(masked[i, got[i]], masked[i, want[i]], rtol=1e-5)
            np.testing.assert_allclose(_assemble_rows(ranks, f"topk_{k}_values")[i], masked[i, want[i]], rtol=1e-5)


def test_sharded_topk_orders_ties_by_id(op_results):
    """Exact integer scores with many ties: the merged lists are (value
    descending, id ascending), masked items last, as the unsharded K4."""
    inp, ranks = op_results
    h, w, b, seen, sm = (inp["ties_" + k] for k in ("h", "w", "b", "seen", "seen_mask"))
    scores = h @ w + b
    for i in range(len(h)):
        scores[i, seen[i][sm[i] > 0]] = -np.inf
    got_ids, got_v = _assemble_rows(ranks, "ties_6_ids"), _assemble_rows(ranks, "ties_6_values")
    n_ties = 0
    for i in range(len(h)):
        order = np.lexsort((np.arange(scores.shape[1]), -scores[i]))[:6]
        np.testing.assert_array_equal(got_ids[i], order)
        np.testing.assert_array_equal(got_v[i], scores[i, order])
        n_ties += len(order) - len(np.unique(scores[i, order]))
    assert n_ties > 0


def test_sharded_gather_sum_matches_jax(op_results):
    from seqrec_tpu.ops.core import gather_sum as jax_gather_sum

    inp, ranks = op_results
    ids, mask, table, cot = (jnp.asarray(inp["gs_" + k]) for k in ("ids", "mask", "table", "cot"))
    want_out = np.asarray(jax_gather_sum(table, ids.astype(jnp.int32), mask))
    want_dt = np.asarray(jax.grad(lambda t: (jax_gather_sum(t, ids.astype(jnp.int32), mask) * cot).sum())(table))
    for m in range(2):
        np.testing.assert_allclose(_assemble_rows(ranks, "gs_out", m), want_out, rtol=1e-6, atol=1e-6)
    dtable = np.concatenate([sum(ranks[_rank(d, m)]["gs_dtable"] for d in range(2)) for m in range(2)])
    np.testing.assert_allclose(dtable, want_dt, rtol=1e-6, atol=1e-6)


# ----------------------------------------------------------------------
# one train step at a 2x2 mesh
# ----------------------------------------------------------------------
def _jax_model(handler, tower="GRU", emb=0, seed=0):
    model = JaxRNNOneHot(recurrent_layer=JaxRecurrentLayers(layer_type=tower, layers=[16], embedding_size=emb),
                         updater=JaxAdam(0.01), max_length=12, batch_size=16, seed=seed)
    model.prepare_model(handler)
    model.set_dataset(handler)
    model.params = model._init_params()
    model._build_functions()
    model.opt_state = model._opt.init(model.params)
    return model


# variant: (tower, embedding size, streaming head, also against the JAX package's mesh step)
STEP_VARIANTS = {"dense": ("GRU", 0, False, True), "streaming": ("GRU", 0, True, True),
                 "lstm": ("LSTM", 0, False, False), "emb": ("GRU", 8, False, False)}


def _step_leaves(params) -> dict:
    leaves = {"W_out": params["W_out"], "b_out": params["b_out"], "W_in": params["tower"]["layer0_fwd"]["W_in"]}
    if "embedding" in params["tower"]:
        leaves["embedding"] = params["tower"]["embedding"]
    return {k: np.asarray(v) for k, v in leaves.items()}


@pytest.fixture(scope="module")
def step_results(tmp_path_factory, synthetic_dataset, synthetic_handler, devices):
    import seqrec_tpu.ops.streaming_cce as sc

    out = tmp_path_factory.mktemp("mesh_step")
    probe = _jax_model(synthetic_handler)
    batch = next(probe._gen_mini_batch(synthetic_handler.training_set(epochs=10)))
    np.savez(out / "inputs.npz", **{"batch_" + k: np.asarray(v) for k, v in batch.items()})
    with open(out / "args.json", "w") as f:
        json.dump({"dataset": synthetic_dataset}, f)
    _spawn("step", 4, out)
    with np.load(out / "step_rank0.npz") as f:
        got = dict(f)
    mesh = jax_make_mesh(n_data=2, n_model=2, devices=devices[:4])
    want = {}
    saved = sc.STREAMING_CCE_MIN_ITEMS
    try:
        for name, (tower, emb, streaming, with_mesh) in STEP_VARIANTS.items():
            sc.STREAMING_CCE_MIN_ITEMS = 1 if streaming else saved
            single = _jax_model(synthetic_handler, tower, emb)
            assert single._use_streaming_head() == streaming
            runs = [single._train_step(single.params, single.opt_state, batch)]
            if with_mesh:
                sharded = _jax_model(synthetic_handler, tower, emb)
                sharded.set_mesh(mesh)
                runs.append(sharded._train_step(shard_params(sharded.params, mesh),
                                                jax.device_put(sharded.opt_state), shard_batch(batch, mesh)))
            want[name] = [(float(cost), _step_leaves(p)) for p, _, cost in runs]
    finally:
        sc.STREAMING_CCE_MIN_ITEMS = saved
    return got, want


@pytest.mark.parametrize("variant", list(STEP_VARIANTS))
def test_mesh_train_step_matches_jax(step_results, variant):
    """The port's step at a 2x2 mesh against the JAX package's
    single-device step (and, for the two heads, its mesh step)."""
    got, want = step_results
    for cost, params in want[variant]:
        assert np.isclose(float(got[f"{variant}_cost"]), cost, rtol=1e-5)
        for key, value in params.items():
            np.testing.assert_allclose(got[f"{variant}_{key}"], value, rtol=1e-4, atol=1e-6, err_msg=key)


def test_cce_grads_plain_target_minus_one_matches_no_column():
    """A target of -1 (another shard's) adds no one-hot in the plain
    gradients, as in K2's kernel: its row's dz is g * softmax."""
    from seqrec_tpu_torch.ops.streaming_cce import cce_grads_plain

    rng = np.random.default_rng(3)
    h, W, b = (torch.tensor(rng.normal(size=s), dtype=torch.float32) for s in ((6, 4), (4, 9), (9,)))
    targets = torch.tensor([2, -1, 8, -1, 0, -1], dtype=torch.int32)
    g = torch.tensor(rng.uniform(0.5, 1.5, size=6), dtype=torch.float32)
    logits = h @ W + b
    logz = torch.logsumexp(logits, dim=1)
    onehot = torch.zeros(6, 9)
    onehot[[0, 2, 4], targets[[0, 2, 4]].long()] = 1.0
    dz = g[:, None] * (torch.softmax(logits, dim=1) - onehot)
    for got, want in zip(cce_grads_plain(h, W, b, targets, logz, g), (dz @ W.t(), h.t() @ dz, dz.sum(0))):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


# ----------------------------------------------------------------------
# the layout rules
# ----------------------------------------------------------------------
def _flat_specs(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flat_specs(value, prefix + (key,))
        else:
            yield ".".join(prefix + (key,)), tuple(value.spec)


@pytest.mark.parametrize("r_emb", [0, 8])
def test_param_layout_matches_jax(synthetic_handler, devices, capsys, r_emb):
    """``W_out`` by columns, ``W_in`` of layer 0 and the embedding by rows,
    ``W_hid`` replicated, as JAX's ``param_sharding`` lays them out; at an
    8-way model axis the 60-item tables stay whole, with JAX's message."""
    model = RNNOneHot(recurrent_layer=RecurrentLayers(layer_type="GRU", layers=[16], embedding_size=r_emb),
                      max_length=12, batch_size=16, seed=1, device="cpu")
    model.prepare_model(synthetic_handler)
    tree = model._init_params()
    shapes = {k: v.shape for k, v in _flat_specs_arrays(tree)}
    for n_data, n_model in ((2, 4), (1, 8)):
        jax_specs = dict(_flat_specs(jax_param_sharding(tree, jax_make_mesh(n_data, n_model, devices=devices))))
        capsys.readouterr()
        specs = param_sharding(shapes, Mesh(n_data, n_model, 0, torch.device("cpu"), {"data": None, "model": None}))
        assert specs == jax_specs
        printed = capsys.readouterr().out
        replicated = [k for k, v in specs.items() if not v and (k.endswith("W_out") or k.endswith("b_out"))]
        if n_model == 4:
            assert specs["W_out"] == (None, "model") and specs["b_out"] == ("model",)
            assert specs["tower.layer0_fwd.W_in"] == ("model", None)
            assert specs["tower.layer0_fwd.W_hid"] == ()
            assert not replicated and printed == ""
        else:
            assert set(replicated) == {"W_out", "b_out"}
            assert f"mesh: W_out (16, {model.n_items}) does not divide the model axis (8); replicating" in printed


def _flat_specs_arrays(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flat_specs_arrays(value, prefix + (key,))
        else:
            yield ".".join(prefix + (key,)), value


# ----------------------------------------------------------------------
# two ranks through the CLIs
# ----------------------------------------------------------------------
CLI_BASE = ["-m", "RNN", "--loss", "CCE", "--r_l", "16", "--max_length", "10", "-b", "8", "--spd", "2",
            "--max_iter", "16", "--progress", "8", "--save", "All", "--metrics", "sps", "--device", "cpu"]
MF = {"bprmf": ["-m", "BPRMF", "-H", "8"], "fpmc": ["-m", "FPMC", "--k_cf", "8", "--k_mc", "8"],
      "fism": ["-m", "FISM", "-H", "8", "--loss", "BPR"], "fossil": ["-m", "Fossil", "-H", "8"]}


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = main(argv)
    return result, buf.getvalue()


@pytest.fixture(scope="module")
def cli_results(tmp_path_factory):
    from seqrec_tpu_torch.data.synthetic import make_dataset

    out = tmp_path_factory.mktemp("mesh_cli")
    ds = make_dataset(str(out / "ds"), n_users=120, n_items=60, min_len=8, max_len=24, seed=3)
    _, text = _run(torch_train_cli.main, ["-d", ds, *CLI_BASE, "--dir", "single/"])
    single_costs = [float(c) for c in re.findall(r"Last train cost :  (\S+)", text)]
    bpr = ["-d", ds, "-m", "RNN", "--loss", "BPR", "--sampling", "8", "--r_l", "8", "-b", "8", "--max_iter", "16",
           "--progress", "8", "--device", "cpu"]
    runs = {"later_slice": bpr + ["--lazy_updates"], "bf16": bpr + ["--bf16"]}
    run_costs = {name: [float(c) for c in re.findall(r"Last train cost :  (\S+)",
                                                     _run(torch_train_cli.main, argv + ["--dir", f"single_{name}/"])[1])]
                 for name, argv in runs.items()}
    mf_lists = {}
    for name, flags in MF.items():
        argv = ["-d", ds, *flags, "--device", "cpu"]
        _run(torch_train_cli.main, argv + ["--max_iter", "8192", "--progress", "8192", "--save", "All"])
        mf_lists[name] = [[int(i) for i in pred] for _, pred in _run(torch_test_cli.main, argv)[0].instances]
    np.savez(out / "inputs.npz")
    args = {
        "train_argv": ["-d", ds, *CLI_BASE, "--mesh", "2,1"],
        "mf_test_argv": {name: ["-d", ds, *flags, "--device", "cpu"] for name, flags in MF.items()},
        "runs": {name: argv + ["--mesh", "2,1"] for name, argv in runs.items()},
        "refusals": {
            "ltm": ["-d", ds, "-m", "LTM", "-H", "8", "--mesh", "2,1", "--device", "cpu"],
            "world": ["-d", ds, *CLI_BASE, "--mesh", "2,2"],
        },
    }
    with open(out / "args.json", "w") as f:
        json.dump(args, f)
    _spawn("cli", 2, out)
    ranks = []
    for r in range(2):
        with open(out / f"cli_rank{r}.json") as f:
            ranks.append(json.load(f))
    for res in ranks:
        res["run_costs_single"] = run_costs
    return ds, single_costs, mf_lists, ranks


def test_two_rank_train_cli_matches_single_device(cli_results):
    ds, single_costs, _, ranks = cli_results
    assert len(single_costs) == 2
    for res in ranks:
        np.testing.assert_allclose(res["costs"], single_costs, rtol=1e-4)
    models = os.path.join(ds, "models")
    single = sorted(os.listdir(os.path.join(models, "single")))
    assert len(single) == 2
    assert sorted(os.listdir(os.path.join(models, "rank0"))) == single
    assert not os.path.exists(os.path.join(models, "rank1")) or not os.listdir(os.path.join(models, "rank1"))
    for name in single:
        got = pytree_load(os.path.join(models, "rank0", name))
        want = pytree_load(os.path.join(models, "single", name))
        assert sorted(_flat_keys(got)) == sorted(_flat_keys(want))
        for key, shape in _flat_keys(want).items():
            assert _flat_keys(got)[key] == shape, key


def _flat_keys(tree, prefix=()):
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_flat_keys(value, prefix + (key,)))
        else:
            out["/".join(prefix + (key,))] = np.shape(value)
    return out


@pytest.mark.parametrize("model", list(MF))
def test_two_rank_mf_test_cli_matches_single_device(cli_results, model):
    """The factorization family's eval mesh: each rank scores its rows
    against its columns of the output table (K4's plain version here), and
    every rank gets the single-device test CLI's lists."""
    _, _, single_lists, ranks = cli_results
    assert len(single_lists[model]) > 0
    for res in ranks:
        assert res["mf_lists"][model] == single_lists[model]


def test_mesh_refusals(cli_results):
    """LTM and a mesh that is not the world are refused; BPR with
    --lazy_updates (``later_slice``) and with --bf16, once refused on two
    ranks, train and match the single-device CLI's costs."""
    _, _, _, ranks = cli_results
    for res in ranks:
        ref = res["refusals"]
        assert ref["ltm"][0] == "ValueError" and "--mesh is supported for the RNN/SDAE/cluster families" in ref["ltm"][1]
        assert ref["world"] == ["ValueError", "--mesh 2,2 asks for 2x2 devices but the pod exposes 1x2"]
        for name in ("later_slice", "bf16"):
            want = res["run_costs_single"][name]
            assert len(want) == 2
            np.testing.assert_allclose(res["runs"][name], want, rtol=1e-4, err_msg=name)
