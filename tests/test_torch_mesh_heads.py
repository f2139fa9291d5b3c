"""The port's mesh for the sampled, margin and cluster heads and the
autoencoder against the JAX package on the CPU.

The port runs in worker processes of a gloo process group
(``tests/torch_mesh_worker.py``, torch only, ``--device cpu``): one group
of 4 ranks (a 2x2 mesh) for the ops and the train steps, one of 2 ranks for
the CLIs. The JAX package runs here, single-device, meanwhile:

- ``parallel/columns.py:gather_columns``: the gathered columns equal
  ``W[:, cols]`` and ``b[cols]``, and its gradients (each data rank's rows,
  each model rank's columns) those of ``jax.grad`` of the global product;
- ``sharded_streaming_margin`` (hinge and unique at a dividing chunk,
  logsig and unique at a padded one, logit without unique) against JAX's
  single-device ``streaming_margin``, loss and gradients, as
  ``tests/test_parallel.py:test_sharded_streaming_margin_op_parity``;
- the sampled and cluster losses with a row offset: the global [B, B+S]
  loss of JAX's, row block by row block;
- one train step at a 2x2 mesh of BPR, Blackout with ``--sampling_bias``
  (LSTM), the dense hinge (``--r_emb 8``), the streaming hinge (the
  switch lowered on the instance and on JAX's module), RNNCluster
  (Blackout, csn 0), FISMCluster and the autoencoder (do 0), each against
  JAX's single-device ``_train_step`` on the same batch;
- the cluster validation's two top-10 lists on scores with ties at 0
  against JAX's ``_cluster_eval_topk``;
- two ranks: each family's train CLI (BPR at --mesh 1,2 --spd 2, hinge
  with an LSTM at 1,2, RNNCluster at --csn 0.1 and SDA at --do 0.3 on 2,1,
  so their device draws are split by rows, FISMCluster at 1,2) against the
  port's single-device CLI, and the test CLI on the single-device
  checkpoint (at 1,2, the output tables' shards merged, for every family
  but the hinge; at 2,1, the rows gathered, for the hinge).

Tolerances: ops and steps as the JAX package's mesh tests (loss rel 1e-5;
gradients and parameters rtol 1e-4, atol 1e-6); the CLIs' progress costs
rel 1e-4 (``test_torch_mesh.py``'s); lists exactly.
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
from seqrec_tpu.models.cluster import FISMCluster as JaxFISMCluster
from seqrec_tpu.models.cluster import RNNCluster as JaxRNNCluster
from seqrec_tpu.models.recurrent import RecurrentLayers as JaxRecurrentLayers
from seqrec_tpu.models.rnn_margin import RNNMargin as JaxRNNMargin
from seqrec_tpu.models.rnn_sampling import RNNSampling as JaxRNNSampling
from seqrec_tpu.models.sdae import StackedDenoisingAutoencoder as JaxSDA
from seqrec_tpu.models.updates import Adam as JaxAdam
from seqrec_tpu.ops import losses as jax_losses
from seqrec_tpu_torch.ops import losses

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_mesh_worker.py")
TIMEOUT = 120

# the train-step cases: the port's and the JAX package's class, tower, keyword arguments
RNN = dict(max_length=12, batch_size=16, seed=0)
HEAD_CASES = {
    "bpr": {"cls": "RNNSampling", "tower": "GRU", "kw": dict(loss_function="BPR", sampling=8, **RNN)},
    "blackout_bias": {"cls": "RNNSampling", "tower": "LSTM",
                      "kw": dict(loss_function="Blackout", sampling=8, sampling_bias=0.5, **RNN)},
    "hinge": {"cls": "RNNMargin", "tower": "GRU", "emb": 8, "kw": dict(loss_function="hinge", **RNN)},
    "hinge_streaming": {"cls": "RNNMargin", "tower": "GRU", "kw": dict(loss_function="hinge", streaming=True, **RNN)},
    "cluster": {"cls": "RNNCluster", "tower": "GRU", "kw": dict(n_clusters=3, loss="Blackout", sampling=8, **RNN)},
    "fism_cluster": {"cls": "FISMCluster", "tower": None,
                     "kw": dict(h=12, n_clusters=3, loss="Blackout", sampling=8, batch_size=16, seed=0)},
    "sda": {"cls": "SDA", "tower": None, "kw": dict(layers=[12], input_dropout=0.2, dropout=0.0, batch_size=16,
                                                    seed=0)},
}
JAX_CLASSES = {"RNNSampling": JaxRNNSampling, "RNNMargin": JaxRNNMargin, "RNNCluster": JaxRNNCluster,
               "FISMCluster": JaxFISMCluster, "SDA": JaxSDA}
TIES_CASE = {"cls": "RNNCluster", "tower": "GRU", "kw": dict(n_clusters=4, loss="Blackout", sampling=8,
                                                             cluster_type="mix", **RNN)}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(scenario: str, n_ranks: int, out) -> list:
    """Start ``n_ranks`` workers of ``scenario`` in one gloo group."""
    port = _free_port()
    ranks = []
    for rank in range(n_ranks):
        env = {**os.environ, "RANK": str(rank), "WORLD_SIZE": str(n_ranks), "LOCAL_RANK": str(rank),
               "LOCAL_WORLD_SIZE": str(n_ranks), "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
               "OMP_NUM_THREADS": "1", "PYTHONPATH": ROOT, "GLOO_SOCKET_IFNAME": "lo"}
        log = open(os.path.join(out, f"{scenario}_rank{rank}.log"), "w+")
        ranks.append((subprocess.Popen([sys.executable, WORKER, scenario, str(out)], env=env, stdout=log,
                                       stderr=subprocess.STDOUT), log))
    return ranks


def _wait(scenario: str, ranks: list, timeout: float = TIMEOUT) -> None:
    """Wait for the workers; fail (and kill them all) when one exits
    non-zero or the time is up."""
    deadline = time.monotonic() + timeout
    procs = [p for p, _ in ranks]
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) or time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        text = []
        for rank, (p, log) in enumerate(ranks):
            if p.poll() is None:
                p.kill()
            p.wait()
            log.seek(0)
            text.append(f"--- rank {rank} (rc {p.returncode}) ---\n" + log.read()[-4000:])
            log.close()
    if any(p.returncode != 0 for p in procs):
        pytest.fail(f"{scenario}: a worker failed or timed out after {timeout} s\n" + "\n".join(text))


def _rank(d: int, m: int) -> int:
    return d * 2 + m


def _rows(ranks, key, m=0):
    """A row-split result assembled over the data ranks (model rank m)."""
    return np.concatenate([ranks[_rank(d, m)][key] for d in range(2)])


def _cols_summed(ranks, key, axis):
    """A column-sharded gradient: each model rank's shard summed over the
    data ranks' rows, the shards concatenated."""
    return np.concatenate([sum(ranks[_rank(d, m)][key] for d in range(2)) for m in range(2)], axis=axis)


# ----------------------------------------------------------------------
# the offset sampled losses (in this process)
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", list(jax_losses.CLUSTER_LOSSES))
def test_offset_sampled_loss_matches_jax_global_loss(name):
    """Each data rank's rows (two blocks of 4 of 8) scored against all 8
    targets and 24 samples, its own targets from column 4 d on: the
    concatenated losses and gradients are JAX's global ones."""
    rng = np.random.default_rng(5)
    B = 8
    x = rng.normal(0, 2, size=(B, B + 24)).astype(np.float32)
    g = rng.normal(size=B).astype(np.float32)
    want, pull = jax.vjp(lambda s: jax_losses.CLUSTER_LOSSES[name](s, B), jnp.asarray(x))
    (want_g,) = pull(jnp.asarray(g))
    got, got_g = [], []
    for d in range(2):
        rows = torch.tensor(x[4 * d : 4 * d + 4], requires_grad=True)
        loss = losses.CLUSTER_LOSSES[name](rows, B, 4 * d)
        got.append(loss.detach().numpy())
        got_g.append(torch.autograd.grad(loss, rows, torch.from_numpy(g[4 * d : 4 * d + 4]))[0].numpy())
    np.testing.assert_allclose(np.concatenate(got), np.asarray(want), rtol=1e-5)
    np.testing.assert_allclose(np.concatenate(got_g), np.asarray(want_g), rtol=1e-4, atol=1e-6)
    # offset 0 over the whole batch: the unsharded call, bit for bit
    whole = losses.CLUSTER_LOSSES[name](torch.from_numpy(x), B)
    np.testing.assert_array_equal(losses.CLUSTER_LOSSES[name](torch.from_numpy(x), B, 0).numpy(), whole.numpy())


# ----------------------------------------------------------------------
# the 2x2 group: ops, train steps, the cluster validation's lists
# ----------------------------------------------------------------------
def _op_inputs(rng) -> dict:
    inp = {}
    B, H, N = 8, 6, 40
    inp["gc_h"] = rng.normal(size=(B, H)).astype(np.float32)
    inp["gc_w"] = rng.normal(size=(H, N)).astype(np.float32)
    inp["gc_b"] = rng.normal(size=N).astype(np.float32)
    inp["gc_cols"] = np.concatenate([rng.integers(0, N, 12), [0, N - 1, N // 2, N // 2 - 1, 3, 3]]).astype(np.int64)
    inp["gc_cot"] = rng.normal(size=(B, len(inp["gc_cols"]))).astype(np.float32)
    # tests/test_parallel.py's streaming-margin inputs (at seed 11 there)
    B, H, N, T, L = 16, 8, 4096, 2, 6
    inp["sm_h"] = rng.normal(size=(B, H)).astype(np.float32)
    inp["sm_w"] = (rng.normal(size=(H, N)) * 0.1).astype(np.float32)
    inp["sm_b"] = (rng.normal(size=N) * 0.1).astype(np.float32)
    tgt = rng.integers(0, N, size=(B, T)).astype(np.int32)
    tgt[::3, -1] = N
    seen = rng.integers(0, N, size=(B, L)).astype(np.int32)
    seen[::2, -2:] = N
    seen[1, 0] = tgt[1, 0]  # a seen target: seen overrides
    inp["sm_tgt"], inp["sm_seen"] = tgt, seen
    inp["sm_w_neg"] = (rng.random(B) * 0.01 + 0.001).astype(np.float32)
    inp["sm_dt"] = (rng.random(N) * 0.3).astype(np.float32)
    return inp


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


def _jax_leaves(params) -> dict:
    leaves = {key: params[key] for key in ("W_out", "b_out", "cluster_repartition", "item_embeddings", "W0")
              if key in params}
    if "tower" in params:
        leaves["W_in"] = params["tower"]["layer0_fwd"]["W_in"]
        if "embedding" in params["tower"]:
            leaves["embedding"] = params["tower"]["embedding"]
    return {k: np.asarray(v) for k, v in leaves.items()}


def _ties_inputs(handler, inp) -> None:
    """A cluster of 5 items that holds every user (W_cs = 0: argmax 0):
    the restricted top-10 fills with items at exactly 0, by id
    (``test_torch_cluster.py:test_cluster_eval_ties_at_zero_match_jax``),
    on an eval chunk of the 12 validation users."""
    probe = _jax_model(TIES_CASE, handler)
    tree = probe._init_params()
    n = tree["cluster_repartition"].shape[0]
    rep = np.full((n, 4), -5.0, dtype=np.float32)
    rep[:5, 0] = 5.0
    rep[5:, 1 + np.arange(n - 5) % 3] = 5.0
    inp["ties_rep"], inp["ties_W_cs"] = rep, np.zeros_like(tree["W_cs"])
    seqs = [s for s, _, _ in probe._iter_test_instances(handler.validation_set(epochs=1))]
    assert len(seqs) == 12
    ids, id_mask, mask = probe._encode_sequences(seqs)
    assert id_mask is None
    S = max(len(s) for s in seqs)
    seen = np.zeros((12, S), np.int32)
    seen_mask = np.zeros((12, S), np.float32)
    for row, s in enumerate(seqs):
        seen[row, : len(s)] = [int(i[0]) for i in s]
        seen_mask[row, : len(s)] = 1.0
    inp.update(ties_ids=ids, ties_mask=mask, ties_seen=seen, ties_seen_mask=seen_mask)


@pytest.fixture(scope="module")
def head_results(tmp_path_factory, synthetic_dataset, synthetic_handler):
    import seqrec_tpu.ops.streaming_margin as jax_sm

    out = tmp_path_factory.mktemp("mesh_heads")
    rng = np.random.default_rng(11)
    inp = _op_inputs(rng)
    batches = {}
    for name, spec in HEAD_CASES.items():
        probe = _jax_model(spec, synthetic_handler)
        batches[name] = next(probe._gen_mini_batch(synthetic_handler.training_set(epochs=10)))
        inp.update({f"batch_{name}/{k}": np.asarray(v) for k, v in batches[name].items()})
    _ties_inputs(synthetic_handler, inp)
    np.savez(out / "inputs.npz", **inp)
    with open(out / "args.json", "w") as f:
        json.dump({"dataset": synthetic_dataset, "cases": HEAD_CASES, "ties_case": TIES_CASE}, f)
    ranks = _start("heads", 4, out)

    # the JAX package's references, while the ranks run
    want = {}
    saved = jax_sm.STREAMING_MARGIN_MIN_ITEMS
    try:
        for name, spec in HEAD_CASES.items():
            jax_sm.STREAMING_MARGIN_MIN_ITEMS = 1 if spec["kw"].get("streaming") else saved
            model = _jax_model(spec, synthetic_handler)
            if spec["cls"] == "RNNMargin":
                assert model._use_streaming_head() == bool(spec["kw"].get("streaming"))
            params, _, cost = model._train_step(model.params, model.opt_state, batches[name])
            want[name] = (float(cost), _jax_leaves(params))
    finally:
        jax_sm.STREAMING_MARGIN_MIN_ITEMS = saved
    ties = _jax_model(TIES_CASE, synthetic_handler)
    params = dict(ties.params, W_cs=jnp.asarray(inp["ties_W_cs"]), cluster_repartition=jnp.asarray(inp["ties_rep"]))
    want["ties"] = [np.asarray(a) for a in jax.jit(ties._cluster_eval_topk)(
        params, inp["ties_ids"], None, inp["ties_mask"], inp["ties_seen"], inp["ties_seen_mask"])]

    _wait("heads", ranks)
    got = []
    for r in range(4):
        with np.load(out / f"heads_rank{r}.npz") as f:
            got.append(dict(f))
    return inp, got, want


def test_gather_columns_matches_jax(head_results):
    """The columns of every shard (ids at both shards' edges, repeated
    ids), the same on both model ranks and equal to W[:, cols]; the
    gradients of <h W[:, cols] + b[cols], cot> against jax.grad."""
    inp, ranks, _ = head_results
    h, w, b, cols, cot = (jnp.asarray(inp["gc_" + k]) for k in ("h", "w", "b", "cols", "cot"))
    for r in range(4):
        np.testing.assert_array_equal(ranks[r]["gc_w_cols"], inp["gc_w"][:, inp["gc_cols"]])
        np.testing.assert_array_equal(ranks[r]["gc_b_cols"], inp["gc_b"][inp["gc_cols"]])

    def f(h, w, b):
        return ((h @ jnp.take(w, cols, axis=1) + jnp.take(b, cols)) * cot).sum()

    dh, dw, db = jax.grad(f, argnums=(0, 1, 2))(h, w, b)
    for m in range(2):
        np.testing.assert_allclose(_rows(ranks, "gc_dh", m), np.asarray(dh), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(_cols_summed(ranks, "gc_dW", 1), np.asarray(dw), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(_cols_summed(ranks, "gc_db", 0), np.asarray(db), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("case", [("hinge", True), ("logsig", True), ("logit", False)], ids=["hinge", "logsig", "logit"])
def test_sharded_streaming_margin_matches_jax(head_results, case):
    """Each rank's 2,048 columns in chunks of 512 (hinge, logit) and of 600
    (logsig: a padded tail) against JAX's single-device op at 512, loss and
    gradients."""
    from seqrec_tpu.ops.streaming_margin import streaming_margin

    loss_name, unique = case
    inp, ranks, _ = head_results
    h, w, b = (jnp.asarray(inp["sm_" + k]) for k in ("h", "w", "b"))
    args = [jnp.asarray(inp["sm_" + k]) for k in ("tgt", "seen", "w_neg", "dt")]

    def ref(h, w, b):
        return streaming_margin(h, w, b, *args, loss_name, unique, 512).sum()

    want_loss, want = jax.value_and_grad(ref, argnums=(0, 1, 2))(h, w, b)
    key = f"sm_{loss_name}_"
    for m in range(2):  # the loss and dh are the same on both model ranks
        np.testing.assert_array_equal(_rows(ranks, key + "loss", m), _rows(ranks, key + "loss"))
        np.testing.assert_array_equal(_rows(ranks, key + "dh", m), _rows(ranks, key + "dh"))
    assert np.isclose(_rows(ranks, key + "loss").sum(), float(want_loss), rtol=1e-5)
    got = (_rows(ranks, key + "dh"), _cols_summed(ranks, key + "dW", 1), _cols_summed(ranks, key + "db", 0))
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w_), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("case", list(HEAD_CASES))
def test_mesh_head_train_step_matches_jax(head_results, case):
    """One step at a 2x2 mesh (each data rank 8 of the 16 rows, the catalog
    tables in two shards) against the JAX package's single-device step:
    the cost, and the gathered W_out, b_out, cluster_repartition,
    item_embeddings and first-layer weights (W_in, the embedding, SDA's
    W0), the same on every rank."""
    _, ranks, want = head_results
    cost, leaves = want[case]
    for r in range(4):
        assert np.isclose(float(ranks[r][f"{case}_cost"]), cost, rtol=1e-5)
        for key, value in leaves.items():
            np.testing.assert_allclose(ranks[r][f"{case}_{key}"], value, rtol=1e-4, atol=1e-6, err_msg=key)
    expected = {"W_out", "b_out"} | ({"cluster_repartition"} if "cluster" in case else set())
    assert expected <= set(leaves)


def test_mesh_cluster_eval_ties_match_jax(head_results):
    """The validation chunk split over "data", W_out and the memberships
    over "model": both merged top-10 lists, the argmax clusters and the
    used-item counts equal JAX's; the restricted list fills with the
    items at 0 by id."""
    _, ranks, want = head_results
    for m in range(2):
        for key, w in zip(("top1", "top2", "c_sel", "used"), want["ties"]):
            got = _rows(ranks, "ties_" + key, m)
            if key == "used":
                np.testing.assert_allclose(got, w, rtol=1e-6)
            else:
                np.testing.assert_array_equal(got, w, err_msg=key)
    top2 = _rows(ranks, "ties_top2")
    assert (top2[:, 5:] == np.arange(5, 10)).all()


# ----------------------------------------------------------------------
# two ranks through the CLIs
# ----------------------------------------------------------------------
# family: (model flags, train-only flags, the train CLI's mesh, the test CLI's mesh)
HEAD_CLI = {
    "bpr": (["-m", "RNN", "--loss", "BPR", "--sampling", "8", "--r_l", "16", "--max_length", "10", "-b", "8"],
            ["--spd", "2"], "1,2", "1,2"),
    "hinge_lstm": (["-m", "RNN", "--loss", "hinge", "--r_t", "LSTM", "--r_l", "16", "--max_length", "10", "-b", "8"],
                   [], "1,2", "2,1"),
    "cluster": (["-m", "RNN", "--clusters", "3", "--loss", "Blackout", "--sampling", "8", "--r_l", "16",
                 "--max_length", "10", "-b", "8", "--csn", "0.1"], [], "2,1", "1,2"),
    "fism_cluster": (["-m", "FISM", "--clusters", "3", "-H", "8", "--fism_alpha", "0.3", "--loss", "Blackout",
                      "--sampling", "8", "-b", "8"], [], "1,2", "1,2"),
    "sda": (["-m", "SDA", "-L", "12", "--in_do", "0.2", "--do", "0.3", "-b", "8"], [], "2,1", "1,2"),
}
TRAIN = ["--max_iter", "16", "--progress", "8", "--save", "All", "--device", "cpu"]


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = main(argv)
    return result, buf.getvalue()


@pytest.fixture(scope="module")
def head_cli_results(tmp_path_factory):
    from seqrec_tpu_torch.data.synthetic import make_dataset

    out = tmp_path_factory.mktemp("mesh_heads_cli")
    ds = make_dataset(str(out / "ds"), n_users=120, n_items=60, min_len=8, max_len=24, seed=3)
    # the single-device checkpoints first: the ranks' test CLI reads them
    single = {}
    runs = {}
    for name, (flags, extra, mesh, test_mesh) in HEAD_CLI.items():
        _, text = _run(torch_train_cli.main, ["-d", ds, *flags, *extra, *TRAIN, "--dir", f"single_{name}/"])
        test_argv = ["-d", ds, *flags, "--dir", f"single_{name}/", "--device", "cpu"]
        runs[name] = {"train": ["-d", ds, *flags, *extra, *TRAIN], "test": test_argv, "mesh": mesh,
                      "test_mesh": test_mesh}
        single[name] = [float(c) for c in re.findall(r"Last train cost :  (\S+)", text)]
    np.savez(out / "inputs.npz")
    with open(out / "args.json", "w") as f:
        json.dump({"dataset": ds, "runs": runs}, f)
    ranks = _start("heads_cli", 2, out)
    for name, run in runs.items():
        ev, _ = _run(torch_test_cli.main, run["test"])
        single[name] = (single[name], [[int(i) for i in pred] for _, pred in ev.instances])
    _wait("heads_cli", ranks)
    got = []
    for r in range(2):
        with open(out / f"heads_cli_rank{r}.json") as f:
            got.append(json.load(f))
    return single, got


@pytest.mark.parametrize("family", list(HEAD_CLI))
def test_two_rank_head_cli_matches_single_device(head_cli_results, family):
    """Both ranks' progress costs within 1e-4 of the single-device CLI's
    (the same batches and device draws), only rank 0's checkpoints, and
    the test CLI's lists at the mesh equal to the single-device ones."""
    single, ranks = head_cli_results
    costs, lists = single[family]
    assert len(costs) == 2 and len(lists) > 0
    for rank, res in enumerate(ranks):
        np.testing.assert_allclose(res[family]["costs"], costs, rtol=1e-4)
        assert res[family]["lists"] == lists
        assert len(res[family]["files"]) == (2 if rank == 0 else 0)
