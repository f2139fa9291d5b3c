"""Worker process of ``tests/test_torch_mesh.py``,
``tests/test_torch_mesh_heads.py`` and ``tests/test_torch_mesh_precision.py``:
one rank of a gloo
process group on the CPU, running the port (and only the port: no JAX)
under a ("data", "model") mesh.

    python tests/torch_mesh_worker.py SCENARIO DIR

with torchrun's variables (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) set by the test.
Inputs come from ``DIR/inputs.npz`` (and ``DIR/args.json``); each rank
writes its results to ``DIR/SCENARIO_rank{RANK}.npz`` (or ``.json``).
"""

import contextlib
import io
import json
import os
import re
import sys
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from seqrec_tpu_torch.parallel import batch_rows, init_distributed, make_mesh  # noqa: E402
from seqrec_tpu_torch.parallel.mesh import shard_offset  # noqa: E402


def _rows(x, mesh):
    n = x.shape[0] // mesh.shape["data"]
    return x[mesh.coords["data"] * n : (mesh.coords["data"] + 1) * n]


def _cols(x, mesh, axis):
    start, n = shard_offset(x.shape[axis], mesh)
    return x.narrow(axis, start, n).contiguous()


def ops(out, inp, args):
    """The sharded ops at a 2x2 mesh on this rank's rows and shard."""
    from seqrec_tpu_torch.ops.gather_sum import sharded_gather_sum
    from seqrec_tpu_torch.ops.streaming_cce import sharded_streaming_cce
    from seqrec_tpu_torch.parallel.topk import sharded_score_topk

    mesh = make_mesh(2, 2, device="cpu")
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    res = {}
    # the streaming CCE: loss rows, dh rows, dW and db columns (sum over the rank's rows)
    for case in ("cce", "cce_own"):
        h = _rows(t[case + "_h"], mesh).clone().requires_grad_(True)
        W = _cols(t[case + "_w"], mesh, 1).requires_grad_(True)
        b = _cols(t[case + "_b"], mesh, 0).requires_grad_(True)
        start, _ = shard_offset(t[case + "_w"].shape[1], mesh)
        loss = sharded_streaming_cce(h, W, b, _rows(t[case + "_t"], mesh), mesh, start)
        loss.sum().backward()
        res.update({case + "_loss": loss.detach(), case + "_dh": h.grad, case + "_dW": W.grad, case + "_db": b.grad})
    # the top-k: random scores (k = 5, and k = 70 past K4's list), and the tie case
    for case, ks in (("topk", (5, 70)), ("ties", (6,))):
        for k in ks:
            w = t[case + "_w"]
            v, i = sharded_score_topk(mesh, _rows(t[case + "_h"], mesh), _cols(w, mesh, 1),
                                      _cols(t[case + "_b"], mesh, 0), _rows(t[case + "_seen"], mesh),
                                      _rows(t[case + "_seen_mask"], mesh), k=k)
            res[f"{case}_{k}_ids"], res[f"{case}_{k}_values"] = i, v
    # the row-sharded gather-sum and the gradient of <out, cotangent>
    table = _cols(t["gs_table"], mesh, 0).requires_grad_(True)
    start, _ = shard_offset(t["gs_table"].shape[0], mesh)
    ids = _rows(t["gs_ids"], mesh)
    assert ids.dtype == torch.int16
    y = sharded_gather_sum(table, ids, _rows(t["gs_mask"], mesh), mesh, start)
    (y * _rows(t["gs_cot"], mesh)).sum().backward()
    res.update(gs_out=y.detach(), gs_dtable=table.grad)
    np.savez(os.path.join(out, f"ops_rank{dist.get_rank()}.npz"), **{k: v.numpy() for k, v in res.items()})


# (tower, embedding size, streaming head) of each train-step variant
STEP_VARIANTS = {"dense": ("GRU", 0, False), "streaming": ("GRU", 0, True), "lstm": ("LSTM", 0, False),
                 "emb": ("GRU", 8, False)}


def step(out, inp, args):
    """One train step of RNNOneHot at a 2x2 mesh on the rows of the given
    batch, per variant (the dense and the streaming head, the LSTM tower,
    --r_emb 8: the embedding and the first W_in by rows); rank 0 writes the
    global cost and the gathered W_out, b_out and input table."""
    from seqrec_tpu_torch.data import DataHandler
    from seqrec_tpu_torch.models.recurrent import RecurrentLayers
    from seqrec_tpu_torch.models.rnn_one_hot import RNNOneHot
    from seqrec_tpu_torch.models.updates import Adam

    mesh = make_mesh(2, 2, device="cpu")
    handler = DataHandler(args["dataset"])
    batch = {k[len("batch_"):]: v for k, v in inp.items() if k.startswith("batch_")}
    res = {}
    for name, (tower, emb, streaming) in STEP_VARIANTS.items():
        model = RNNOneHot(recurrent_layer=RecurrentLayers(layer_type=tower, layers=[16], embedding_size=emb),
                          updater=Adam(0.01), max_length=12, batch_size=16, seed=0, device="cpu")
        if streaming:
            model.streaming_min_items = 1
        model.prepare_model(handler)
        model.set_dataset(handler)
        model.set_mesh(mesh)
        model.params_from_numpy(model._init_params())
        shards = {"embedding"} if emb else {"layer0_fwd"}
        assert model._shard_start("W_out") is not None and shards <= set(model.recurrent_layer.input_shards)
        cost = model._step(model._device_batch(batch_rows(batch, mesh)))
        full = model.params_to_numpy()
        res.update({f"{name}_cost": cost.numpy(), f"{name}_W_out": full["W_out"], f"{name}_b_out": full["b_out"],
                    f"{name}_W_in": full["tower"]["layer0_fwd"]["W_in"]})
        if emb:
            res[f"{name}_embedding"] = full["tower"]["embedding"]
    if dist.get_rank() == 0:
        np.savez(os.path.join(out, "step_rank0.npz"), **res)


def _cli(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = main(argv)
    return result, buf.getvalue()


def _costs(text) -> list:
    return [float(c) for c in re.findall(r"Last train cost :  (\S+)", text)]


def cli(out, inp, args):
    """The train CLI at --mesh 2,1 --spd 2, the test CLI of the
    factorization family at --mesh 1,2, the train CLI's runs of
    ``args["runs"]`` (their progress costs) and the refusals."""
    import seqrec_tpu_torch.cli.test as test_cli
    import seqrec_tpu_torch.cli.train as train_cli

    rank = dist.get_rank()
    res = {}
    _, text = _cli(train_cli.main, args["train_argv"] + ["--dir", f"rank{rank}/"])
    res["costs"] = _costs(text)
    res["runs"] = {name: _costs(_cli(train_cli.main, argv + ["--dir", f"{name}_r{rank}/"])[1])
                   for name, argv in args.get("runs", {}).items()}
    res["mf_lists"] = {}
    for name, argv in args["mf_test_argv"].items():
        ev, _ = _cli(test_cli.main, argv + ["--mesh", "1,2"])
        res["mf_lists"][name] = [[int(i) for i in pred] for _, pred in ev.instances]
    refusals = {}
    for name, argv in args["refusals"].items():
        try:
            _cli(test_cli.main if name == "ltm" else train_cli.main, argv)
            refusals[name] = None
        except (ValueError, NotImplementedError) as exc:
            refusals[name] = [type(exc).__name__, str(exc)]
    res["refusals"] = refusals
    with open(os.path.join(out, f"cli_rank{rank}.json"), "w") as f:
        json.dump(res, f)


# ----------------------------------------------------------------------
# the sampled, margin and cluster heads and the autoencoder
# (tests/test_torch_mesh_heads.py)
# ----------------------------------------------------------------------
def head_model(spec, handler, mesh=None):
    """A port model of a case spec ``{"cls", "tower", "kw"}`` (the test's
    HEAD_CASES), prepared on ``handler``, on the mesh, from its own seed's
    initial parameters."""
    from seqrec_tpu_torch.models.cluster import FISMCluster, RNNCluster
    from seqrec_tpu_torch.models.recurrent import RecurrentLayers
    from seqrec_tpu_torch.models.rnn_margin import RNNMargin
    from seqrec_tpu_torch.models.rnn_one_hot import RNNOneHot
    from seqrec_tpu_torch.models.rnn_sampling import RNNSampling
    from seqrec_tpu_torch.models.sdae import StackedDenoisingAutoencoder
    from seqrec_tpu_torch.models.updates import Adam

    classes = {"RNNSampling": RNNSampling, "RNNMargin": RNNMargin, "RNNCluster": RNNCluster,
               "FISMCluster": FISMCluster, "SDA": StackedDenoisingAutoencoder, "RNNOneHot": RNNOneHot}
    kw = dict(spec["kw"])
    streaming = kw.pop("streaming", False)
    if spec["tower"]:
        kw["recurrent_layer"] = RecurrentLayers(layer_type=spec["tower"], layers=[16],
                                                embedding_size=spec.get("emb", 0))
    model = classes[spec["cls"]](updater=Adam(0.01, moment_dtype=spec.get("moments", "float32")), device="cpu",
                                 **kw)
    if streaming:
        model.streaming_min_items = 1
    model.prepare_model(handler)
    model.set_dataset(handler)
    model.set_mesh(mesh)
    model.params_from_numpy(model._init_params())
    return model


def _head_ops(inp, mesh, res):
    from seqrec_tpu_torch.ops.streaming_margin import sharded_streaming_margin
    from seqrec_tpu_torch.parallel.columns import gather_columns

    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    # the column gather: the gathered columns, and the gradients of <h W[:, cols] + b[cols], cot>
    h = _rows(t["gc_h"], mesh).clone().requires_grad_(True)
    W = _cols(t["gc_w"], mesh, 1).requires_grad_(True)
    b = _cols(t["gc_b"], mesh, 0).requires_grad_(True)
    start, _ = shard_offset(t["gc_w"].shape[1], mesh)
    w_cols, b_cols = gather_columns(W, b, t["gc_cols"], mesh, start)
    ((h @ w_cols + b_cols) * _rows(t["gc_cot"], mesh)).sum().backward()
    res.update(gc_w_cols=w_cols.detach(), gc_b_cols=b_cols.detach(), gc_dh=h.grad, gc_dW=W.grad, gc_db=b.grad)
    # the sharded streaming margin: loss rows, dh rows, dW and db columns
    for name, loss_name, unique, chunk in (("hinge", "hinge", True, 512), ("logsig", "logsig", True, 600),
                                          ("logit", "logit", False, 512)):
        h = _rows(t["sm_h"], mesh).clone().requires_grad_(True)
        W = _cols(t["sm_w"], mesh, 1).requires_grad_(True)
        b = _cols(t["sm_b"], mesh, 0).requires_grad_(True)
        start, n = shard_offset(t["sm_w"].shape[1], mesh)
        loss = sharded_streaming_margin(h, W, b, _rows(t["sm_tgt"], mesh).long(), _rows(t["sm_seen"], mesh).long(),
                                        _rows(t["sm_w_neg"], mesh), t["sm_dt"], mesh, start, loss_name, unique,
                                        chunk=chunk)
        loss.sum().backward()
        res.update({f"sm_{name}_loss": loss.detach(), f"sm_{name}_dh": h.grad, f"sm_{name}_dW": W.grad,
                    f"sm_{name}_db": b.grad})


def _head_leaves(model):
    full = model.params_to_numpy()
    leaves = {key: full[key] for key in ("W_out", "b_out", "cluster_repartition", "item_embeddings", "W0")
              if key in full}
    if "tower" in full:
        leaves["W_in"] = full["tower"]["layer0_fwd"]["W_in"]
        if "embedding" in full["tower"]:
            leaves["embedding"] = full["tower"]["embedding"]
    return leaves


def heads(out, inp, args):
    """At a 2x2 mesh: the column gather and the sharded streaming margin
    on this rank's rows and shard; one train step of each case of
    ``args["cases"]`` on the rows of its batch (the global cost and the
    gathered tables); the cluster validation on its rows of a chunk whose
    restricted list ties at 0."""
    from seqrec_tpu_torch.data import DataHandler

    mesh = make_mesh(2, 2, device="cpu")
    handler = DataHandler(args["dataset"])
    res = {}
    _head_ops(inp, mesh, res)
    for name, spec in args["cases"].items():
        model = head_model(spec, handler, mesh)
        assert model._shard_start("W_out") is not None
        batch = {k[len(name) + 7:]: v for k, v in inp.items() if k.startswith(f"batch_{name}/")}
        cost = model._step(model._device_batch(batch_rows(batch, mesh)))
        res[f"{name}_cost"] = cost
        res.update({f"{name}_{k}": torch.from_numpy(v) for k, v in _head_leaves(model).items()})
    # the cluster validation on a chunk whose restricted list ties at 0
    model = head_model(args["ties_case"], handler, mesh)
    tree = model.params_to_numpy()
    tree["W_cs"] = inp["ties_W_cs"]
    tree["cluster_repartition"] = inp["ties_rep"]
    model.params_from_numpy(tree)
    names = ("ids", "mask", "seen", "seen_mask")
    rows = batch_rows({k: inp["ties_" + k] for k in names}, mesh)
    got = model._cluster_eval_topk(*(torch.from_numpy(rows[k]) if k != "id_mask" else None
                                     for k in ("ids", "id_mask", "mask", "seen", "seen_mask")))
    for key, value in zip(("top1", "top2", "c_sel", "used"), got):
        res["ties_" + key] = value
    np.savez(os.path.join(out, f"heads_rank{dist.get_rank()}.npz"), **{k: v.numpy() for k, v in res.items()})


def heads_cli(out, inp, args):
    """Two ranks: each family's train CLI at its --mesh, and the test CLI
    at its own on the single-device run's checkpoint."""
    import seqrec_tpu_torch.cli.test as test_cli
    import seqrec_tpu_torch.cli.train as train_cli

    rank = dist.get_rank()
    res = {}
    for name, run in args["runs"].items():
        _, text = _cli(train_cli.main, run["train"] + ["--dir", f"mesh_{name}_r{rank}/", "--mesh", run["mesh"]])
        ev, _ = _cli(test_cli.main, run["test"] + ["--mesh", run["test_mesh"]])
        res[name] = {"costs": [float(c) for c in re.findall(r"Last train cost :  (\S+)", text)],
                     "lists": [[int(i) for i in pred] for _, pred in ev.instances],
                     "files": sorted(os.listdir(os.path.join(args["dataset"], "models", f"mesh_{name}_r{rank}")))
                     if os.path.isdir(os.path.join(args["dataset"], "models", f"mesh_{name}_r{rank}")) else []}
    with open(os.path.join(out, f"heads_cli_rank{rank}.json"), "w") as f:
        json.dump(res, f)


# ----------------------------------------------------------------------
# --lazy_updates, --bf16 and bf16 Adam moments on the mesh
# (tests/test_torch_mesh_precision.py)
# ----------------------------------------------------------------------
def _batch_of(inp, prefix):
    return {k[len(prefix):]: v for k, v in inp.items() if k.startswith(prefix)}


def precision(out, inp, args):
    """At a 2x2 mesh, per case of ``args["cases"]``: two train steps on the
    rows of its two batches; after each the global cost, the gathered
    tables and the gathered optimizer leaves (``_opt_leaves``), the same on
    every rank."""
    from seqrec_tpu_torch.data import DataHandler

    mesh = make_mesh(2, 2, device="cpu")
    handler = DataHandler(args["dataset"])
    res = {}
    for name, spec in args["cases"].items():
        model = head_model(spec, handler, mesh)
        for step in range(2):
            batch = _batch_of(inp, f"batch_{name}/{step}/")
            res[f"{name}/{step}/cost"] = model._step(model._device_batch(batch_rows(batch, mesh)))
            # copies: a replicated leaf is the live tensor, which the next step updates in place
            res.update({f"{name}/{step}/{k}": torch.tensor(v) for k, v in _head_leaves(model).items()})
            for i, leaf in enumerate(model._opt_leaves()):
                res[f"{name}/{step}/opt{i}"] = torch.as_tensor(leaf).clone()
    np.savez(os.path.join(out, f"precision_rank{dist.get_rank()}.npz"),
             **{k: (v.view(torch.int16) if v.dtype == torch.bfloat16 else v).numpy() for k, v in res.items()})


def precision_cli(out, inp, args):
    """Two ranks: one step of bf16-moment Adam at each of ``args["moments"]``'
    meshes (the gathered optimizer leaves); a lazy model at --mesh 1,2 that
    steps once and saves with its optimizer state (rank 0 writes), and a
    fresh one that loads that checkpoint there and steps again (its cost);
    then the train CLI's runs of ``args["runs"]`` (their progress costs)
    and the optimizer state of each model of ``args["refusals"]`` there."""
    import seqrec_tpu_torch.cli.train as train_cli
    from seqrec_tpu_torch.data import DataHandler

    rank = dist.get_rank()
    handler = DataHandler(args["dataset"])
    res = {}
    arrays = {}
    for shape in args["moments"]:
        mesh = make_mesh(*shape, device="cpu")
        model = head_model(args["moments_case"], handler, mesh)
        model._step(model._device_batch(batch_rows(_batch_of(inp, "moments/"), mesh)))
        for i, leaf in enumerate(model._opt_leaves()):
            leaf = torch.as_tensor(leaf)
            arrays[f"moments_{shape[0]}x{shape[1]}/opt{i}"] = (
                leaf.view(torch.int16) if leaf.dtype == torch.bfloat16 else leaf).numpy()
    mesh = make_mesh(1, 2, device="cpu")
    model = head_model(args["lazy_case"], handler, mesh)
    model.save_optimizer_state = True
    model._step(model._device_batch(batch_rows(_batch_of(inp, "lazy/0/"), mesh)))
    model.save(args["checkpoint"])
    dist.barrier()
    again = head_model(args["lazy_case"], handler, mesh)
    again.load(args["checkpoint"])
    res["lazy_next_cost"] = float(again._step(again._device_batch(batch_rows(_batch_of(inp, "lazy/1/"), mesh))))
    res["runs"] = {name: _costs(_cli(train_cli.main, argv + ["--dir", f"{name}_r{rank}/"])[1])
                   for name, argv in args["runs"].items()}
    refusals = {}
    for name, spec in args["refusals"].items():
        try:
            head_model(spec, handler, mesh)._init_opt_state()
            refusals[name] = None
        except ValueError as exc:
            refusals[name] = str(exc)
    res["refusals"] = refusals
    np.savez(os.path.join(out, f"precision_cli_rank{rank}.npz"), **arrays)
    with open(os.path.join(out, f"precision_cli_rank{rank}.json"), "w") as f:
        json.dump(res, f)


SCENARIOS = {"ops": ops, "step": step, "cli": cli, "heads": heads, "heads_cli": heads_cli, "precision": precision,
             "precision_cli": precision_cli}


def main() -> int:
    scenario, out = sys.argv[1:3]
    torch.set_num_threads(1)
    if not init_distributed(backend="gloo"):
        raise RuntimeError("no process group: torchrun's variables are missing")
    try:
        with np.load(os.path.join(out, "inputs.npz")) as f:
            inp = dict(f)
        args = {}
        if os.path.exists(os.path.join(out, "args.json")):
            with open(os.path.join(out, "args.json")) as f:
                args = json.load(f)
        SCENARIOS[scenario](out, inp, args)
    except Exception:
        traceback.print_exc()
        return 1
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
