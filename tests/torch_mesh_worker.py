"""Worker process of ``tests/test_torch_mesh.py``: one rank of a gloo
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


def cli(out, inp, args):
    """The train CLI at --mesh 2,1 --spd 2, the test CLI of the
    factorization family at --mesh 1,2, and the refusals."""
    import seqrec_tpu_torch.cli.test as test_cli
    import seqrec_tpu_torch.cli.train as train_cli

    rank = dist.get_rank()
    res = {}
    _, text = _cli(train_cli.main, args["train_argv"] + ["--dir", f"rank{rank}/"])
    res["costs"] = [float(c) for c in re.findall(r"Last train cost :  (\S+)", text)]
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


SCENARIOS = {"ops": ops, "step": step, "cli": cli}


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
