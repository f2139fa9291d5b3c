"""Training CLI: ``python -m seqrec_tpu_torch.cli.train``.

Same flags as ``seqrec_tpu/cli/train.py`` (``-d DATASET_DIR -m RNN --loss
CCE --save Best ...``), plus ``--device {cuda,cuda:N,cpu}``: it trains on
CUDA unless ``--device cpu`` is given, and a missing GPU is an error. It writes
the JAX package's checkpoints (same filenames and ``.npz`` keys) under
``DATASET_DIR/models/``. ``--profile DIR`` records the run with
``torch.profiler`` (host and, on the card, CUDA activity) and writes a
Chrome trace, ``DIR/trace.json``, with the training loop's spans
(``utils/tracing.py``): the main thread's as the profiler recorded them,
the assembly and transfer threads' added on the trace's clock. ``--spd K`` runs K optimizer steps a
dispatch where the predictor has ``steps_per_dispatch`` (the RNN family;
the factorization family and LTM take the flag and ignore it, as in the
JAX package). ``--mesh DATA,MODEL`` (or ``auto``) trains over a
("data", "model") mesh of ``torch.distributed`` ranks, one process a rank:

    torchrun --nproc_per_node N -m seqrec_tpu_torch.cli.train ... --mesh D,M

(NCCL, rank r on ``cuda:LOCAL_RANK``; with ``--device cpu``, gloo). It
takes every head of ``-m RNN`` (CCE, the sampled BPR/TOP1/Blackout, the
margin hinge/logit/logsig, each with its dense and streaming head where it
has both, ``--clusters N``; either tower, ``--r_emb``, ``--mf``/``--uf``,
``--spd``, ``--lazy_updates``, ``--bf16`` and ``--u_moments bfloat16``),
``-m FISM --clusters N`` and ``-m SDA``; the factorization family shards
its evaluation only.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import re

import numpy as np

import seqrec_tpu_torch.utils.command_parser as parse
from seqrec_tpu_torch import resolve_device
from seqrec_tpu_torch.data import DataHandler
from seqrec_tpu_torch.utils import tracing


def training_command_parser(parser):
    parser.add_argument(
        "--tshuffle", help="Shuffle sequences during training.", action="store_true"
    )
    parser.add_argument(
        "--extended_set",
        help="Use extended training set (first half of validation and test users).",
        action="store_true",
    )
    parser.add_argument(
        "-d", dest="dataset", help="Directory name of the dataset.", default="", type=str
    )
    parser.add_argument(
        "--dir", help="Directory name to save model.", default="", type=str
    )
    parser.add_argument(
        "--save",
        choices=["All", "Best", "None"],
        help="Policy for saving models.",
        default="Best",
    )
    parser.add_argument(
        "--metrics",
        help="Metrics for validation, comma separated",
        default="sps",
        type=str,
    )
    parser.add_argument(
        "--time_based_progress",
        help="Progress based on time instead of iterations.",
        action="store_true",
    )
    parser.add_argument(
        "--load_last_model",
        help="Load last model before starting training.",
        action="store_true",
    )
    parser.add_argument("--progress", help="Progress intervals", default="2.", type=str)
    parser.add_argument(
        "--mpi", help="Max progress intervals", default=np.inf, type=float
    )
    parser.add_argument(
        "--max_iter", help="Max number of iterations", default=np.inf, type=float
    )
    parser.add_argument(
        "--max_time", help="Max training time in seconds", default=np.inf, type=float
    )
    parser.add_argument(
        "--min_iter",
        help="Min iterations before showing progress",
        default=0.0,
        type=float,
    )
    parser.add_argument(
        "--profile",
        help="Write a torch.profiler Chrome trace of the training run into this directory.",
        default="",
        type=str,
    )
    parser.add_argument(
        "--spd",
        dest="steps_per_dispatch",
        help="Optimizer steps fused into one device dispatch.",
        default=1,
        type=int,
    )
    parser.add_argument(
        "--mesh",
        help='Shard training over a ("data","model") device mesh: "DATA,MODEL" or "auto".',
        default="",
        type=str,
    )
    parser.add_argument(
        "--device",
        type=device_arg,
        help="Device to train on (cuda, cuda:N or cpu); cuda raises when no GPU is present. Under --mesh, "
        "cuda is cuda:LOCAL_RANK.",
        default="cuda",
    )


def device_arg(value: str) -> str:
    """--device: ``cuda``, ``cuda:N`` or ``cpu``."""
    if not re.fullmatch(r"cpu|cuda(:\d+)?", value):
        raise argparse.ArgumentTypeError(f"invalid device {value!r} (choose from cuda, cuda:N, cpu)")
    return value


def make_cli_mesh(spec: str, device="cuda"):
    """The ("data", "model") mesh of a --mesh spec: ``"auto"`` or
    ``"DATA,MODEL"``, over the ranks of torchrun's process group (joined
    here; one rank without one), ``device`` the ranks' device type."""
    from seqrec_tpu_torch.parallel import init_distributed, make_mesh, make_pod_mesh

    distributed = init_distributed(device=device)
    if spec == "auto":
        return make_pod_mesh(device=device) if distributed else make_mesh(device=device)
    try:
        n_data, n_model = (int(x) for x in spec.split(","))
    except ValueError:
        raise ValueError(f'--mesh must be "auto" or "DATA,MODEL" (e.g. "4,2"), got {spec!r}') from None
    if distributed:
        import torch.distributed as dist

        world = dist.get_world_size()
        if n_data * n_model != world:
            raise ValueError(
                f"--mesh {spec} asks for {n_data}x{n_model} devices but the pod exposes {world // n_model}x{n_model}"
            )
        return make_pod_mesh(n_model=n_model, device=device)
    return make_mesh(n_data=n_data, n_model=n_model, device=device)


def num(s):
    try:
        return int(s)
    except ValueError:
        return float(s)


def main(argv=None):
    """Run the CLI; returns ``predictor.train``'s (best metrics, seconds,
    best checkpoint file)."""
    args = parse.command_parser(
        parse.predictor_command_parser,
        training_command_parser,
        parse.early_stopping_command_parser,
        argv=argv,
    )
    mesh = make_cli_mesh(args.mesh, args.device) if args.mesh else None
    if mesh is not None:
        args.device = str(mesh.device)
    resolve_device(args.device)
    predictor = parse.get_predictor(args)
    dataset = DataHandler(
        dirname=args.dataset,
        extended_training_set=args.extended_set,
        shuffle_training=args.tshuffle,
    )
    predictor.prepare_model(dataset)
    if mesh is not None:
        if not hasattr(predictor, "set_mesh"):
            raise ValueError(
                f"--mesh is supported for the RNN/SDAE/cluster families (sharded training) and the MF family "
                f"(sharded eval top-k); {predictor.name!r} runs single-device"
            )
        predictor.set_mesh(mesh)
    if args.steps_per_dispatch > 1 and hasattr(predictor, "steps_per_dispatch"):
        predictor.steps_per_dispatch = args.steps_per_dispatch
    profiler = contextlib.nullcontext()
    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if resolve_device(args.device).type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        profiler = profile(activities=activities)
    with profiler:
        result = predictor.train(
            dataset,
            save_dir=dataset.dirname + "models/" + args.dir,
            time_based_progress=args.time_based_progress,
            progress=num(args.progress),
            autosave=args.save,
            max_progress_interval=args.mpi,
            max_iter=args.max_iter,
            min_iterations=args.min_iter,
            max_time=args.max_time,
            early_stopping=parse.get_early_stopper(args),
            load_last_model=args.load_last_model,
            validation_metrics=args.metrics.split(","),
        )
    if args.profile:
        os.makedirs(args.profile, exist_ok=True)
        path = os.path.join(args.profile, "trace.json")
        profiler.export_chrome_trace(path)
        tracing.add_to_chrome_trace(path)
        print("Profiler trace written to", args.profile)
    return result


if __name__ == "__main__":
    try:
        main()
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()
