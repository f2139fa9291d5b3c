"""Process-group initialization and the pod layout of the mesh.

Counterpart of ``seqrec_tpu/parallel/distributed.py``. The port runs one
process per rank, launched by ``torchrun`` (``torchrun --nproc_per_node N
-m seqrec_tpu_torch.cli.train ... --mesh D,M``), which sets ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` and
``MASTER_PORT``:

- :func:`init_distributed` joins the ranks into one ``torch.distributed``
  process group: NCCL for a CUDA rank, gloo for a CPU rank, unless the
  caller names the backend. It is a no-op without those variables, and it
  leaves a process group that already exists alone;
- :func:`rank_device` is the rank's device: the one asked for when it has
  an index (``--device cuda:0``), else ``cuda:LOCAL_RANK``; a rank is never
  moved to another card or to the CPU;
- :func:`make_pod_mesh` lays out the ("data", "model") mesh with the
  "model" axis (the catalog tables' shards, which reduce every step)
  packed inside each host: torchrun numbers the ranks of a host
  contiguously, and a model group is ``M`` consecutive ranks.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from seqrec_tpu_torch import resolve_device

TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0"))


def rank_device(device="cuda") -> torch.device:
    """This rank's device: ``device`` itself when it names one (``cpu``,
    ``cuda:N``), else ``cuda:LOCAL_RANK``. Raises when that card does not
    exist."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank())
    if dev.type == "cuda" and dev.index >= torch.cuda.device_count():
        raise RuntimeError(
            f"rank device {dev}: this host has {torch.cuda.device_count()} CUDA devices "
            "(one rank per card under NCCL; name a card with --device cuda:N)"
        )
    return dev


def init_distributed(backend: str | None = None, device="cuda") -> bool:
    """Join torchrun's ranks into the default process group; True when one
    exists (also one that the caller created before). ``backend``: NCCL
    when the rank's device is a card, gloo on the CPU, unless named. Under
    NCCL the rank's card (:func:`rank_device`) becomes the current
    device."""
    if dist.is_initialized():
        return True
    if any(key not in os.environ for key in TORCHRUN_ENV):
        return False
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(rank_device(device))
    dist.init_process_group(
        backend, init_method="env://", rank=int(os.environ["RANK"]), world_size=int(os.environ["WORLD_SIZE"])
    )
    return True


def make_pod_mesh(n_model: int | None = None, device="cuda"):
    """("data", "model") mesh over every rank of the process group, with
    ``n_model`` (by default the largest of 8, 4, 2, 1 that divides the
    ranks of a host) consecutive ranks a model group."""
    from seqrec_tpu_torch.parallel.mesh import make_mesh

    world = dist.get_world_size()
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if n_model is None:
        n_model = next(c for c in (8, 4, 2, 1) if local % c == 0)
    return make_mesh(world // n_model, n_model, device=device)


def writes_files() -> bool:
    """Whether this process writes checkpoints and result files: always
    outside a process group; in one, the rank with ``LOCAL_RANK`` 0 of
    each host (ranks on one host would race on the same files)."""
    return not dist.is_initialized() or local_rank() == 0
