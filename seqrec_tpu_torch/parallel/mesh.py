"""The ("data", "model") mesh over ``torch.distributed`` ranks, and its
sharding rules.

Counterpart of ``seqrec_tpu/parallel/mesh.py``. PyTorch has no GSPMD, so
the layout that the JAX package hands to its compiler is spelled out here
and in the sharded ops (``ops/gather_sum.py:sharded_gather_sum``,
``ops/streaming_cce.py:sharded_streaming_cce``,
``ops/streaming_margin.py:sharded_streaming_margin``,
``ops/losses.py:vocab_parallel_cce``, ``parallel/columns.py``,
``parallel/topk.py``):

- ranks form a ``D x M`` grid, rank ``d * M + m`` at (data ``d``, model
  ``m``), and each rank belongs to one process group along each axis
  (:class:`Mesh`);
- the dense tower weights are replicated and run data-parallel; the
  catalog-sized tables shard over "model" by parameter name
  (:func:`param_sharding`, the JAX package's ``_spec_for_param``):
  ``W_out`` by columns, ``b_out`` with it, the embedding, the first
  layer's ``W_in``, ``cluster_repartition``, FISMCluster's
  ``item_embeddings`` and the factorization item tables by rows; a table
  whose catalog does not divide the model axis stays replicated;
- a batch splits over "data" on its batch axis (axis 1 of a stacked
  ``[K, B]`` payload); the fields shared by the whole batch replicate
  (``_REPLICATED_BATCH_KEYS``).

The batch pipeline needs no collective, as ``put_global`` needs none in
the JAX package: every rank assembles the identical global batch from the
same seeds and keeps its own rows (:func:`batch_rows`,
:func:`stacked_rows`, :func:`index_payload_rows`). Collectives run on the
main thread only: the prefetch and transfer threads of ``models/base.py``
never call one (the JAX package documents the deadlock of a collective on
its prefetch thread, ``mesh.py:219-223``). Checkpoints are gathered from
the shards by :func:`gather_params`, a collective every rank reaches in
program order.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from seqrec_tpu_torch.parallel.collectives import all_gather
from seqrec_tpu_torch.parallel.distributed import rank_device


class Mesh:
    """A ``n_data x n_model`` grid of ranks: this rank's ``coords``, its
    ``device``, and per axis the process group of the ranks that share its
    other coordinate (``groups``; None outside a process group, where the
    mesh is one rank and every collective is the identity)."""

    def __init__(self, n_data: int, n_model: int, rank: int, device, groups: dict):
        self.shape = {"data": n_data, "model": n_model}
        self.coords = {"data": rank // n_model, "model": rank % n_model}
        self.device = device
        self.groups = groups

    @property
    def size(self) -> int:
        return self.shape["data"] * self.shape["model"]


def make_mesh(n_data: int | None = None, n_model: int | None = None, device="cuda") -> Mesh:
    """The ("data", "model") mesh over the ranks of the process group (one
    rank without one). With neither count given the catalog ("model")
    axis takes the largest of 8, 4, 2, 1 that divides the ranks. Every
    rank creates every group, in the same order (``dist.new_group``)."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if n_data is None and n_model is None:
        n_model = next(c for c in (8, 4, 2, 1) if n % c == 0)
        n_data = n // n_model
    elif n_data is None:
        n_data = n // n_model
    elif n_model is None:
        n_model = n // n_data
    if n_data * n_model != n:
        raise ValueError(f"mesh {n_data}x{n_model} != {n} devices")
    device = rank_device(device)
    groups = {"data": None, "model": None}
    rank = 0
    if dist.is_initialized():
        rank = dist.get_rank()
        members = {
            "model": [[d * n_model + m for m in range(n_model)] for d in range(n_data)],
            "data": [[d * n_model + m for d in range(n_data)] for m in range(n_model)],
        }
        for axis in ("model", "data"):
            for ranks in members[axis]:
                group = dist.new_group(ranks)
                if rank in ranks:
                    groups[axis] = group
    return Mesh(n_data, n_model, rank, device, groups)


# ----------------------------------------------------------------------
# sharding rules
# ----------------------------------------------------------------------
def _spec_for_param(path: tuple, ndim: int) -> tuple:
    """Per-dimension axis names of a parameter by its path (``()``:
    replicated), the JAX package's ``_spec_for_param``."""
    name = path[-1] if path else ""
    if name == "W_out":
        return (None, "model")
    if name == "b_out":
        return ("model",)
    if name == "embedding":
        return ("model", None)
    if name == "W_in" and any(k in ("layer0_fwd", "layer0_bwd") for k in path):
        return ("model", None)
    if name in ("item_embeddings", "cluster_repartition", "V", "H", "item_bias"):
        return ("model",) if ndim == 1 else ("model", None)
    return ()


def param_sharding(shapes: dict, mesh: Mesh, verbose: bool = True) -> dict:
    """``{state-dict key: spec}`` for ``{key: shape}``. A table whose
    sharded dimension does not divide the model axis is replicated
    (catalog sizes are arbitrary)."""
    specs = {}
    for key, shape in shapes.items():
        spec = _spec_for_param(tuple(key.split(".")), len(shape))
        if any(ax is not None and shape[i] % mesh.shape[ax] for i, ax in enumerate(spec)):
            if verbose:
                print(
                    f"mesh: {key.replace('.', '/')} {tuple(shape)} does not divide the "
                    f"model axis ({mesh.shape['model']}); replicating"
                )
            spec = ()
        specs[key] = spec
    return specs


def sharded_axis(spec: tuple):
    """The dimension a spec splits over "model", or None."""
    return spec.index("model") if "model" in spec else None


def shard_offset(size: int, mesh: Mesh, axis: str = "model") -> tuple[int, int]:
    """(first index, count) of this rank's part of a dimension of ``size``
    split evenly over ``axis``: a table's shard over "model", a batch's
    rows over "data"."""
    n = size // mesh.shape[axis]
    return mesh.coords[axis] * n, n


def _part(value, dim: int, mesh: Mesh, axis: str):
    """This rank's part of ``value`` (an array or a tensor) on dimension
    ``dim``, split over ``axis``: a view."""
    start, n = shard_offset(value.shape[dim], mesh, axis)
    index = [slice(None)] * value.ndim
    index[dim] = slice(start, start + n)
    return value[tuple(index)]


def shard_params(state: dict, specs: dict, mesh: Mesh) -> dict:
    """This rank's slices of a full ``{key: array or tensor}`` tree."""
    out = {}
    for key, value in state.items():
        dim = sharded_axis(specs[key])
        if dim is None:
            out[key] = value
            continue
        part = _part(value, dim, mesh, "model")
        out[key] = part.contiguous() if isinstance(part, torch.Tensor) else np.ascontiguousarray(part)
    return out


def gather_params(state: dict, specs: dict, mesh: Mesh) -> dict:
    """The full ``{key: tensor}`` tree from this rank's shards: each
    sharded leaf gathered over "model" (a collective: every rank calls it,
    in the same order)."""
    out = {}
    for key, value in state.items():
        axis = sharded_axis(specs.get(key, ()))
        out[key] = value if axis is None else all_gather(value, mesh, "model", dim=axis)
    return out


# ----------------------------------------------------------------------
# batches: every rank holds the global batch and keeps its rows
# ----------------------------------------------------------------------
# fields shared across the whole batch (negative-sample sets, the margin
# default-target vector, per-step scalars): replicated, never split
_REPLICATED_BATCH_KEYS = {
    "samples",
    "cluster_samples",
    "default_target",
    "scale",
    "noise_seed",
    "dropout_seed",
}


def batch_rows(batch: dict, mesh: Mesh) -> dict:
    """This rank's rows (axis 0) of a host batch; replicated keys, scalars
    and non-array fields as they are."""
    return {
        key: value if key in _REPLICATED_BATCH_KEYS or np.ndim(value) == 0
        else _part(np.asarray(value), 0, mesh, "data")
        for key, value in batch.items()
    }


def stacked_rows(payload: dict, mesh: Mesh) -> dict:
    """This rank's rows (axis 1) of a [K, B, ...] payload: per-example
    arrays split, per-step shared fields ([K] scalars, [K, S] sample
    sets) replicate."""
    return {
        key: _part(value, 1, mesh, "data") if key not in _REPLICATED_BATCH_KEYS and np.ndim(value) >= 2 else value
        for key, value in payload.items()
    }


def index_payload_rows(payload: dict, mesh: Mesh) -> dict:
    """This rank's (rows, cuts) of a [K, B] index-wire payload (axis 1);
    the per-step extras, whatever their shape, replicate."""
    return {key: _part(value, 1, mesh, "data") if key in ("rows", "cuts") else value for key, value in payload.items()}
