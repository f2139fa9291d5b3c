"""The mesh's collectives, and the two differentiable ones of the sharded
ops.

A collective over an axis runs in the process group of the ranks that
share this rank's other coordinate (``Mesh.groups``); outside a process
group it is the identity. Only ``all_reduce`` (sum, max) and
``all_gather`` are used: gloo runs both on CUDA tensors too, which lets
two ranks share one card.

The pair of autograd functions is Megatron's conjugate pair:

- :func:`copy_to_model`: the identity forward, an all-reduce (sum) over
  "model" backward. A replicated activation that enters a shard-local
  product (``h`` before the column-sharded ``W_out``) gets the sum of the
  shards' cotangents;
- :func:`reduce_from_model`: an all-reduce (sum) over "model" forward, the
  identity backward. The partial sums of a row-sharded table (the
  gather-sum of ``W_in``'s local rows) become the full sum, and each shard
  takes the full cotangent.

The gradient rule of a mesh step (``models/base.py:_step``): each data
rank's loss is the mean over its ``B / D`` rows, replicated over "model"
(the sharded ops combine their partial statistics over "model" before
the loss), and every gradient is then averaged over "data"
(:func:`mean_over_data`). The mean over D equal shares of B / D rows is
the global mean over B rows of ``rnn_one_hot.py:_loss``. A term that does
not depend on the rows, as the ``b_out`` regularization, is the same on
every data rank, so its mean over "data" is itself: it enters once, as in
the global loss. Every term that sums over a sharded table goes through
:func:`reduce_from_model`, as that penalty does over ``b_out``'s shards:
the loss is then the same on every model rank, and each shard's gradient
is its own part of the global one.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def all_reduce(x: torch.Tensor, mesh, axis: str, op: str = "sum") -> torch.Tensor:
    """``x`` reduced over ``axis`` in place (and returned)."""
    group = mesh.groups[axis]
    if group is not None:
        dist.all_reduce(x, op=_OPS[op], group=group)
    return x


def all_gather(x: torch.Tensor, mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """The ranks' ``x`` along ``axis``, concatenated on ``dim`` in the order
    of their coordinate."""
    group = mesh.groups[axis]
    if group is None:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.shape[axis])]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def mean_over_data(tensors: list, mesh) -> None:
    """Average each tensor over "data" in place, as one all-reduce of their
    concatenation."""
    group = mesh.groups["data"]
    if group is None or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    flat /= mesh.shape["data"]
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(), ctx.mesh, "model"), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return all_reduce(x.clone(), mesh, "model")

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, mesh) -> torch.Tensor:
    return _CopyToModel.apply(x, mesh)


def reduce_from_model(x: torch.Tensor, mesh) -> torch.Tensor:
    return _ReduceFromModel.apply(x, mesh)
