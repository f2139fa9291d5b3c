"""The multi-hot input gather-sum, forward and backward, as CUDA kernels.

Counterpart of ``seqrec_tpu/ops/core.py:gather_sum``, which XLA compiles
to a gather and a scatter-add (not a Pallas kernel): the sum of ``table``
rows selected by ``ids`` over the last ids-axis, negative ids pad slots
that add 0 and get no gradient, ``id_mask`` entries multiplying their
rows; the gradient with respect to ``table`` is the dense [N, D] sum of
each slot's cotangent row, times its mask, into the row of its id.

On a CPU tensor :func:`gather_sum` runs ``ops/core.py:gather_sum``, the
plain version, differentiated by autograd, and :func:`gather_sum_table_grad`
its plain version with ``index_add_``. On a CUDA tensor it runs an
autograd Function whose forward launches ``csrc/gather_sum.cu``'s forward
kernel (:func:`gather_sum_fwd`) and whose backward sorts the slots by id
(:func:`segment_order`), cuts each id's run into chunks
(:func:`segment_plan`) and launches the two-pass segment sum
(:func:`gather_sum_bwd`). Without a gradient to take (eval), only the
forward kernel runs. The order of every sum is fixed by the sort and the
plan, so two calls give the same bits; there are no atomics.
"""

from __future__ import annotations

import ctypes
import math

import torch

from seqrec_tpu_torch.ops import _build
from seqrec_tpu_torch.ops.core import check_tensors, on_device
from seqrec_tpu_torch.ops.core import gather_sum as gather_sum_plain
from seqrec_tpu_torch.ops.core import gather_sum_table_grad as gather_sum_table_grad_plain

SEGMENT = 32  # S: the most slots of one id one chunk sums (the fastest of 8-512 on an H100, PERF.md)
_ID_BYTES = {torch.int16: 2, torch.int32: 4, torch.int64: 8}

_lib = None


def _library():
    global _lib
    if _lib is not None:
        return _lib
    lib = _build.load("gather_sum")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.seqrec_gather_sum_fwd_f32.argtypes = [vp, vp, ci, vp, vp, ctypes.c_longlong, ci, ci, ci, vp]
    lib.seqrec_gather_sum_fwd_f32.restype = ci
    lib.seqrec_gather_sum_bwd_f32.argtypes = [vp] * 7 + [ci] * 5 + [vp]
    lib.seqrec_gather_sum_bwd_f32.restype = ci
    _lib = lib
    return lib


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check(fn, table, ids, id_mask):
    check_tensors(fn, table.device, {"table": (table, torch.float32, tuple(table.shape))})
    if table.dim() != 2 or ids.dim() < 1 or ids.dtype not in _ID_BYTES:
        raise ValueError(f"{fn}: table must be [N, D] and ids an int16, int32 or int64 tensor [..., F]")
    check_tensors(fn, table.device, {"ids": (ids, ids.dtype, tuple(ids.shape))})
    if id_mask is not None:
        check_tensors(fn, table.device, {"id_mask": (id_mask, torch.float32, tuple(ids.shape))})


def gather_sum_fwd(table, ids, id_mask=None):
    """The forward kernel: [..., D] sums of table [N, D] (f32) rows at ids
    [..., F] (int16, int32 or int64; negative: a pad slot) times id_mask
    [..., F] (f32 or None), all contiguous on one CUDA device; the F slots
    are added in slot order (at F = 1 the rows themselves)."""
    _check("gather_sum_fwd", table, ids, id_mask)
    N, D = table.shape
    F = ids.shape[-1]
    P0 = math.prod(ids.shape[:-1])
    out = torch.empty((*ids.shape[:-1], D), dtype=torch.float32, device=table.device)
    if P0 == 0 or D == 0 or F == 0:
        return out.zero_()
    if N == 0:
        raise ValueError("gather_sum_fwd: the table has no rows")
    with on_device(table.device):
        err = _library().seqrec_gather_sum_fwd_f32(
            table.data_ptr(), ids.data_ptr(), _ID_BYTES[ids.dtype], _ptr(id_mask), out.data_ptr(), P0, F, N, D,
            torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"gather_sum_fwd kernel launch failed with CUDA error {err}")
    gather_sum_fwd.launches += 1
    return out


def segment_order(ids, n_rows: int):
    """(sorted ids int32 [P], perm int64 [P]) of the P = ids.numel() slots
    of ids, flattened: sorted by id, stably (each id's slots stay in
    ascending slot order), pad slots (negative ids) under the sentinel
    ``n_rows``, so they sort last."""
    flat = ids.reshape(-1).to(torch.int32)
    keys = torch.where(flat >= 0, flat, n_rows)
    return torch.sort(keys, stable=True)


def segment_plan(sorted_ids, n_rows: int, segment: int = SEGMENT):
    """How the backward sums each id's run of the sorted slots: (row_start
    [N + 1], row_chunk [N + 1]), int32, for N = ``n_rows`` and
    ``sorted_ids`` from :func:`segment_order`.

    - ``row_start[i]`` is the first sorted slot of id i (``row_start[N]``:
      the first pad slot); id i's run is [row_start[i], row_start[i + 1]).
    - A run of more than ``segment`` slots is cut into ceil(run / segment)
      chunks; id i owns chunks [row_chunk[i], row_chunk[i + 1]) (none for
      a run of at most ``segment`` slots), numbered in id order; its k-th
      chunk covers the slots [row_start[i] + k segment, that + segment),
      cut at the run's end. :func:`chunk_bound` bounds their count.

    The kernel's pass 1 sums each chunk in slot order; its pass 2 sums a
    row's chunk partials in chunk order, or a short run's slots in slot
    order. Every step is a device op: no host sync."""
    dev = sorted_ids.device
    row_start = torch.searchsorted(
        sorted_ids, torch.arange(n_rows + 1, dtype=torch.int32, device=dev), out_int32=True
    )
    run = row_start[1:] - row_start[:-1]
    row_chunk = torch.zeros(n_rows + 1, dtype=torch.int32, device=dev)
    torch.cumsum((run + segment - 1) // segment * (run > segment), 0, dtype=torch.int32, out=row_chunk[1:])
    return row_start, row_chunk


def chunk_bound(n_slots: int, segment: int = SEGMENT) -> int:
    """At most this many chunks for ``n_slots`` slots: an id of r >
    ``segment`` slots has ceil(r / segment) < 2 r / segment of them."""
    return 2 * n_slots // segment + 1


def gather_sum_bwd(g, perm, id_mask, plan, n_rows: int, F: int, segment: int = SEGMENT):
    """The backward kernels: the dense gradient [N, D] of the table from
    the cotangent g [..., D] of the forward's output, the slots' sorted
    order ``perm`` [P] (:func:`segment_order`), ``plan``
    (:func:`segment_plan` with this ``segment``) and id_mask [..., F] or
    None."""
    D = g.shape[-1]
    row_start, row_chunk = plan
    P = math.prod(g.shape[:-1]) * F
    check_tensors("gather_sum_bwd", g.device, {
        "g": (g, torch.float32, tuple(g.shape)), "perm": (perm, torch.int64, (P,)),
        "row_start": (row_start, torch.int32, (n_rows + 1,)), "row_chunk": (row_chunk, torch.int32, (n_rows + 1,)),
    })
    if id_mask is not None:
        check_tensors("gather_sum_bwd", g.device, {"id_mask": (id_mask, torch.float32, (*g.shape[:-1], F))})
    dtable = torch.empty((n_rows, D), dtype=torch.float32, device=g.device)
    if n_rows == 0 or D == 0:
        return dtable
    n_chunks = chunk_bound(P, segment)
    part = torch.empty((n_chunks, D), dtype=torch.float32, device=g.device)
    with on_device(g.device):
        err = _library().seqrec_gather_sum_bwd_f32(
            g.data_ptr(), perm.data_ptr(), _ptr(id_mask), row_start.data_ptr(), row_chunk.data_ptr(),
            part.data_ptr(), dtable.data_ptr(), n_chunks, n_rows, segment, F, D,
            torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"gather_sum_bwd kernel launch failed with CUDA error {err}")
    gather_sum_bwd.launches += 1
    return dtable


gather_sum_fwd.launches = 0
gather_sum_bwd.launches = 0


def gather_sum_table_grad(g, ids, id_mask, n_rows: int, segment: int = SEGMENT):
    """The table's gradient [n_rows, D] from the cotangent g [..., D] of the
    forward's output, ids [..., F] and id_mask [..., F] or None. CPU
    tensors: the plain version (``index_add_``); CUDA tensors: sort, plan,
    then the kernels."""
    if g.device.type == "cpu":
        return gather_sum_table_grad_plain(g, ids, id_mask, n_rows)
    sorted_ids, perm = segment_order(ids, n_rows)
    plan = segment_plan(sorted_ids, n_rows, segment)
    return gather_sum_bwd(g, perm, id_mask, plan, n_rows, ids.shape[-1], segment)


class _GatherSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ids, id_mask):
        ctx.save_for_backward(ids, id_mask)
        ctx.n_rows = table.shape[0]
        return gather_sum_fwd(table, ids, id_mask)

    @staticmethod
    def backward(ctx, g):
        ids, id_mask = ctx.saved_tensors
        return gather_sum_table_grad(g.contiguous(), ids, id_mask, ctx.n_rows), None, None


def gather_sum(table, ids, id_mask=None):
    """Sum of ``table`` [N, D] rows selected by ``ids`` [..., F] over the
    last ids-axis, ``id_mask`` [..., F] (or None) multiplying each slot;
    negative ids are pad slots. Returns [..., D], differentiable in
    ``table``. CPU tensors: the plain version; CUDA tensors: the kernels."""
    if table.device.type == "cpu":
        return gather_sum_plain(table, ids, id_mask)
    ids = ids.contiguous()
    id_mask = None if id_mask is None else id_mask.contiguous()
    if torch.is_grad_enabled() and table.requires_grad:
        return _GatherSum.apply(table, ids, id_mask)
    return gather_sum_fwd(table.detach(), ids, id_mask)
