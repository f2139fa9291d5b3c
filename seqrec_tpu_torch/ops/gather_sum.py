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
kernel (:func:`gather_sum_fwd`) and whose backward is one library call
(:func:`gather_sum_bwd`): the slots sorted by row on the device, chunks of
S slots of one row summed, then each row of the dense gradient written
once. Without a gradient to take (eval), only the forward kernel runs.
The ids alone fix the order of every sum, so two calls give the same
bits; there are no float atomics.
"""

from __future__ import annotations

import ctypes
import math

import torch

from seqrec_tpu_torch.ops import _build
from seqrec_tpu_torch.ops.core import check_tensors, on_device
from seqrec_tpu_torch.ops.core import gather_sum as gather_sum_plain
from seqrec_tpu_torch.ops.core import gather_sum_table_grad as gather_sum_table_grad_plain

SEGMENT = 32  # S: the most slots of one row one chunk sums (csrc/gather_sum.cu's kS, a warp's width)
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
    ll = ctypes.c_longlong
    lib.seqrec_gather_sum_bwd_f32.argtypes = [vp, vp, ci, vp, vp, ll, vp, ll, ci, ci, ci, vp]
    lib.seqrec_gather_sum_bwd_f32.restype = ci
    _lib = lib
    return lib


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check(fn, table, ids, id_mask):
    if table.dim() != 2 or ids.dim() < 1 or ids.dtype not in _ID_BYTES:
        raise ValueError(f"{fn}: table must be [N, D] and ids an int16, int32 or int64 tensor [..., F]")
    expected = {"table": (table, torch.float32, tuple(table.shape)), "ids": (ids, ids.dtype, tuple(ids.shape))}
    if id_mask is not None:
        expected["id_mask"] = (id_mask, torch.float32, tuple(ids.shape))
    check_tensors(fn, table.device, expected)


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


def bwd_scratch_bytes(n_slots: int, n_rows: int, D: int) -> int:
    """Bytes of the backward's scratch for ``n_slots`` slots and a table of
    ``n_rows`` rows of D columns: the chunk partials [2 ceil(P / S), D]
    f32, then row_start [N + 1], the sorted slots and their rows [P] each,
    int32 (``csrc/gather_sum.cu:bwd_scratch_bytes``, against which the
    library checks the size it is given)."""
    return 4 * (2 * -(-n_slots // SEGMENT) * D + n_rows + 1 + 2 * n_slots)


def gather_sum_bwd(g, ids, id_mask, n_rows: int):
    """The backward kernels: the dense gradient [n_rows, D] of the table
    from the cotangent g [..., D] (f32) of the forward's output, ids [...,
    F] (int16, int32 or int64) and id_mask [..., F] (f32 or None), all
    contiguous on one CUDA device. One library call of three kernels and no
    host sync: the slots sorted by row on the device, chunk sums, then each
    row written once, in the order ``csrc/gather_sum.cu`` documents."""
    if ids.dim() < 1 or ids.dtype not in _ID_BYTES:
        raise ValueError("gather_sum_bwd: ids must be an int16, int32 or int64 tensor [..., F]")
    D = g.shape[-1]
    expected = {"g": (g, torch.float32, (*ids.shape[:-1], D)), "ids": (ids, ids.dtype, tuple(ids.shape))}
    if id_mask is not None:
        expected["id_mask"] = (id_mask, torch.float32, tuple(ids.shape))
    check_tensors("gather_sum_bwd", g.device, expected)
    dtable = torch.empty((n_rows, D), dtype=torch.float32, device=g.device)
    P0, F = math.prod(ids.shape[:-1]), ids.shape[-1]
    if n_rows == 0 or D == 0:
        return dtable
    if P0 * F == 0:
        return dtable.zero_()
    n_bytes = bwd_scratch_bytes(P0 * F, n_rows, D)
    scratch = torch.empty(n_bytes, dtype=torch.uint8, device=g.device)
    with on_device(g.device):
        err = _library().seqrec_gather_sum_bwd_f32(
            g.data_ptr(), ids.data_ptr(), _ID_BYTES[ids.dtype], _ptr(id_mask), scratch.data_ptr(), n_bytes,
            dtable.data_ptr(), P0, F, n_rows, D, torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"gather_sum_bwd kernel launch failed with CUDA error {err}")
    gather_sum_bwd.launches += 1
    return dtable


gather_sum_fwd.launches = 0
gather_sum_bwd.launches = 0


def gather_sum_table_grad(g, ids, id_mask, n_rows: int):
    """The table's gradient [n_rows, D] from the cotangent g [..., D] of the
    forward's output, ids [..., F] and id_mask [..., F] or None. CPU
    tensors: the plain version (``index_add_``); CUDA tensors: the kernels
    (:func:`gather_sum_bwd`)."""
    if g.device.type == "cpu":
        return gather_sum_table_grad_plain(g, ids, id_mask, n_rows)
    return gather_sum_bwd(g, ids, id_mask, n_rows)


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


def sharded_gather_sum(table, ids, id_mask, mesh, offset: int):
    """:func:`gather_sum` of a table whose rows are sharded over the mesh's
    "model" axis: ``table`` holds rows ``[offset, offset + n)`` of the full
    table. Each shard gathers its own rows, with the ids localized by the
    offset and every slot that another shard owns made a pad slot (-1:
    adds 0, gets no gradient, in the kernels as in the plain version), and
    the partial sums are reduced over "model"
    (``parallel/collectives.py:reduce_from_model``). The backward scatters
    only into the local rows. The ids keep their dtype (int16 stays int16:
    the localized ids lie in (-N, N))."""
    from seqrec_tpu_torch.parallel.collectives import reduce_from_model

    local = ids - offset
    local = torch.where((local >= 0) & (local < table.shape[0]), local, torch.full_like(local, -1))
    return reduce_from_model(gather_sum(table, local, id_mask), mesh)
