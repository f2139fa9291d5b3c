"""Plain PyTorch ops shared across models (counterpart of
``seqrec_tpu/ops/core.py``).

Top-k order here is (value descending, id ascending), what ``lax.top_k``
returns on the JAX package's CPU path: ties, masked items included, keep
their ids in ascending order.
"""

from __future__ import annotations

import contextlib

import torch


def pad_bucket(n: int, floor: int = 8) -> int:
    """Next power-of-two padding bucket (>= floor) for a dynamic size: the
    bag models pad their host buffers to it, as the JAX package does."""
    b = floor
    while b < n:
        b *= 2
    return b


class _GradClip(torch.autograd.Function):
    """Identity forward; the backward clamps the cotangent to +-limit
    (Lasagne's ``grad_clipping``, ``seqrec_tpu/ops/core.py:grad_clip``)."""

    @staticmethod
    def forward(ctx, x, limit):
        ctx.limit = limit
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.clamp(-ctx.limit, ctx.limit), None


def grad_clip(x: torch.Tensor, limit: float) -> torch.Tensor:
    return _GradClip.apply(x, float(limit))


def maybe_grad_clip(x: torch.Tensor, limit: float) -> torch.Tensor:
    """Identity when ``limit`` is falsy (or nothing needs a gradient)."""
    return grad_clip(x, limit) if limit and x.requires_grad else x


def mm_bf16(a16: torch.Tensor, b16: torch.Tensor) -> torch.Tensor:
    """f32 product of two bf16 matrices: bf16 inputs, f32 accumulation.
    On CUDA one ``torch.mm(..., out_dtype=torch.float32)`` (the tensor
    cores' bf16 product); on the CPU, which has no kernel for that op, the
    bf16 values upcast and an f32 product: the same math, summed in another
    order."""
    if a16.is_cuda:
        return torch.mm(a16, b16, out_dtype=torch.float32)
    return a16.float() @ b16.float()


class _MatmulBF16(torch.autograd.Function):
    """The JAX package's ``jnp.dot(a.astype(bf16), b.astype(bf16),
    preferred_element_type=f32)`` under autodiff: the cotangent of each
    operand is the f32 product of the incoming f32 cotangent with the other
    bf16 operand, rounded to bf16 (the transpose of the cast).

    Under a ``mesh`` each f32 cotangent is summed where the whole product's
    is, before its rounding, so that it rounds as the one-device product's
    does: ``a`` holds this rank's rows (of the batch, split over "data")
    and ``b`` is a parameter, whose gradient the step averages over "data":
    ``b``'s cotangent is the mean over "data" of the ranks' partial sums,
    rounded (the step's later mean then averages equal values); with
    ``b_sharded``, ``b`` is this rank's columns of a column-sharded operand
    and ``a`` is replicated over "model": ``a``'s cotangent is summed over
    "model" (``copy_to_model``'s backward, inside the cast's transpose)."""

    @staticmethod
    def forward(ctx, a, b, mesh, b_sharded):
        a16, b16 = a.to(torch.bfloat16), b.to(torch.bfloat16)
        ctx.save_for_backward(a16, b16)
        ctx.mesh, ctx.b_sharded = mesh, b_sharded
        return mm_bf16(a16, b16)

    @staticmethod
    def backward(ctx, g):
        from seqrec_tpu_torch.parallel.collectives import all_reduce

        a16, b16 = ctx.saved_tensors
        mesh = ctx.mesh
        da = db = None
        if ctx.needs_input_grad[0]:
            da = g @ b16.float().t()
            if mesh is not None and ctx.b_sharded:
                da = all_reduce(da, mesh, "model")
            da = da.to(torch.bfloat16).float()
        if ctx.needs_input_grad[1]:
            db = a16.float().t() @ g
            if mesh is not None and mesh.groups["data"] is not None:
                db = all_reduce(db, mesh, "data") / mesh.shape["data"]
            db = db.to(torch.bfloat16).float()
        return da, db, None, None


def matmul_bf16(a: torch.Tensor, b: torch.Tensor, mesh=None, b_sharded: bool = False) -> torch.Tensor:
    """a [M, K] @ b [K, N] in f32 from operands rounded to bf16 (``--bf16``'s
    catalog-sized products), differentiable; under a ``mesh``, ``a`` holds
    this rank's rows and ``b`` is a parameter, with ``b_sharded`` this
    rank's columns of it (the class docstring)."""
    return _MatmulBF16.apply(a, b, mesh, b_sharded)


def check_tensors(fn: str, device, expected: dict, rows=()) -> None:
    """Raise unless every ``name: (tensor, dtype, shape)`` of ``expected``
    is a contiguous tensor of that dtype and shape on ``device``, and
    ``device`` is a CUDA device (the kernels' wrappers check their inputs
    with this before passing pointers). The 2-D tensors named in ``rows``
    need only contiguous rows: a row stride of at least their width."""
    if device.type != "cuda":
        raise ValueError(f"{fn}: no kernel for device {device}")
    for name, (t, dtype, shape) in expected.items():
        dense = has_dense_rows(t) if name in rows else t.is_contiguous()
        if t.device != device or t.dtype != dtype or not dense:
            raise ValueError(f"{fn}: {name} must be a contiguous {dtype} tensor on {device}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{fn}: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")


def on_device(device):
    """A context that makes ``device`` current for a launch; nothing to do
    (and no host cost) when it already is."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def has_dense_rows(x: torch.Tensor) -> bool:
    """x is 2-D with contiguous rows that do not overlap."""
    if x.dim() != 2:
        return False
    return (x.shape[1] <= 1 or x.stride(1) == 1) and (x.shape[0] <= 1 or x.stride(0) >= x.shape[1])


def rows_16b(x: torch.Tensor) -> torch.Tensor:
    """x [R, C] itself when its rows start 16-byte aligned (contiguous rows,
    a row stride that is a multiple of 4, aligned data), else a copy whose
    rows are padded with zeros to a multiple of 4 floats, as its [R, C]
    view: the block products of K2 and K4 copy 16-byte chunks and read the
    row stride from ``x.stride(0)``."""
    C = x.shape[1]
    if has_dense_rows(x) and x.stride(0) % 4 == 0 and x.data_ptr() % 16 == 0:
        return x
    if C % 4 == 0:  # misaligned or strided: a fresh copy is aligned
        return x.clone(memory_format=torch.contiguous_format)
    return torch.nn.functional.pad(x, (0, -C % 4))[:, :C]  # one kernel on the card


def gather_sum(table: torch.Tensor, ids: torch.Tensor, id_mask: torch.Tensor | None = None):
    """Sum of ``table`` rows selected by ``ids`` over the last ids-axis.

    table: [n_rows, D]; ids: integer [..., F]. Negative ids are pad slots
    that contribute 0, and so get no gradient. id_mask: optional float
    [..., F]; 0 entries contribute 0. Returns [..., D].
    """
    rows = table[ids.clamp_min(0).long()]  # [..., F, D]
    rows = rows * (ids >= 0).to(rows.dtype).unsqueeze(-1)
    if id_mask is not None:
        rows = rows * id_mask.unsqueeze(-1)
    return rows.sum(dim=-2)


def gather_sum_table_grad(g: torch.Tensor, ids: torch.Tensor, id_mask: torch.Tensor | None, n_rows: int):
    """The gradient of :func:`gather_sum` with respect to its table, given
    the cotangent g [..., D] of its output: [n_rows, D], each slot's row of
    g (times its mask) added into the row of its id by ``index_add_``;
    negative ids add nothing."""
    D = g.shape[-1]
    rows = g.unsqueeze(-2).expand(*ids.shape, D)
    if id_mask is not None:
        rows = rows * id_mask.unsqueeze(-1)
    flat = ids.reshape(-1).long()
    keep = flat >= 0
    out = torch.zeros((n_rows, D), dtype=g.dtype, device=g.device)
    return out.index_add_(0, flat[keep], rows.reshape(-1, D)[keep])


def top_k_sorted(scores: torch.Tensor, k: int):
    """(values [B, k], ids int32 [B, k]) in (value descending, id
    ascending) order. Rows with fewer than k columns are filled with the
    empty-slot sentinel (-inf, INT32_MAX)."""
    n = scores.shape[1]
    values, ids = torch.sort(scores, dim=1, descending=True, stable=True)
    values, ids = values[:, :k], ids[:, :k].to(torch.int32)
    if n < k:
        pad = (scores.shape[0], k - n)
        values = torch.cat([values, values.new_full(pad, float("-inf"))], dim=1)
        ids = torch.cat([ids, ids.new_full(pad, torch.iinfo(torch.int32).max)], dim=1)
    return values, ids


def mask_seen(scores: torch.Tensor, seen_ids=None, seen_mask=None) -> torch.Tensor:
    """Scatter -inf into each row at its seen ids (entries whose
    ``seen_mask`` is 0 add 0). Returns a new tensor."""
    if seen_ids is None:
        return scores
    if seen_mask is None:
        updates = torch.full(seen_ids.shape, float("-inf"), dtype=scores.dtype, device=scores.device)
    else:
        updates = torch.where(
            seen_mask > 0,
            torch.tensor(float("-inf"), dtype=scores.dtype, device=scores.device),
            torch.tensor(0.0, dtype=scores.dtype, device=scores.device),
        )
    return scores.scatter_add(1, seen_ids.long(), updates)


def masked_top_k(scores: torch.Tensor, k: int, seen_ids=None, seen_mask=None) -> torch.Tensor:
    """Top-k item ids per row after excluding already-seen items.

    scores: [B, n_items]; seen_ids: int [B, S]; seen_mask: float [B, S],
    0 entries of seen_ids are ignored. Returns int32 [B, k], best first.
    """
    return top_k_sorted(mask_seen(scores, seen_ids, seen_mask), k)[1]
