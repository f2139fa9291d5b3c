"""Streaming (chunked-scan) multi-target margin losses.

Counterpart of ``seqrec_tpu/ops/streaming_margin.py``.
The margin head evaluates an elementwise loss ``f(pred, Y, Wt)`` against
per-example target (``Y``) and weight (``Wt``) rows over the whole catalog
and sums over items. ``Y`` and ``Wt`` take their DEFAULT values
(``default_target[j]``, ``w_neg``) on every column but the ~T+L special
ones of each example (targets: Y=1, Wt=-1; seen items when interactions
are unique: both 0), so the loss splits exactly into

  loss = sum_j f(pred_j, default_j, w_neg)                # uniform part
       + sum_{j special} [f(pred_j, Y_j, Wt_j) - f(pred_j, default_j, w_neg)]

- the uniform part (:func:`streaming_margin_uniform`): a scan over column
  chunks of ``W``, each one [B, chunk] product and the elementwise loss
  summed into a [B] carry; its backward (a ``torch.autograd.Function``)
  recomputes each chunk and contracts the chunk's d(pred), from autograd
  of the elementwise loss, into dh, the chunk's dW columns and db. No
  [B, n_items] tensor is kept;
- the correction (:func:`margin_special_correction`): one gather of the
  K = T+L special columns per example and a batched product, under plain
  autograd. Duplicate ids and the dense path's precedence (seen overrides
  target) are reproduced with first-occurrence masks.

The JAX package runs both in XLA, not Pallas, so the products stay
``torch.matmul`` (with ``compute_dtype="bfloat16"``, for ``--bf16``, bf16
operands summed in f32: ``ops.core.mm_bf16``, as the JAX op casts). The
correction's column gather is ``index_select``: its
backward is an atomic ``index_add_`` on CUDA, so card-against-CPU results
agree to a tolerance, not bit for bit. Like the JAX op, the uniform part
passes no cotangent to ``w_neg`` or ``default_target`` (they depend on the
batch, not on parameters).

:func:`sharded_streaming_margin` is the op over a mesh whose "model" axis
shards W's columns (``seqrec_tpu/ops/streaming_margin.py:305-426``): the
uniform part's chunk scan runs over the rank's columns with its slice of
the default targets, chunked by ``pick_chunk(N / M)``, and the
per-example partials are summed over "model"; in the backward the
partial dh is summed over "model" and dW and db stay on their shard. The
correction gathers its K special columns of each example from their
shards (``parallel/columns.py:gather_columns``). Both take the compute
dtype, as on one device (``streaming_margin.py:411-425``).
"""

from __future__ import annotations

import torch

from seqrec_tpu_torch.ops import losses
from seqrec_tpu_torch.ops.core import mm_bf16
from seqrec_tpu_torch.ops.streaming_cce import CHUNK_COLS, _pad_cols, pick_chunk  # noqa: F401 (re-export)
from seqrec_tpu_torch.parallel.collectives import copy_to_model, reduce_from_model
from seqrec_tpu_torch.parallel.columns import gather_columns

# the dense path below this catalog size (the JAX package's switch, the
# same as the CCE head's; not re-derived for the H100)
STREAMING_MARGIN_MIN_ITEMS = 16384


def _pad_default(default_target, Np: int):
    return torch.nn.functional.pad(default_target, (0, Np - default_target.shape[0]))


def _f_cols(loss_name: str, pred, Y, Wt):
    """Per-column loss values (the shape of ``pred``): the losses sum over
    their last axis, which a trailing singleton makes a no-op."""
    return losses.MARGIN_LOSSES[loss_name](pred[..., None], Y[..., None], Wt[..., None])


def _product(a, b):
    """f32 product, from bf16 operands where they are bf16."""
    return mm_bf16(a, b) if a.dtype == torch.bfloat16 else a @ b


def _chunk(h, Wp, bp, defp, n_valid, i, chunk):
    """Chunk i's ([B, chunk] predictions, W columns, default targets,
    0/1 validity of its columns). A bf16 ``h`` takes bf16 ``Wp`` columns
    and gives f32 predictions (bf16 products accumulated in f32)."""
    sl = slice(i * chunk, (i + 1) * chunk)
    W_c = Wp[:, sl]
    cols = torch.arange(i * chunk, (i + 1) * chunk, device=h.device)
    return _product(h, W_c) + bp[sl], W_c, defp[sl], (cols < n_valid).float()


def _chunk_loss(loss_name, pred, def_c, w_neg, valid):
    # pad columns masked on the VALUE (Wt = 0 would not do: logsig maps a
    # weight of 0 to log 2)
    val = _f_cols(loss_name, pred, def_c[None, :].expand_as(pred), w_neg[:, None].expand_as(pred))
    return (val * valid[None, :]).sum(dim=1)


def _operands(h, W, b, chunk, compute_dtype):
    """(h, padded W, padded b, chunk count) in the compute dtype (b stays
    f32)."""
    Wp, bp, n_chunks = _pad_cols(W, b, chunk)
    if compute_dtype == "bfloat16":
        return h.to(torch.bfloat16), Wp.to(torch.bfloat16), bp, n_chunks
    return h, Wp, bp, n_chunks


class _UniformMargin(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, W, b, w_neg, default_target, loss_name, chunk, compute_dtype):
        N = W.shape[1]
        h_c, Wp, bp, n_chunks = _operands(h, W, b, chunk, compute_dtype)
        defp = _pad_default(default_target, n_chunks * chunk)
        acc = torch.zeros(h.shape[0], dtype=torch.float32, device=h.device)
        for i in range(n_chunks):
            pred, _, def_c, valid = _chunk(h_c, Wp, bp, defp, N, i, chunk)
            acc = acc + _chunk_loss(loss_name, pred, def_c, w_neg, valid)
        ctx.save_for_backward(h, W, b, w_neg, default_target)
        ctx.loss_name, ctx.chunk, ctx.compute_dtype = loss_name, chunk, compute_dtype
        return acc

    @staticmethod
    def backward(ctx, g):
        h, W, b, w_neg, default_target = ctx.saved_tensors
        chunk = ctx.chunk
        N = W.shape[1]
        h_c, Wp, bp, n_chunks = _operands(h, W, b, chunk, ctx.compute_dtype)
        defp = _pad_default(default_target, n_chunks * chunk)
        dh = torch.zeros_like(h)
        dW = torch.empty((W.shape[0], n_chunks * chunk), dtype=torch.float32, device=h.device)
        db = torch.empty(n_chunks * chunk, dtype=torch.float32, device=h.device)
        for i in range(n_chunks):
            with torch.enable_grad():
                pred, W_c, def_c, valid = _chunk(h_c.detach(), Wp.detach(), bp.detach(), defp, N, i, chunk)
                pred.requires_grad_()
                (dpred,) = torch.autograd.grad(_chunk_loss(ctx.loss_name, pred, def_c, w_neg, valid), pred, g)
            dpred = dpred.to(h_c.dtype)
            sl = slice(i * chunk, (i + 1) * chunk)
            dW[:, sl] = _product(h_c.t(), dpred)
            db[sl] = dpred.float().sum(dim=0)
            dh = dh + _product(dpred, W_c.t())
        return dh, dW[:, :N], db[:N], None, None, None, None, None


def streaming_margin_uniform(h, W, b, w_neg, default_target, loss_name: str, chunk: int = CHUNK_COLS,
                             compute_dtype: str = "float32"):
    """[B] per-example margin loss with every catalog column at its default
    target and weight, with no [B, n_items] tensor kept for the backward."""
    return _UniformMargin.apply(h, W, b, w_neg, default_target, loss_name, chunk, compute_dtype)


# ----------------------------------------------------------------------
# special-column correction (plain autograd)
# ----------------------------------------------------------------------
def _first_occurrence(ids, valid):
    """[B, K] mask: slot k is the first valid slot in its row with its id
    (the dense scatters write a constant per id, so duplicate slots count
    once)."""
    K = ids.shape[1]
    same = ids[:, :, None] == ids[:, None, :]
    earlier = torch.tril(torch.ones((K, K), dtype=torch.bool, device=ids.device), diagonal=-1)
    dup = (same & earlier & valid[:, None, :]).any(dim=2)
    return valid & ~dup


def margin_special_correction(h, W, b, tgt_ids, seen_ids, w_neg, default_target,
                              loss_name: str, unique: bool, n_items: int, compute_dtype: str = "float32",
                              mesh=None, col0: int = 0):
    """[B] correction that moves the special columns from their default
    (Y = default, Wt = w_neg) to their true values: targets (1, -1), seen
    items (0, 0) when interactions are unique, seen overriding target, each
    id once. Its predictions take the uniform part's precision (the
    correction subtracts what the scan added): with bf16 compute, operands
    rounded to bf16 (``x.bfloat16().float()``, whose autograd rounds the
    cotangents to bf16 as the JAX package's casts do) and f32 sums. With a
    ``mesh``, W and b are this rank's columns from ``col0`` on and the
    special columns are gathered from their shards (exact f32 values,
    rounded after the gather);
    ``default_target`` and ``n_items`` stay the whole catalog's."""
    B, T = tgt_ids.shape
    L = seen_ids.shape[1]
    t_valid = (tgt_ids >= 0) & (tgt_ids < n_items)
    s_valid = (seen_ids >= 0) & (seen_ids < n_items)
    t_keep = _first_occurrence(tgt_ids, t_valid)
    if unique:
        s_keep = _first_occurrence(seen_ids, s_valid)
        overridden = ((tgt_ids[:, :, None] == seen_ids[:, None, :]) & s_valid[:, None, :]).any(dim=2)
        t_keep = t_keep & ~overridden
    else:
        s_keep = torch.zeros_like(s_valid)

    ids = torch.cat([tgt_ids, seen_ids], dim=1)  # [B, K]
    keep = torch.cat([t_keep, s_keep], dim=1)
    safe = ids.clamp(0, n_items - 1).reshape(-1)
    K = ids.shape[1]
    if mesh is None:
        Wg, bg = W.t().index_select(0, safe), b.index_select(0, safe)
    else:
        Wc, bg = gather_columns(W, b, safe, mesh, col0)
        Wg = Wc.t()
    Wg = Wg.reshape(B, K, -1)  # [B, K, H]
    if compute_dtype == "bfloat16":
        Wg, h = Wg.bfloat16().float(), h.bfloat16().float()
    pred = torch.bmm(Wg, h[:, :, None])[:, :, 0] + bg.reshape(B, K)

    f_def = _f_cols(loss_name, pred, default_target.index_select(0, safe).reshape(B, K), w_neg[:, None].expand(B, K))
    dev, f32 = h.device, torch.float32
    Yv = torch.cat([torch.ones((B, T), dtype=f32, device=dev), torch.zeros((B, L), dtype=f32, device=dev)], dim=1)
    Wv = torch.cat([torch.full((B, T), -1.0, dtype=f32, device=dev), torch.zeros((B, L), dtype=f32, device=dev)], dim=1)
    f_true = _f_cols(loss_name, pred, Yv, Wv)
    return ((f_true - f_def) * keep).sum(dim=1)


def streaming_margin(h, W, b, tgt_ids, seen_ids, w_neg, default_target,
                     loss_name: str, unique: bool, chunk: int = CHUNK_COLS, compute_dtype: str = "float32"):
    """Per-example margin loss [B]: the dense ``MARGIN_LOSSES[loss_name]
    (h @ W + b, Y, Wt)`` with Y and Wt assembled from the id arrays (ids
    outside [0, n_items) are padding), without a [B, n_items] tensor; the
    products in ``compute_dtype`` ("float32" or "bfloat16", f32 sums)."""
    uniform = streaming_margin_uniform(h, W, b, w_neg, default_target, loss_name, chunk, compute_dtype)
    corr = margin_special_correction(
        h, W, b, tgt_ids, seen_ids, w_neg, default_target, loss_name, unique, W.shape[1], compute_dtype
    )
    return uniform + corr


# ----------------------------------------------------------------------
# over a mesh whose "model" axis shards W's columns
# ----------------------------------------------------------------------
def sharded_streaming_margin_uniform(h, W, b, w_neg, default_target, mesh, loss_name: str, chunk: int | None = None,
                                     compute_dtype: str = "float32"):
    """:func:`streaming_margin_uniform` over this rank's columns W [H, N/M],
    b and ``default_target`` [N/M] (its slice), h [B, H] and w_neg [B] the
    rank's rows (the same on every model rank): the per-example partials
    summed over "model" (the margin losses sum over columns). Backward:
    the partial dh (f32 sums, also of bf16 products) summed over "model"
    (``copy_to_model``), dW and db local. ``chunk`` defaults to
    ``pick_chunk(N / M)``; the products in ``compute_dtype``."""
    if chunk is None:
        chunk = pick_chunk(W.shape[1])
    part = streaming_margin_uniform(copy_to_model(h, mesh), W, b, w_neg, default_target, loss_name, chunk,
                                    compute_dtype)
    return reduce_from_model(part, mesh)


def sharded_streaming_margin(h, W, b, tgt_ids, seen_ids, w_neg, default_target, mesh, col0: int,
                             loss_name: str, unique: bool, chunk: int | None = None, compute_dtype: str = "float32"):
    """Per-example margin loss [B] of :func:`streaming_margin` over a
    catalog whose columns are sharded over the mesh's "model" axis: W [H,
    N/M] and b [N/M] are this rank's columns from ``col0`` on,
    ``default_target`` [N] the whole catalog's, the id arrays global; the
    products in ``compute_dtype``. The result is the same on every model
    rank."""
    n_local = W.shape[1]
    uniform = sharded_streaming_margin_uniform(
        h, W, b, w_neg, default_target[col0 : col0 + n_local], mesh, loss_name, chunk, compute_dtype
    )
    corr = margin_special_correction(
        h, W, b, tgt_ids, seen_ids, w_neg, default_target, loss_name, unique, n_local * mesh.shape["model"],
        compute_dtype, mesh=mesh, col0=col0,
    )
    return uniform + corr
