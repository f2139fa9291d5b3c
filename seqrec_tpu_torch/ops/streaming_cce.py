"""Streaming (flash-style) full-catalog cross-entropy (kernel K2).

Counterpart of ``seqrec_tpu/ops/streaming_cce.py:streaming_cce``, unsharded:
the per-example CCE ``logsumexp_j(h W + b)_j - (h W + b)_target`` of
``h [B, H]``, ``W [H, N]``, ``b [N]`` and int targets ``[B]``, the same math
as ``losses.log_softmax_cce(h @ W + b, targets)``, with a hand-written
backward. On CUDA tensors the forward's log-sum-exp stats (m, s) and the
backward's (dh, dW, db) come from the kernels of ``csrc/streaming_cce.cu``,
which never write the [B, N] logits; the target logit is one gather of B
columns outside the kernel, as in the JAX package. On CPU tensors
:func:`cce_stats_plain` and :func:`cce_grads_plain` compute the same from
the dense logits.

The kernels mask the ragged catalog edge themselves: there is no chunk-size
choice. They copy h and W in 16-byte chunks, so rows whose length is not a
multiple of 4 floats are padded (:func:`rows_16b`): once a step in the
forward, which passes the padded tensors on to the backward. Targets
outside ``[0, N)`` raise.

With ``compute_dtype="bfloat16"`` (``--bf16``) the op is the JAX package's
chunk scan instead (``_stats_scan``, ``_target_logit``, ``_grad_scan``),
which is what that package runs for bf16 compute: K2 is an f32 kernel
there and here. A plain loop over column chunks of ``W`` (:func:`pick_chunk`
wide, the catalog padded to whole chunks): each chunk's [B, chunk] logits
from bf16 operands with f32 accumulation (:func:`ops.core.mm_bf16`), the
online (m, s) stats, and in the backward the chunk's d(logits) rounded to
bf16 and contracted into dh, the chunk's dW columns and db. The caller
(the model) picks the route from its compute dtype; the K2 wrappers never
hand work to the loop.

:func:`sharded_streaming_cce` is the op over a mesh whose "model" axis
shards W's columns (``seqrec_tpu/ops/streaming_cce.py:313-456``): K2's
stats and gradient kernels run on the rank's column slice, as they run on
the whole W here; with bf16 compute the chunk loop runs there instead.
"""

from __future__ import annotations

import ctypes

import torch

from seqrec_tpu_torch.ops import _build
from seqrec_tpu_torch.ops.core import check_tensors, mm_bf16, rows_16b

# catalogs at least this large route RNNOneHot's training loss through the
# streaming op (the JAX package's switch; not re-derived for the H100 yet)
STREAMING_CCE_MIN_ITEMS = 16384
# the chunk loops' column chunk when no width in pick_chunk's range divides N
CHUNK_COLS = 1024
TILE = 128  # rows, columns and H chunk of one logits tile (csrc/block_mma.cuh kBT)
STATS_SMEM = (3 * 2 * TILE * 36 + 8 * TILE) * 4  # the stats kernel's ring and row sums (kStatsSmem)
MAX_H = 256  # the gradient kernels take H in at most two 128-wide chunks


def pick_chunk(N: int, lo: int = 512, hi: int = 2048) -> int:
    """Largest chunk in [lo, hi] that divides N (no column padding), else
    ``CHUNK_COLS``."""
    for c in range(min(hi, N), lo - 1, -1):
        if N % c == 0:
            return c
    return CHUNK_COLS


def _pad_cols(W, b, chunk: int):
    """W and b padded to a whole number of chunks (pad bias -1e30: a pad
    column adds exp(-inf) = 0 and is never the max), and the chunk count."""
    N = W.shape[1]
    n_chunks = -(-N // chunk)
    pad = n_chunks * chunk - N
    if pad:
        W = torch.nn.functional.pad(W, (0, pad))
        b = torch.nn.functional.pad(b, (0, pad), value=-1e30)
    return W, b, n_chunks


def cce_stats_plain(h, W, b):
    """(m, s) [B]: row max of the logits and the sum of exp(logit - m)."""
    logits = h @ W + b
    m = logits.max(dim=1).values
    return m, torch.exp(logits - m[:, None]).sum(dim=1)


def cce_grads_plain(h, W, b, targets, logz, g):
    """(dh [B, H], dW [H, N], db [N]) of sum_i g[i] * CCE_i, given the
    log-partition logz [B]; a target of -1 matches no column."""
    logits = h @ W + b
    dz = torch.exp(logits - logz[:, None])
    # a target of -1 (another shard's, sharded_streaming_cce) matches no column, as in the kernel
    dz -= (torch.arange(W.shape[1], device=h.device)[None, :] == targets.long()[:, None]).to(dz.dtype)
    dz *= g[:, None]
    return dz @ W.t(), h.t() @ dz, dz.sum(dim=0)


def split_plan(B: int, N: int, n_sm: int, h_chunks: int = 1) -> tuple[int, int]:
    """(n_splits, cols_per_split) of the catalog for a grid of (row tiles,
    catalog splits, h_chunks): about one block per SM (each holds most of
    an SM's shared memory and registers), whole 128-column tiles per
    split, no split empty. The stats kernel's plan (h_chunks = 1)."""
    row_tiles = -(-B // TILE)
    col_tiles = -(-N // TILE)
    n_splits = max(1, min(col_tiles, n_sm // (row_tiles * h_chunks)))
    cols = -(-col_tiles // n_splits) * TILE
    return -(-N // cols), cols


def grads_plan(B: int, H: int, N: int, n_sm: int) -> tuple[int, int, int]:
    """(n_splits, cols_per_split, h_chunks) of the gradient kernels: the
    dh kernel's grid of (row tiles, catalog splits, H chunks) as
    :func:`split_plan` lays it out; the scratch is n_splits partial dh
    [B, H]."""
    h_chunks = -(-H // TILE)
    return (*split_plan(B, N, n_sm, h_chunks), h_chunks)


def _library():
    lib = _build.load("streaming_cce")
    stats, grads = lib.seqrec_cce_stats_f32, lib.seqrec_cce_grads_f32
    if stats.argtypes is None:
        stats.argtypes = [ctypes.c_void_p, ctypes.c_int] * 2 + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        stats.restype = ctypes.c_int
        grads.argtypes = (
            [ctypes.c_void_p, ctypes.c_int] * 2 + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        )
        grads.restype = ctypes.c_int
    return stats, grads


def _check(fn: str, h, expected: dict) -> None:
    check_tensors(fn, h.device, expected, rows=("h", "W"))
    if 0 in h.shape or expected["W"][0].shape[1] == 0:
        raise ValueError(f"{fn}: the kernel needs B, H and N >= 1")


def _n_sm(h):
    return torch.cuda.get_device_properties(h.device).multi_processor_count


def cce_stats(h, W, b):
    """(m, s) [B] of the logits h W + b; CUDA tensors launch K2's stats
    kernels, CPU tensors run :func:`cce_stats_plain`. h and W need
    contiguous rows (padded here where they are not 16-byte rows)."""
    if h.device.type == "cpu":
        return cce_stats_plain(h, W, b)
    B, H = h.shape
    N = W.shape[1]
    f32 = torch.float32
    _check("cce_stats", h, {"h": (h, f32, (B, H)), "W": (W, f32, (H, N)), "b": (b, f32, (N,))})
    n_splits, cols = split_plan(B, N, _n_sm(h))
    part = torch.empty((2, n_splits, B), dtype=f32, device=h.device)
    m = torch.empty(B, dtype=f32, device=h.device)
    s = torch.empty(B, dtype=f32, device=h.device)
    h, W = rows_16b(h), rows_16b(W)
    stats, _ = _library()
    with torch.cuda.device(h.device):
        err = stats(
            h.data_ptr(), h.stride(0), W.data_ptr(), W.stride(0), b.data_ptr(), part[0].data_ptr(),
            part[1].data_ptr(), m.data_ptr(), s.data_ptr(), B, H, N, n_splits, cols,
            torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"cce_stats kernel launch failed with CUDA error {err}")
    cce_stats.launches += 1
    return m, s


def cce_grads(h, W, b, targets, logz, g):
    """(dh, dW, db) of sum_i g[i] * CCE_i; targets int32 [B] in [0, N), or
    -1 for a row whose target no column matches (another shard's, in
    :func:`sharded_streaming_cce`), logz and g f32 [B]. CUDA tensors launch K2's gradient kernels, CPU
    tensors run :func:`cce_grads_plain`. h and W need contiguous rows
    (padded here where they are not 16-byte rows)."""
    if h.device.type == "cpu":
        return cce_grads_plain(h, W, b, targets, logz, g)
    B, H = h.shape
    N = W.shape[1]
    f32 = torch.float32
    _check("cce_grads", h, {
        "h": (h, f32, (B, H)), "W": (W, f32, (H, N)), "b": (b, f32, (N,)),
        "targets": (targets, torch.int32, (B,)), "logz": (logz, f32, (B,)), "g": (g, f32, (B,)),
    })
    if H > MAX_H:
        raise ValueError(f"cce_grads: the kernel takes H <= {MAX_H}, got {H}")
    n_splits, cols, _ = grads_plan(B, H, N, _n_sm(h))
    dh = torch.empty((B, H), dtype=f32, device=h.device)
    dW = torch.empty((H, N), dtype=f32, device=h.device)
    db = torch.empty(N, dtype=f32, device=h.device)
    part = torch.empty((n_splits, B, H), dtype=f32, device=h.device)
    h, W = rows_16b(h), rows_16b(W)
    _, grads = _library()
    with torch.cuda.device(h.device):
        err = grads(
            h.data_ptr(), h.stride(0), W.data_ptr(), W.stride(0), b.data_ptr(), targets.data_ptr(), logz.data_ptr(),
            g.data_ptr(), dh.data_ptr(), dW.data_ptr(), db.data_ptr(), part.data_ptr(),
            B, H, N, n_splits, cols, torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"cce_grads kernel launch failed with CUDA error {err}")
    cce_grads.launches += 1
    return dh, dW, db


cce_stats.launches = 0
cce_grads.launches = 0


def target_logit(h, W, b, targets):
    """[B] logit of each row's target: a gather of B columns of W and a
    length-H dot per row (``streaming_cce.py:_target_logit``)."""
    return (h * W.index_select(1, targets).t()).sum(dim=1) + b.index_select(0, targets)


class _StreamingCCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, W, b, targets):
        h, W, b = h.contiguous(), W.contiguous(), b.contiguous()
        if h.is_cuda:  # once a step, for both kernels
            h, W = rows_16b(h), rows_16b(W)
        targets = targets.to(torch.int32).contiguous()
        m, s = cce_stats(h, W, b)
        ctx.save_for_backward(h, W, b, targets, m, s)
        return torch.log(s) + m - target_logit(h, W, b, targets.long())

    @staticmethod
    def backward(ctx, g):
        h, W, b, targets, m, s = ctx.saved_tensors
        dh, dW, db = cce_grads(h, W, b, targets, m + torch.log(s), g.contiguous())
        return dh, dW, db, None


def _bf16_operands(h, W, b, chunk: int):
    """(h, W padded to whole chunks) in bf16, the padded b in f32, and the
    chunk count, for the bf16 chunk loop."""
    Wp, bp, n_chunks = _pad_cols(W, b, chunk)
    return h.to(torch.bfloat16), Wp.to(torch.bfloat16), bp, n_chunks


def _chunk_stats(h16, Wp16, bp, chunk: int, n_chunks: int):
    """(m, s) [B] of the bf16 logits h16 Wp16 + bp, one column chunk at a
    time (``streaming_cce.py:_stats_scan``)."""
    m = torch.full((h16.shape[0],), -1e30, dtype=torch.float32, device=h16.device)
    s = torch.zeros_like(m)
    for i in range(n_chunks):
        sl = slice(i * chunk, (i + 1) * chunk)
        logits = mm_bf16(h16, Wp16[:, sl]) + bp[sl]
        m_new = torch.maximum(m, logits.max(dim=1).values)
        # m starts at -1e30 with s = 0: the first chunk's rescale is 0 * 0
        s = s * torch.exp(m - m_new) + torch.exp(logits - m_new[:, None]).sum(dim=1)
        m = m_new
    return m, s


def _chunk_grads(h16, Wp16, bp, t, logz, g, chunk: int, n_chunks: int):
    """(dh [B, H], dW [H, n_chunks * chunk], db) of sum_i g[i] * CCE_i
    from the bf16 chunk loop (``streaming_cce.py:_grad_scan``): each
    chunk's d(logits) rounded to bf16, its products summed in f32. A
    target of -1 (another shard's) matches no column."""
    cols = torch.arange(chunk, device=h16.device)
    dh = torch.zeros(h16.shape, dtype=torch.float32, device=h16.device)
    dW = torch.empty((Wp16.shape[0], n_chunks * chunk), dtype=torch.float32, device=h16.device)
    db = torch.empty(n_chunks * chunk, dtype=torch.float32, device=h16.device)
    for i in range(n_chunks):
        sl = slice(i * chunk, (i + 1) * chunk)
        W_c = Wp16[:, sl]
        p = torch.exp(mm_bf16(h16, W_c) + bp[sl] - logz[:, None])
        onehot = cols[None, :] == (t - i * chunk)[:, None]
        dl = (g[:, None] * (p - onehot.float())).to(torch.bfloat16)
        dW[:, sl] = mm_bf16(h16.t(), dl)
        db[sl] = dl.float().sum(dim=0)
        dh = dh + mm_bf16(dl, W_c.t())
    return dh, dW, db


class _StreamingCCEChunks(torch.autograd.Function):
    """The bf16 chunk loop (``streaming_cce.py:_fwd``/``_bwd`` off the
    kernel): operands rounded to bf16, products accumulated in f32, the
    stats, loss and dh in f32. With a ``mesh``, W and b are this rank's
    columns from ``col0`` on (``streaming_cce.py:_local_stats`` and
    ``_sh_bwd``'s scan): the local (m, s) and the owned target logits are
    combined over "model" as :class:`_ShardedStreamingCCE` combines K2's,
    and the partial dh is summed over "model"."""

    @staticmethod
    def forward(ctx, h, W, b, targets, chunk, mesh, col0):
        from seqrec_tpu_torch.parallel.collectives import all_reduce

        N = W.shape[1]
        h16, Wp16, bp, n_chunks = _bf16_operands(h, W, b, chunk)
        t = targets.long()
        if mesh is not None:
            t = t - col0
            owned = (t >= 0) & (t < N)
            t = torch.where(owned, t, -1)
        m, s = _chunk_stats(h16, Wp16, bp, chunk, n_chunks)
        safe = t.clamp_min(0)
        cols = W.index_select(1, safe).to(torch.bfloat16)  # [H, B]
        tl = (h16.float() * cols.float().t()).sum(dim=1) + b.index_select(0, safe)
        if mesh is not None:
            m_g = all_reduce(m.clone(), mesh, "model", op="max")
            s = all_reduce(s * torch.exp(m - m_g), mesh, "model")
            m = m_g
            tl = all_reduce(torch.where(owned, tl, 0.0), mesh, "model")  # one shard owns each target
        ctx.save_for_backward(h, W, b, t, m, s)
        ctx.chunk, ctx.mesh = chunk, mesh
        return torch.log(s) + m - tl

    @staticmethod
    def backward(ctx, g):
        from seqrec_tpu_torch.parallel.collectives import all_reduce

        h, W, b, t, m, s = ctx.saved_tensors
        N = W.shape[1]
        h16, Wp16, bp, n_chunks = _bf16_operands(h, W, b, ctx.chunk)
        dh, dW, db = _chunk_grads(h16, Wp16, bp, t, m + torch.log(s), g, ctx.chunk, n_chunks)
        if ctx.mesh is not None:
            dh = all_reduce(dh, ctx.mesh, "model")
        return dh, dW[:, :N], db[:N], None, None, None, None


def streaming_cce(h, W, b, targets, compute_dtype: str = "float32", chunk: int | None = None,
                  check_targets: bool = True):
    """Per-example CCE [B] of h [B, H], W [H, N], b [N] and int targets
    [B], each in [0, N) (checked: one host sync; a caller whose targets
    were checked already, as the index wire's store items are when the
    store is uploaded, passes ``check_targets=False``). ``compute_dtype``
    "float32" runs K2; "bfloat16" the chunk loop, ``chunk`` columns at a
    time (default :func:`pick_chunk`)."""
    N = W.shape[1]
    if check_targets and len(targets) and bool(((targets < 0) | (targets >= N)).any()):
        raise ValueError(f"streaming_cce: a target is outside the catalog [0, {N})")
    if compute_dtype == "bfloat16":
        return _StreamingCCEChunks.apply(h, W, b, targets, chunk or pick_chunk(N), None, 0)
    if compute_dtype != "float32":
        raise ValueError(f"streaming_cce: compute_dtype must be float32 or bfloat16, got {compute_dtype!r}")
    return _StreamingCCE.apply(h, W, b, targets)


class _ShardedStreamingCCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, W, b, targets, mesh, col0):
        from seqrec_tpu_torch.parallel.collectives import all_reduce

        h, W, b = h.contiguous(), W.contiguous(), b.contiguous()
        if h.is_cuda:
            h, W = rows_16b(h), rows_16b(W)
        t_rel = targets.long() - col0
        owned = (t_rel >= 0) & (t_rel < W.shape[1])
        t_rel = torch.where(owned, t_rel, -1).to(torch.int32).contiguous()
        m_l, s_l = cce_stats(h, W, b)
        # the flash combine: the global max, then each shard's sum rescaled to it
        m = all_reduce(m_l.clone(), mesh, "model", op="max")
        s = all_reduce(s_l * torch.exp(m_l - m), mesh, "model")
        # exactly one shard owns each target
        tl = torch.where(owned, target_logit(h, W, b, t_rel.clamp_min(0).long()), 0.0)
        tl = all_reduce(tl, mesh, "model")
        ctx.save_for_backward(h, W, b, t_rel, m, s)
        ctx.mesh = mesh
        return torch.log(s) + m - tl

    @staticmethod
    def backward(ctx, g):
        from seqrec_tpu_torch.parallel.collectives import all_reduce

        h, W, b, t_rel, m, s = ctx.saved_tensors
        dh, dW, db = cce_grads(h, W, b, t_rel, m + torch.log(s), g.contiguous())
        # dh sums over every column: the shards' partials summed over "model";
        # dW and db stay on their shard until the gradients' mean over "data"
        return all_reduce(dh, ctx.mesh, "model"), dW, db, None, None, None


def sharded_streaming_cce(h, W, b, targets, mesh, col0: int, check_targets: bool = True,
                          compute_dtype: str = "float32", chunk: int | None = None):
    """Per-example CCE [B] over a catalog whose columns are sharded over
    the mesh's "model" axis: W [H, N/M] and b [N/M] are this rank's
    columns, from ``col0`` on; h [B, H] and the global targets [B] are the
    rank's rows, the same on every model rank. Forward: K2's stats kernel
    on the local slice, (m, s) combined by an all-reduce MAX and then a
    SUM over "model", the target logit summed from the shard that owns
    it. Backward: K2's gradient kernel with the targets relative to the
    shard (another shard's target: -1), then dh summed over "model". The
    result is the same on every model rank. ``compute_dtype="bfloat16"``
    runs the bf16 chunk loop on the local columns instead, ``chunk``
    columns at a time (default :func:`pick_chunk` of the shard's width, as
    the JAX package's), combined the same way: K2 is f32 only.
    ``check_targets`` as in :func:`streaming_cce`, against the whole
    catalog."""
    N = W.shape[1] * mesh.shape["model"]
    if check_targets and len(targets) and bool(((targets < 0) | (targets >= N)).any()):
        raise ValueError(f"sharded_streaming_cce: a target is outside the catalog [0, {N})")
    if compute_dtype == "bfloat16":
        return _StreamingCCEChunks.apply(h, W, b, targets, chunk or pick_chunk(W.shape[1]), mesh, col0)
    if compute_dtype != "float32":
        raise ValueError(f"sharded_streaming_cce: compute_dtype must be float32 or bfloat16, got {compute_dtype!r}")
    return _ShardedStreamingCCE.apply(h, W, b, targets, mesh, col0)
