"""Fused catalog scoring + seen-item masking + top-k (kernel K4).

Counterpart of ``seqrec_tpu/ops/pallas_topk.py:fused_score_topk``: the k
best items of ``h·W_out + b_out`` per row, with the row's seen ids masked
to -inf, best first. Order is (value descending, id ascending) over all
real columns, with (-inf, INT32_MAX) for empty slots: what the JAX
package's CPU path (``masked_top_k`` -> ``lax.top_k``) returns, rows with
fewer than k unmasked items included.

On a CUDA tensor :func:`fused_score_topk` launches the two kernels of
``csrc/score_topk.cu`` (per-split partial top-k on 3xTF32 tensor-core
logits tiles, then a merge) for any catalog size and k <= 64; on a CPU
tensor it runs :func:`fused_score_topk_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from seqrec_tpu_torch.ops import _build
from seqrec_tpu_torch.ops.core import check_tensors, mask_seen, rows_16b, top_k_sorted

MAX_K = 64  # the kernel's per-row list length (csrc/score_topk.cu kMaxK)
TILE = 128  # rows and columns of one logits tile (csrc/block_mma.cuh kBT)
MAX_CANDIDATES = 2048  # splits * k candidates the merge kernel ranks per row
RING_BYTES = 3 * 2 * TILE * 36 * 4  # block_mma.cuh's copy ring; the spilled tile reuses it
H100_SMEM_OPTIN = 232_448  # shared memory a block may use on an H100


def fused_score_topk_plain(h, w_out, b_out, seen_ids=None, seen_mask=None, k: int = 10):
    """Plain version: the full [B, N] scores, -inf scattered at the seen
    ids, a stable sort. Returns (values f32 [B, k], ids int32 [B, k])."""
    return top_k_sorted(mask_seen(h @ w_out + b_out, seen_ids, seen_mask), k)


def partial_smem(k: int) -> int:
    """Bytes of shared memory of the partial kernel: the copy ring (which
    later holds the spilled logits tile) and each row's sorted list. The
    seen ids are read from device memory, so S does not count."""
    return RING_BYTES + TILE * k * 8


def split_plan(B: int, N: int, k: int, n_sm: int, smem_optin: int = H100_SMEM_OPTIN) -> tuple[int, int, int]:
    """(n_splits, cols_per_split, groups) of the partial kernel: whole
    128-column tiles per split, no split empty, at most MAX_CANDIDATES
    candidates per row for the merge, and one block per SM (a block holds
    most of an SM's shared memory). Where the logits tiles alone would
    leave most SMs idle, ``groups`` blocks (up to 8, at least 8 rows each)
    share each tile, each inserting for its slice of the tile's rows.
    Raises on a k or a shared-memory size the kernel cannot take."""
    if not 1 <= k <= MAX_K:
        raise ValueError(f"fused_score_topk: the kernel takes 1 <= k <= {MAX_K}, got {k}")
    if partial_smem(k) > smem_optin:
        raise ValueError(f"fused_score_topk: k={k} needs {partial_smem(k)} bytes of shared memory, "
                         f"the card gives a block {smem_optin}")
    row_tiles = -(-B // TILE)
    col_tiles = -(-N // TILE)
    groups = 1
    if 2 * row_tiles * col_tiles < n_sm:
        while groups < 8 and 8 * groups < min(B, TILE):
            groups *= 2
    n_splits = max(1, min(col_tiles, MAX_CANDIDATES // k, n_sm // (row_tiles * groups)))
    cols_per_split = -(-col_tiles // n_splits) * TILE
    return -(-N // cols_per_split), cols_per_split, groups


def _library():
    fn = _build.load("score_topk").seqrec_score_topk_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int] * 2 + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def fused_score_topk(h, w_out, b_out, seen_ids=None, seen_mask=None, k: int = 10):
    """Top-k (values f32 [B, k], ids int32 [B, k]) of h [B, H] · w_out [H, N]
    + b_out [N], with seen_ids int32 [B, S] masked where seen_mask [B, S]
    is > 0 (both None: nothing masked). h and w_out need contiguous rows;
    where a row is not a multiple of 16 bytes, they are copied with padded
    rows (:func:`rows_16b`)."""
    if h.device.type == "cpu":
        return fused_score_topk_plain(h, w_out, b_out, seen_ids, seen_mask, k)
    if not 1 <= k <= MAX_K:
        raise ValueError(f"fused_score_topk: the kernel takes 1 <= k <= {MAX_K}, got {k}")
    if (seen_ids is None) != (seen_mask is None):
        raise ValueError("fused_score_topk: pass both seen_ids and seen_mask, or neither")
    B, H = h.shape
    N = w_out.shape[1]
    S = 0 if seen_ids is None else seen_ids.shape[1]
    expected = {
        "h": (h, torch.float32, (B, H)),
        "w_out": (w_out, torch.float32, (H, N)),
        "b_out": (b_out, torch.float32, (N,)),
    }
    if S:
        expected["seen_ids"] = (seen_ids, torch.int32, (B, S))
        expected["seen_mask"] = (seen_mask, torch.float32, (B, S))
    check_tensors("fused_score_topk", h.device, expected, rows=("h", "w_out"))
    values = torch.empty((B, k), dtype=torch.float32, device=h.device)
    ids = torch.empty((B, k), dtype=torch.int32, device=h.device)
    if B == 0:
        return values, ids
    # the kernel checks the card's own shared-memory limit again
    n_sm = torch.cuda.get_device_properties(h.device).multi_processor_count
    n_splits, cols_per_split, groups = split_plan(B, N, k, n_sm)
    h, w_out = rows_16b(h), rows_16b(w_out)
    part_v = torch.empty((B, n_splits, k), dtype=torch.float32, device=h.device)
    part_i = torch.empty((B, n_splits, k), dtype=torch.int32, device=h.device)
    fn = _library()
    with torch.cuda.device(h.device):
        err = fn(
            h.data_ptr(), h.stride(0), w_out.data_ptr(), w_out.stride(0), b_out.data_ptr(),
            seen_ids.data_ptr() if S else None, seen_mask.data_ptr() if S else None,
            part_v.data_ptr(), part_i.data_ptr(), values.data_ptr(), ids.data_ptr(),
            B, H, N, S, k, n_splits, cols_per_split, groups,
            torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"fused_score_topk kernel launch failed with CUDA error {err}")
    fused_score_topk.launches += 1
    return values, ids


fused_score_topk.launches = 0
