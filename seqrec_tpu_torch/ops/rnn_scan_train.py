"""Differentiable GRU time scan for training (kernel K1).

Counterpart of ``seqrec_tpu/ops/pallas_rnn_train.py:gru_scan_train``: the
final GRU state [B, H] of ``x_pre [B, L, 3H]`` (gate order
reset|update|candidate, masked steps carry h), whose backward recomputes
the gates from ``x_pre[t]`` and ``h_{t-1}``, clips the cotangent of
``hid = h_{t-1} W_hid`` to +-``grad_clip`` (Lasagne's grad clipping) and
gives dx_pre (unclipped: the caller clips ``x_pre`` itself), dW_hid and
dh0.

On a CUDA tensor :func:`gru_scan_train` runs an autograd Function whose
forward launches :func:`gru_scan_train_fwd` and whose backward launches
:func:`gru_scan_train_bwd`, the kernels of ``csrc/gru_scan_train.cu``; on
a CPU tensor it runs :func:`gru_scan_train_plain`, the plain masked loop
with the same clip, differentiated by autograd. The chip check holds the
kernels against that plain version.
"""

from __future__ import annotations

import ctypes

import torch

from seqrec_tpu_torch.ops import _build
from seqrec_tpu_torch.ops.core import check_tensors
from seqrec_tpu_torch.ops.rnn_scan import gru_step

TILE = 64  # rows of one dW split (csrc/tile_mma.cuh kTile)


def gru_scan_train_plain(x_pre, mask, w_hid, h0, grad_clip: float = 0.0):
    """Plain version: x_pre [B, L, 3H], mask [B, L], w_hid [H, 3H],
    h0 [B, H] -> final state [B, H], differentiable."""
    h = h0
    for t in range(x_pre.shape[1]):
        h = gru_step(h, x_pre[:, t], mask[:, t : t + 1], w_hid, grad_clip)
    return h


def dw_split_plan(K: int, H: int, G: int, n_sm: int) -> tuple[int, int]:
    """(n_splits, rows_per_split) of the K = L*B rows of dW = hs^T dpre,
    dW [H, G] (G = 3H for the GRU, 4H for the LSTM): about two blocks per
    SM over the output tiles, whole tiles of rows per split, no split
    empty."""
    out_tiles = -(-H // TILE) * -(-G // TILE)
    k_tiles = -(-K // TILE)
    n_splits = max(1, min(-(-2 * n_sm // out_tiles), k_tiles))
    per_split = -(-k_tiles // n_splits) * TILE
    return -(-K // per_split), per_split


def _library():
    lib = _build.load("gru_scan_train")
    fwd, bwd = lib.seqrec_gru_train_fwd_f32, lib.seqrec_gru_train_bwd_f32
    if fwd.argtypes is None:
        fwd.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fwd.restype = ctypes.c_int
        bwd.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
        bwd.restype = ctypes.c_int
    return fwd, bwd


def gru_scan_train_fwd(x_pre, mask, w_hid, h0):
    """K1 forward on the card: (final state [B, H], hs [L, B, H]) where
    hs[t] is h_{t-1}, the state before step t."""
    B, L, _ = x_pre.shape
    H = h0.shape[-1]
    f32 = torch.float32
    check_tensors("gru_scan_train_fwd", x_pre.device, {
        "x_pre": (x_pre, f32, (B, L, 3 * H)), "mask": (mask, f32, (B, L)),
        "w_hid": (w_hid, f32, (H, 3 * H)), "h0": (h0, f32, (B, H)),
    })
    if B == 0 or L == 0:
        raise ValueError("gru_scan_train_fwd: the kernel needs B >= 1 and L >= 1")
    out = torch.empty((B, H), dtype=torch.float32, device=x_pre.device)
    hs = torch.empty((L, B, H), dtype=torch.float32, device=x_pre.device)
    fwd, _ = _library()
    with torch.cuda.device(x_pre.device):
        err = fwd(
            x_pre.data_ptr(), mask.data_ptr(), w_hid.data_ptr(), h0.data_ptr(), out.data_ptr(),
            hs.data_ptr(), B, L, H, torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"gru_scan_train_fwd kernel launch failed with CUDA error {err}")
    gru_scan_train_fwd.launches += 1
    return out, hs


def gru_scan_train_bwd(x_pre, mask, w_hid, hs, dh, grad_clip: float):
    """K1 backward on the card: (dx_pre [B, L, 3H], dh0 [B, H],
    dW_hid [H, 3H]) for the upstream cotangent dh [B, H] of the final
    state."""
    B, L, _ = x_pre.shape
    H = dh.shape[-1]
    f32 = torch.float32
    check_tensors("gru_scan_train_bwd", x_pre.device, {
        "x_pre": (x_pre, f32, (B, L, 3 * H)), "mask": (mask, f32, (B, L)),
        "w_hid": (w_hid, f32, (H, 3 * H)), "hs": (hs, f32, (L, B, H)), "dh": (dh, f32, (B, H)),
    })
    if B == 0 or L == 0:
        raise ValueError("gru_scan_train_bwd: the kernel needs B >= 1 and L >= 1")
    dev = x_pre.device
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    n_splits, per_split = dw_split_plan(L * B, H, 3 * H, n_sm)
    w_t = w_hid.t().contiguous()
    dx = torch.empty((B, L, 3 * H), dtype=torch.float32, device=dev)
    dh0 = torch.empty((B, H), dtype=torch.float32, device=dev)
    dw = torch.empty((H, 3 * H), dtype=torch.float32, device=dev)
    dhid = torch.empty((L, B, 3 * H), dtype=torch.float32, device=dev)
    part = torch.empty((n_splits, H, 3 * H), dtype=torch.float32, device=dev)
    _, bwd = _library()
    with torch.cuda.device(dev):
        err = bwd(
            x_pre.data_ptr(), mask.data_ptr(), w_hid.data_ptr(), w_t.data_ptr(), hs.data_ptr(),
            dh.data_ptr(), dx.data_ptr(), dh0.data_ptr(), dw.data_ptr(), dhid.data_ptr(),
            part.data_ptr(), B, L, H, n_splits, per_split, float(grad_clip or 0.0),
            torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"gru_scan_train_bwd kernel launch failed with CUDA error {err}")
    gru_scan_train_bwd.launches += 1
    return dx, dh0, dw


gru_scan_train_fwd.launches = 0
gru_scan_train_bwd.launches = 0


class _GRUScanTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_pre, mask, w_hid, h0, grad_clip):
        x_pre, mask, w_hid, h0 = (t.contiguous() for t in (x_pre, mask, w_hid, h0))
        h, hs = gru_scan_train_fwd(x_pre, mask, w_hid, h0)
        ctx.save_for_backward(x_pre, mask, w_hid, hs)
        ctx.grad_clip = grad_clip
        return h

    @staticmethod
    def backward(ctx, dh):
        x_pre, mask, w_hid, hs = ctx.saved_tensors
        dx, dh0, dw = gru_scan_train_bwd(x_pre, mask, w_hid, hs, dh.contiguous(), ctx.grad_clip)
        return dx, None, dw, dh0, None


def gru_scan_train(x_pre, mask, w_hid, h0, grad_clip: float = 0.0):
    """Final GRU state [B, H] of x_pre [B, L, 3H], mask [B, L],
    w_hid [H, 3H] and h0 [B, H] (f32), differentiable in x_pre, w_hid and
    h0, with the cotangent of hid clipped to +-grad_clip (0: no clip)."""
    if x_pre.device.type == "cpu":
        return gru_scan_train_plain(x_pre, mask, w_hid, h0, grad_clip)
    if x_pre.device.type != "cuda":
        raise ValueError(f"gru_scan_train: no kernel for device {x_pre.device}")
    return _GRUScanTrain.apply(x_pre, mask, w_hid, h0, float(grad_clip or 0.0))
