"""Differentiable LSTM time scan for training (kernel K5).

Counterpart of ``seqrec_tpu/ops/pallas_lstm_train.py:lstm_scan_train``:
the final hidden state [B, H] of ``x_pre [B, L, 4H]`` (Lasagne's cell with
peepholes, gate order in|forget|cell|out, masked steps carry (h, c)),
whose backward recomputes the gates from ``x_pre[t]``, ``h_{t-1}`` and
``c_{t-1}``, clips the cotangent of the summed pre-activation ``x_pre[t] +
h_{t-1} W_hid`` to +-``grad_clip`` (so dx is the clipped cotangent, and the
same clipped value feeds dW_hid and dh_{t-1}), and gives dx_pre, dW_hid,
dpeepholes [3, H] (taken before the clip), dh0 and dc0.

On a CUDA tensor :func:`lstm_scan_train` runs an autograd Function whose
forward launches :func:`lstm_scan_train_fwd` and whose backward launches
:func:`lstm_scan_train_bwd`, the kernels of ``csrc/lstm_scan_train.cu`` on
the path ``ops/rnn_scan_train.py:train_scan_plan`` picks; on a CPU tensor
it runs :func:`lstm_scan_train_plain`, the plain masked loop with the same
clip, differentiated by autograd. The chip check holds the kernels
against that plain version.
"""

from __future__ import annotations

import ctypes

import torch

from seqrec_tpu_torch.ops import _build
from seqrec_tpu_torch.ops.core import check_tensors, on_device
from seqrec_tpu_torch.ops.rnn_scan import lstm_step
from seqrec_tpu_torch.ops.rnn_scan_train import PATHS, backward_scratch, device_train_plan


def lstm_scan_train_plain(x_pre, mask, w_hid, peepholes, h0, c0, grad_clip: float = 0.0):
    """Plain version: x_pre [B, L, 4H], mask [B, L], w_hid [H, 4H],
    peepholes [3, H], h0 and c0 [B, H] -> final hidden state [B, H],
    differentiable."""
    h, c = h0, c0
    for t in range(x_pre.shape[1]):
        h, c = lstm_step(h, c, x_pre[:, t], mask[:, t : t + 1], w_hid, peepholes, grad_clip)
    return h


_lib = None


def _library():
    global _lib
    if _lib is not None:
        return _lib
    lib = _build.load("lstm_scan_train")
    fwd, bwd = lib.seqrec_lstm_train_fwd_f32, lib.seqrec_lstm_train_bwd_f32
    if fwd.argtypes is None:
        fwd.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fwd.restype = ctypes.c_int
        bwd.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
        bwd.restype = ctypes.c_int
        lib.seqrec_lstm_train_capacity.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
        lib.seqrec_lstm_train_capacity.restype = ctypes.c_int
        lib.seqrec_lstm_train_smem.argtypes = [ctypes.c_int] * 5
        lib.seqrec_lstm_train_smem.restype = ctypes.c_longlong
    _lib = lib
    return lib


def lstm_train_plan(B: int, H: int, device, backward: bool) -> tuple[str, int, int]:
    """K5's (path, C, R) on ``device`` (rnn_scan_train.train_scan_plan)."""
    return device_train_plan("lstm", B, H, device, backward, _library)


def _shapes(x_pre, mask, w_hid, peepholes, H):
    B, L, _ = x_pre.shape
    f32 = torch.float32
    return {
        "x_pre": (x_pre, f32, (B, L, 4 * H)), "mask": (mask, f32, (B, L)),
        "w_hid": (w_hid, f32, (H, 4 * H)), "peepholes": (peepholes, f32, (3, H)),
    }


def lstm_scan_train_fwd(x_pre, mask, w_hid, peepholes, h0, c0):
    """K5 forward on the card: (final hidden state [B, H], hs [L, B, H],
    cs [L, B, H]) where hs[t], cs[t] are h_{t-1}, c_{t-1}, the state before
    step t."""
    B, L, _ = x_pre.shape
    H = h0.shape[-1]
    f32 = torch.float32
    check_tensors("lstm_scan_train_fwd", x_pre.device, {
        **_shapes(x_pre, mask, w_hid, peepholes, H), "h0": (h0, f32, (B, H)), "c0": (c0, f32, (B, H)),
    })
    if B == 0 or L == 0:
        raise ValueError("lstm_scan_train_fwd: the kernel needs B >= 1 and L >= 1")
    dev = x_pre.device
    path, C, R = lstm_train_plan(B, H, dev, backward=False)
    out = torch.empty((B, H), dtype=f32, device=dev)
    hs = torch.empty((L, B, H), dtype=f32, device=dev)
    cs = torch.empty((L, B, H), dtype=f32, device=dev)
    with on_device(dev):
        err = _library().seqrec_lstm_train_fwd_f32(
            x_pre.data_ptr(), mask.data_ptr(), w_hid.data_ptr(), peepholes.data_ptr(), h0.data_ptr(),
            c0.data_ptr(), out.data_ptr(), hs.data_ptr(), cs.data_ptr(), B, L, H, PATHS[path], C, R,
            torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"lstm_scan_train_fwd kernel launch ({path} path) failed with CUDA error {err}")
    lstm_scan_train_fwd.launches += 1
    lstm_scan_train_fwd.wide_launches += path == "wide"
    return out, hs, cs


def lstm_scan_train_bwd(x_pre, mask, w_hid, peepholes, hs, cs, dh, grad_clip: float):
    """K5 backward on the card: (dx_pre [B, L, 4H], dW_hid [H, 4H],
    dpeepholes [3, H], dh0 [B, H], dc0 [B, H]) for the upstream cotangent
    dh [B, H] of the final hidden state."""
    B, L, _ = x_pre.shape
    H = dh.shape[-1]
    f32 = torch.float32
    check_tensors("lstm_scan_train_bwd", x_pre.device, {
        **_shapes(x_pre, mask, w_hid, peepholes, H), "hs": (hs, f32, (L, B, H)),
        "cs": (cs, f32, (L, B, H)), "dh": (dh, f32, (B, H)),
    })
    if B == 0 or L == 0:
        raise ValueError("lstm_scan_train_bwd: the kernel needs B >= 1 and L >= 1")
    dev = x_pre.device
    path, C, R = lstm_train_plan(B, H, dev, backward=True)
    G = 4 * H
    dx = torch.empty((B, L, G), dtype=f32, device=dev)
    dh0 = torch.empty((B, H), dtype=f32, device=dev)
    dc0 = torch.empty((B, H), dtype=f32, device=dev)
    dw = torch.empty((H, G), dtype=f32, device=dev)
    dpeep = torch.empty((3, H), dtype=f32, device=dev)
    part, dpre, w_t, n_splits, per_split = backward_scratch(path, B, L, R, w_hid)
    blocks = -(-B // R)  # row tiles (reg, wide, l2) or clusters: one dpeep partial each
    peep_part = torch.empty((blocks, 3 * H), dtype=f32, device=dev) if blocks > 1 else None
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with on_device(dev):
        err = _library().seqrec_lstm_train_bwd_f32(
            x_pre.data_ptr(), mask.data_ptr(), w_hid.data_ptr(), ptr(w_t), peepholes.data_ptr(),
            hs.data_ptr(), cs.data_ptr(), dh.data_ptr(), dx.data_ptr(), dh0.data_ptr(), dc0.data_ptr(),
            dw.data_ptr(), dpeep.data_ptr(), ptr(dpre), ptr(part), ptr(peep_part), B, L, H, PATHS[path], C, R,
            n_splits, per_split, float(grad_clip or 0.0), torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"lstm_scan_train_bwd kernel launch ({path} path) failed with CUDA error {err}")
    lstm_scan_train_bwd.launches += 1
    lstm_scan_train_bwd.wide_launches += path == "wide"
    return dx, dw, dpeep, dh0, dc0


# every launch, and those of the wide path
lstm_scan_train_fwd.launches = lstm_scan_train_fwd.wide_launches = 0
lstm_scan_train_bwd.launches = lstm_scan_train_bwd.wide_launches = 0


class _LSTMScanTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_pre, mask, w_hid, peepholes, h0, c0, grad_clip):
        x_pre, mask, w_hid, peepholes, h0, c0 = (t.contiguous() for t in (x_pre, mask, w_hid, peepholes, h0, c0))
        h, hs, cs = lstm_scan_train_fwd(x_pre, mask, w_hid, peepholes, h0, c0)
        ctx.save_for_backward(x_pre, mask, w_hid, peepholes, hs, cs)
        ctx.grad_clip = grad_clip
        return h

    @staticmethod
    def backward(ctx, dh):
        x_pre, mask, w_hid, peepholes, hs, cs = ctx.saved_tensors
        dx, dw, dpeep, dh0, dc0 = lstm_scan_train_bwd(
            x_pre, mask, w_hid, peepholes, hs, cs, dh.contiguous(), ctx.grad_clip
        )
        return dx, None, dw, dpeep, dh0, dc0, None


def lstm_scan_train(x_pre, mask, w_hid, peepholes, h0, c0, grad_clip: float = 0.0):
    """Final LSTM hidden state [B, H] of x_pre [B, L, 4H], mask [B, L],
    w_hid [H, 4H], peepholes [3, H] (w_ci, w_cf, w_co), h0 and c0 [B, H]
    (f32), differentiable in all but the mask, with the cotangent of the
    summed pre-activation clipped to +-grad_clip (0: no clip)."""
    if x_pre.device.type == "cpu":
        return lstm_scan_train_plain(x_pre, mask, w_hid, peepholes, h0, c0, grad_clip)
    if x_pre.device.type != "cuda":
        raise ValueError(f"lstm_scan_train: no kernel for device {x_pre.device}")
    return _LSTMScanTrain.apply(x_pre, mask, w_hid, peepholes, h0, c0, float(grad_clip or 0.0))
