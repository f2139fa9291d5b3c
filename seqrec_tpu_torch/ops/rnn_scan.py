"""Forward GRU and LSTM time scans for eval and serving (kernels K3, K6),
and the plain masked cell steps of all three towers.

Counterpart of ``seqrec_tpu/ops/pallas_rnn.py:gru_scan`` and
``lstm_scan``: from the precomputed input contributions ``x_pre`` (the
gather-sum of the input table plus bias, ``[B, L, 3H]`` for the GRU,
``[B, L, 4H]`` for the LSTM), run the cell over all L steps and return the
final hidden state. On a CUDA tensor :func:`gru_scan` and
:func:`lstm_scan` launch the CUDA kernels of ``csrc/gru_scan.cu`` and
``csrc/lstm_scan.cu``; on a CPU tensor they run :func:`gru_scan_plain` and
:func:`lstm_scan_plain`, the same math in plain PyTorch, which the chip
check also holds the kernels against.
"""

from __future__ import annotations

import ctypes

import torch

from seqrec_tpu_torch.ops import _build
from seqrec_tpu_torch.ops.core import check_tensors, maybe_grad_clip


def gru_step(h, x_t, m, w_hid, grad_clip: float = 0.0):
    """One masked GRU step (Lasagne formulation, gate order
    reset|update|candidate); rows whose ``m`` [B, 1] is 0 keep ``h``.
    ``grad_clip`` clips the cotangent of ``hid`` in the backward
    (``seqrec_tpu/models/recurrent.py:_gru_step``)."""
    H = h.shape[-1]
    hid = maybe_grad_clip(h @ w_hid, grad_clip)
    r = torch.sigmoid(x_t[:, :H] + hid[:, :H])
    u = torch.sigmoid(x_t[:, H : 2 * H] + hid[:, H : 2 * H])
    c = torch.tanh(x_t[:, 2 * H :] + r * hid[:, 2 * H :])
    h_new = (1.0 - u) * h + u * c
    return torch.where(m > 0, h_new, h)


def lstm_step(h, c, x_t, m, w_hid, peepholes, grad_clip: float = 0.0):
    """One masked LSTM step with peepholes (Lasagne formulation, gate order
    in|forget|cell|out; ``peepholes`` [3, H] or a triple (w_ci, w_cf,
    w_co)); rows whose ``m`` [B, 1] is 0 keep ``(h, c)``. ``grad_clip``
    clips the cotangent of the summed ``x_t + h W_hid`` in the backward;
    the peephole terms are added after it
    (``seqrec_tpu/models/recurrent.py:_lstm_step``)."""
    H = h.shape[-1]
    pre = maybe_grad_clip(x_t + h @ w_hid, grad_clip)
    i = torch.sigmoid(pre[:, :H] + c * peepholes[0])
    f = torch.sigmoid(pre[:, H : 2 * H] + c * peepholes[1])
    g = torch.tanh(pre[:, 2 * H : 3 * H])
    c_new = f * c + i * g
    o = torch.sigmoid(pre[:, 3 * H :] + c_new * peepholes[2])
    h_new = o * torch.tanh(c_new)
    keep = m > 0
    return torch.where(keep, h_new, h), torch.where(keep, c_new, c)


def vanilla_step(h, x_t, m, w_hid, grad_clip: float = 0.0):
    """One masked tanh RNN step; ``grad_clip`` clips the cotangent of
    ``x_t + h W_hid`` (``seqrec_tpu/models/recurrent.py:_vanilla_step``)."""
    h_new = torch.tanh(maybe_grad_clip(x_t + h @ w_hid, grad_clip))
    return torch.where(m > 0, h_new, h)


def gru_scan_plain(x_pre, mask, w_hid, h0):
    """x_pre [B, L, 3H], mask [B, L], w_hid [H, 3H], h0 [B, H] -> [B, H]."""
    h = h0
    for t in range(x_pre.shape[1]):
        h = gru_step(h, x_pre[:, t], mask[:, t : t + 1], w_hid)
    return h


def _library():
    lib = _build.load("gru_scan")
    fn = lib.seqrec_gru_scan_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def gru_scan(x_pre, mask, w_hid, h0):
    """Final GRU state [B, H] (f32) of x_pre [B, L, 3H], mask [B, L],
    w_hid [H, 3H] and h0 [B, H], all f32 and contiguous."""
    if x_pre.device.type == "cpu":
        return gru_scan_plain(x_pre, mask, w_hid, h0)
    B, L, _ = x_pre.shape
    H = h0.shape[-1]
    f32 = torch.float32
    check_tensors("gru_scan", x_pre.device, {
        "x_pre": (x_pre, f32, (B, L, 3 * H)), "mask": (mask, f32, (B, L)),
        "w_hid": (w_hid, f32, (H, 3 * H)), "h0": (h0, f32, (B, H)),
    })
    out = torch.empty((B, H), dtype=torch.float32, device=x_pre.device)
    if B == 0:
        return out
    fn = _library()
    with torch.cuda.device(x_pre.device):
        err = fn(
            x_pre.data_ptr(), mask.data_ptr(), w_hid.data_ptr(), h0.data_ptr(), out.data_ptr(),
            B, L, H, torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"gru_scan kernel launch failed with CUDA error {err}")
    gru_scan.launches += 1
    return out


gru_scan.launches = 0


def lstm_scan_plain(x_pre, mask, w_hid, peepholes, h0, c0):
    """x_pre [B, L, 4H], mask [B, L], w_hid [H, 4H], peepholes [3, H]
    (w_ci, w_cf, w_co), h0 and c0 [B, H] -> final hidden state [B, H]."""
    h, c = h0, c0
    for t in range(x_pre.shape[1]):
        h, c = lstm_step(h, c, x_pre[:, t], mask[:, t : t + 1], w_hid, peepholes)
    return h


def _lstm_library():
    lib = _build.load("lstm_scan")
    fn = lib.seqrec_lstm_scan_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def lstm_scan(x_pre, mask, w_hid, peepholes, h0, c0):
    """Final LSTM hidden state [B, H] (f32) of x_pre [B, L, 4H], mask
    [B, L], w_hid [H, 4H], peepholes [3, H] (w_ci, w_cf, w_co), h0 and c0
    [B, H], all f32 and contiguous."""
    if x_pre.device.type == "cpu":
        return lstm_scan_plain(x_pre, mask, w_hid, peepholes, h0, c0)
    B, L, _ = x_pre.shape
    H = h0.shape[-1]
    f32 = torch.float32
    check_tensors("lstm_scan", x_pre.device, {
        "x_pre": (x_pre, f32, (B, L, 4 * H)), "mask": (mask, f32, (B, L)),
        "w_hid": (w_hid, f32, (H, 4 * H)), "peepholes": (peepholes, f32, (3, H)),
        "h0": (h0, f32, (B, H)), "c0": (c0, f32, (B, H)),
    })
    out = torch.empty((B, H), dtype=torch.float32, device=x_pre.device)
    if B == 0:
        return out
    fn = _lstm_library()
    with torch.cuda.device(x_pre.device):
        err = fn(
            x_pre.data_ptr(), mask.data_ptr(), w_hid.data_ptr(), peepholes.data_ptr(), h0.data_ptr(),
            c0.data_ptr(), out.data_ptr(), B, L, H, torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"lstm_scan kernel launch failed with CUDA error {err}")
    lstm_scan.launches += 1
    return out


lstm_scan.launches = 0
