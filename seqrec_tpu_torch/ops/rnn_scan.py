"""Forward GRU time scan for eval and serving (kernel K3).

Counterpart of ``seqrec_tpu/ops/pallas_rnn.py:gru_scan``: from the
precomputed input contributions ``x_pre [B, L, 3H]`` (the gather-sum of the
input table plus bias), run the GRU over all L steps and return the final
state. On a CUDA tensor :func:`gru_scan` launches the CUDA kernel of
``csrc/gru_scan.cu``; on a CPU tensor it runs :func:`gru_scan_plain`, the
same math in plain PyTorch, which the chip check also holds the kernel
against.
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
