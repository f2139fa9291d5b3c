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
check also holds the kernels against. :func:`gru_scan_plan` picks the GRU
kernel from the shape: one block per row tile where W_hid fits in its
shared memory, else W_hid split over a thread-block cluster.
:func:`lstm_scan_plan` picks the LSTM kernel: the training scan's forward
(K5) without its state stores, W_hid in registers (H <= 50) or split over
a thread-block cluster, or the single-block kernel reading W_hid through
L2 where no cluster slice fits.
"""

from __future__ import annotations

import ctypes

import torch

from seqrec_tpu_torch.ops import _build
from seqrec_tpu_torch.ops.core import check_tensors, maybe_grad_clip, on_device


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


PATHS = {"reg": 0, "cluster": 1, "l2": 2}  # the paths of K1, K5 and K6 (csrc/scan_train.cuh kPath*)
SCAN_ROWS_MAX = 8  # rows of one single-block tile (csrc/scan_common.cuh kMaxRows)
CLUSTER_CTAS = 8  # CTAs of one cluster, the portable maximum (gru_cluster.cuh kClusterMax)
CLUSTER_ROWS = (64, 48, 40, 32, 16, 8)  # row tiles of one cluster (8 warps x 8 ... 1 rows)
CLUSTER_MAX_UNITS = 64  # units of one CTA: at most two per lane
CLUSTER_STEP_ROWS = 24  # a step's fixed cost (barrier, gate math, stores) in rows of product


def gru_cluster_units(H: int, C: int) -> list[tuple[int, int]]:
    """[begin, end) of the hidden units of each CTA of a C-CTA cluster
    (gru_cluster.cuh unit_begin)."""
    return [(q * H // C, (q + 1) * H // C) for q in range(C)]


def gru_cluster_smem(H: int, C: int, R: int) -> int:
    """Shared-memory bytes of one CTA of the cluster kernel: its W_hid
    slice [H padded to 4, 3 ceil(H / C)] and the h double buffer
    [2, R, H padded to 4] (gru_cluster.cuh gru_cluster_smem)."""
    Hp = -(-H // 4) * 4
    return 4 * (Hp * 3 * -(-H // C) + 2 * R * Hp)


def gru_scan_plan(B: int, H: int, n_sm: int, smem_optin: int, capacity=None) -> tuple[str, int, int]:
    """(path, C, R) of the GRU eval scan at batch B and hidden size H on a
    card of ``n_sm`` SMs and ``smem_optin`` bytes of shared memory a block
    may use; ``capacity`` maps R to the clusters of that tile the card
    holds at once (default: one per C SMs).

    - ``"shared"``: one block per tile of R rows (about one block per SM,
      at most 8 rows), W_hid in its shared memory; C = 1.
    - ``"cluster"``: clusters of C = 8 CTAs, each cluster R rows, W_hid
      split over the CTAs. R is the tile whose waves of clusters times
      (R + 24), a step's product plus its fixed cost, is least; ties go to
      the larger R.
    - ``"l2"``: the single-block kernel reading W_hid through L2, where
      not even a cluster slice fits (H above about 370); C = 1.
    """
    rows = min(SCAN_ROWS_MAX, max(1, -(-B // n_sm)))
    if rows * 4 * H * 4 + 3 * H * H * 4 <= smem_optin:  # scan_common.cuh launch_scan
        return "shared", 1, rows
    C = CLUSTER_CTAS
    best = None
    if H >= C and -(-H // C) <= CLUSTER_MAX_UNITS:
        for R in CLUSTER_ROWS:
            if gru_cluster_smem(H, C, R) > smem_optin:
                continue
            held = capacity[R] if capacity is not None else n_sm // C
            waves = -(-(-(-B // R)) // max(1, held))
            cost = waves * (R + CLUSTER_STEP_ROWS)
            if best is None or cost < best[0]:
                best = (cost, R)
    if best is None:
        return "l2", 1, rows
    return "cluster", C, best[1]


_limits: dict[int, tuple[int, int]] = {}
_capacity: dict[tuple[int, int], dict[int, int]] = {}


def device_limits(index: int) -> tuple[int, int]:
    """(SM count, opt-in shared memory a block may use) of CUDA device
    ``index``, read once."""
    if index not in _limits:
        n_sm, smem = ctypes.c_int(0), ctypes.c_int(0)
        with torch.cuda.device(index):
            err = _library().seqrec_gru_device_limits(ctypes.byref(n_sm), ctypes.byref(smem))
        if err:
            raise RuntimeError(f"gru_scan: reading the device limits failed with CUDA error {err}")
        _limits[index] = (n_sm.value, smem.value)
    return _limits[index]


def _device_plan(B, H, device):
    """gru_scan_plan on ``device``'s SM count, opt-in shared memory and
    cluster capacity."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    n_sm, smem = device_limits(index)
    if gru_scan_plan(B, H, n_sm, smem)[0] != "cluster":
        return gru_scan_plan(B, H, n_sm, smem)
    if (index, H) not in _capacity:
        _capacity[index, H] = {
            R: gru_cluster_capacity(H, CLUSTER_CTAS, R, index)
            for R in CLUSTER_ROWS if gru_cluster_smem(H, CLUSTER_CTAS, R) <= smem
        }
    return gru_scan_plan(B, H, n_sm, smem, _capacity[index, H])


def _library():
    lib = _build.load("gru_scan")
    fn = lib.seqrec_gru_scan_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.seqrec_gru_scan_cluster_f32.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.seqrec_gru_scan_cluster_f32.restype = ctypes.c_int
        lib.seqrec_gru_cluster_capacity.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
        lib.seqrec_gru_cluster_capacity.restype = ctypes.c_int
        lib.seqrec_gru_device_limits.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
        lib.seqrec_gru_device_limits.restype = ctypes.c_int
    return lib


def gru_cluster_capacity(H: int, C: int, R: int, device="cuda") -> int:
    """Clusters of the cluster kernel at (H, C, R) that the card holds at
    once (cudaOccupancyMaxActiveClusters)."""
    lib = _library()
    n = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = lib.seqrec_gru_cluster_capacity(H, C, R, ctypes.byref(n))
    if err:
        raise RuntimeError(f"gru_cluster_capacity failed with CUDA error {err}")
    return n.value


def gru_scan(x_pre, mask, w_hid, h0):
    """Final GRU state [B, H] (f32) of x_pre [B, L, 3H], mask [B, L],
    w_hid [H, 3H] and h0 [B, H], all f32 and contiguous. On a CUDA tensor
    the kernel of :func:`gru_scan_plan`'s path; ``gru_scan.launches``
    counts every launch and ``gru_scan.cluster_launches`` those of the
    cluster kernel."""
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
    path, C, R = _device_plan(B, H, x_pre.device)
    lib = _library()
    ptrs = (x_pre.data_ptr(), mask.data_ptr(), w_hid.data_ptr(), h0.data_ptr(), out.data_ptr())
    with torch.cuda.device(x_pre.device):
        stream = torch.cuda.current_stream().cuda_stream
        if path == "cluster":
            err = lib.seqrec_gru_scan_cluster_f32(*ptrs, B, L, H, C, R, stream)
        else:
            err = lib.seqrec_gru_scan_f32(*ptrs, B, L, H, stream)
    if err:
        raise RuntimeError(f"gru_scan kernel launch ({path} path) failed with CUDA error {err}")
    gru_scan.launches += 1
    gru_scan.cluster_launches += path == "cluster"
    return out


gru_scan.launches = 0
gru_scan.cluster_launches = 0


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
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.seqrec_lstm_scan_capacity.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
        lib.seqrec_lstm_scan_capacity.restype = ctypes.c_int
        lib.seqrec_lstm_scan_smem.argtypes = [ctypes.c_int] * 5
        lib.seqrec_lstm_scan_smem.restype = ctypes.c_longlong
    return lib


def lstm_scan_plan(B: int, H: int, device) -> tuple[str, int, int]:
    """K6's (path, C, R) on ``device``: the training scan's forward plan
    (``ops/rnn_scan_train.py:train_scan_plan``), whose kernels K6 runs
    without their state stores: "reg" (H <= 50), "cluster" (W_hid split
    over C CTAs, R rows a cluster) or "l2" (no cluster slice fits)."""
    from seqrec_tpu_torch.ops.rnn_scan_train import device_train_plan  # it imports this module

    return device_train_plan("lstm", B, H, device, False, _lstm_library, kernels="scan")


def lstm_scan(x_pre, mask, w_hid, peepholes, h0, c0):
    """Final LSTM hidden state [B, H] (f32) of x_pre [B, L, 4H], mask
    [B, L], w_hid [H, 4H], peepholes [3, H] (w_ci, w_cf, w_co), h0 and c0
    [B, H], all f32 and contiguous. On a CUDA tensor the kernel of
    :func:`lstm_scan_plan`'s path; ``lstm_scan.launches`` counts every
    launch, ``lstm_scan.reg_launches`` and ``lstm_scan.cluster_launches``
    those of the reg and cluster paths."""
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
    path, C, R = lstm_scan_plan(B, H, x_pre.device)
    with on_device(x_pre.device):
        err = _lstm_library().seqrec_lstm_scan_f32(
            x_pre.data_ptr(), mask.data_ptr(), w_hid.data_ptr(), peepholes.data_ptr(), h0.data_ptr(),
            c0.data_ptr(), out.data_ptr(), B, L, H, PATHS[path], C, R, torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"lstm_scan kernel launch ({path} path) failed with CUDA error {err}")
    lstm_scan.launches += 1
    lstm_scan.reg_launches += path == "reg"
    lstm_scan.cluster_launches += path == "cluster"
    return out


lstm_scan.launches = 0
lstm_scan.reg_launches = 0
lstm_scan.cluster_launches = 0
