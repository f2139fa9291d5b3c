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

Both run the training scans' forward kernels (K1's, K5's) without their
state stores, on the training forward's plan
(``ops/rnn_scan_train.py:train_scan_plan``): W_hid in registers (H <= 50),
split over a thread-block cluster of at most 32 units a CTA (H up to 256),
or the single-block kernel reading W_hid through L2 where no cluster slice
fits. :func:`gru_scan_plan` gives the GRU one more kernel, from
``GRU_CLUSTER_MIN_H`` (256, where it measured faster) up to its reach (H
of about 368 on an H100): ``csrc/gru_cluster.cuh``'s, 8 CTAs of up to 64
units and 64 rows.
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


# the paths of K1, K3, K5 and K6 (csrc/scan_train.cuh kPath*); "wide" is the training scans' alone (K1's and
# K5's csrc/scan_train_wide.cuh)
PATHS = {"reg": 0, "cluster": 1, "l2": 2, "wide": 4}
GRU_PATHS = {**PATHS, "gru_cluster": 3}  # K3's, with gru_cluster.cuh's kernel (csrc/gru_scan.cu kPathGruCluster)
# K3 runs gru_cluster.cuh's kernel (8 CTAs of up to 64 units, tiles up to 64 rows) from this H on:
# at GRU-256 serving's B512 chunk its 8x40 tile took 0.356 ms where the training forward's cluster
# kernel (at most 32 units and 32 rows) took 0.467 on its 8x24 plan; at H=192 the training kernel was
# the faster (kernel_breakdown.py --parts k3 on an H100, PERF.md §6)
GRU_CLUSTER_MIN_H = 256
CLUSTER_CTAS = 8  # CTAs of one cluster, the portable maximum (gru_cluster.cuh kClusterMax)
CLUSTER_ROWS = (64, 48, 40, 32, 16, 8)  # row tiles of one cluster (8 warps x 8 ... 1 rows)
CLUSTER_MAX_UNITS = 64  # units of one CTA: at most two per lane
CLUSTER_STEP_ROWS = 24  # a step's fixed cost (barrier, gate math, stores) in rows of product


def gru_cluster_units(H: int, C: int) -> list[tuple[int, int]]:
    """[begin, end) of the hidden units of each CTA of a C-CTA cluster
    (gru_cluster.cuh unit_begin)."""
    return [(q * H // C, (q + 1) * H // C) for q in range(C)]


def gru_cluster_smem(H: int, C: int, R: int) -> int:
    """Shared-memory bytes of one CTA of gru_cluster.cuh's kernel: its
    W_hid slice [H padded to 4, 3 ceil(H / C)] and the h double buffer
    [2, R, H padded to 4] (gru_cluster.cuh gru_cluster_smem)."""
    Hp = -(-H // 4) * 4
    return 4 * (Hp * 3 * -(-H // C) + 2 * R * Hp)


def gru_cluster_tile(B: int, H: int, n_sm: int, smem_optin: int, held=None) -> int | None:
    """Rows R a cluster of gru_cluster.cuh's kernel (C = 8) at batch B and
    hidden size H: the tile whose waves of clusters times (R + 24), a
    step's product plus its fixed cost, is least, ties to the larger R;
    ``held`` maps R to the clusters of that tile the card holds at once
    (default: one per 8 SMs). None where no tile fits: H < 8, over 64
    units a CTA, or no tile within ``smem_optin`` bytes."""
    C = CLUSTER_CTAS
    if H < C or -(-H // C) > CLUSTER_MAX_UNITS:
        return None
    best = None
    for R in CLUSTER_ROWS:
        if gru_cluster_smem(H, C, R) > smem_optin:
            continue
        n = held[R] if held is not None else n_sm // C
        cost = -(-(-(-B // R)) // max(1, n)) * (R + CLUSTER_STEP_ROWS)
        if best is None or cost < best[0]:
            best = (cost, R)
    return None if best is None else best[1]


def gru_scan_plan(B: int, H: int, n_sm: int, smem_optin: int, capacity=None,
                  gru_cluster_held=None) -> tuple[str, int, int]:
    """(path, C, R) of the GRU eval scan (K3) at batch B and hidden size H
    on a card of ``n_sm`` SMs and ``smem_optin`` bytes of shared memory a
    block may use.

    - ``"gru_cluster"``, from H = GRU_CLUSTER_MIN_H (256) on where a tile
      fits (H up to about 368 on an H100): gru_cluster.cuh's kernel, C =
      8, R from :func:`gru_cluster_tile` on ``gru_cluster_held``.
    - otherwise the training forward's plan
      (``ops/rnn_scan_train.py:train_scan_plan``, forward), whose kernels
      K3 runs without their state stores: ``"reg"`` (H <= 50, W_hid in
      registers), ``"cluster"`` (W_hid split over C CTAs of at most 32
      units, R rows a cluster; ``capacity`` maps (C, R) to the clusters
      held) or ``"l2"`` (no cluster slice fits: the single-block kernel
      reading W_hid through L2).
    """
    if H >= GRU_CLUSTER_MIN_H:
        R = gru_cluster_tile(B, H, n_sm, smem_optin, gru_cluster_held)
        if R is not None:
            return "gru_cluster", CLUSTER_CTAS, R
    from seqrec_tpu_torch.ops.rnn_scan_train import train_scan_plan  # it imports this module

    return train_scan_plan("gru", B, H, n_sm, smem_optin, False, capacity, kernels="scan")


_limits: dict[int, tuple[int, int]] = {}
_plans: dict[tuple[int, int, int], tuple[str, int, int]] = {}


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


def gru_scan_device_plan(B: int, H: int, device) -> tuple[str, int, int]:
    """K3's (path, C, R) on ``device``, cached per (device, B, H): from
    GRU_CLUSTER_MIN_H on, gru_cluster.cuh's tile on the card's cluster
    capacity; below it, or past that kernel's reach, the training
    forward's plan as ``ops/rnn_scan_train.py:device_train_plan`` makes it
    of K3's own library (the capacity of the eval form of the cluster
    kernel). Either way the first plan of a shape holds its shared-memory
    count against the kernel's (``seqrec_gru_scan_smem``) and raises if
    they differ."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    plan = _plans.get((index, B, H))
    if plan is not None:
        return plan
    n_sm, smem = device_limits(index)
    if H >= GRU_CLUSTER_MIN_H and gru_cluster_tile(B, H, n_sm, smem) is not None:
        held = {R: gru_cluster_capacity(H, CLUSTER_CTAS, R, index)
                for R in CLUSTER_ROWS if gru_cluster_smem(H, CLUSTER_CTAS, R) <= smem}
        plan = gru_scan_plan(B, H, n_sm, smem, gru_cluster_held=held)
        got = _library().seqrec_gru_scan_smem(0, GRU_PATHS[plan[0]], H, plan[1], plan[2])
        if got != gru_cluster_smem(H, plan[1], plan[2]):
            raise RuntimeError(f"gru scan: the plan {plan} at H={H} counts {gru_cluster_smem(H, plan[1], plan[2])} "
                               f"bytes of shared memory, its kernel {got}")
    else:
        from seqrec_tpu_torch.ops.rnn_scan_train import device_train_plan  # it imports this module

        plan = device_train_plan("gru", B, H, device, False, _library, kernels="scan")
    _plans[index, B, H] = plan
    return plan


_lib = None


def _library():
    global _lib
    if _lib is not None:
        return _lib
    lib = _build.load("gru_scan")
    lib.seqrec_gru_scan_f32.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.seqrec_gru_scan_f32.restype = ctypes.c_int
    lib.seqrec_gru_scan_capacity.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
    lib.seqrec_gru_scan_capacity.restype = ctypes.c_int
    lib.seqrec_gru_scan_smem.argtypes = [ctypes.c_int] * 5
    lib.seqrec_gru_scan_smem.restype = ctypes.c_longlong
    lib.seqrec_gru_cluster_capacity.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    lib.seqrec_gru_cluster_capacity.restype = ctypes.c_int
    lib.seqrec_gru_device_limits.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
    lib.seqrec_gru_device_limits.restype = ctypes.c_int
    _lib = lib
    return lib


def gru_cluster_capacity(H: int, C: int, R: int, device="cuda") -> int:
    """Clusters of gru_cluster.cuh's kernel at (H, C, R) that the card
    holds at once (cudaOccupancyMaxActiveClusters)."""
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
    the kernel of :func:`gru_scan_device_plan`'s path; ``gru_scan.launches``
    counts every launch, ``gru_scan.reg_launches``,
    ``gru_scan.cluster_launches`` and ``gru_scan.gru_cluster_launches``
    those of the reg, cluster and gru_cluster paths."""
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
    path, C, R = gru_scan_device_plan(B, H, x_pre.device)
    with on_device(x_pre.device):
        err = _library().seqrec_gru_scan_f32(
            x_pre.data_ptr(), mask.data_ptr(), w_hid.data_ptr(), h0.data_ptr(), out.data_ptr(), B, L, H,
            GRU_PATHS[path], C, R, torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"gru_scan kernel launch ({path} path) failed with CUDA error {err}")
    gru_scan.launches += 1
    gru_scan.reg_launches += path == "reg"
    gru_scan.cluster_launches += path == "cluster"
    gru_scan.gru_cluster_launches += path == "gru_cluster"
    return out


gru_scan.launches = 0
gru_scan.reg_launches = gru_scan.cluster_launches = gru_scan.gru_cluster_launches = 0


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
