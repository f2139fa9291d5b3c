"""Differentiable GRU time scan for training (kernel K1), and the plan of
both training scans (K1 and K5).

Counterpart of ``seqrec_tpu/ops/pallas_rnn_train.py:gru_scan_train``: the
final GRU state [B, H] of ``x_pre [B, L, 3H]`` (gate order
reset|update|candidate, masked steps carry h), whose backward recomputes
the gates from ``x_pre[t]`` and ``h_{t-1}``, clips the cotangent of
``hid = h_{t-1} W_hid`` to +-``grad_clip`` (Lasagne's grad clipping) and
gives dx_pre (unclipped: the caller clips ``x_pre`` itself), dW_hid and
dh0.

On a CUDA tensor :func:`gru_scan_train` runs an autograd Function whose
forward launches :func:`gru_scan_train_fwd` and whose backward launches
:func:`gru_scan_train_bwd`, the kernels of ``csrc/gru_scan_train.cu`` on
the path :func:`train_scan_plan` picks; on a CPU tensor it runs
:func:`gru_scan_train_plain`, the plain masked loop with the same clip,
differentiated by autograd. The chip check holds the kernels against that
plain version.
"""

from __future__ import annotations

import ctypes

import torch

from seqrec_tpu_torch.ops import _build
from seqrec_tpu_torch.ops.core import check_tensors, on_device
from seqrec_tpu_torch.ops.rnn_scan import PATHS, device_limits, gru_step

TILE = 64  # the dW splits' rows come in whole multiples of this (two 32-row slices)
DW_TILE = 128  # rows and columns of one dW output tile (csrc/block_mma.cuh kBT)
REG_MAX_H = 50  # csrc/scan_train_reg.cuh kRegMaxH
REG_MAX_ROWS = 16
REG_HS, REG_GS = 52, 208  # row strides of its h and hid buffers
WIDE_MAX_H = 50  # csrc/scan_train_wide.cuh kWideMaxH
WIDE_ROWS = (16, 32)  # rows of a forward and of a backward CTA (kWideFwdRows, kWideBwdRows)
# rows an SM from which a training scan takes the wide path: K1 past the reg path's 16; K5 from 14, where its reg
# and wide kernels cross (L 200, H 50 on an H100, forward and backward: 3.71 against 3.76 ms at 13 rows an SM,
# 3.99 against 3.85 at 14)
WIDE_MIN_ROWS = {"gru": REG_MAX_ROWS + 1, "lstm": 14}
CLUSTER_CTAS = (2, 4, 8)
CLUSTER_ROWS = (32, 24, 16, 8)  # csrc/scan_train.cuh cluster_*_instance
CLUSTER_UNITS = 32  # units of one CTA: one a lane
CLUSTER_STEP_ROWS = 24  # a step's fixed cost in rows of product (ops/rnn_scan.py's)
L2_MAX_ROWS = 8  # csrc/scan_common.cuh kMaxRows


def gru_scan_train_plain(x_pre, mask, w_hid, h0, grad_clip: float = 0.0):
    """Plain version: x_pre [B, L, 3H], mask [B, L], w_hid [H, 3H],
    h0 [B, H] -> final state [B, H], differentiable."""
    h = h0
    for t in range(x_pre.shape[1]):
        h = gru_step(h, x_pre[:, t], mask[:, t : t + 1], w_hid, grad_clip)
    return h


def dw_split_plan(K: int, H: int, G: int, n_sm: int) -> tuple[int, int]:
    """(n_splits, rows_per_split) of the K = L*B rows of dW = hs^T dpre on
    the cluster and l2 paths, dW [H, G] (G = 3H for the GRU, 4H for the
    LSTM): about one block per SM over the 128 x 128 output tiles, whole
    multiples of TILE rows per split, no split empty."""
    out_tiles = -(-H // DW_TILE) * -(-G // DW_TILE)
    k_tiles = -(-K // TILE)
    n_splits = max(1, min(-(-n_sm // out_tiles), k_tiles))
    per_split = -(-k_tiles // n_splits) * TILE
    return -(-K // per_split), per_split


def backward_scratch(path: str, B: int, L: int, R: int, w_hid):
    """(part, split, w_t, n_splits, per_split): the scratch of a training
    scan's backward on ``path`` at B rows, L steps and R rows a block, on
    ``w_hid``'s device (W_hid [H, G]). reg and wide: per-block dW partials
    part [ceil(B / R), H, G] where there is more than one block; cluster
    and l2: the dhid (dpre) rows split [L, B, G] and the dW splits' part
    [n_splits, H, G] (dw_split_plan, n_splits of per_split rows); l2 also
    W^T as w_t [G, H]. None where a buffer is not needed."""
    H, G = w_hid.shape
    if path in ("reg", "wide"):
        part = torch.empty((-(-B // R), H, G), dtype=torch.float32, device=w_hid.device) if B > R else None
        return part, None, None, 0, 0
    n_splits, per_split = dw_split_plan(L * B, H, G, device_limits(w_hid.device.index)[0])
    split = torch.empty((L, B, G), dtype=torch.float32, device=w_hid.device)
    part = torch.empty((n_splits, H, G), dtype=torch.float32, device=w_hid.device)
    return part, split, w_hid.t().contiguous() if path == "l2" else None, n_splits, per_split


def _h4(n: int) -> int:
    return -(-n // 4) * 4


def train_scan_smem(cell: str, path: str, H: int, C: int, R: int, backward: bool) -> int:
    """Shared-memory bytes of one block (CTA) of a training scan's kernel
    (csrc/scan_train_reg.cuh reg_*_floats, scan_train_wide.cuh
    wide_*_floats, scan_train_cluster.cuh cluster_*_floats, and the l2
    kernels' state)."""
    n = 3 if cell == "gru" else 4
    if path == "wide":  # R = WIDE_ROWS[backward]
        HQ, G, S = -(-H // 4) * 4, n * H, R + 4  # units to 4s; rows of the transposed buffers S floats apart
        floats = 2 * R + 2 * R * G + HQ * (HQ // 2) * 8  # mask, x_pre, W as [HQ, HQ / 2, 8]
        if backward:  # h [3, HQ, S], dhid [2, G to 16s, S], W^T as [G to 16s, HQ]
            GP = -(-G // 16) * 16
            floats += 3 * HQ * S + 2 * GP * S + GP * HQ
        else:  # h [2, HQ, S]
            floats += 2 * HQ * S
    elif path == "reg":
        floats = R * (9 * REG_HS + 2 * REG_GS + 3 * n * H + 3 + 3 * H) if backward else R * (
            2 * REG_HS + REG_GS + 2 * n * H + 2)
    elif path == "cluster":
        U, Hp, Gp = -(-H // C), _h4(H), _h4(n * H)
        floats = Hp * n * U + 2 * R * Hp + (Gp * U + 2 * R * Gp if backward else 0)
    elif cell == "gru":
        floats = R * (6 if backward else 4) * H
    else:
        floats = R * 11 * H + 3 * H + R if backward else R * 6 * H
    return 4 * floats


def train_scan_plan(cell: str, B: int, H: int, n_sm: int, smem_optin: int, backward: bool = True,
                    capacity=None, kernels: str = "train") -> tuple[str, int, int]:
    """(path, C, R) of the training scan of ``cell`` ("gru": K1, "lstm":
    K5), forward or backward, at batch B and hidden size H on a card of
    ``n_sm`` SMs and ``smem_optin`` bytes of shared memory a block may use;
    ``capacity`` maps (C, R) to the clusters of that shape the card holds
    at once (default: one per C SMs). ``kernels`` "scan" plans the eval
    scans (K3, K6) on the same kernels, which never take "wide".

    - ``"wide"`` (H <= 50, at least ``WIDE_MIN_ROWS[cell]`` rows an SM: K1
      17, K5 14): CTAs of R = 16 rows forward (several an SM) and 32
      backward (one wave up to 32 rows an SM), the step's products as
      register micro-tiles (csrc/scan_train_wide.cuh, both cells); C = 1.
    - ``"reg"`` (H <= 50): W_hid in registers, one block per tile of R =
      ceil(B / SMs) rows (at most 16); C = 1.
    - ``"cluster"``: clusters of C CTAs of at most 32 units each, R rows a
      cluster, W_hid split over the CTAs. (C, R) is the shape whose waves
      of clusters times (R + 24), a step's product plus its fixed cost, is
      least; ties go to the smaller C, then the larger R.
    - ``"l2"``: the single-block kernels reading W_hid through L2, where no
      cluster slice fits; R = ceil(B / SMs), at most 8; C = 1.

    Raises ValueError for an empty batch or where no kernel fits.
    """
    if B < 1 or H < 1:
        raise ValueError(f"train_scan_plan: no kernel for B={B}, H={H}")
    rows = max(1, -(-B // n_sm))
    if (kernels == "train" and H <= WIDE_MAX_H and rows >= WIDE_MIN_ROWS[cell]
            and train_scan_smem(cell, "wide", H, 1, WIDE_ROWS[backward], backward) <= smem_optin):
        return "wide", 1, WIDE_ROWS[backward]
    if H <= REG_MAX_H:
        R = min(REG_MAX_ROWS, rows)
        if train_scan_smem(cell, "reg", H, 1, R, backward) <= smem_optin:
            return "reg", 1, R
    best = None
    for C in CLUSTER_CTAS:
        if H < C or -(-H // C) > CLUSTER_UNITS:
            continue
        for R in CLUSTER_ROWS:
            if train_scan_smem(cell, "cluster", H, C, R, backward) > smem_optin:
                continue
            held = capacity[C, R] if capacity is not None else max(1, n_sm // C)
            cost = -(-(-(-B // R)) // max(1, held)) * (R + CLUSTER_STEP_ROWS)
            if best is None or cost < best[0]:
                best = (cost, C, R)
    if best is not None:
        return "cluster", best[1], best[2]
    R = min(L2_MAX_ROWS, rows)
    if train_scan_smem(cell, "l2", H, 1, R, backward) > smem_optin:
        raise ValueError(f"train_scan_plan: no {cell} training kernel takes H={H}")
    return "l2", 1, R


_plans: dict = {}


def device_train_plan(cell: str, B: int, H: int, device, backward: bool, library, kernels: str = "train"):
    """train_scan_plan on ``device``'s SM count, opt-in shared memory and
    the cluster capacity that ``library()``'s
    ``seqrec_<cell>_<kernels>_capacity`` measures, cached per device and
    shape (a lookup on later calls). The first plan of a shape holds
    train_scan_smem against the kernels' own sizes
    (``seqrec_<cell>_<kernels>_smem``) and raises if they differ.
    ``kernels`` is "train" for the training scans (K1, K5) and "scan" for
    the LSTM eval scan (K6), which runs the training forward's kernels
    without their state stores (forward plans only)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    key = (index, cell, kernels, B, H, backward)
    plan = _plans.get(key)
    if plan is not None:
        return plan
    lib = library()
    n_sm, smem = device_limits(index)
    held = None
    if train_scan_plan(cell, B, H, n_sm, smem, backward, kernels=kernels)[0] == "cluster":
        fn, held = getattr(lib, f"seqrec_{cell}_{kernels}_capacity"), {}
        with torch.cuda.device(index):
            for C in CLUSTER_CTAS:
                for R in CLUSTER_ROWS:
                    if H < C or -(-H // C) > CLUSTER_UNITS or train_scan_smem(cell, "cluster", H, C, R, backward) > smem:
                        continue
                    n = ctypes.c_int(0)
                    err = fn(int(backward), H, C, R, ctypes.byref(n))
                    if err:
                        raise RuntimeError(f"{cell} {kernels} scan: reading the cluster capacity failed with CUDA error {err}")
                    held[C, R] = n.value
    plan = train_scan_plan(cell, B, H, n_sm, smem, backward, held, kernels)
    path, C, R = plan
    want = train_scan_smem(cell, path, H, C, R, backward)
    got = getattr(lib, f"seqrec_{cell}_{kernels}_smem")(int(backward), PATHS[path], H, C, R)
    if got != want:
        raise RuntimeError(f"{cell} {kernels} scan: the plan {plan} at H={H} counts {want} bytes of shared memory, "
                           f"its kernel {got}")
    _plans[key] = plan
    return plan


_lib = None


def _library():
    global _lib
    if _lib is not None:
        return _lib
    lib = _build.load("gru_scan_train")
    fwd, bwd = lib.seqrec_gru_train_fwd_f32, lib.seqrec_gru_train_bwd_f32
    if fwd.argtypes is None:
        fwd.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fwd.restype = ctypes.c_int
        bwd.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
        bwd.restype = ctypes.c_int
        lib.seqrec_gru_train_capacity.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
        lib.seqrec_gru_train_capacity.restype = ctypes.c_int
        lib.seqrec_gru_train_smem.argtypes = [ctypes.c_int] * 5
        lib.seqrec_gru_train_smem.restype = ctypes.c_longlong
        lib.seqrec_gru_train_blocks_per_sm.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
        lib.seqrec_gru_train_blocks_per_sm.restype = ctypes.c_int
    _lib = lib
    return lib


def gru_train_plan(B: int, H: int, device, backward: bool) -> tuple[str, int, int]:
    """K1's (path, C, R) on ``device`` (train_scan_plan)."""
    return device_train_plan("gru", B, H, device, backward, _library)


def gru_train_blocks_per_sm(path: str, H: int, R: int, backward: bool, device="cuda") -> int:
    """Blocks of K1's reg or wide kernel at (H, R) that one SM of
    ``device`` holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor
    with the shared memory the launch asks for)."""
    n = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = _library().seqrec_gru_train_blocks_per_sm(int(backward), PATHS[path], H, R, ctypes.byref(n))
    if err:
        raise RuntimeError(f"gru_train_blocks_per_sm ({path} path) failed with CUDA error {err}")
    return n.value


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
    dev = x_pre.device
    path, C, R = gru_train_plan(B, H, dev, backward=False)
    out = torch.empty((B, H), dtype=f32, device=dev)
    hs = torch.empty((L, B, H), dtype=f32, device=dev)
    with on_device(dev):
        err = _library().seqrec_gru_train_fwd_f32(
            x_pre.data_ptr(), mask.data_ptr(), w_hid.data_ptr(), h0.data_ptr(), out.data_ptr(),
            hs.data_ptr(), B, L, H, PATHS[path], C, R, torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"gru_scan_train_fwd kernel launch ({path} path) failed with CUDA error {err}")
    gru_scan_train_fwd.launches += 1
    gru_scan_train_fwd.cluster_launches += path == "cluster"
    gru_scan_train_fwd.wide_launches += path == "wide"
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
    path, C, R = gru_train_plan(B, H, dev, backward=True)
    G = 3 * H
    dx = torch.empty((B, L, G), dtype=f32, device=dev)
    dh0 = torch.empty((B, H), dtype=f32, device=dev)
    dw = torch.empty((H, G), dtype=f32, device=dev)
    part, dhid, w_t, n_splits, per_split = backward_scratch(path, B, L, R, w_hid)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with on_device(dev):
        err = _library().seqrec_gru_train_bwd_f32(
            x_pre.data_ptr(), mask.data_ptr(), w_hid.data_ptr(), ptr(w_t), hs.data_ptr(), dh.data_ptr(),
            dx.data_ptr(), dh0.data_ptr(), dw.data_ptr(), ptr(dhid), ptr(part), B, L, H, PATHS[path], C, R,
            n_splits, per_split, float(grad_clip or 0.0), torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"gru_scan_train_bwd kernel launch ({path} path) failed with CUDA error {err}")
    gru_scan_train_bwd.launches += 1
    gru_scan_train_bwd.cluster_launches += path == "cluster"
    gru_scan_train_bwd.wide_launches += path == "wide"
    return dx, dh0, dw


# every launch, and those of the cluster and wide paths
gru_scan_train_fwd.launches = gru_scan_train_fwd.cluster_launches = gru_scan_train_fwd.wide_launches = 0
gru_scan_train_bwd.launches = gru_scan_train_bwd.cluster_launches = gru_scan_train_bwd.wide_launches = 0


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
