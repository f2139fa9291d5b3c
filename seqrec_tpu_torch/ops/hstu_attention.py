"""HSTU's causal pointwise attention (``csrc/hstu_attention.cu``).

The sequence mixer of the HSTU tower (``models/hstu.py``; Zhai et al.,
arXiv:2402.17152), which has no counterpart in the JAX package. For q, k
[B, L, heads * dqk] and v [B, L, heads * dv] (head h at columns h d ..
h d + d - 1), the prefix lengths m [B] of left-aligned rows and, per head,

    S[i, j] = q_i . k_j + rab[i, j],   A = SiLU(S) * scale on j <= i < m, else 0,
    O[i] = sum_j A[i, j] v_j,

with no softmax; the tower passes scale = 1 / L, L the padded length.
The relative attention bias has a position part and a time part,
``rab[i, j] = rab_p[j - i + L_max - 1] + rab_w[bucket(|t_i - t_j|)]`` with
``bucket(x) = min(floor(ln(max(x, 1)) / 0.301), 128)``. The port's batches
carry no times: a row's interactions are consecutive, so t_i - t_j = i - j
and on the causal pairs rab is a function of r = i - j alone,
:func:`rab_bias` ``[L]``.

On CPU tensors :func:`hstu_attention` is :func:`hstu_attention_plain`, the
same math in torch ops (S and A materialised), differentiated by autograd.
On CUDA tensors it is an autograd Function whose forward launches the fused
forward kernel (:func:`hstu_attention_fwd`) and whose backward launches the
dQ kernel and the dK/dV kernel (:func:`hstu_attention_bwd`); the dbias
partials of the dQ kernel's blocks are summed here, in a fixed order, and
mapped back onto ``rab_p`` and ``rab_w`` by :func:`rab_grads`: no float
atomics anywhere, the same bits on every call.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from seqrec_tpu_torch.ops import _build
from seqrec_tpu_torch.ops.core import on_device

RAB_BUCKETS = 128  # rab_w has RAB_BUCKETS + 1 entries
BUCKET_DIVISOR = 0.301  # HSTU's log base: ln(x) / 0.301
TILE = 64  # rows of a block's tile and the largest head width (csrc/hstu_attention.cu kT)

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("hstu_attention")
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.seqrec_hstu_attention_fwd_f32.argtypes = [vp, vp, vp, ci, vp, vp, vp, ci, ci, ci, ci, ci, cf, vp]
        lib.seqrec_hstu_attention_fwd_f32.restype = ci
        lib.seqrec_hstu_attention_bwd_f32.argtypes = [vp, vp, vp, ci, vp, vp, vp, vp, vp, vp, vp,
                                                       ci, ci, ci, ci, ci, cf, vp]
        lib.seqrec_hstu_attention_bwd_f32.restype = ci
        _lib = lib
    return _lib


def time_buckets(gaps: torch.Tensor) -> torch.Tensor:
    """HSTU's log buckets of non-negative time gaps (any integer or float
    tensor): ``min(floor(ln(max(gap, 1)) / 0.301), 128)``, int64."""
    x = torch.clamp(gaps.float(), min=1.0)
    return torch.clamp((torch.log(x) / BUCKET_DIVISOR).long(), max=RAB_BUCKETS)


@functools.lru_cache(maxsize=None)
def _bucket_tables(L: int, device: torch.device):
    """(bucket [L] of r = 0..L-1, runs [RAB_BUCKETS + 1, R]: the r of each
    bucket, padded with L). The buckets rise with r, so each is one run."""
    bucket = time_buckets(torch.arange(L))
    counts = torch.bincount(bucket, minlength=RAB_BUCKETS + 1)
    runs = torch.full((RAB_BUCKETS + 1, max(int(counts.max()), 1)), L, dtype=torch.int64)
    for b in torch.nonzero(counts).flatten().tolist():
        r = torch.nonzero(bucket == b).flatten()
        runs[b, : len(r)] = r
    return bucket.to(device), runs.to(device)


def rab_bias(rab_p: torch.Tensor, rab_w: torch.Tensor, L: int) -> torch.Tensor:
    """[L] relative attention bias of r = i - j >= 0 (consecutive times):
    ``rab_p[c - r] + rab_w[bucket(r)]``, c = (len(rab_p) - 1) / 2 the
    table's centre (L_max - 1 for a table of 2 L_max - 1); differentiable."""
    bucket, _ = _bucket_tables(L, rab_p.device)
    c = (rab_p.shape[0] - 1) // 2
    return rab_p[c - L + 1 : c + 1].flip(0) + rab_w[bucket]


def rab_grads(dbias: torch.Tensor, n_p: int, L: int):
    """(d rab_p [n_p], d rab_w [RAB_BUCKETS + 1]) from d bias [L]: each
    bucket's entries summed in the order of r, by a gather (no atomics)."""
    _, runs = _bucket_tables(L, dbias.device)
    c = (n_p - 1) // 2
    d_p = torch.zeros(n_p, dtype=dbias.dtype, device=dbias.device)
    d_p[c - L + 1 : c + 1] = dbias.flip(0)
    d_w = torch.cat([dbias, dbias.new_zeros(1)])[runs].sum(dim=1)
    return d_p, d_w


def _heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    B, L, C = x.shape
    return x.reshape(B, L, heads, C // heads).transpose(1, 2)  # [B, heads, L, d]


def hstu_attention_plain(q, k, v, bias, lengths, heads: int, scale: float) -> torch.Tensor:
    """O [B, L, heads * dv] in torch ops: S [B, heads, L, L] and A
    materialised, bias [L] the rab of r = i - j."""
    B, L, _ = q.shape
    i = torch.arange(L, device=q.device)
    r = i[:, None] - i[None, :]
    valid = (r >= 0)[None] & (i[None, :, None] < lengths.to(q.device)[:, None, None])  # [B, L, L]
    s = _heads(q, heads) @ _heads(k, heads).transpose(-1, -2) + bias[r.clamp(min=0)]
    a = torch.where(valid[:, None], torch.nn.functional.silu(s) * scale, torch.zeros((), device=q.device))
    return (a @ _heads(v, heads)).transpose(1, 2).reshape(B, L, -1)


def _operands(q, k, v):
    """q, k, v [B, L, C] as the kernels read them: unit column strides, one
    row stride that is a multiple of 4, batch strides of L rows, 16-byte
    aligned (views of one projection's output are); else contiguous
    copies."""
    L = q.shape[1]
    ld = q.stride(1)
    ok = all(x.stride(2) == 1 and x.stride(1) == ld and x.stride(0) == L * ld and x.data_ptr() % 16 == 0
             and ld >= x.shape[2] for x in (q, k, v)) and ld % 4 == 0
    return (q, k, v) if ok else tuple(x.contiguous() for x in (q, k, v))


def _check(fn: str, q, k, v, bias, lengths, heads: int):
    B, L, C = q.shape
    if q.device.type != "cuda":
        raise ValueError(f"{fn}: no kernel for device {q.device}")
    for name, t, dtype in (("q", q, torch.float32), ("k", k, torch.float32), ("v", v, torch.float32),
                           ("bias", bias, torch.float32), ("lengths", lengths, torch.int32)):
        if t.dtype != dtype or t.device != q.device:
            raise ValueError(f"{fn}: {name} must be a {dtype} tensor on {q.device}")
    if k.shape != q.shape or v.shape[:2] != (B, L) or bias.shape != (L,) or lengths.shape != (B,):
        raise ValueError(f"{fn}: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}, "
                         f"bias {tuple(bias.shape)}, lengths {tuple(lengths.shape)} do not agree")
    if C % heads or v.shape[2] % heads:
        raise ValueError(f"{fn}: {heads} heads do not divide the widths {C} and {v.shape[2]}")
    dqk, dv = C // heads, v.shape[2] // heads
    if not (0 < dqk <= TILE and 0 < dv <= TILE and dqk % 4 == 0 and dv % 4 == 0):
        raise ValueError(f"{fn}: the kernel takes head widths that are multiples of 4 up to {TILE}, "
                         f"got dqk {dqk}, dv {dv}")
    if _operands(q, k, v)[0] is not q or not (lengths.is_contiguous() and bias.is_contiguous()):
        raise ValueError(f"{fn}: q, k and v need the layout of _operands, bias and lengths contiguity")
    return B, L, dqk, dv


def hstu_attention_fwd(q, k, v, bias, lengths, heads: int, scale: float) -> torch.Tensor:
    """O [B, L, heads * dv] from the fused forward kernel (CUDA tensors
    only): q, k, v as :func:`_operands` leaves them, bias f32 [L],
    lengths int32 [B]."""
    B, L, dqk, dv = _check("hstu_attention_fwd", q, k, v, bias, lengths, heads)
    out = torch.empty((B, L, heads * dv), dtype=torch.float32, device=q.device)
    with on_device(q.device):
        err = _library().seqrec_hstu_attention_fwd_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q.stride(1), bias.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), B, L, heads, dqk, dv, float(scale),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"hstu_attention_fwd kernel launch failed with CUDA error {err}")
    hstu_attention_fwd.launches += 1
    return out


def hstu_attention_bwd(q, k, v, bias, lengths, heads: int, scale: float, dout):
    """(dq, dk, dv, dbias [L]) from the dQ and dK/dV kernels (CUDA tensors
    only), the dbias partials of the dQ kernel's blocks summed here."""
    B, L, dqk, dv = _check("hstu_attention_bwd", q, k, v, bias, lengths, heads)
    dout = dout.contiguous()
    if dout.shape != (B, L, heads * dv) or dout.data_ptr() % 16:
        raise ValueError("hstu_attention_bwd: dout must be a contiguous, aligned [B, L, heads * dv] tensor")
    f32, dev = torch.float32, q.device
    dq = torch.empty((B, L, heads * dqk), dtype=f32, device=dev)
    dk = torch.empty_like(dq)
    dvt = torch.empty((B, L, heads * dv), dtype=f32, device=dev)
    part = torch.empty((B * heads * -(-L // TILE), L), dtype=f32, device=dev)
    with on_device(dev):
        err = _library().seqrec_hstu_attention_bwd_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q.stride(1), bias.data_ptr(),
            lengths.data_ptr(), dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dvt.data_ptr(), part.data_ptr(),
            B, L, heads, dqk, dv, float(scale), torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"hstu_attention_bwd kernel launch failed with CUDA error {err}")
    hstu_attention_bwd.launches += 1
    return dq, dk, dvt, part.sum(dim=0)


hstu_attention_fwd.launches = 0
hstu_attention_bwd.launches = 0


class _HSTUAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, rab_p, rab_w, lengths, heads, scale):
        q, k, v = _operands(q, k, v)
        L = q.shape[1]
        bias = rab_bias(rab_p.detach(), rab_w.detach(), L).contiguous()
        lengths = lengths.to(torch.int32).contiguous()
        ctx.save_for_backward(q, k, v, bias, lengths)
        ctx.heads, ctx.scale, ctx.n_p = heads, scale, rab_p.shape[0]
        return hstu_attention_fwd(q, k, v, bias, lengths, heads, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, lengths = ctx.saved_tensors
        dq, dk, dv, dbias = hstu_attention_bwd(q, k, v, bias, lengths, ctx.heads, ctx.scale, g)
        d_p, d_w = rab_grads(dbias, ctx.n_p, q.shape[1])
        return dq, dk, dv, d_p, d_w, None, None, None


def hstu_attention(q, k, v, rab_p, rab_w, lengths, heads: int, scale: float) -> torch.Tensor:
    """O [B, L, heads * dv] of q, k [B, L, heads * dqk], v [B, L, heads *
    dv] (views with a unit column stride are taken as they are), the rab
    tables rab_p [>= L] and rab_w [RAB_BUCKETS + 1] and the prefix lengths
    [B]; differentiable in q, k, v, rab_p and rab_w. CPU tensors: the plain
    version; CUDA tensors: the kernels (or a raise)."""
    if q.device.type == "cpu":
        return hstu_attention_plain(q, k, v, rab_bias(rab_p, rab_w, q.shape[1]), lengths, heads, scale)
    return _HSTUAttention.apply(q, k, v, rab_p, rab_w, lengths, heads, scale)
