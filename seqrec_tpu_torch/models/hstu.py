"""HSTU tower: Hierarchical Sequential Transduction Units as a sequence
tower of the RNN family (``--r_t HSTU``).

Zhai et al., "Actions Speak Louder than Words: Trillion-Parameter
Sequential Transducers for Generative Recommendations", ICML 2024,
arXiv:2402.17152 (github.com/facebookresearch/generative-recommenders).
It has no counterpart in the JAX package. The tower has
``RecurrentLayers``' interface (``param_shapes``, ``init_params``,
``build``, ``name``, ``output_size``, ``forward``), so every head of the
family takes it as ``net.tower``. For ids [B, L, F] with a left-aligned
prefix mask of m valid steps a row, d the width and positions t < m:

- x0[t] = sqrt(d) E[ids_t] + P[t], E the item table (the gather-sum of the
  step's feature rows, ``ops/gather_sum.py``, as the RNN's first ``W_in``)
  and P a learned [L, d] position table;
- each block: n = LN(x) (no affine, eps 1e-6); [U, V, Q, K] =
  SiLU(n W_uvqk) (no bias); O = the causal pointwise attention of Q, K, V
  with the block's relative bias tables (``ops/hstu_attention.py``, scale
  1 / L); x <- x + (LN(O) * U) W_o + b_o;
- the output is x at each row's last valid step (or at every step).

Packed tokens. Valid steps never read padded ones (rows are left-aligned
prefixes, the norms, SiLU and projections act on one token at a time, the
attention masks j <= i < m and the output reads step m - 1), so the
residual stream runs over the T packed tokens of the batch alone: max(m, 1)
a row, in row order, an empty row keeping its step 0 (the step its output
reads, the same computation as on the padded layout). The flat index
b L + t of each packed token and the row ends are worked out on the device
from the mask; the one device-to-host read of a forward is T, which sizes
the tensors, and what needs no T (the indices, the ids in packed order,
the position table at every step) is launched before it. x0, the
LayerNorms, both projections, SiLU, the gating and the residual adds run
on [T, d]. The attention keeps its padded interface: each block scatters
the packed V, Q, K into zero-filled [B, L, .] buffers and gathers O back
to the packed rows; autograd differentiates both moves. Where dqk = dv
the three are buffers of their own (one row stride, as the kernels take
it, and the backward gathers each gradient at the packed rows with no
padded gradient assembled); else one buffer holds the three. At T = B L
(every row full) the same moves run, as an identity.
``tokens_run`` and ``tokens_padded`` count the packed tokens and the B L
padded steps of every forward, from the T already read; with
``only_return_final=False`` the output is x at the packed steps and zeros
at the other padded ones.

Dropout is not applied (the published 0.2 is left out so that training is
deterministic). The projections, norms and gating are torch ops; the
attention is ``csrc/hstu_attention.cu`` on the card. Parameters (state-dict
keys under ``tower.``): ``embedding`` [input size, d], ``pos`` [L, d] and
``block{b}.W_uvqk`` [d, 2 heads (dv + dqk)], ``block{b}.W_o`` [heads dv,
d], ``block{b}.b_o`` [d], ``block{b}.rab_p`` [2 L - 1],
``block{b}.rab_w`` [129].
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from seqrec_tpu_torch.ops.gather_sum import gather_sum
from seqrec_tpu_torch.ops.hstu_attention import RAB_BUCKETS, hstu_attention

EPS = 1e-6  # the LayerNorms' epsilon


class HSTULayers(nn.Module):
    """Configuration, parameters and forward pass of the HSTU stack."""

    def __init__(self, hidden: int = 256, blocks: int = 8, heads: int = 4, dqk: int = 64, dv: int = 64,
                 max_length: int = 200):
        super().__init__()
        if min(hidden, blocks, heads, dqk, dv) < 1 or not np.isfinite(max_length):
            raise ValueError("HSTU needs positive sizes and a finite --max_length")
        self.hidden, self.blocks, self.heads, self.dqk, self.dv = hidden, blocks, heads, dqk, dv
        self.max_length = int(max_length)
        # the item table is the tower's catalog-indexed input table, as the
        # RNN's --r_emb embedding is (base.py's lazy updates read it)
        self.embedding_size = hidden
        self.name = f"HSTU_b{blocks}_nh{heads}_qk{dqk}_v{dv}_h{hidden}"
        self.tokens_run = 0  # packed tokens over every forward
        self.tokens_padded = 0  # B L over every forward

    @property
    def output_size(self) -> int:
        return self.hidden

    def param_shapes(self, true_input_size: int) -> dict:
        """Nested ``{name: shape}`` of every parameter, in draw order."""
        d, L, h = self.hidden, self.max_length, self.heads
        shapes: dict = {"embedding": (true_input_size, d), "pos": (L, d)}
        for b in range(self.blocks):
            shapes[f"block{b}"] = {
                "W_uvqk": (d, 2 * h * (self.dv + self.dqk)), "W_o": (h * self.dv, d), "b_o": (d,),
                "rab_p": (2 * L - 1,), "rab_w": (RAB_BUCKETS + 1,),
            }
        return shapes

    def init_params(self, rng: np.random.Generator, true_input_size: int) -> dict:
        """Numpy parameter tree in declaration order, as HSTU initialises
        it: E ~ N(0, 0.02), P ~ N(0, 1/d), W_uvqk and the rab tables ~
        N(0, 0.02), Glorot-uniform W_o, zero b_o (untruncated normals)."""

        def leaf(name, shape):
            if name == "pos":
                return rng.normal(0.0, math.sqrt(1.0 / self.hidden), size=shape).astype(np.float32)
            if name == "W_o":
                limit = math.sqrt(6.0 / (shape[0] + shape[1]))
                return rng.uniform(-limit, limit, size=shape).astype(np.float32)
            if name == "b_o":
                return np.zeros(shape, dtype=np.float32)
            return rng.normal(0.0, 0.02, size=shape).astype(np.float32)

        return {
            key: leaf(key, val) if isinstance(val, tuple) else {n: leaf(n, s) for n, s in val.items()}
            for key, val in self.param_shapes(true_input_size).items()
        }

    def build(self, true_input_size: int, device) -> None:
        """Create the (uninitialised, trainable) parameters on ``device``."""

        def param(shape):
            return nn.Parameter(torch.empty(shape, device=device))

        for key, val in self.param_shapes(true_input_size).items():
            if isinstance(val, tuple):
                self.register_parameter(key, param(val))
            else:
                self.add_module(key, nn.ParameterDict({n: param(s) for n, s in val.items()}))

    def forward(self, inputs, mask, id_mask=None, only_return_final: bool = True, train: bool = False):
        """inputs: integer ``[B, L, F]`` feature ids; mask: float ``[B, L]``,
        a prefix of valid steps a row; id_mask: optional float ``[B, L, F]``.
        Returns ``[B, d]`` (the last valid step; step 0 for an empty row)
        or ``[B, L, d]``: x at the valid steps and at step 0 of an empty
        row, zeros at every other padded step. ``train`` changes nothing:
        one path trains and serves."""
        if inputs.is_floating_point():
            raise ValueError("HSTU takes sparse (id) inputs")
        B, L = mask.shape
        if L > self.max_length:
            raise ValueError(f"HSTU: {L} steps, the position table has {self.max_length}")
        d, hq, hv = self.hidden, self.heads * self.dqk, self.heads * self.dv
        lengths = mask.sum(dim=1).round().int()
        steps = torch.clamp(lengths, min=1)  # packed tokens a row: an empty row keeps its step 0
        ends = torch.cumsum(steps, dim=0)  # one past each row's last packed token
        # what needs no T is launched before the read, while the card still works, not after it,
        # while the card waits: the flat indices b L + t of the packed tokens in row order (then
        # of the other steps), the ids in that order, the position table at every step
        kept = torch.arange(L, device=mask.device)[None, :] < steps[:, None]
        order = torch.argsort(torch.logical_not(kept).flatten().byte(), stable=True)
        ids = inputs.reshape(B * L, -1).index_select(0, order)
        id_mask = None if id_mask is None else id_mask.reshape(B * L, -1).index_select(0, order)
        pos = self.pos[:L].expand(B, L, d).reshape(B * L, d)  # its gradient: a sum over the rows, no atomics
        T = int(ends[-1]) if B else 0  # the forward's one device-to-host read
        self.tokens_run += T
        self.tokens_padded += B * L
        flat = order[:T]

        def unpack(a):  # [T, C] -> [B, L, C], zeros at the steps not packed
            return a.new_zeros(B * L, a.shape[1]).index_copy_(0, flat, a).view(B, L, -1)

        x = math.sqrt(d) * gather_sum(self.embedding, ids[:T], None if id_mask is None else id_mask[:T])
        x = x + pos.index_select(0, flat)
        for b in range(self.blocks):
            p = getattr(self, f"block{b}")
            uvqk = F.silu(F.layer_norm(x, (d,), eps=EPS) @ p["W_uvqk"])
            if hq == hv:  # three buffers of one width: one row stride, as the kernels take, and no padded gradient
                u, v, q, k = torch.split(uvqk, [hv, hv, hq, hq], dim=-1)
                v, q, k = unpack(v), unpack(q), unpack(k)
            else:  # one buffer of the three
                u, vqk = torch.split(uvqk, [hv, hv + 2 * hq], dim=-1)
                v, q, k = torch.split(unpack(vqk), [hv, hq, hq], dim=-1)
            o = hstu_attention(q, k, v, p["rab_p"], p["rab_w"], lengths, self.heads, 1.0 / L)
            o = o.reshape(B * L, hv).index_select(0, flat)
            x = x + (F.layer_norm(o, (hv,), eps=EPS) * u) @ p["W_o"] + p["b_o"]
        if not only_return_final:
            return unpack(x)
        return x.index_select(0, ends - 1)
