"""Plain reference of HSTU (Zhai et al., arXiv:2402.17152) with categorical
cross-entropy over the whole catalog, trained with Adam: a frozen copy of
``seqrec_tpu_torch/reference/hstu.py``'s arithmetic with the benchmark's
interface (``make_weights``, ``train_steps``), as ``rnn_cce.py`` has it.

Plain PyTorch, float32, the attention materialised; it imports nothing of
the port. For ids [B, L] of left-aligned rows with m valid steps:

- x0[t] = sqrt(d) E[ids_t] + P[t];
- each block: n = LayerNorm(x) (no affine, eps 1e-6); U, V, Q, K =
  SiLU(n W_uvqk) split in that order (no bias); per head
  S[i, j] = Q_i . K_j + rab[i, j] with
  rab[i, j] = p[j - i + L_max - 1] + w[min(floor(ln(max(|t_i - t_j|, 1)) / 0.301), 128)],
  A = SiLU(S) / L on the pairs j <= i < m and 0 elsewhere (L the padded
  length), O = A V with the heads concatenated;
  x <- x + (LayerNorm(O) * U) W_o + b_o;
- h = x at step m - 1; logits = h W_out + b_out; the cost is the mean
  over the batch of ``CCE_i / pop(target_i)^db``;
- Adam as optax computes it (``rnn_cce.Adam``).

The data's times are consecutive integers a user and the batches carry
none, so t_i - t_j = i - j: the time term is a log-bucketed relative
position term, which is what the published bias computes on such data.

Departures from the published configuration (also in the configuration
file): dropout 0 rather than 0.2; one target a row with a full-catalog
softmax over an untied W_out and b_out, where the published loss is a
sampled softmax at every position (128 negatives, L2-normalised tied
embeddings, temperature 0.05), so the output is not L2-normalised; the
port's Adam.

The weights are made here from the seed, on the device, with a
``torch.Generator``, and both the port and this reference start from them:
``N(0, 0.02)`` for E, W_uvqk and the rab tables, ``N(0, 1/d)`` for P,
Glorot-uniform W_o and W_out, zeros for b_o and b_out. P and p are made
for the configuration's ``max_length``; a run at a shorter L uses P's
first L rows and p's central 2 L - 1 entries, as the port's tables of
that length hold them (``programs/hstu_cce.py:fit``).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.rnn_cce import Adam, norms

EPS = 1e-6
N_BUCKETS = 128
DIVISOR = 0.301


def leaf_shapes(model: dict, n_items: int) -> dict:
    """{leaf: shape} in draw order; leaf names are the port's state-dict
    keys without ``tower.``."""
    d, L, h = model["hidden"], model["max_length"], model["heads"]
    shapes = {"embedding": (n_items, d), "pos": (L, d)}
    for b in range(model["blocks"]):
        shapes.update({f"block{b}.W_uvqk": (d, 2 * h * (model["dv"] + model["dqk"])),
                       f"block{b}.W_o": (h * model["dv"], d), f"block{b}.b_o": (d,),
                       f"block{b}.rab_p": (2 * L - 1,), f"block{b}.rab_w": (N_BUCKETS + 1,)})
    shapes.update(W_out=(d, n_items), b_out=(n_items,))
    return shapes


def make_weights(model: dict, n_items: int, seed: int, device) -> dict:
    """The initial weights, float32 on ``device``, from ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    out = {}
    for name, shape in leaf_shapes(model, n_items).items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("W_o", "W_out"):
            limit = float(np.sqrt(6.0 / (shape[0] + shape[1])))
            out[name] = torch.rand(shape, generator=gen, device=device).mul_(2 * limit).sub_(limit)
        elif leaf in ("b_o", "b_out"):
            out[name] = torch.zeros(shape, device=device)
        else:
            std = math.sqrt(1.0 / model["hidden"]) if leaf == "pos" else 0.02
            out[name] = torch.randn(shape, generator=gen, device=device).mul_(std)
    return out


def fit(name: str, w: torch.Tensor, L: int) -> torch.Tensor:
    """A weight made for ``max_length`` as a run of padded length L holds
    it: P's first L rows, p's central 2 L - 1 entries, the rest whole."""
    if name == "pos":
        return w[:L]
    if name.endswith("rab_p"):
        c = (w.shape[0] - 1) // 2
        return w[c - L + 1 : c + L]
    return w


def rab(p: torch.Tensor, w: torch.Tensor, L: int) -> torch.Tensor:
    """[L, L] relative attention bias at times = positions 0..L-1."""
    t = torch.arange(L, device=p.device)
    centre = (p.shape[0] - 1) // 2
    gap = torch.clamp((t[:, None] - t[None, :]).abs().float(), min=1.0)
    bucket = torch.clamp((torch.log(gap) / DIVISOR).long(), max=N_BUCKETS)
    return p[t[None, :] - t[:, None] + centre] + w[bucket]


def final_state(p: dict, model: dict, ids: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """[B, d] tower output at each row's last valid step."""
    B, L = ids.shape
    d, h, dqk, dv = model["hidden"], model["heads"], model["dqk"], model["dv"]
    t = torch.arange(L, device=ids.device)
    valid = (t[None, :] <= t[:, None])[None] & (t[None, :, None] < lengths[:, None, None])  # [B, L, L]
    x = math.sqrt(d) * p["embedding"][ids] + p["pos"]
    for b in range(model["blocks"]):
        blk = {k.split(".", 1)[1]: v for k, v in p.items() if k.startswith(f"block{b}.")}
        uvqk = F.silu(F.layer_norm(x, (d,), eps=EPS) @ blk["W_uvqk"])
        u, v, q, k = torch.split(uvqk, [h * dv, h * dv, h * dqk, h * dqk], dim=-1)
        q, k, v = (y.reshape(B, L, h, -1).transpose(1, 2) for y in (q, k, v))
        s = q @ k.transpose(-1, -2) + rab(blk["rab_p"], blk["rab_w"], L)
        a = torch.where(valid[:, None], F.silu(s) / L, torch.zeros((), device=s.device))
        o = (a @ v).transpose(1, 2).reshape(B, L, h * dv)
        x = x + (F.layer_norm(o, (h * dv,), eps=EPS) * u) @ blk["W_o"] + blk["b_o"]
    return x[torch.arange(B, device=ids.device), lengths - 1]


def cost(p: dict, model: dict, batch, target_pop: torch.Tensor) -> torch.Tensor:
    ids, lengths, targets = batch
    logits = final_state(p, model, ids, lengths) @ p["W_out"] + p["b_out"]
    per_example = torch.logsumexp(logits, dim=1) - logits.gather(1, targets[:, None])[:, 0]
    return (per_example / target_pop[targets]).mean()


def train_steps(model: dict, weights: dict, batches, item_pop: np.ndarray, n_steps: int = 3,
                matmul_tf32: bool = False, half_batch: bool = False) -> dict:
    """``n_steps`` optimizer steps from ``weights`` (consumed) on the host
    batches ``batches`` (``batches.steps``). Returns the readings the
    output check compares: each step's cost, each leaf's gradient at the
    first step (float64, on the host) and its norm, and the norm of its
    change after the last. ``matmul_tf32`` computes the products in TF32
    (the control); ``half_batch`` drops the second half of every batch (a
    planted fault)."""
    device = weights["embedding"].device
    pop = np.asarray(item_pop, dtype=np.float32) ** np.float32(model["diversity_bias"])
    target_pop = torch.as_tensor(pop, device=device)
    params, start, adam = None, None, None
    costs, first_grads = [], None
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = matmul_tf32
    try:
        for _ in range(n_steps):
            ids, lengths, targets = (torch.as_tensor(a, device=device) for a in next(batches))
            if params is None:  # the tables of the batches' padded length
                params = {k: fit(k, v, ids.shape[1]).contiguous().requires_grad_(True) for k, v in weights.items()}
                start = {k: v.detach().clone() for k, v in params.items()}
                adam = Adam(model["optimizer"], params)
            if half_batch:
                keep = len(ids) // 2
                ids, lengths, targets = ids[:keep], lengths[:keep], targets[:keep]
            c = cost(params, model, (ids, lengths, targets), target_pop)
            grads = dict(zip(params, torch.autograd.grad(c, list(params.values()))))
            costs.append(float(c.detach()))
            if first_grads is None:
                first_grads = {k: g.detach().double().cpu() for k, g in grads.items()}
            adam.step(params, grads)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
    change = norms({k: params[k].detach() - start[k] for k in params})
    return {"costs": costs, "grads": first_grads, "grad_norms": norms(first_grads), "change_norms": change}
