"""Plain reference of the HSTU tower with the RNN family's CCE head.

Zhai et al., "Actions Speak Louder than Words: Trillion-Parameter
Sequential Transducers for Generative Recommendations", ICML 2024,
arXiv:2402.17152; github.com/facebookresearch/generative-recommenders
(``HSTUJagged``, ``RelativeBucketedTimeAndPositionBasedBias``). Plain
``torch``, float32, the attention materialised; it imports nothing of the
port (no kernel), and :func:`cost` runs with TF32 off. For ids [B, L] of
left-aligned rows with m valid steps and times t:

- x0[t] = sqrt(d) E[ids_t] + P[t];
- each block: n = LayerNorm(x) (no affine, eps 1e-6); U, V, Q, K =
  SiLU(n W_uvqk) split in that order (no bias); per head
  S[i, j] = Q_i . K_j + rab[i, j] with
  rab[i, j] = p[j - i + L_max - 1] + w[min(floor(ln(max(|t_i - t_j|, 1)) / 0.301), 128)],
  A = SiLU(S) / L on the pairs j <= i < m and 0 elsewhere (L the padded
  length), O = A V with the heads concatenated;
  x <- x + (LayerNorm(O) * U) W_o + b_o;
- h = x at step m - 1; the cost is the mean over the batch of
  CCE(h W_out + b_out, target) / pop(target)^db.

Interaction times here are the positions (the data's times are
consecutive integers a user and the batches carry none), so |t_i - t_j| =
|i - j|: the time term is a log-bucketed relative position term, which is
what the published bias computes on such data.

Departures from the published configuration: no dropout (0.2 there); the
loss is one target a row with a full-catalog softmax over an untied
W_out and b_out, where the published loss is a sampled softmax at every
position with 128 negatives over L2-normalised tied embeddings at
temperature 0.05, so the output is not L2-normalised; the optimiser is the
port's Adam.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

EPS = 1e-6
N_BUCKETS = 128
DIVISOR = 0.301


def rab(p: torch.Tensor, w: torch.Tensor, times: torch.Tensor) -> torch.Tensor:
    """[L, L] relative attention bias of steps with ``times`` [L]; p has
    2 L_max - 1 entries (L <= L_max), w N_BUCKETS + 1."""
    L = times.shape[0]
    i = torch.arange(L, device=p.device)
    centre = (p.shape[0] - 1) // 2
    gap = torch.clamp((times[:, None] - times[None, :]).abs().float(), min=1.0)
    bucket = torch.clamp((torch.log(gap) / DIVISOR).long(), max=N_BUCKETS)
    return p[i[None, :] - i[:, None] + centre] + w[bucket]


def attention(q, k, v, bias: torch.Tensor, lengths: torch.Tensor, heads: int) -> torch.Tensor:
    """O [B, L, heads dv] of q, k [B, L, heads dqk], v [B, L, heads dv]
    with the [L, L] bias on the causal pairs of each row's m valid steps:
    S and A materialised."""
    B, L, _ = q.shape
    steps = torch.arange(L, device=q.device)
    valid = (steps[None, :] <= steps[:, None])[None] & (steps[None, :, None] < lengths[:, None, None])
    q, k, v = (x.reshape(B, L, heads, -1).transpose(1, 2) for x in (q, k, v))
    a = torch.where(valid[:, None], F.silu(q @ k.transpose(-1, -2) + bias) / L, torch.zeros((), device=q.device))
    return (a @ v).transpose(1, 2).reshape(B, L, -1)


def tower(params: dict, cfg: dict, ids: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """[B, d] output at each row's last valid step. ``params`` holds
    ``embedding``, ``pos`` and ``block{b}.W_uvqk``, ``.W_o``, ``.b_o``,
    ``.rab_p``, ``.rab_w``; ``cfg`` ``blocks``, ``heads``, ``dqk``, ``dv``."""
    B, L = ids.shape
    d = params["embedding"].shape[1]
    h, dqk, dv = cfg["heads"], cfg["dqk"], cfg["dv"]
    steps = torch.arange(L, device=ids.device)
    x = math.sqrt(d) * params["embedding"][ids] + params["pos"][:L]
    for b in range(cfg["blocks"]):
        blk = {k.split(".", 1)[1]: v for k, v in params.items() if k.startswith(f"block{b}.")}
        uvqk = F.silu(F.layer_norm(x, (d,), eps=EPS) @ blk["W_uvqk"])
        u, v, q, k = torch.split(uvqk, [h * dv, h * dv, h * dqk, h * dqk], dim=-1)
        o = attention(q, k, v, rab(blk["rab_p"], blk["rab_w"], steps), lengths, h)
        x = x + (F.layer_norm(o, (h * dv,), eps=EPS) * u) @ blk["W_o"] + blk["b_o"]
    return x[torch.arange(B, device=ids.device), lengths - 1]


def cost(params: dict, cfg: dict, ids, lengths, targets, target_pop) -> torch.Tensor:
    """Mean CCE over the catalog, each row over ``target_pop[target]``
    (pop^db); TF32 off for its products."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        logits = tower(params, cfg, ids, lengths) @ params["W_out"] + params["b_out"]
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
    per_row = torch.logsumexp(logits, dim=1) - logits.gather(1, targets[:, None])[:, 0]
    return (per_row / target_pop[targets]).mean()


def grads(params: dict, cfg: dict, *batch):
    """(cost, {leaf: gradient}) by autograd."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    c = cost(leaves, cfg, *batch)
    return c.detach(), dict(zip(leaves, torch.autograd.grad(c, list(leaves.values()))))


@torch.no_grad()
def adam_step(params: dict, grads: dict, state: dict, lr: float, b1: float, b2: float, eps: float) -> None:
    """optax.adam's update in place; ``state`` starts as {} (bias
    corrections 1 - b^t in float32)."""
    state["count"] = t = state.get("count", 0) + 1
    bc1 = float(1 - torch.tensor(b1, dtype=torch.float32) ** t)
    bc2 = float(1 - torch.tensor(b2, dtype=torch.float32) ** t)
    for k, p in params.items():
        mu = state.setdefault(("mu", k), torch.zeros_like(p)).mul_(b1).add_((1 - b1) * grads[k])
        nu = state.setdefault(("nu", k), torch.zeros_like(p)).mul_(b2).add_((1 - b2) * grads[k] * grads[k])
        p.add_((mu / bc1) / (torch.sqrt(nu / bc2) + eps) * -lr)
