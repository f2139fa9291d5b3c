"""Plain reference of the RNN with categorical cross-entropy over the whole
catalog (Devooght & Bersini, arXiv:1608.07400), trained with Adam.

Plain PyTorch, float32; it imports nothing of the port. One layer of
either tower over the one-hot input (the input product is a row gather of
``W_in``), as Lasagne defines them:

- GRU, gate order reset | update | candidate:
  ``r = s(x_r + hid_r)``, ``u = s(x_u + hid_u)``, ``c = tanh(x_c + r * hid_c)``,
  ``h' = (1 - u) h + u c`` with ``hid = h W_hid``;
- LSTM with peepholes, gate order in | forget | cell | out:
  ``i = s(pre_i + c w_ci)``, ``f = s(pre_f + c w_cf)``, ``g = tanh(pre_g)``,
  ``c' = f c + i g``, ``o = s(pre_o + c' w_co)``, ``h' = o tanh(c')`` with
  ``pre = x + h W_hid``;
- masked steps (past a row's prefix) carry the state; the final state
  feeds ``logits = h W_out + b_out``;
- Lasagne's gradient clipping (``grad_clipping=100``): the cotangent of the
  input pre-activation ``x = W_in[ids] + b`` and, inside each step, of
  ``hid`` (GRU) or of ``pre`` (LSTM) is clipped to +-clip;
- the cost is the mean over the batch of ``CCE_i / pop(target_i)^db``;
- Adam as optax computes it: ``mu = (1-b1) g + b1 mu``,
  ``nu = (1-b2) g^2 + b2 nu``, bias corrections ``1 - b^t`` in float32,
  ``p -= lr (mu / bc1) / (sqrt(nu / bc2) + eps)``.

The initial weights are made here from the seed, on the device, with a
``torch.Generator``, and both the port and this reference start from them:
``N(0, 0.1)`` for ``W_in``, ``W_hid`` and the peepholes, Glorot-uniform
``W_out``, zeros for the biases and the initial states (the port's own
initialiser draws the same laws from numpy).
"""

from __future__ import annotations

import numpy as np
import torch

GATES = {"GRU": 3, "LSTM": 4}


def leaf_shapes(model: dict, n_items: int) -> dict:
    """{leaf: shape} in draw order."""
    H, G = model["hidden"], GATES[model["cell"]]
    shapes = {"W_in": (n_items, G * H), "W_hid": (H, G * H), "b": (G * H,), "h0": (H,)}
    if model["cell"] == "LSTM":
        shapes.update(c0=(H,), w_ci=(H,), w_cf=(H,), w_co=(H,))
    shapes.update(W_out=(H, n_items), b_out=(n_items,))
    return shapes


def make_weights(model: dict, n_items: int, seed: int, device) -> dict:
    """The initial weights, float32 on ``device``, from ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    out = {}
    for name, shape in leaf_shapes(model, n_items).items():
        if name in ("W_in", "W_hid", "w_ci", "w_cf", "w_co"):
            out[name] = torch.randn(shape, generator=gen, device=device).mul_(0.1)
        elif name == "W_out":
            limit = float(np.sqrt(6.0 / (shape[0] + shape[1])))
            out[name] = torch.rand(shape, generator=gen, device=device).mul_(2 * limit).sub_(limit)
        else:
            out[name] = torch.zeros(shape, device=device)
    return out


def _clipped(x: torch.Tensor, clip: float) -> torch.Tensor:
    if clip and x.requires_grad:
        x.register_hook(lambda g: g.clamp(-clip, clip))
    return x


def final_state(p: dict, cell: str, ids: torch.Tensor, lengths: torch.Tensor, clip: float) -> torch.Tensor:
    """[B, H] final state of the tower over ids [B, L] with prefix lengths [B]."""
    B, L = ids.shape
    H = p["W_hid"].shape[0]
    x = _clipped(p["W_in"][ids] + p["b"], clip)  # [B, L, G H]
    mask = torch.arange(L, device=ids.device)[None, :] < lengths[:, None]
    h = p["h0"].expand(B, H)
    c = p["c0"].expand(B, H) if cell == "LSTM" else None
    for t in range(L):
        x_t, keep = x[:, t], mask[:, t : t + 1]
        if cell == "GRU":
            hid = _clipped(h @ p["W_hid"], clip)
            r = torch.sigmoid(x_t[:, :H] + hid[:, :H])
            u = torch.sigmoid(x_t[:, H : 2 * H] + hid[:, H : 2 * H])
            cand = torch.tanh(x_t[:, 2 * H :] + r * hid[:, 2 * H :])
            h = torch.where(keep, (1.0 - u) * h + u * cand, h)
        else:
            pre = _clipped(x_t + h @ p["W_hid"], clip)
            i = torch.sigmoid(pre[:, :H] + c * p["w_ci"])
            f = torch.sigmoid(pre[:, H : 2 * H] + c * p["w_cf"])
            g = torch.tanh(pre[:, 2 * H : 3 * H])
            c_new = f * c + i * g
            o = torch.sigmoid(pre[:, 3 * H :] + c_new * p["w_co"])
            h, c = torch.where(keep, o * torch.tanh(c_new), h), torch.where(keep, c_new, c)
    return h


def cost(p: dict, model: dict, batch, target_pop: torch.Tensor) -> torch.Tensor:
    ids, lengths, targets = batch
    h = final_state(p, model["cell"], ids, lengths, model["grad_clip"])
    logits = h @ p["W_out"] + p["b_out"]
    per_example = torch.logsumexp(logits, dim=1) - logits.gather(1, targets[:, None])[:, 0]
    return (per_example / target_pop[targets]).mean()


class Adam:
    """optax.adam's update, in place."""

    def __init__(self, opt: dict, params: dict):
        self.lr, self.b1, self.b2, self.eps = opt["learning_rate"], opt["beta1"], opt["beta2"], opt["eps"]
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> None:
        self.count += 1
        t = torch.tensor(self.count, dtype=torch.float32)
        bc1 = float(1 - torch.tensor(self.b1, dtype=torch.float32) ** t)
        bc2 = float(1 - torch.tensor(self.b2, dtype=torch.float32) ** t)
        for k, p in params.items():
            g = grads[k]
            self.mu[k].mul_(self.b1).add_((1 - self.b1) * g)
            self.nu[k].mul_(self.b2).add_((1 - self.b2) * (g * g))
            p.add_((self.mu[k] / bc1) / (torch.sqrt(self.nu[k] / bc2) + self.eps) * -self.lr)


def norms(tree: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tree.items()}


def train_steps(model: dict, weights: dict, batches, item_pop: np.ndarray, n_steps: int = 3,
                matmul_tf32: bool = False, half_batch: bool = False) -> dict:
    """``n_steps`` optimizer steps from ``weights`` (consumed: updated in
    place) on the host batches ``batches`` (``batches.steps``). Returns the
    readings the output check compares: each step's cost, each leaf's
    gradient at the first step (float64, on the host) and its norm, and
    the norm of its change after the last. ``matmul_tf32`` computes the products in TF32 (the control);
    ``half_batch`` drops the second half of every batch (a planted fault)."""
    device = weights["W_in"].device
    pop = np.asarray(item_pop, dtype=np.float32) ** np.float32(model["diversity_bias"])
    target_pop = torch.as_tensor(pop, device=device)
    params = {k: v.requires_grad_(True) for k, v in weights.items()}
    start = {k: v.detach().clone() for k, v in params.items()}
    adam = Adam(model["optimizer"], params)
    costs, first_grads = [], None
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = matmul_tf32
    try:
        for _ in range(n_steps):
            ids, lengths, targets = (torch.as_tensor(a, device=device) for a in next(batches))
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
