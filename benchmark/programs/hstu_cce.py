"""How the benchmark drives the port's HSTU tower (``--r_t HSTU``) with the
CCE head.

The predictor is built as for the RNN cells (``rnn_cce.build``: the train
CLI's ``get_predictor`` on the configuration's flags, the traffic's batch,
length and ``--spd``) and trains through the same ``RNNBase.train``: the
index wire, ``_payload_pipeline``, ``train_function_stacked``, ``_step``.
The reference's leaves are the port's state-dict keys, without ``tower.``
for the tower's. Nothing of the port is edited.
"""

from __future__ import annotations

import torch

from benchmark.programs.rnn_cce import build  # noqa: F401 (the family's entry point)
from benchmark.reference.hstu_cce import fit

HEAD = ("W_out", "b_out")


def port_key(leaf: str) -> str:
    return leaf if leaf in HEAD else "tower." + leaf


def load_weights(predictor, weights: dict) -> None:
    """The benchmark's weights into the port (``params_from_numpy``), the
    position tables cut to the port's padded length."""
    L = predictor.recurrent_layer.max_length
    tree: dict = {}
    for leaf, w in weights.items():
        node = tree
        *path, last = port_key(leaf).split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[last] = fit(leaf, w, L).detach().cpu().numpy()
    predictor.params_from_numpy(tree)


def named_leaves(predictor) -> dict:
    """{reference leaf: the port's parameter tensor}."""
    return {key.removeprefix("tower."): p for key, p in predictor.net.named_parameters()}


class Capture:
    """``rnn_cce.Capture`` for this family's leaves: wraps the instance's
    ``_step`` for the first ``n_steps`` optimizer steps; each step's cost,
    after the first step each leaf's gradient as Adam got it (its first
    moment over ``1 - b1``, on the host) and its norm, and after the last
    the norm of each leaf's change from ``start`` (the weights loaded, cut
    as the port holds them). Norms are taken on the device in float64."""

    def __init__(self, predictor, start: dict, n_steps: int = 3):
        L = predictor.recurrent_layer.max_length
        self.predictor, self.n_steps = predictor, n_steps
        self.start = {leaf: fit(leaf, w, L) for leaf, w in start.items()}
        self.costs, self.grads, self.grad_norms, self.change_norms = [], None, None, None
        self._step = predictor._step
        predictor._step = self

    def __call__(self, dev_batch):
        cost = self._step(dev_batch)
        if len(self.costs) < self.n_steps:
            self.costs.append(cost.detach().clone())
            leaves = named_leaves(self.predictor)
            if len(self.costs) == 1:
                state = self.predictor.opt_state
                index = {id(p): i for i, p in enumerate(self.predictor._train_params())}
                b1 = self.predictor.updater.beta1
                self.grads = {leaf: (state["mu"][index[id(p)]].double() / (1 - b1)).cpu()
                              for leaf, p in leaves.items()}
                self.grad_norms = {leaf: torch.linalg.vector_norm(g) for leaf, g in self.grads.items()}
            if len(self.costs) == self.n_steps:
                self.change_norms = {
                    leaf: torch.linalg.vector_norm(p.detach().double() - self.start[leaf].double())
                    for leaf, p in leaves.items()
                }
                self.start = None
                self.remove()
        return cost

    def remove(self) -> None:
        if self.predictor.__dict__.get("_step") is self:
            del self.predictor._step

    def readings(self) -> dict:
        return {
            "costs": [float(c) for c in self.costs],
            "grads": self.grads or {},
            "grad_norms": {k: float(v) for k, v in (self.grad_norms or {}).items()},
            "change_norms": {k: float(v) for k, v in (self.change_norms or {}).items()},
        }
