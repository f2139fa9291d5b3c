"""How the benchmark drives the port's RNN with the CCE head.

The predictor is built as ``seqrec_tpu_torch/cli/train.py`` builds it:
``utils/command_parser.py:get_predictor`` on the configuration's flags
and the traffic's batch and length, ``steps_per_dispatch`` set from the
traffic's ``--spd``, the dataset read by ``DataHandler``. The weights the
benchmark made are loaded through ``params_from_numpy``. Training goes
through ``RNNBase.train``, the stacked index-wire pipeline:
``_payload_pipeline``, then ``train_function_stacked``, then ``_step``.

Nothing of the port is edited: the benchmark wraps methods of the one
instance it built (``train_function_stacked``, ``_step``,
``updater.step``) from its own files.
"""

from __future__ import annotations

import numpy as np
import torch

# the port's parameter (state-dict key) of each reference leaf
PORT_KEYS = {
    "W_in": "tower.layer0_fwd.W_in", "W_hid": "tower.layer0_fwd.W_hid", "b": "tower.layer0_fwd.b",
    "h0": "tower.layer0_fwd.h0", "c0": "tower.layer0_fwd.c0", "w_ci": "tower.layer0_fwd.w_ci",
    "w_cf": "tower.layer0_fwd.w_cf", "w_co": "tower.layer0_fwd.w_co", "W_out": "W_out", "b_out": "b_out",
}


def build(config: dict, traffic: dict, dirname: str, seed: int, device: str):
    """(predictor, dataset handler) on ``device``, the predictor's batch
    generator seeded from ``seed``."""
    import seqrec_tpu_torch.utils.command_parser as parse
    from seqrec_tpu_torch.data import DataHandler

    argv = [*config["flags"], "-b", str(traffic["batch"]), "--max_length", str(traffic["max_length"])]
    args = parse.command_parser(parse.predictor_command_parser, argv=argv)
    args.device = device
    predictor = parse.get_predictor(args)
    predictor.seed = seed
    predictor.rng = np.random.default_rng(seed)
    dataset = DataHandler(dirname)
    predictor.prepare_model(dataset)
    if traffic["steps_per_dispatch"] > 1:  # as cli/train.py sets it
        predictor.steps_per_dispatch = traffic["steps_per_dispatch"]
    return predictor, dataset


def load_weights(predictor, weights: dict) -> None:
    """The benchmark's weights into the port (its ``params_from_numpy``
    tree: ``/``-paths of the state-dict keys)."""
    tree: dict = {}
    for leaf, w in weights.items():
        node = tree
        *path, last = PORT_KEYS[leaf].split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[last] = w.detach().cpu().numpy()
    predictor.params_from_numpy(tree)


def named_leaves(predictor) -> dict:
    """{reference leaf: the port's parameter tensor}."""
    params = dict(predictor.net.named_parameters())
    return {leaf: params[key] for leaf, key in PORT_KEYS.items() if key in params}


class Capture:
    """Wraps the instance's ``_step`` for the first ``n_steps`` optimizer
    steps of training: each step's cost (a device scalar), after the first
    step each leaf's gradient as Adam got it (its first moment over
    ``1 - b1``, copied to the host) and its norm, and after the last the
    norm of each leaf's change from ``start`` (the weights loaded). Norms
    are taken on the device in float64 and read when :meth:`readings` is
    called."""

    def __init__(self, predictor, start: dict, n_steps: int = 3):
        self.predictor, self.start, self.n_steps = predictor, start, n_steps
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
