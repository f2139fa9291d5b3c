"""Target selection from the unconsumed suffix of a sequence.

Matches the reference's neural_networks/target_selection.py:15-53: optional
shuffling of the remaining sequence, popularity-biased skipping with keep
probability ``(min_pop / pop)^bias``, deterministic behavior at test time
unless ``rand_test_target``.
"""

from __future__ import annotations

import numpy as np


def target_selection_command_parser(parser) -> None:
    parser.add_argument(
        "--n_targets",
        help="Number of targets (Only for RNN with hinge, logit or logsig loss).",
        default=1,
        type=int,
    )
    parser.add_argument(
        "--shuffle_targets",
        help="Pick targets randomly in the remaining sequence instead of the next items.",
        action="store_true",
    )
    parser.add_argument(
        "--rand_test_target",
        help="Use the same target-selection procedure during training and testing.",
        action="store_true",
    )
    parser.add_argument(
        "--target_bias",
        help="Skip popular targets with probability proportional to pop^bias. Negative disables.",
        default=-1.0,
        type=float,
    )


def get_target_selection(args) -> "SelectTargets":
    return SelectTargets(
        n_targets=args.n_targets,
        shuffle=args.shuffle_targets,
        bias=args.target_bias,
        determinist_test=(not args.rand_test_target),
    )


class SelectTargets:
    def __init__(
        self,
        n_targets: int = 1,
        shuffle: bool = False,
        bias: float = -1,
        determinist_test: bool = True,
        rng: np.random.Generator | None = None,
    ):
        self.n_targets = n_targets
        self.shuffle = shuffle
        self.bias = bias
        self.determinist_test = determinist_test
        # rng_explicit: RNNBase reseeds default streams from the model
        # seed (reproducible runs; required for mesh/single parity and
        # identical batches across multi-process hosts) but never
        # overrides a caller-provided generator
        self.rng_explicit = rng is not None
        self.rng = rng or np.random.default_rng()

    @property
    def name(self) -> str:
        name = "nt" + str(self.n_targets)
        if self.bias >= 0.0:
            name += "_tb" + str(self.bias)
        if self.shuffle:
            name += "_shufT"
        return name

    def set_dataset(self, dataset) -> None:
        if self.bias >= 0.0:
            pop = np.maximum(1, dataset.item_popularity)
            self.keep_prob = np.power(pop.min() / pop, self.bias)

    def __call__(self, remaining_sequence, test: bool = False):
        """Choose target(s) among the items the RNN has not consumed."""
        remaining_sequence = list(remaining_sequence)
        if not (test and self.determinist_test):
            if self.shuffle:
                self.rng.shuffle(remaining_sequence)
            if self.bias >= 0.0:
                remaining_sequence = [
                    i
                    for i in remaining_sequence
                    if self.rng.random() <= self.keep_prob[i[0]]
                ]
        return remaining_sequence[: min(len(remaining_sequence), self.n_targets)]
