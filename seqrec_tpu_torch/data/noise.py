"""Training-time sequence augmentation.

Behavior matches the reference's neural_networks/sequence_noise.py:15-94:
item dropout (re-draw if fewer than 2 items survive), adjacent swaps (no
double swap of the same item), gaussian-distance shuffle, and ±0.5 rating
perturbation clipped to [1, 5]. Operates on the host-side sequence stream
before packing; randomness comes from a ``numpy.random.Generator`` so runs
are seedable end-to-end.
"""

from __future__ import annotations

import numpy as np


def sequence_noise_command_parser(parser) -> None:
    parser.add_argument("--n_dropout", help="Dropout probability", default=0.0, type=float)
    parser.add_argument(
        "--n_swap",
        help="Probability of swapping two consecutive items",
        default=0.0,
        type=float,
    )
    parser.add_argument(
        "--n_shuf",
        help="Probability of swapping two random items",
        default=0.0,
        type=float,
    )
    parser.add_argument(
        "--n_shuf_std",
        help="Std of the normal distribution the swap distance is drawn from",
        default=5.0,
        type=float,
    )
    parser.add_argument(
        "--n_ratings", help="Probability of changing the rating.", default=0.0, type=float
    )


def get_sequence_noise(args) -> "SequenceNoise":
    return SequenceNoise(
        dropout=args.n_dropout,
        swap=args.n_swap,
        ratings_perturb=args.n_ratings,
        shuf=args.n_shuf,
        shuf_std=args.n_shuf_std,
    )


class SequenceNoise:
    def __init__(
        self,
        dropout: float = 0.0,
        swap: float = 0.0,
        ratings_perturb: float = 0.0,
        shuf: float = 0.0,
        shuf_std: float = 0.0,
        rng: np.random.Generator | None = None,
    ):
        self.dropout = dropout
        self.swap = swap
        self.ratings_perturb = ratings_perturb
        self.shuf = shuf
        self.shuf_std = shuf_std
        self.rng_explicit = rng is not None  # see SelectTargets.__init__
        self.rng = rng or np.random.default_rng()
        self._check_param_validity()
        self._set_name()

    def _set_name(self) -> None:
        name = []
        if self.dropout > 0:
            name.append("do" + str(self.dropout))
        if self.swap > 0:
            name.append("sw" + str(self.swap))
        if self.ratings_perturb > 0:
            name.append("rp" + str(self.ratings_perturb))
        if self.shuf > 0:
            name.append("sh" + str(self.shuf) + "-" + str(self.shuf_std))
        self.name = "_".join(name)

    def _check_param_validity(self) -> None:
        if not 0.0 <= self.dropout < 1.0:
            raise ValueError("Dropout should be in [0,1)")
        if not 0.0 <= self.swap < 1.0:
            raise ValueError("Swapping probability should be in [0,1)")
        if not 0.0 <= self.ratings_perturb < 1.0:
            raise ValueError("Rating perturbation probability should be in [0,1)")

    @property
    def is_identity(self) -> bool:
        return (
            self.dropout == 0.0
            and self.swap == 0.0
            and self.ratings_perturb == 0.0
            and self.shuf == 0.0
        )

    def apply(self, sequence):
        """Apply noise to one sequence (list of [item, rating] pairs).

        Returns None when dropout leaves fewer than 2 items (caller should
        skip and draw the next sequence, sequence_noise.py:62-65).
        """
        rng = self.rng
        if self.dropout > 0.0:
            sequence = [i for i in sequence if rng.random() >= self.dropout]
            if len(sequence) < 2:
                return None

        if self.swap > 0.0:
            i = 0
            while i < len(sequence) - 1:
                if rng.random() < self.swap:
                    sequence[i], sequence[i + 1] = sequence[i + 1], sequence[i]
                    i += 1  # don't allow swapping the same item twice
                i += 1

        if self.shuf > 0.0:
            for i in range(len(sequence)):
                if rng.random() < self.shuf:
                    other = max(
                        0,
                        min(
                            len(sequence) - 1,
                            int(rng.normal() * self.shuf_std) + i,
                        ),
                    )
                    sequence[i], sequence[other] = sequence[other], sequence[i]

        if self.ratings_perturb > 0:
            for i in range(len(sequence)):
                if rng.random() < self.ratings_perturb:
                    if rng.random() < 0.5:
                        sequence[i][1] = min(5, sequence[i][1] + 0.5)
                    else:
                        sequence[i][1] = max(1, sequence[i][1] - 0.5)

        return sequence

    def __call__(self, sequence_generator):
        """Wrap a ``(sequence, user)`` generator, reference-style."""
        while True:
            sequence, user = next(sequence_generator)
            noisy = self.apply(sequence)
            if noisy is None:
                continue
            yield noisy, user
