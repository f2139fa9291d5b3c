"""Early-stopping policies.

Decision semantics follow the reference's helpers/early_stopping.py:19-86:
policies are callables ``stopper(epochs, val_costs) -> bool`` where
``val_costs`` are oriented so higher is better (``higher_is_better=False``
flips the sign before deciding, early_stopping.py:25-30).
"""

from __future__ import annotations


def early_stopping_command_parser(parser) -> None:
    parser.add_argument(
        "--es_m",
        dest="early_stopping_method",
        choices=["WorstTimesX", "StopAfterN", "None"],
        help="Early stopping method",
        default="None",
    )
    parser.add_argument(
        "--es_n", help="N parameter (for StopAfterN)", default=5, type=int
    )
    parser.add_argument(
        "--es_x", help="X parameter (for WorstTimesX)", default=2.0, type=float
    )
    parser.add_argument(
        "--es_min_wait",
        help="Minimum wait before stopping (for WorstTimesX)",
        default=1.0,
        type=float,
    )
    parser.add_argument(
        "--es_LiB",
        help="Lower is better for validation score.",
        action="store_true",
    )


def get_early_stopper(args):
    if args.early_stopping_method == "StopAfterN":
        return StopAfterN(n=args.es_n, higher_is_better=(not args.es_LiB))
    if args.early_stopping_method == "WorstTimesX":
        return WaitWorstCaseTimesX(
            x=args.es_x, min_wait=args.es_min_wait, higher_is_better=(not args.es_LiB)
        )
    return None


class EarlyStopperBase:
    def __init__(self, higher_is_better: bool = True):
        self.higher_is_better = higher_is_better

    def __call__(self, epochs, val_costs) -> bool:
        if not self.higher_is_better:
            val_costs = [-i for i in val_costs]
        return self.decide_stopping(epochs, val_costs)

    def decide_stopping(self, epochs, val_costs) -> bool:  # pragma: no cover
        raise NotImplementedError


class StopAfterN(EarlyStopperBase):
    """Stop after N consecutive non-improving evaluations
    (early_stopping.py:35-52)."""

    def __init__(self, n: int = 3, **kwargs):
        super().__init__(**kwargs)
        self.n = n

    def decide_stopping(self, epochs, val_costs) -> bool:
        if len(val_costs) <= self.n:
            return False
        for i in range(self.n):
            if val_costs[-1 - i] > val_costs[-2 - i]:
                return False
        return True


class WaitWorstCaseTimesX(EarlyStopperBase):
    """Stop when the wait since the best score exceeds X times the longest
    historical gap between consecutive bests (early_stopping.py:55-86)."""

    def __init__(self, x: float = 2.0, min_wait: float = 1.0, **kwargs):
        super().__init__(**kwargs)
        self.x = x
        self.min_wait = min_wait

    def decide_stopping(self, epochs, val_costs) -> bool:
        last_best = val_costs[0]
        last_best_epoch = epochs[0]
        longest_wait = 0.0
        for epoch, cost in zip(epochs[1:], val_costs[1:]):
            if cost > last_best:
                wait = epoch - last_best_epoch
                last_best_epoch = epoch
                last_best = cost
                if wait > longest_wait:
                    longest_wait = wait

        current_wait = epochs[-1] - last_best_epoch
        if longest_wait == 0:
            return current_wait > self.min_wait
        return current_wait > max(self.min_wait, longest_wait * self.x)
