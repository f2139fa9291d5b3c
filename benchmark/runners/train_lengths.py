"""Training cells whose per-layer metrics count work row by row:
``runners/train.py``'s run (set-up, the timed window, the traced calls,
the output check), with the traced steps' statistics (``run.step_stats``
of the metric readers) a :class:`Steps` list: each step's entry also
carries ``lengths``, the prefix length of each of its rows, worked out
again from the dataset and the seed by ``reference/batches.py:steps``, and
the list carries the configuration's ``model`` keys. The HSTU attention's
work grows with the square of a row's length, so a step's total of valid
positions does not fix it.
"""

from __future__ import annotations

from benchmark.reference import batches
from benchmark.runners import train

_step_stats = batches.step_stats


class Steps(list):
    """The traced steps' statistics, and the ``model`` they ran through."""

    model: dict = {}


def step_stats_with_lengths(model: dict):
    """``batches.step_stats`` giving :class:`Steps` of ``model``."""

    def step_stats(items, offsets, seed, B, K, L, n_steps):
        stats = Steps(_step_stats(items, offsets, seed, B, K, L, n_steps))
        stats.model = model
        for s, (_, m, _) in zip(stats, batches.steps(items, offsets, seed, B, K, L)):
            s["lengths"] = m.tolist()
        return stats

    return step_stats


def run(bench, workload: str, seed: int, seconds: float, trace: bool, t0: float, device: str = "cuda",
        plant=None) -> dict:
    """``train.run`` with :func:`step_stats_with_lengths` in place of the
    batches' ``step_stats`` while it runs."""
    model = bench.config(bench.workload(workload)["config"])["model"]
    train.ref_batches.step_stats = step_stats_with_lengths(model)
    try:
        return train.run(bench, workload, seed, seconds, trace, t0, device=device, plant=plant)
    finally:
        train.ref_batches.step_stats = _step_stats
