"""The numbers that decide ``correct`` for a training cell.

Both sides report, for the first three optimizer steps from the same
weights on the same batches: each step's cost, each leaf's gradient at
the first step, and each leaf's change norm after the third. Four numbers
are compared, each against a limit of its own (``limits/<cell>.json``):

- ``cost_rel_gap``: the largest ``|cost - cost_ref| / |cost_ref|`` over the
  steps;
- ``grad_norm_gap``: over the leaves, the largest gap between the two
  sides' gradient norms, ``| |g| - |g_ref| |``, over the larger of the
  reference's norm of that leaf and its median leaf norm;
- ``change_norm_gap``: the same of the change norms, over the leaves that
  the reference moves: a leaf whose reference gradient norm is under a
  thousandth of the median leaf's moves under Adam by round-off alone and
  is left out;
- ``grad_rel_diff``: over the leaves, the largest norm of the difference
  of the two first gradients, ``|g - g_ref|``, over the same scale. A gap
  of norms moves only by the part of an error along the gradient, so
  rounding that is random in sign (TF32 products in place of float32)
  hardly moves it; the norm of the difference sees it. The first gradient
  comes from the same weights and batch on both sides, so the difference
  does not grow from step to step as the parameters' would (Adam's first
  steps move every element by about the learning rate, whatever its size).

A missing or non-finite reading makes its number infinite, which no limit
passes.
"""

from __future__ import annotations

import math
import statistics

NAMES = ("cost_rel_gap", "grad_norm_gap", "grad_rel_diff", "change_norm_gap")
# a leaf whose reference gradient norm is under this share of the median
# leaf's is left out of the change comparison
MOVED_SHARE = 1e-3


def _leaf_gap(ours: dict, ref: dict, leaves) -> float:
    leaves = list(leaves)
    if not leaves or any(k not in ours for k in leaves):
        return math.inf
    median = statistics.median(ref[k] for k in leaves)
    gap = 0.0
    for k in leaves:
        scale = max(ref[k], median)
        d = abs(ours[k] - ref[k]) / scale if scale > 0 else (0.0 if ours[k] == ref[k] else math.inf)
        gap = max(gap, d if math.isfinite(d) else math.inf)
    return gap


def _leaf_diff(ours: dict, ref: dict) -> float:
    if not ref or set(ours) != set(ref):
        return math.inf
    norms = {k: float(ref[k].norm()) for k in ref}
    median = statistics.median(norms.values())
    gap = 0.0
    for k, g in ref.items():
        d = float((ours[k].double() - g.double()).norm()) / max(norms[k], median)
        gap = max(gap, d if math.isfinite(d) else math.inf)
    return gap


def moved_leaves(ref: dict) -> list:
    median = statistics.median(ref["grad_norms"].values())
    return [k for k, v in ref["grad_norms"].items() if v >= MOVED_SHARE * median]


def numbers(ours: dict, ref: dict) -> dict:
    costs, ref_costs = ours.get("costs", []), ref["costs"]
    if len(costs) != len(ref_costs) or not all(math.isfinite(c) for c in costs):
        cost_gap = math.inf
    else:
        cost_gap = max(abs(c - r) / abs(r) for c, r in zip(costs, ref_costs))
    return {
        "cost_rel_gap": cost_gap,
        "grad_norm_gap": _leaf_gap(ours.get("grad_norms") or {}, ref["grad_norms"], ref["grad_norms"]),
        "grad_rel_diff": _leaf_diff(ours.get("grads") or {}, ref["grads"]),
        "change_norm_gap": _leaf_gap(ours.get("change_norms") or {}, ref["change_norms"], moved_leaves(ref)),
    }


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {"value", "limit"}})."""
    checks = {k: {"value": values[k], "limit": limits[k]} for k in NAMES}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks
