"""The output check on the CPU at a tiny size: a sound run is correct, and
each fault a training cell can have, planted under the timed path after
set-up, makes ``correct`` false. The chip's look is skipped: the runner
is driven directly, on the port's CPU path."""

import pytest
import torch

from benchmark.harness import manifest
from benchmark.tests import tiny

CELLS = list(manifest.Manifest().workloads)


def unchanged_state(predictor):
    """The optimizer step returns its state unchanged."""
    predictor.updater.step = lambda *args, **kwargs: None


def half_batch(predictor):
    """Half of each batch left out; the mean taken over the rest."""
    expand = predictor._expand_index_wire

    def first_half(batch, store):
        out = expand(batch, store)
        keep = out["targets"].shape[0] // 2
        return {k: v[:keep] if isinstance(v, torch.Tensor) and v.dim() else v for k, v in out.items()}

    predictor._expand_index_wire = first_half


def cost_altered(predictor):
    """The cost altered by 1% where it is produced (the model's loss)."""
    loss = predictor._loss

    def altered(batch):
        return loss(batch) * 1.01

    predictor._loss = altered


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    out = tiny.run(cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0


@pytest.mark.parametrize("fault", [unchanged_state, half_batch, cost_altered], ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell", CELLS)
def test_fault_makes_correct_false(cell, fault):
    out = tiny.run(cell, plant=fault)
    assert not out["correct"], out["checks"]
