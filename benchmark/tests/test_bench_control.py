"""On the card, at each cell's own size: the control (the reference with
TF32 products, the precision below the configuration's float32, in the
port's place) and the planted half-batch fault both fail the cell's
output check, on three seeds."""

import pytest

from benchmark import calibrate
from benchmark.harness import compare, manifest

CELLS = list(manifest.Manifest().workloads)
SEEDS = [2**31 + 7001, 2**31 + 7002, 2**31 + 7003]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_and_half_batch_are_not_correct(cuda, cell):
    bench = manifest.Manifest()
    limits = bench.limits(cell)
    for seed in SEEDS:
        readings = calibrate.stand_in_readings(bench, cell, seed)
        for name in ("control", "half_batch"):
            ok, checks = compare.judge(readings[name], limits)
            assert not ok, (seed, name, checks)
