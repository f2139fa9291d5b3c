"""HSTU's attention counts and model flops (``harness/counts_hstu.py``) on a
hand-worked case of two rows, the cell's scale, and the four readers of
the HSTU cell on a synthetic trace (``runners/train_lengths.py``'s step
statistics), which read nothing in another cell."""

from types import SimpleNamespace

import numpy as np
import pytest

from benchmark.harness import counts, counts_hstu, dataset, manifest
from benchmark.harness.trace import Trace
from benchmark.reference import batches
from benchmark.runners.train_lengths import Steps, step_stats_with_lengths
from benchmark.tests.test_bench_trace import _launch, _x

H100 = counts.peaks("NVIDIA H100 80GB HBM3")
TWO_ROWS = dict(blocks=2, heads=1, dqk=2, dv=2)
CELL = "hstu_large_cce_26744.l200_b512"


def test_attention_of_two_rows_by_hand():
    """Rows of 3 and 1 valid steps, 2 blocks, one head of 2, L 4: block 1
    has 6 + 1 causal pairs, the last block the final rows' 3 + 1."""
    w = counts_hstu.attention([3, 1], L=4, **TWO_ROWS)
    assert w.matrix_flops == 6 * (2 + 2) * 11  # 2 (dqk + dv) a pair forward, twice that backward
    assert w.other_flops == 12 * 11
    # block 1: Q, K, dQ, dK, V, O, dO, dV at 4 steps (16 floats a step); the last block: K, V, dK, dV
    # at 4 steps and Q, O, dO, dQ at the 2 final ones; each block's tables (7 + 129, read and written)
    # and the 2 lengths
    assert w.bytes == 4 * (4 * 16 + (4 * 8 + 2 * 8) + 2 * (2 * (7 + 129) + 2))


def test_model_flops_of_a_row_by_hand():
    """m 3, d 4, 2 blocks, one head of 2, 10 items: the projections (64 a
    step), the output projection (16), 8 a pair; the last block's K and V
    (32 a step) with U, Q and the output projection once, and its 3 pairs;
    the output layer 80; forward and backward 3 times that."""
    full = 3 * (64 + 16) + 6 * 8
    last = 3 * 32 + 32 + 16 + 3 * 8
    assert counts_hstu.model_flops_per_sequence(3, 4, 2, 1, 2, 2, 10) == 3 * (full + last + 80)


def test_the_cells_scale():
    """About 1.6 GFLOP a sequence of 100 steps at the cell's widths; the
    attention of a B 512 step of 100-step rows is bound by bytes."""
    assert counts_hstu.model_flops_per_sequence(100, 256, 8, 4, 64, 64, 26_744) == pytest.approx(1.606e9, rel=1e-3)
    w = counts_hstu.attention([100] * 512, 8, 4, 64, 64, 200)
    assert w.least_seconds(H100, "float32") == pytest.approx(w.bytes / H100["bytes"])


def _hstu_trace():
    """A step's item gather and attention forward on thread 1 and their
    backward on thread 2 (times in microseconds), with a kernel outside
    them."""
    ev = [_x("cpu_op", "_HSTUAttention", 1, 10, 10), _x("cpu_op", "_HSTUAttentionBackward", 2, 40, 10),
          _x("cpu_op", "_GatherSum", 1, 2, 5), _x("cpu_op", "_GatherSumBackward", 2, 70, 5)]
    ev += _launch(1, 3, 5, "gather_sum_fwd", 80, 8)
    ev += _launch(2, 71, 6, "gather_sum_bwd", 300, 12)
    ev += _launch(1, 12, 1, "fwd_kernel", 100, 30)
    ev += _launch(2, 42, 2, "dq_kernel", 140, 50)
    ev += _launch(2, 45, 3, "dkv_kernel", 190, 70)
    ev += _launch(1, 60, 4, "other", 260, 40)
    return Trace(ev)


def test_readers_on_a_synthetic_trace():
    model = manifest.Manifest().config("hstu_large_cce_26744")["model"]
    stats = Steps([{"valid": 150, "unique_rows": 90, "lengths": [100, 50]},
                   {"valid": 60, "unique_rows": 40, "lengths": [10, 50]}])
    stats.model = model
    run = SimpleNamespace(cell=dict(cell="HSTU", H=256, N=26_744, B=2, L=200, K=2), precision="float32",
                          peaks=H100, trace=_hstu_trace(), step_stats=stats, train_seq_per_s=1000.0)
    read = {m: manifest.metric_reader(m).read(run) for m in
            ("hstu_attn_roofline", "hstu_attn_ms_per_step", "hstu_step_mfu_pct", "hstu_g1_roofline")}
    work = counts_hstu.attention([100, 50], 8, 4, 64, 64, 200) + counts_hstu.attention([10, 50], 8, 4, 64, 64, 200)
    assert read["hstu_attn_roofline"] == pytest.approx(100 * work.least_seconds(H100, "float32") / 150e-6)
    assert read["hstu_attn_ms_per_step"] == pytest.approx(0.075)
    mean = sum(counts_hstu.model_flops_per_sequence(m, 256, 8, 4, 64, 64, 26_744) for m in (100, 50, 10, 50)) / 4
    assert read["hstu_step_mfu_pct"] == pytest.approx(100 * mean * 1000 / 495e12)
    g1 = counts.gather_sum(256, 150, 90) + counts.gather_sum(256, 60, 40)  # D is the width d, not gates x H
    assert read["hstu_g1_roofline"] == pytest.approx(100 * g1.least_seconds(H100, "float32") / 20e-6)
    # statistics without the rows' lengths (a plain list) and a trace without the entries read nothing
    other = SimpleNamespace(**{**vars(run), "step_stats": list(stats), "trace": Trace([])})
    for m in read:
        assert manifest.metric_reader(m).read(other) is None


def test_the_cell_reports_the_new_metrics_and_runs_on_the_row_runner():
    bench = manifest.Manifest()
    names = {m["name"] for m in bench.metrics_of(CELL, "per_layer")}
    assert {"hstu_attn_roofline", "hstu_attn_ms_per_step", "hstu_step_mfu_pct", "hstu_g1_roofline",
            "device_idle_pct"} <= names
    assert not names & {"k1_roofline", "k5_roofline", "g1_roofline", "step_mfu_pct"}  # the RNN's counts
    assert bench.traffic(bench.workload(CELL)["traffic"])["kind"] == "train_lengths"
    for cell in bench.workloads:
        if cell != CELL:
            assert not {m["name"] for m in bench.metrics_of(cell, "per_layer")} & {
                "hstu_attn_roofline", "hstu_attn_ms_per_step", "hstu_step_mfu_pct", "hstu_g1_roofline"}


def test_step_stats_carry_each_rows_length_and_the_model(tmp_path):
    traffic = dict(manifest.Manifest().traffic("l200_b512"), n_users=200, min_len=5, max_len=40, n_val_users=10,
                   n_test_users=10)
    data = dataset.generate(str(tmp_path / "ds"), traffic, 300, 2**31 + 5)
    args = (data.train_items, data.train_offsets, 2**31 + 5, 16, 2, 12, 4)
    stats = step_stats_with_lengths({"cell": "HSTU"})(*args)
    assert isinstance(stats, Steps) and stats.model == {"cell": "HSTU"} and len(stats) == 4
    for s, plain, (_, m, _) in zip(stats, batches.step_stats(*args), batches.steps(*args[:-1])):
        assert s["lengths"] == m.tolist() and s["valid"] == plain["valid"] == int(np.sum(m))
