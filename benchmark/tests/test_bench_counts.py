"""The count functions against hand-worked counts at the cells' shapes, and
the least time as a lower bound against the peaks of the precision."""

import pytest

from benchmark.harness import counts

H100 = counts.peaks("NVIDIA H100 80GB HBM3")


@pytest.mark.parametrize("cell,L,expected", [
    ("GRU", 30, 47_247_360),  # 6*30*128*384 + 6*128*50000
    ("LSTM", 30, 50_196_480),  # 6*30*128*512 + 38.4 M
    ("GRU", 200, 97_382_400),  # 6*200*128*384 + 38.4 M
])
def test_model_flops_per_sequence(cell, L, expected):
    assert counts.model_flops_per_sequence(cell, L, 128, 50_000) == expected


@pytest.mark.parametrize("cell,steps,expected", [
    ("GRU", 200, 14_331_000),  # 6*200*50*150 + 6*50*17770: a full row of the L 200 cells
    ("LSTM", 200, 17_331_000),  # 6*200*50*200 + 5.331 M
    ("GRU", 105.5, 10_078_500),  # the mean valid steps of a row: padding is no work
])
def test_model_flops_per_sequence_at_the_cells_shapes(cell, steps, expected):
    assert counts.model_flops_per_sequence(cell, steps, 50, 17_770) == pytest.approx(expected)


def test_cce_head_at_b4096_h50_n17770():
    w = counts.cce_head(4096, 50, 17_770)
    assert w.matrix_flops == 6 * 4096 * 50 * 17_770  # 21.8 GFLOP
    assert w.bytes == 4 * (2 * 4096 * 50 + 2 * 50 * 17_770 + 2 * 17_770 + 3 * 4096)
    # matrix-bound at the TF32 peak: 44.1 us
    assert w.least_seconds(H100, "float32") == pytest.approx(6 * 4096 * 50 * 17_770 / 495e12)


def test_gru128_l30_is_47_2_mflop():
    assert round(counts.model_flops_per_sequence("GRU", 30, 128, 50_000) / 1e6, 1) == 47.2


def test_cce_head_at_b1024_h128_n50000():
    w = counts.cce_head(1024, 128, 50_000)
    assert w.matrix_flops == 6 * 1024 * 128 * 50_000  # 39.3 GFLOP
    assert w.other_flops == 6 * 1024 * 50_000
    # h, W, b, targets, row weights in; costs, dh, dW, db out
    assert w.bytes == 4 * (2 * 1024 * 128 + 2 * 128 * 50_000 + 2 * 50_000 + 3 * 1024)
    # matrix-bound at the TF32 peak: 79.4 us
    assert w.least_seconds(H100, "float32") == pytest.approx(6 * 1024 * 128 * 50_000 / 495e12)


@pytest.mark.parametrize("cell,G,ops,extra", [("GRU", 3, 33, 0), ("LSTM", 4, 51, 1)])
def test_recurrence_at_b1024_h128(cell, G, ops, extra):
    valid = 24_000
    w = counts.recurrence(cell, 128, 1024, valid)
    assert w.matrix_flops == 3 * 2 * valid * 128 * G * 128
    assert w.other_flops == ops * valid * 128
    n_states = 1 + extra
    moved = 2 * valid * G * 128 + 2 * 128 * G * 128 + 2 * 3 * 128 * extra + 2 * n_states * 1024 * 128 + 2 * 1024 * 128 + 1024
    assert w.bytes == 4 * moved


def test_gather_sum_counts_valid_slots_and_touched_rows():
    w = counts.gather_sum(384, valid=24_000, unique_rows=1_000)
    assert w.matrix_flops == 0
    assert w.other_flops == (24_000 - 1_000) * 384
    assert w.bytes == 4 * (2 * 24_000 + 2 * 1_000 * 384 + 2 * 24_000 * 384)


@pytest.mark.parametrize("work", [
    counts.cce_head(1024, 128, 50_000),
    counts.recurrence("GRU", 128, 1024, 24_000),
    counts.recurrence("LSTM", 128, 1024, 150_000),
    counts.gather_sum(384, 24_000, 1_000),
    counts.Work(1e9, 1e9, 1e9),
])
@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_least_time_is_a_lower_bound(work, precision):
    least = work.least_seconds(H100, precision)
    # no part of the work can run faster than its own ceiling ...
    assert least >= work.matrix_flops / H100["matrix"][precision]
    assert least >= work.other_flops / H100["other"]
    assert least >= work.bytes / H100["bytes"]
    # ... and the least time is the slowest of the three, no sum of them
    assert least == max(work.matrix_flops / H100["matrix"][precision], work.other_flops / H100["other"],
                        work.bytes / H100["bytes"])
    # float32 operands multiply at the TF32 rate, never at the bf16 one
    if precision == "float32":
        assert least >= work.matrix_flops / 495e12


def test_work_adds_up():
    a, b = counts.gather_sum(384, 10, 5), counts.gather_sum(384, 20, 7)
    s = a + b
    assert (s.matrix_flops, s.other_flops, s.bytes) == (0, a.other_flops + b.other_flops, a.bytes + b.bytes)


def test_peaks_refuse_another_card():
    with pytest.raises(KeyError):
        counts.peaks("NVIDIA A100-SXM4-80GB")
