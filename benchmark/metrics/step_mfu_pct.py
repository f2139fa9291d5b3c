"""``step_mfu_pct``: the whole training step's share of the card's matrix
peak for the configuration's precision: model flops a sequence
(``counts.model_flops_per_sequence``: 6 S H G H + 6 H N, forward and
backward, with S the mean valid steps a row of the traced steps' batches,
as the rooflines count them) times the timed window's sequences a second,
over the peak. Layer: the model step (``models/base.py:_step``,
``models/recurrent.py``, ``models/rnn_one_hot.py``)."""

from __future__ import annotations

from benchmark.harness import counts


def read(run):
    c = run.cell
    if not run.step_stats:
        return None
    steps = sum(s["valid"] for s in run.step_stats) / (len(run.step_stats) * c["B"])
    flops = counts.model_flops_per_sequence(c["cell"], steps, c["H"], c["N"])
    return 100.0 * flops * run.train_seq_per_s / run.peaks["matrix"][run.precision]
