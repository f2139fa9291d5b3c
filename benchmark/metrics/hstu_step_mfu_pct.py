"""``hstu_step_mfu_pct``: the whole HSTU training step's share of the card's
matrix peak for the configuration's precision: model flops a sequence
(``counts_hstu.model_flops_per_sequence``, forward and backward, the
mean over the rows of the traced steps' batches, so that the attention's
square in a row's length is averaged as it falls) times the timed window's
sequences a second, over the peak. Layer: the model step
(``models/base.py:_step``, ``models/hstu.py``, ``models/rnn_one_hot.py``)."""

from __future__ import annotations

import numpy as np

from benchmark.harness import counts_hstu


def read(run):
    m = getattr(run.step_stats, "model", None)
    if not m or not run.step_stats:
        return None
    rows = np.concatenate([np.asarray(s["lengths"], dtype=np.float64) for s in run.step_stats])
    flops = float(np.mean(counts_hstu.model_flops_per_sequence(rows, run.cell["H"], m["blocks"], m["heads"],
                                                               m["dqk"], m["dv"], run.cell["N"])))
    return 100.0 * flops * run.train_seq_per_s / run.peaks["matrix"][run.precision]
