"""A cell of the real manifest cut to a size the CPU runs in seconds: the
configuration, traffic and limits read from their files, then the
catalog, the hidden size, the batch, the length and the users made
small. For tests only: the numbers of such a run are not device metrics."""

import time

from benchmark.harness import manifest


class TinyManifest(manifest.Manifest):
    def __init__(self, n_items=300, hidden=16, batch=32, max_length=12, flags=()):
        super().__init__()
        self.n_items, self.hidden, self.batch, self.max_length = n_items, hidden, batch, max_length
        self.extra_flags = list(flags)

    def config(self, name):
        c = super().config(name)
        c["model"]["n_items"] = self.n_items
        c["model"]["hidden"] = self.hidden
        i = c["flags"].index("--r_l")
        c["flags"][i + 1] = str(self.hidden)
        c["flags"] += self.extra_flags
        return c

    def traffic(self, name):
        t = super().traffic(name)
        t.update(batch=self.batch, max_length=min(t["max_length"], self.max_length), n_users=200, min_len=5,
                 max_len=40, n_val_users=10, n_test_users=10, steps_per_dispatch=2)
        return t


def run(cell, seed=2**31 + 101, bench=None, **kwargs):
    from benchmark.runners import train

    return train.run(bench or TinyManifest(), cell, seed, 0.5, False, time.perf_counter(), device="cpu", **kwargs)
