#!/usr/bin/env python3
"""Steady step times of the cells that run G1's backward, for two
checkouts in one run on one CUDA GPU, in turns.

    python3 -m seqrec_tpu_torch.scripts.step_pairs --before DIR [--rounds N]

DIR is the root of another checkout of the repository (for example a
``git archive`` of the parent commit unpacked under ``build/``). Each round
runs the checkouts as before, this one, this one, before, each in a process
of its own started from its root, so that each measures its own kernels
and wrappers with its own ``chip_smoke.py`` helpers (each checkout builds
its kernels into its own ``build/`` once):

- ``flagship``: GRU-50 CCE at B16 (``chip_smoke.steady_state``, 300 steps);
- ``featured``: the same with ``--rf --mf --uf`` (F = 14 ids a step);
- ``ltm``: LTM's CBOW steps (200 steps of 2,048 positions, host clock to a
  synchronize);
- ``bprmf`` and ``fism``: the factorization family's device-sampled
  dispatches (``chip_smoke.mf_steady``).

Prints one JSON line per cell and checkout in each turn, with the card's
name and power limit, and last the medians of each cell's step time by
checkout. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# run in each checkout's root: its own chip_smoke.py and package
CELLS = r"""
import json, sys, time
import numpy as np
import torch
sys.path.insert(0, ".")
import chip_smoke as cs
from seqrec_tpu_torch.ops import _build

torch.backends.cuda.matmul.allow_tf32 = False
_build.build(sorted({src.split("/")[-1][:-3] for _, src, _ in cs.KERNELS.values()}))
card = cs.card_line()


def emit(cell, step_ms, unit, rate, extra):
    print(json.dumps({"cell": cell, "step_ms": step_ms, unit: rate, **extra, "card": card}), flush=True)


for cell, argv, ds in (("flagship", cs.FLAGSHIP, cs.ml1m_dataset()), ("featured", cs.FEATURED, cs.featured_dataset())):
    st = cs.steady_state(argv, ds, steps=300, warmup=20, profile_steps=20, card=card)
    emit(cell, st["step_ms"], "sequences_per_s", st["sequences_per_s"],
         {"device_ms_per_step": st["device_ms_per_step"], "device_busy_share": st["device_busy_share"]})
pp_dir, _ = cs.ml1m_pp_dataset()
model = cs.ltm_model(pp_dir, "cuda")
cs.ltm_steps(model, 20)
torch.cuda.synchronize()
t0 = time.perf_counter()
cs.ltm_steps(model, 200)
torch.cuda.synchronize()
step_s = (time.perf_counter() - t0) / 200
emit("ltm", step_s * 1e3, "steps_per_s", 1.0 / step_s, {})
for cell, flags, dispatches in (("bprmf", cs.MF_RUNS["bprmf"], 20), ("fism", cs.MF_RUNS["fism_bpr"], 4)):
    st = cs.mf_steady(pp_dir, flags, dispatches, card)
    emit(cell, st["chunk_ms"], "samples_per_s", st["samples_per_s"],
         {"device_ms_per_chunk": st["device_ms_per_chunk"], "device_busy_share": st["device_busy_share"]})
"""


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--before", required=True, help="root of the other checkout")
    parser.add_argument("--rounds", type=int, default=1, help="rounds of before, this, this, before")
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("step_pairs: no CUDA device is available", file=sys.stderr)
        return 1
    trees = {"before": os.path.abspath(args.before), "this": HERE}
    steps = {}
    for r in range(args.rounds):
        for name in ("before", "this", "this", "before"):
            out = subprocess.run([sys.executable, "-c", CELLS], cwd=trees[name], capture_output=True, text=True)
            if out.returncode:
                sys.stderr.write(out.stderr[-4000:])
                return out.returncode
            for line in out.stdout.splitlines():
                if line.startswith('{"cell"'):
                    res = json.loads(line)
                    print(json.dumps({"round": r, "checkout": name, **res}), flush=True)
                    steps.setdefault(res["cell"], {}).setdefault(name, []).append(res["step_ms"])
    print(json.dumps({"median_step_ms": {cell: {name: statistics.median(v) for name, v in by.items()}
                                         for cell, by in steps.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
