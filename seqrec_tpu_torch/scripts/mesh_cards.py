#!/usr/bin/env python3
"""The train CLI over a ("data", "model") mesh of N cards of one host, one
NCCL rank a card, against the same run on one card.

    python3 -m seqrec_tpu_torch.scripts.mesh_cards [--cards 4]

From the root of a checkout, on a machine with at least N CUDA GPUs. The
ranks are processes of ``chip_smoke.py --mesh-rank`` (torchrun's
variables set by ``chip_smoke.start_ranks``, rank r on ``cuda:r``), one
process group for every run, each run with every launch counter at 0:

- the flagship (GRU-50, 3,706 items, B=16, 200 steps, two progress
  lines) at every split of N into D x M: at M = 2 the vocab-parallel
  dense head and ``W_in`` by rows; a catalog that does not divide M keeps
  both tables whole (3,706 at M = 4);
- GRU-128 at B=1024 on the 50,000-item catalog (``chip_smoke``'s
  ``catalog50k_even_dataset``), ``--spd 4``, 32 steps and a validation,
  at every split: the streaming head, K2 on each shard.

Each run's progress costs are held to the single-device run's on
``cuda:0`` (rel 1e-4), and every rank must launch K1, G1, K3 and K4 (and
K2 in the streaming runs). Prints one JSON line per run (each rank's wall
seconds of its CLI call, dataset load and validation included: not a
scaling measurement), then the cards' names and power limits. Exits
non-zero on a failed check or with fewer than N cards.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TIMEOUT = 900  # seconds the rank processes may take for every run together
TOL = 1e-4


def splits(n: int) -> list:
    return [(d, n // d) for d in range(n, 0, -1) if n % d == 0]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cards", type=int, default=4)
    args = parser.parse_args(argv)
    import torch

    if torch.cuda.device_count() < args.cards:
        print(f"mesh_cards: {torch.cuda.device_count()} CUDA devices, {args.cards} asked for", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from seqrec_tpu_torch.cli import train as train_cli
    from seqrec_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.build(sorted({os.path.basename(src)[: -len(".cu")] for _, src, _ in cs.KERNELS.values()}))
    ds_dir, big_dir = cs.ml1m_dataset(), cs.catalog50k_even_dataset()
    cells = {
        "flagship": ["-d", ds_dir, *cs.FLAGSHIP, "--max_iter", "200", "--progress", "100", "--save", "None"],
        "large_spd4": ["-d", big_dir, *cs.LARGE, "--spd", "4", "--max_iter", "32", "--progress", "32",
                       "--save", "None"],
    }
    single = {}
    for cell, argv in cells.items():
        t1 = time.perf_counter()
        text = cs.run_cli(train_cli.main, argv + ["--device", "cuda:0"])[1]
        torch.cuda.synchronize()
        single[cell] = {"costs": cs.progress_values(text, "Last train cost"), "seconds": time.perf_counter() - t1}
    setup_s = time.perf_counter() - t0
    runs = [{"name": f"{cell}_{d}x{m}", "cli": "train", "argv": argv + ["--mesh", f"{d},{m}"]}
            for cell, argv in cells.items() for d, m in splits(args.cards)]
    t0 = time.perf_counter()
    results = cs.wait_ranks(cs.start_ranks(f"cards{args.cards}", args.cards, "nccl", runs), TIMEOUT)
    ranks_s = time.perf_counter() - t0
    ranks = results[f"cards{args.cards}"]
    failed = []
    for run in runs:
        name = run["name"]
        cell = name.rsplit("_", 1)[0]
        want = single[cell]["costs"]
        got = [rank[name]["costs"] for rank in ranks]
        rel = max(abs(a - b) / abs(b) for costs in got for a, b in zip(costs, want))
        ran = cs.MESH_RAN + (("cce_stats", "cce_grads") if cell == "large_spd4" else ())
        missing = sorted({k for rank in ranks for k in ran if rank[name]["launches"][k] == 0})
        ok = all(len(costs) == len(want) for costs in got) and rel <= TOL and not missing
        if not ok:
            failed.append(name)
        cs.emit({"run": name, "ranks": args.cards, "backend": "nccl", "progress_costs": got[0],
                 "single_device_costs": want, "max_rel_diff": rel, "ok": ok, "not_launched": missing,
                 "seconds_per_rank": [rank[name]["seconds"] for rank in ranks],
                 "single_device_seconds": single[cell]["seconds"],
                 "launches_rank0": {k: ranks[0][name]["launches"][k] for k in ran}})
    cs.emit({"setup_s": setup_s, "ranks_wall_s": ranks_s, "tolerance": f"progress costs rel {TOL}",
             "note": "wall seconds of CLI calls (dataset load, validation, process start): not a scaling number"})
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(out.stdout.strip(), flush=True)
    if failed:
        print(f"mesh_cards: failed {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
