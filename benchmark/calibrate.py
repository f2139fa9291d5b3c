"""Readings behind the limits of a training cell's output check, on the card
at the cell's own size, in one process:

    python3 benchmark/calibrate.py --workload NAME --seeds 1 2 ... --control-seeds 1 2 3

- the port (lower readings): a run of the cell on each of ``--seeds``, with
  a short window (the compared steps are set-up's first three), and the
  three numbers its output check compares;
- the control (upper readings): the reference computed with TF32 products,
  the nearest precision below the configuration's float32, in the port's
  place, on each of ``--control-seeds``;
- a planted fault: the reference with the second half of every batch left
  out, the mean taken over the rest, in the port's place, on the same
  seeds. (A state left unchanged reads 1 on the change and needs no run.)

Prints one JSON line a reading and a summary line; the benchmark's own
runs never run this.
"""

import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def stand_in_readings(bench, workload: str, seed: int, device: str = "cuda") -> dict:
    """{"control": numbers, "half_batch": numbers}: the reference with TF32
    products and with half of each batch, each against the float32
    reference, from the cell's weights on the cell's batches."""
    import shutil

    import numpy as np

    from benchmark.harness import compare, dataset, manifest
    from benchmark.reference import batches

    cell = bench.workload(workload)
    config, traffic = bench.config(cell["config"]), bench.traffic(cell["traffic"])
    model, reference = config["model"], manifest.reference(config["family"])
    B, L, K = traffic["batch"], traffic["max_length"], traffic["steps_per_dispatch"]
    workdir = os.path.join(tempfile.gettempdir(), f"seqrec_calibrate_{os.getpid()}")
    try:
        data = dataset.generate(workdir, traffic, model["n_items"], seed)
        pop = np.bincount(data.train_items, minlength=data.n_items)

        def readings(**variant):
            return reference.train_steps(
                model, reference.make_weights(model, data.n_items, seed, device),
                batches.steps(data.train_items, data.train_offsets, seed, B, K, L), pop, 3, **variant)

        ref = readings()
        return {name: compare.numbers(readings(**variant), ref)
                for name, variant in (("control", {"matmul_tf32": True}), ("half_batch", {"half_batch": True}))}
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="*", default=[])
    parser.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = parser.parse_args()

    from benchmark.harness import compare, manifest
    from benchmark.runners import train

    bench = manifest.Manifest(ROOT)
    lower = {k: [] for k in compare.NAMES}
    upper = {"control": {k: [] for k in compare.NAMES}, "half_batch": {k: [] for k in compare.NAMES}}
    for seed in args.seeds:
        out = train.run(bench, args.workload, seed, 1.0, False, time.perf_counter())
        values = compare.numbers(out["readings"]["port"], out["readings"]["reference"])
        for k in compare.NAMES:
            lower[k].append(values[k])
        print(json.dumps({"side": "port", "seed": seed, **values}), flush=True)
    for seed in args.control_seeds:
        for name, values in stand_in_readings(bench, args.workload, seed).items():
            for k in compare.NAMES:
                upper[name][k].append(values[k])
            print(json.dumps({"side": name, "seed": seed, **values}), flush=True)
    print(json.dumps({
        "workload": args.workload,
        "lower": {k: max(v) for k, v in lower.items() if v},
        "upper": {name: {k: min(v) for k, v in d.items() if v} for name, d in upper.items()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
