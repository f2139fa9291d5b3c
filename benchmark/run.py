"""Run one cell of the benchmark of ``seqrec_tpu_torch`` once, on the card.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout. The cell, its configuration, traffic and
limits are found by name from ``BENCHMARK.json`` (``harness/manifest.py``).
The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number of the output check beside
its limit, also printed as the last lines of standard error. The run
exits non-zero without a result when no card is present, and when JAX or
the JAX package is loaded once the window has closed.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _finite(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else None


def power_limit() -> str:
    if shutil.which("nvidia-smi") is None:
        return "not read"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=30)
    return out.stdout.strip() or "not read"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", required=True, type=int)
    parser.add_argument("--seconds", required=True, type=float)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    from benchmark.harness import hygiene, manifest

    bench = manifest.Manifest(ROOT)
    cell = bench.workload(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    seed = args.seed % 2**63
    traffic = bench.traffic(cell["traffic"])
    out = manifest.runner(traffic["kind"]).run(bench, args.workload, seed, args.seconds, bool(args.trace), T0)

    found = hygiene.forbidden_loaded()
    if found:
        print("forbidden modules loaded: " + ", ".join(found), file=sys.stderr)
        return 3

    if args.trace:
        metrics = {m["name"]: {"value": out["per_layer"][m["name"]], "unit": m["unit"]}
                   for m in bench.metrics_of(args.workload, "per_layer") if m["name"] in out["per_layer"]}
    else:
        metrics = {m["name"]: {"value": out["end_to_end"][m["name"]], "unit": m["unit"]}
                   for m in bench.metrics_of(args.workload, "end_to_end")}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell["chips"],
              "memory_peak_bytes": out["memory_peak_bytes"]}
    if args.trace:
        device.update(busy_s=out["busy_s"], window_s=out["trace_window_s"])
    result = {"correct": bool(out["correct"]), "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": device}
    if args.trace:
        result["breakdown"] = out["breakdown"]
    checks = {k: {"value": _finite(c["value"]), "limit": c["limit"]} for k, c in out["checks"].items()}
    result["checks"] = checks

    readings = {side: {k: v for k, v in r.items() if k != "grads"} for side, r in out["readings"].items()}
    print(json.dumps({"window_s": out["window_s"], "dispatches": out["dispatches"], "dispatch_ms": out["dispatch_ms"],
                      "window_cpu_s": out["window_cpu_s"], "build_s": out["build_s"], "dispatch_ms_by_second": out["dispatch_ms_by_second"],
                      "launches": out["launches"], "power": power_limit(), "readings": readings}))
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
