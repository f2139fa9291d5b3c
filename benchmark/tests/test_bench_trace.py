"""The trace reduction and the per-layer readers on a synthetic trace, and
the entry point's refusals without a card."""

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import pytest

from benchmark.harness import counts, manifest
from benchmark.harness.trace import Trace


def _x(cat, name, tid, ts, dur, corr=None):
    ev = {"ph": "X", "cat": cat, "name": name, "tid": tid, "ts": ts, "dur": dur}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


def _launch(tid, ts, corr, kernel, start, dur, stream=7):
    return [_x("cuda_runtime", "cudaLaunchKernel", tid, ts, 1, corr), _x("kernel", kernel, stream, start, dur, corr)]


def synthetic():
    """A dispatch on thread 1 (forward entries, Adam) whose backward runs on
    thread 2, times in microseconds."""
    ev = [_x("user_annotation", "bench::dispatch", 1, 0, 100), _x("cpu_op", "_GatherSum", 1, 5, 5),
          _x("cpu_op", "_GRUScanTrain", 1, 12, 6), _x("cpu_op", "aten::mm", 1, 13, 2),
          _x("cpu_op", "_StreamingCCE", 1, 20, 5), _x("user_annotation", "bench::adam", 1, 60, 30),
          _x("cpu_op", "_StreamingCCEBackward", 2, 30, 5), _x("cpu_op", "_GRUScanTrainBackward", 2, 40, 5),
          _x("cpu_op", "_GatherSumBackward", 2, 50, 5)]
    ev += _launch(1, 6, 1, "gather_fwd", 110, 10)
    ev += _launch(1, 14, 2, "scan_fwd", 120, 20)  # under aten::mm inside the forward entry
    ev += _launch(1, 21, 3, "stats", 140, 30)
    ev += _launch(2, 31, 4, "grads", 170, 40)
    ev += _launch(2, 41, 5, "scan_bwd", 210, 50)
    ev += _launch(2, 51, 6, "gather_bwd", 260, 10)
    ev += _launch(1, 61, 7, "adam", 300, 20)
    ev += _launch(1, 95, 8, "other", 330, 10)  # inside the dispatch, no entry
    ev.append({"ph": "X", "cat": "gpu_memset", "name": "Memset", "tid": 7, "ts": 325, "dur": 2})
    ev.append({"ph": "i", "cat": "marker", "name": "ignored", "ts": 1})
    return Trace(ev)


def test_device_time_by_entry_whatever_the_kernel():
    tr = synthetic()
    us = 1e-6
    assert tr.device_seconds_under(["_GRUScanTrain", "_GRUScanTrainBackward"]) == pytest.approx(70 * us)
    assert tr.device_seconds_under(["_StreamingCCE", "_StreamingCCEBackward"]) == pytest.approx(70 * us)
    assert tr.device_seconds_under(["_GatherSum", "_GatherSumBackward"]) == pytest.approx(20 * us)
    assert tr.device_seconds_under(["bench::adam"]) == pytest.approx(20 * us)
    assert tr.device_seconds_under(["no such entry"]) == 0
    assert tr.count("bench::adam") == 1


def test_busy_idle_and_gaps():
    tr = synthetic()
    us = 1e-6
    busy = tr.busy(100 * us, 340 * us)
    assert sum(e - s for s, e in busy) == pytest.approx((160 + 20 + 2 + 10) * us)
    gaps = dict(tr.idle_gaps(100 * us, 340 * us, tr.launch_threads()))
    assert sum(gaps.values()) == pytest.approx(48 * us)
    assert set(gaps) == {"no host range open"}  # the host ranges all closed before the device ran
    ops = dict(tr.top_device_ops(100 * us, 340 * us))
    assert ops["scan_bwd"] == pytest.approx(50 * us) and len(ops) == 9


def test_readers_on_the_synthetic_trace():
    tr = synthetic()
    table = counts.peaks("NVIDIA H100 80GB HBM3")
    stats = [{"valid": 100, "unique_rows": 30}]
    run = SimpleNamespace(cell=dict(cell="GRU", H=8, N=50, B=4, L=30, K=1), precision="float32", peaks=table,
                          trace=tr, window=(100e-6, 340e-6), busy_s=222e-6, step_stats=stats,
                          dispatch_s=[0.01] * 19 + [0.02], train_seq_per_s=1000.0)
    read = {m: manifest.metric_reader(m).read(run) for m in
            ("k1_roofline", "k5_roofline", "k2_roofline", "g1_roofline", "adam_ms_per_step",
             "device_idle_pct", "dispatch_ms_p95", "step_mfu_pct")}
    least = counts.recurrence("GRU", 8, 4, 100).least_seconds(table, "float32")
    assert read["k1_roofline"] == pytest.approx(100 * least / 70e-6)
    assert read["k5_roofline"] is None  # a GRU cell has no K5
    assert read["k2_roofline"] == pytest.approx(100 * counts.cce_head(4, 8, 50).least_seconds(table, "float32") / 70e-6)
    assert read["g1_roofline"] == pytest.approx(100 * counts.gather_sum(24, 100, 30).least_seconds(table, "float32") / 20e-6)
    assert read["adam_ms_per_step"] == pytest.approx(0.02)
    assert read["device_idle_pct"] == pytest.approx(100 * (1 - 222 / 240))
    assert read["dispatch_ms_p95"] == pytest.approx(10.0)
    assert read["step_mfu_pct"] == pytest.approx(100 * counts.model_flops_per_sequence("GRU", 100 / 4, 8, 50) * 1000 / 495e12)
    empty = SimpleNamespace(**{**vars(run), "trace": Trace([]), "dispatch_s": [0.01]})
    for m in ("k1_roofline", "k2_roofline", "g1_roofline", "adam_ms_per_step", "dispatch_ms_p95"):
        assert manifest.metric_reader(m).read(empty) is None  # nothing to read: no metric, never 0


def _run(args, cwd):
    return subprocess.run([sys.executable, "benchmark/run.py", *args], cwd=cwd, capture_output=True, text=True,
                          timeout=120, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})


def _has_result(stdout):
    for line in stdout.strip().splitlines()[-1:]:
        try:
            return "correct" in json.loads(line)
        except ValueError:
            return False
    return False


def test_refuses_without_a_card():
    p = _run(["--workload", next(iter(manifest.Manifest().workloads)), "--seed", "2147483999", "--seconds", "1"], manifest.ROOT)
    assert p.returncode != 0 and not _has_result(p.stdout)


def test_refuses_in_a_directory_of_only_the_benchmark(tmp_path):
    import shutil

    shutil.copy(os.path.join(manifest.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(manifest.BENCH_DIR, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(["--workload", next(iter(manifest.Manifest().workloads)), "--seed", "1", "--seconds", "1"], tmp_path)
    assert p.returncode != 0 and not _has_result(p.stdout)
