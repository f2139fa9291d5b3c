"""Training cells: the port's training loop on a dataset drawn from the seed.

Set-up builds one predictor (``programs/<family>.py``), loads the weights
the benchmark made from the seed, and runs a first ``train`` call of
``WARMUP_DISPATCHES`` dispatches: it builds or loads the kernels, fills
the allocator, and its first ``CHECK_STEPS`` optimizer steps are the ones
the output check compares with the plain reference. The same object then
runs the timed ``train`` call. The window starts when that call's first
dispatch returns and ends at ``torch.cuda.synchronize()`` after ``train``
returns; the benchmark counts dispatches by wrapping the instance's
``train_function_stacked`` and ends the window by raising
``StopIteration`` from the wrap once ``seconds`` have passed, which
``train`` takes as the end of its data. ``progress`` lies beyond the
window, so no validation pass or checkpoint falls inside it.

With ``trace``, two more ``train`` calls of the traffic's
``trace_dispatches`` dispatches each run under ``torch.profiler``: the
first records device activity alone, for the busy and idle share (from its
first kernel to its last device operation) and the device operations that
took most time; the second records the host's ops too, with each dispatch
and each Adam update inside a ``record_function`` range of the
benchmark's (``bench::dispatch``, ``bench::adam``), for the device time
under each layer's entries and what the host did in the idle gaps. The
per-layer metrics read these traces, the timed window's dispatch times and
its rate.

After the window (and the trace) the peak memory is read, the port's state
is freed and the reference runs the same first steps from the same weights
on the batches it works out itself.
"""

from __future__ import annotations

import gc
import math
import os
import shutil
import tempfile
import time
from types import SimpleNamespace

import numpy as np

from benchmark.harness import compare, counts, dataset, manifest
from benchmark.harness.trace import Trace
from benchmark.reference import batches as ref_batches

WARMUP_DISPATCHES = 3
CHECK_STEPS = 3
NEVER = 10**18  # a progress interval no run reaches: no validation, no checkpoint


class DispatchClock:
    """Wraps the predictor's ``train_function_stacked``: the host time of
    each return, the last cost; ends a window after ``seconds`` (from the
    first return) by raising ``StopIteration``; with ``annotate`` each
    dispatch runs inside a ``bench::dispatch`` range."""

    def __init__(self, predictor):
        self.fn = predictor.train_function_stacked
        predictor.train_function_stacked = self
        self.reset()

    def reset(self, seconds: float = math.inf, annotate: bool = False) -> None:
        self.seconds, self.annotate = seconds, annotate
        self.returns, self.last_cost = [], None

    def __call__(self, payload):
        if self.returns and time.perf_counter() - self.returns[0] >= self.seconds:
            raise StopIteration
        if self.annotate:
            import torch

            with torch.profiler.record_function("bench::dispatch"):
                cost = self.fn(payload)
        else:
            cost = self.fn(payload)
        self.returns.append(time.perf_counter())
        self.last_cost = cost
        return cost


class BuildClock:
    """Seconds spent in the port's kernel builds: wraps ``ops/_build.py:build``,
    which ``load`` calls at each kernel's first use. In a checkout's first
    run that is ``nvcc``; after it, a look for the built library. Reported
    as ``build_s`` on an earlier line; ``setup_s`` includes it."""

    def __init__(self):
        from seqrec_tpu_torch.ops import _build

        self.module, self.fn, self.seconds = _build, _build.build, 0.0
        _build.build = self

    def __call__(self, names):
        t = time.perf_counter()
        try:
            return self.fn(names)
        finally:
            self.seconds += time.perf_counter() - t

    def remove(self) -> None:
        self.module.build = self.fn


def _annotated(fn, name: str):
    import torch

    def wrapped(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)

    return wrapped


def _profile(predictor, handler, clock, n_dispatches: int, K: int, train_kw: dict, path: str,
             host: bool) -> Trace:
    """A ``train`` call of ``n_dispatches`` under ``torch.profiler``: device
    activity only, or with ``host`` also the host's ops and the benchmark's
    ranges around each dispatch and Adam update."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if host else [ProfilerActivity.CUDA]
    if host:
        predictor.updater.step = _annotated(predictor.updater.step, "bench::adam")
    clock.reset(annotate=host)
    try:
        with profile(activities=activities) as prof:
            predictor.train(handler, max_iter=n_dispatches * K, **train_kw)
            torch.cuda.synchronize()
        prof.export_chrome_trace(path)
    finally:
        if host:
            del predictor.updater.step
    trace = Trace.from_file(path)
    os.remove(path)
    return trace


def run(bench: manifest.Manifest, workload: str, seed: int, seconds: float, trace: bool, t0: float,
        device: str = "cuda", plant=None) -> dict:
    """One run of a training cell; ``plant(predictor)``, where given, breaks
    the timed path after set-up (the tests of the output check use it)."""
    import torch

    cell = bench.workload(workload)
    config, traffic, limits = bench.config(cell["config"]), bench.traffic(cell["traffic"]), bench.limits(workload)
    model, family = config["model"], config["family"]
    program, reference = manifest.program(family), manifest.reference(family)
    B, L, K = traffic["batch"], traffic["max_length"], traffic["steps_per_dispatch"]
    # the configurations state float32 with TF32 off
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    on_card = device.startswith("cuda")

    workdir = os.path.join(tempfile.gettempdir(), f"seqrec_bench_{os.getpid()}")
    builds = BuildClock()
    try:
        data = dataset.generate(workdir, traffic, model["n_items"], seed)
        predictor, handler = program.build(config, traffic, data.dirname, seed, device)
        weights = reference.make_weights(model, data.n_items, seed, device)
        program.load_weights(predictor, weights)
        capture = program.Capture(predictor, weights, CHECK_STEPS)
        del weights
        if plant is not None:
            plant(predictor)
        clock = DispatchClock(predictor)
        train_kw = dict(progress=NEVER, autosave="None", save_dir=data.dirname + "models/")

        predictor.train(handler, max_iter=WARMUP_DISPATCHES * K, **train_kw)
        if on_card:
            torch.cuda.synchronize()
        clock.reset(seconds=seconds)
        cpu0 = time.process_time()
        predictor.train(handler, **train_kw)
        if on_card:
            torch.cuda.synchronize()
        t_end = time.perf_counter()
        cpu_s = time.process_time() - cpu0
        returns = clock.returns
        window_s = t_end - returns[0]
        steps = len(returns) * K
        last_cost = float(clock.last_cost)
        e2e = {
            "train_seq_per_s": (len(returns) - 1) * K * B / window_s,
            "setup_s": returns[0] - t0,
        }
        gaps = np.diff(returns) * 1e3
        sec = np.floor(np.asarray(returns[1:]) - returns[0]).astype(int)
        out = {"attempted": steps, "failed": 0 if math.isfinite(last_cost) else steps, "window_s": window_s,
               "build_s": builds.seconds,
               "dispatches": len(returns), "end_to_end": e2e, "window_cpu_s": cpu_s,
               "dispatch_ms": {q: float(np.percentile(gaps, p)) for q, p in (("p5", 5), ("p50", 50), ("p95", 95))}
               if len(gaps) else {},
               # mean dispatch ms in each second of the window: where a run's rate shifts
               "dispatch_ms_by_second": [float(np.mean(gaps[sec == s])) for s in np.unique(sec)]
               if len(gaps) else []}

        if trace:
            # device activity alone for the busy share: recording every host
            # op slows the host enough to idle the card in host-bound cells
            n_trace = traffic["trace_dispatches"]
            path = os.path.join(workdir, "trace.json")
            dev = _profile(predictor, handler, clock, n_trace, K, train_kw, path, host=False)
            first = min(dev.kernel_starts)  # the first dispatch's first kernel: the pipeline's start-up is left out
            last = max(e for s, e, *_ in dev.device)
            busy = sum(e - s for s, e in dev.busy(first, last))
            tr = _profile(predictor, handler, clock, n_trace, K, train_kw, path, host=True)
            t0_host = min(lst[0][1] for lst in tr.ranges["bench::dispatch"].values())
            t1_host = max(e for s, e, *_ in tr.device)
            ctx = SimpleNamespace(
                cell=dict(cell=model["cell"], H=model["hidden"], N=data.n_items, B=B, L=L, K=K),
                precision=config["precision"],
                peaks=counts.peaks(torch.cuda.get_device_name(0)),
                trace=tr, window=(first, last), busy_s=busy,
                step_stats=ref_batches.step_stats(data.train_items, data.train_offsets, seed, B, K, L, n_trace * K),
                dispatch_s=list(np.diff(returns)), train_seq_per_s=e2e["train_seq_per_s"],
            )
            per_layer = {}
            for m in bench.metrics_of(workload, "per_layer"):
                value = manifest.metric_reader(m["name"]).read(ctx)
                if value is not None:
                    per_layer[m["name"]] = value
            out.update(per_layer=per_layer, busy_s=busy, trace_window_s=last - first, breakdown={
                "device_ops": dev.top_device_ops(first, last),
                "idle_gaps": tr.idle_gaps(t0_host, t1_host, tr.launch_threads()),
            })

        out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device) if on_card else 0
        out["launches"] = launch_counters()
        ours = capture.readings()
        capture.remove()
        del predictor, handler, capture, clock
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()

        ref = reference.train_steps(
            model, reference.make_weights(model, data.n_items, seed, device),
            ref_batches.steps(data.train_items, data.train_offsets, seed, B, K, L),
            np.bincount(data.train_items, minlength=data.n_items), CHECK_STEPS,
        )
        values = compare.numbers(ours, ref)
        out["correct"], out["checks"] = compare.judge(values, limits)
        out["readings"] = {"port": ours, "reference": ref}
        return out
    finally:
        builds.remove()
        shutil.rmtree(workdir, ignore_errors=True)


def launch_counters() -> dict:
    """The port's launch counters (``<op>.launches`` and the like), nonzero
    ones: a record that the window's kernels ran. Not a metric."""
    import sys

    found = {}
    for name, mod in list(sys.modules.items()):
        if not name.startswith("seqrec_tpu_torch.ops.") or mod is None:
            continue
        for attr, fn in vars(mod).items():
            for key in ("launches", "cluster_launches"):
                value = getattr(fn, key, None) if callable(fn) else None
                if isinstance(value, int) and value:
                    found[f"{attr}.{key}"] = value
    return dict(sorted(found.items()))

