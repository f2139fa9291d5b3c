"""The training loop's spans (``seqrec_tpu_torch/utils/tracing.py``) on the
CPU: a tiny ``RNNOneHot`` (GRU-16, CCE, Adam, B 8, L 10) trained for three
dispatches at ``--spd 2`` through the stacked pipeline, once under
``torch.profiler`` and once without:

- every span of the loop, with its count: one ``dispatch`` and
  ``wait_payload`` a dispatch, one ``step``, ``expand``, ``forward``,
  ``backward`` and ``update`` a step, an ``assemble`` and a ``transfer``
  for every payload the batcher made (it runs ahead), one ``validate``;
- the assembly, the transfer and the main thread's spans each on a thread
  of their own; each child inside its parent; a payload's assembly, its
  transfer and its dispatch in that order;
- the main thread's spans in the exported trace as ``user_annotation``
  events, onto which ``clock_offset`` maps nine in ten of the buffer's
  within 50 us;
- without a profiler, no span is recorded and ``record_function`` is never
  entered; the costs and parameters of both runs are equal bit for bit;
- a span nested in one of its own name is part of it; the buffer keeps the
  newest ``MAX_SPANS``.
"""

import collections
import json
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import seqrec_tpu_torch.utils.command_parser as parse
from seqrec_tpu_torch.data import DataHandler
from seqrec_tpu_torch.data.synthetic import make_dataset
from seqrec_tpu_torch.utils import tracing

ARGV = ["-m", "RNN", "--loss", "CCE", "--r_l", "16", "--max_length", "10", "-b", "8", "--u_m", "adam"]
K, DISPATCHES = 2, 3
MAIN = ["seqrec::wait_payload", "seqrec::dispatch", "seqrec::step", "seqrec::expand", "seqrec::forward",
        "seqrec::backward", "seqrec::update", "seqrec::validate", "seqrec::save"]
WORKERS = ["seqrec::assemble", "seqrec::transfer"]


def _train(dataset_dir, save_dir):
    """(costs a dispatch, parameters) of a fresh predictor's ``train`` call."""
    args = parse.command_parser(parse.predictor_command_parser, argv=ARGV)
    args.device = "cpu"
    model = parse.get_predictor(args)
    handler = DataHandler(dataset_dir)
    model.prepare_model(handler)
    model.steps_per_dispatch = K
    costs, dispatch = [], model.train_function_stacked

    def recorded(payload):
        cost = dispatch(payload)
        costs.append(cost.clone())
        return cost

    model.train_function_stacked = recorded
    model.train(handler, max_iter=DISPATCHES * K, progress=DISPATCHES * K, autosave="All", save_dir=save_dir)
    return torch.stack(costs).numpy(), {k: v.detach().clone().numpy() for k, v in model.net.state_dict().items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("tracing")
    d = make_dataset(str(root / "ds"), n_users=120, n_items=60, min_len=8, max_len=24, seed=3)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("warm-up"):
            pass  # a profile's first range opens 0.05-1 ms late
        traced = _train(d, d + "models/traced/")
    recorded = tracing.spans()
    path = str(root / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]

    entered = []

    class Counting:
        def __init__(self, name):
            entered.append(name)

    plain_start = time.perf_counter_ns()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tracing, "record_function", Counting)
        plain = _train(d, d + "models/plain/")
    return dict(traced=traced, plain=plain, spans=recorded, events=events, entered=entered,
                after_plain=tracing.spans(), plain_start=plain_start, main=threading.get_native_id())


def _by_name(spans):
    out = collections.defaultdict(list)
    for s in spans:
        out[s.name].append(s)
    return out


@pytest.mark.parametrize("name, count", [
    ("seqrec::dispatch", DISPATCHES), ("seqrec::wait_payload", DISPATCHES), ("seqrec::step", DISPATCHES * K),
    ("seqrec::expand", DISPATCHES * K), ("seqrec::forward", DISPATCHES * K), ("seqrec::backward", DISPATCHES * K),
    ("seqrec::update", DISPATCHES * K), ("seqrec::validate", 1),
])
def test_each_main_thread_span_is_recorded_once_a_dispatch_or_step(runs, name, count):
    assert len(_by_name(runs["spans"])[name]) == count


@pytest.mark.parametrize("name", WORKERS + ["seqrec::save"])
def test_the_batcher_and_the_saves_record_a_span_for_each_item(runs, name):
    at_least = 1 if name == "seqrec::save" else DISPATCHES
    assert len(_by_name(runs["spans"])[name]) >= at_least


@pytest.mark.parametrize("name", MAIN)
def test_main_thread_spans_sit_on_the_calling_thread(runs, name):
    assert {s.thread for s in _by_name(runs["spans"])[name]} == {runs["main"]}


@pytest.mark.parametrize("name", WORKERS)
def test_each_worker_span_sits_on_a_thread_of_its_own(runs, name):
    by = _by_name(runs["spans"])
    threads = {s.thread for s in by[name]}
    others = {s.thread for s in runs["spans"] if s.name != name}
    assert len(threads) == 1 and not threads & others


@pytest.mark.parametrize("child, parent", [
    ("seqrec::step", "seqrec::dispatch"), ("seqrec::expand", "seqrec::step"), ("seqrec::forward", "seqrec::step"),
    ("seqrec::backward", "seqrec::step"), ("seqrec::update", "seqrec::step"),
])
def test_each_child_lies_inside_its_parent(runs, child, parent):
    by_id = {s.id: s for s in runs["spans"]}
    for s in _by_name(runs["spans"])[child]:
        p = by_id[s.parent]
        assert p.name == parent and p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns


def test_a_payloads_spans_run_assemble_transfer_dispatch_in_order(runs):
    by = _by_name(runs["spans"])
    first = {name: {s.payload: s for s in by[name]} for name in ("seqrec::assemble", "seqrec::transfer")}
    assert sorted(s.payload for s in by["seqrec::dispatch"]) == list(range(DISPATCHES))
    for d in by["seqrec::dispatch"]:
        a, t = first["seqrec::assemble"][d.payload], first["seqrec::transfer"][d.payload]
        assert a.end_ns <= t.start_ns and t.end_ns <= d.start_ns
        steps = [s for s in by["seqrec::step"] if s.parent == d.id]
        assert len(steps) == K and {s.payload for s in steps} == {d.payload}


def test_main_thread_spans_are_in_the_trace_on_its_clock(runs):
    offset = tracing.clock_offset(runs["events"], runs["spans"])
    assert offset is not None
    annotations = collections.defaultdict(list)
    for ev in runs["events"]:
        if ev.get("ph") == "X" and ev.get("cat") == "user_annotation":
            annotations[ev["name"]].append(float(ev["ts"]))
    by = _by_name(runs["spans"])
    gaps = []
    for name in MAIN:
        ts = sorted(annotations[name])
        assert len(ts) == len(by[name]), name
        gaps += [m - t for m, t in zip(sorted(s.start_ns / 1e3 + offset for s in by[name]), ts)]
    # a range takes its start somewhere inside its opening call (10 us, to
    # hundreds when the thread waits for the interpreter lock there)
    assert np.mean(np.abs(gaps) <= 50.0) >= 0.9, sorted(np.abs(gaps))
    assert not set(WORKERS) & set(annotations)  # the worker threads are not the profiler's


def test_without_a_profiler_nothing_is_recorded_and_nothing_changes(runs):
    assert runs["entered"] == []
    # the buffer still holds the traced call's spans (a worker's last one
    # may land after that call returned), none of the plain call's
    assert runs["after_plain"][: len(runs["spans"])] == runs["spans"]
    assert all(s.start_ns < runs["plain_start"] for s in runs["after_plain"])
    assert tracing.span("seqrec::step") is tracing.span("seqrec::dispatch")
    (costs_a, params_a), (costs_b, params_b) = runs["traced"], runs["plain"]
    np.testing.assert_array_equal(costs_a, costs_b)
    assert params_a.keys() == params_b.keys()
    for key in params_a:
        np.testing.assert_array_equal(params_a[key], params_b[key], err_msg=key)


@tracing.records
def _nested_and_many(n):
    with tracing.span("a", 7):
        with tracing.span("a"), tracing.span("b"):
            pass
    for i in range(n):
        with tracing.span("c", i):
            pass


def test_a_span_inside_its_own_name_merges_and_the_buffer_is_bounded(monkeypatch):
    monkeypatch.setattr(tracing, "MAX_SPANS", 5)
    with profile(activities=[ProfilerActivity.CPU]):
        _nested_and_many(10)
    got = tracing.spans()
    assert [(s.name, s.payload) for s in got] == [("c", i) for i in range(5, 10)]
    with profile(activities=[ProfilerActivity.CPU]):
        _nested_and_many(0)
    a, b = sorted(tracing.spans(), key=lambda s: s.name)
    assert (a.name, a.payload, b.name, b.parent) == ("a", 7, "b", a.id)
