"""The readers of the port's spans (``harness/spans.py`` and the eight
metrics on it) on a hand-built trace and span buffer: two dispatches of one
step each on thread 1, whose backward kernels thread 2 (the autograd
engine's) launches and during which thread 3 (the transfer thread) copies;
times in microseconds."""

import collections
from types import SimpleNamespace

import pytest

from benchmark.harness import manifest, spans
from benchmark.harness.trace import Trace
from benchmark.tests.test_bench_trace import _launch, _x

SPAN_METRICS = ("payload_wait_ms_per_dispatch", "assemble_ms_per_payload", "transfer_ms_per_payload",
                "expand_ms_per_step", "forward_ms_per_step", "backward_ms_per_step", "update_ms_per_step",
                "launches_per_step")
Span = collections.namedtuple("Span", "id name thread start_ns end_ns parent payload")


def _dispatch(t, corr):
    """A wait, then a dispatch at ``t`` with one step's phases; a kernel of
    each phase (backward's from thread 2) and a copy from thread 3 during the
    forward and during the backward."""
    ev = [_x("user_annotation", "seqrec::dispatch", 1, t, 100), _x("user_annotation", "seqrec::step", 1, t + 2, 96),
          _x("user_annotation", "seqrec::expand", 1, t + 3, 7), _x("user_annotation", "seqrec::forward", 1, t + 10, 20),
          _x("user_annotation", "seqrec::backward", 1, t + 30, 40), _x("user_annotation", "seqrec::update", 1, t + 70, 25),
          _x("cpu_op", "autograd::engine::evaluate_function: MulBackward0", 2, t + 35, 25)]
    ev += _launch(1, t + 5, corr, "expand", 1000 + t, 5)
    ev += _launch(1, t + 15, corr + 1, "forward", 1010 + t, 10)
    ev += _launch(2, t + 40, corr + 2, "backward", 1020 + t, 20)
    ev += _launch(1, t + 80, corr + 3, "adam", 1040 + t, 3)
    for k, at in enumerate((t + 20, t + 50)):
        ev += [_x("cuda_runtime", "cudaMemcpyAsync", 3, at, 1, corr + 4 + k),
               _x("gpu_memcpy", "Memcpy HtoD", 8, 1050 + t + 10 * k, 7, corr + 4 + k)]
    return ev


def hand_built():
    ev = [_x("user_annotation", "seqrec::wait_payload", 1, 0, 50)]  # the pipeline's fill
    ev += _dispatch(50, 10)
    ev += [_x("user_annotation", "seqrec::wait_payload", 1, 150, 4)]
    ev += _launch(1, 151, 30, "between", 1300, 4)  # inside no step
    ev += _dispatch(154, 20)
    return Trace(ev)


BUFFER = [Span(0, "seqrec::assemble", 11, 0, 3_000_000, None, 0), Span(1, "seqrec::transfer", 12, 3_000_000,
          4_000_000, None, 0), Span(2, "seqrec::assemble", 11, 3_000_000, 8_000_000, None, 1),
          Span(3, "seqrec::transfer", 12, 8_000_000, 10_000_000, None, 1)]


def test_launches_of_the_autograd_thread_count_and_the_transfer_threads_do_not():
    tr = hand_built()
    assert sorted(k for _, _, k, _ in spans.launched_during(tr, "seqrec::backward")) == ["backward"] * 2
    assert sorted(k for _, _, k, _ in spans.launched_during(tr, "seqrec::forward")) == ["forward"] * 2
    assert len(spans.launched_during(tr, spans.STEP)) == 8  # neither the copies nor the launch between steps
    assert spans.launched_during(tr, "no such span") == []


def test_durations_and_means():
    tr = hand_built()
    assert spans.durations(tr, "seqrec::wait_payload") == pytest.approx([50e-6, 4e-6])
    assert spans.mean_ms(BUFFER, "seqrec::assemble") == pytest.approx(4.0)
    assert spans.mean_ms(BUFFER, "seqrec::nothing") is None and spans.mean_ms(None, "seqrec::assemble") is None


def test_span_readers(monkeypatch):
    monkeypatch.setattr(spans, "program_spans", lambda: BUFFER)
    run = SimpleNamespace(trace=hand_built())
    read = {m: manifest.metric_reader(m).read(run) for m in SPAN_METRICS}
    assert read == pytest.approx({
        "payload_wait_ms_per_dispatch": 0.004,  # the fill left out
        "assemble_ms_per_payload": 4.0, "transfer_ms_per_payload": 1.5,
        "expand_ms_per_step": 0.005, "forward_ms_per_step": 0.010, "backward_ms_per_step": 0.020,
        "update_ms_per_step": 0.003, "launches_per_step": 4.0,
    })


@pytest.mark.parametrize("metric", SPAN_METRICS)
def test_each_reader_is_none_without_its_spans(monkeypatch, metric):
    """A port without spans (the parent of the change that added them)."""
    monkeypatch.setattr(spans, "program_spans", lambda: None)
    assert manifest.metric_reader(metric).read(SimpleNamespace(trace=Trace([]))) is None
