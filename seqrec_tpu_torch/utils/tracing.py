"""Spans of the training loop: where its host threads spend their time.

``span(name, payload=None)`` is a context manager that records the span's
name, the native id of its thread, its start and end (``perf_counter_ns``),
its parent (the innermost span open on the same thread) and the id of
the payload it works on: the assembly, transfer, dispatch and steps of one
K-step payload share that id. A span opened directly inside an open span
of the same name on the same thread is part of it and records nothing.

Recording is on for a whole ``RNNBase.train`` call (``records``) when a
profiler is active on the calling thread as the call starts
(``torch.autograd._profiler_enabled()``): ``--profile`` and the
benchmark's traced calls. Otherwise ``span`` returns one shared no-op
object after a single global check. While recording, the calling
thread's spans also open a ``torch.profiler.record_function`` range of
the same name, which puts them on the device trace's clock; the spans of
the worker threads (the batcher's assembly and transfer) go to the
in-memory buffer alone, since a profiler does not record threads started
inside it. ``spans()`` returns the last recorded call's spans, at most
``MAX_SPANS`` of them (the newest); ``clock_offset`` maps their clock onto
a Chrome trace's, and ``add_to_chrome_trace`` writes the worker spans into
one.
"""

from __future__ import annotations

import collections
import functools
import itertools
import json
import statistics
import threading
import time

import torch

MAX_SPANS = 1 << 16
record_function = torch.profiler.record_function

Span = collections.namedtuple("Span", "id name thread start_ns end_ns parent payload")

_on = False  # the one check a span makes when recording is off
_main = None  # threading.get_ident() of the recording call's thread
_main_native = None  # its native id, as a Chrome trace's tid names it
_buffer: collections.deque = collections.deque(maxlen=MAX_SPANS)
_ids = itertools.count()
_local = threading.local()  # .stack: the spans open on this thread; .native: its native id


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "payload", "id", "parent", "start", "range", "buffer", "stack", "thread")

    def __init__(self, name, payload):
        self.name, self.payload = name, payload

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            # get_native_id is a system call (6 us on some hosts): once a thread
            stack = _local.stack = []
            _local.native = threading.get_native_id()
        if stack and stack[-1].name == self.name:
            self.stack = None  # part of the enclosing span
            return self
        self.stack, self.buffer, self.thread = stack, _buffer, _local.native
        self.parent = stack[-1].id if stack else None
        self.id = next(_ids)
        self.range = None
        stack.append(self)
        self.start = time.perf_counter_ns()
        if threading.get_ident() == _main:
            # the range takes its own time somewhere inside its opening call
            # (10-150 us): the span starts at that call's midpoint
            self.range = record_function(self.name)
            self.range.__enter__()
            self.start = (self.start + time.perf_counter_ns()) // 2
        return self

    def __exit__(self, *exc):
        if self.stack is None:
            return False
        end = time.perf_counter_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
            end = (end + time.perf_counter_ns()) // 2
        self.stack.pop()
        self.buffer.append(Span(self.id, self.name, self.thread, self.start, end, self.parent, self.payload))
        return False


def span(name: str, payload=None):
    if not _on:
        return _NO_SPAN
    return _Span(name, payload)


def records(fn):
    """Decorator: ``fn``'s calls record spans if a profiler is active on the
    calling thread as they start (and no call records already)."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        global _on, _main, _main_native, _buffer
        if _on or not torch.autograd._profiler_enabled():
            return fn(*args, **kwargs)
        _buffer = collections.deque(maxlen=MAX_SPANS)
        _main, _main_native = threading.get_ident(), threading.get_native_id()
        _on = True
        try:
            return fn(*args, **kwargs)
        finally:
            _on = False

    return wrapped


def spans() -> list:
    """The last recorded call's spans, in the order they ended."""
    return list(_buffer)


def clock_offset(trace_events, recorded=None):
    """Microseconds to add to ``start_ns / 1e3`` to land on a Chrome trace's
    ``ts``: the median difference over the spans that appear in both, the
    ``user_annotation`` events of the same name paired in order from the
    newest (the buffer may have dropped the oldest). None if none pair."""
    by_name = collections.defaultdict(list)
    for ev in trace_events:
        if ev.get("ph") == "X" and ev.get("cat") == "user_annotation":
            by_name[ev["name"]].append(float(ev["ts"]))
    mine = collections.defaultdict(list)
    for s in spans() if recorded is None else recorded:
        if s.name in by_name:
            mine[s.name].append(s.start_ns / 1e3)
    diffs = []
    for name, starts in mine.items():
        theirs = sorted(by_name[name])
        n = min(len(starts), len(theirs))
        diffs += [t - s for s, t in zip(sorted(starts)[-n:], theirs[-n:])]
    return statistics.median(diffs) if diffs else None


def add_to_chrome_trace(path: str) -> int:
    """Write the last recorded call's worker-thread spans into the Chrome
    trace at ``path`` as ``user_annotation`` events on their own threads,
    on the trace's clock; returns how many were written."""
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    offset = clock_offset(events)
    if offset is None:
        return 0
    pid = next((ev["pid"] for ev in events if ev.get("cat") == "user_annotation"), 0)
    added = [
        {"ph": "X", "cat": "user_annotation", "name": s.name, "pid": pid, "tid": s.thread,
         "ts": s.start_ns / 1e3 + offset, "dur": (s.end_ns - s.start_ns) / 1e3,
         "args": {"span": s.id, "parent": s.parent, "payload": s.payload}}
        for s in spans() if s.thread != _main_native
    ]
    events.extend(added)
    with open(path, "w") as f:
        json.dump(data, f)
    return len(added)
