"""``BENCHMARK.json`` and the files it names.

Everything that belongs to one configuration, one traffic mix, one cell or
one per-layer metric is a file of its own, found by the name that
``BENCHMARK.json`` gives it:

- ``configs/<config>.json``: the configuration (its ``file`` entry);
- ``traffic/<traffic>.json``: the traffic mix, whose ``kind`` names the
  runner ``runners/<kind>.py``;
- ``limits/<workload>.json``: the limits of the cell's output check;
- ``metrics/<metric>.py``: the reader of a per-layer metric;
- a configuration's ``family`` names ``programs/<family>.py`` (how the port
  is driven) and ``reference/<family>.py`` (the plain reference).

A later change adds a cell, a configuration or a metric by adding such
files and entries; no file here needs an edit for it.
"""

from __future__ import annotations

import importlib
import json
import os
import re

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)

NAME_RE = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT_RE = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class Manifest:
    """The parsed ``BENCHMARK.json`` with lookups by name."""

    def __init__(self, root: str = ROOT):
        self.root = root
        self.data = _read_json(os.path.join(root, "BENCHMARK.json"))
        self.configs = {c["name"]: c for c in self.data["configs"]}
        self.workloads = {w["name"]: w for w in self.data["workloads"]}

    def workload(self, name: str) -> dict:
        if name not in self.workloads:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(self.workloads)})")
        return self.workloads[name]

    def config(self, name: str) -> dict:
        """The configuration file of entry ``name``."""
        return _read_json(os.path.join(self.root, self.configs[name]["file"]))

    def traffic(self, name: str) -> dict:
        return _read_json(os.path.join(BENCH_DIR, "traffic", name + ".json"))

    def limits(self, workload: str) -> dict:
        return _read_json(os.path.join(BENCH_DIR, "limits", workload + ".json"))

    def metrics_of(self, workload: str, kind: str) -> list[dict]:
        """The ``end_to_end`` or ``per_layer`` metrics that ``workload``
        reports: those without a ``workloads`` key, and those that list it."""
        return [m for m in self.data[kind] if workload in m.get("workloads", [workload])]


def runner(kind: str):
    return importlib.import_module(f"benchmark.runners.{kind}")


def program(family: str):
    return importlib.import_module(f"benchmark.programs.{family}")


def reference(family: str):
    return importlib.import_module(f"benchmark.reference.{family}")


def metric_reader(name: str):
    return importlib.import_module(f"benchmark.metrics.{name}")
