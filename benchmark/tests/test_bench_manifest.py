"""Hygiene of the benchmark's sources and the contract of BENCHMARK.json:
names, units, keys, and every file a name points to."""

import ast
import importlib
import json
import os

import pytest

from benchmark.harness import compare, hygiene, manifest

BENCH = manifest.BENCH_DIR
ROOT = manifest.ROOT
DATA = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))


def _sources(sub=""):
    top = os.path.join(BENCH, sub)
    for dirpath, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _imported(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module" and node.args:
            arg = node.args[0]
            if isinstance(arg, ast.Constant):
                yield arg.value
            elif isinstance(arg, ast.JoinedStr) and arg.values and isinstance(arg.values[0], ast.Constant):
                yield arg.values[0].value


@pytest.mark.parametrize("path", sorted(_sources()), ids=lambda p: os.path.relpath(p, BENCH))
def test_no_module_imports_jax_or_the_jax_package(path):
    bad = [m for m in _imported(path) if hygiene.top_level(m) in hygiene.FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", sorted(_sources("reference")), ids=os.path.basename)
def test_reference_imports_nothing_of_the_port(path):
    bad = [m for m in _imported(path) if hygiene.top_level(m) == "seqrec_tpu_torch"]
    assert not bad, f"{path} imports {bad}"


def test_forbidden_names_compare_whole_top_level_names():
    loaded = ["seqrec_tpu_torch", "seqrec_tpu_torch.ops.core", "jaxtyping", "numpy", "seqrec_tpu.models", "jax",
              "flax.linen", "jaxlib.xla_client"]
    assert hygiene.forbidden_loaded(loaded) == ["flax.linen", "jax", "jaxlib.xla_client", "seqrec_tpu.models"]


def test_top_level_keys():
    assert set(DATA) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert DATA["command"] == ["python3", "benchmark/run.py"]
    assert DATA["paths"] == ["benchmark"]
    assert isinstance(DATA["run_seconds"], int) and 1 <= DATA["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def _one_line(text, limit=200):
    return isinstance(text, str) and 1 <= len(text) <= limit and "\n" not in text and "\t" not in text


def test_names_and_units():
    names = [c["name"] for c in DATA["configs"]] + [w["name"] for w in DATA["workloads"]]
    metrics = DATA["end_to_end"] + DATA["per_layer"]
    names += [m["name"] for m in metrics] + [w["traffic"] for w in DATA["workloads"]]
    names += [k for c in DATA["configs"] for k in c["reduced"]]
    for n in names:
        assert manifest.NAME_RE.fullmatch(n), n
    for kind in ("configs", "workloads"):
        assert len({x["name"] for x in DATA[kind]}) == len(DATA[kind])
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert manifest.UNIT_RE.fullmatch(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")


def test_entries_have_the_contract_keys():
    for c in DATA["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _one_line(c["source"]) and _one_line(c["why"]) and len(c["reduced"]) <= 16
    for w in DATA["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert _one_line(w["why"])
    pairs = [(w["config"], w["traffic"]) for w in DATA["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for m in DATA["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in {m["name"] for m in DATA["end_to_end"]}
    for m in DATA["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _one_line(m["layer"])
        assert m["moves"] in {e["name"] for e in DATA["end_to_end"]}


def test_every_config_is_used_and_every_cell_reports_enough():
    bench = manifest.Manifest(ROOT)
    assert {w["config"] for w in DATA["workloads"]} == {c["name"] for c in DATA["configs"]}
    for w in DATA["workloads"]:
        e2e = {m["name"] for m in bench.metrics_of(w["name"], "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        per_layer = bench.metrics_of(w["name"], "per_layer")
        assert per_layer and all(m["moves"] in e2e for m in per_layer)
    for m in DATA["per_layer"] + DATA["end_to_end"]:
        assert set(m.get("workloads", [])) <= set(bench.workloads)


@pytest.mark.parametrize("cell", [w["name"] for w in DATA["workloads"]])
def test_every_file_of_a_cell_is_found_by_name(cell):
    bench = manifest.Manifest(ROOT)
    w = bench.workload(cell)
    entry = bench.configs[w["config"]]
    assert entry["file"].startswith("benchmark/configs/")
    config = bench.config(w["config"])
    assert config["name"] == w["config"] and config["reduced"] == entry["reduced"]
    traffic = bench.traffic(w["traffic"])
    assert manifest.runner(traffic["kind"]).run
    assert manifest.program(config["family"]).build
    assert manifest.reference(config["family"]).train_steps
    assert set(bench.limits(cell)) == set(compare.NAMES)
    for m in bench.metrics_of(cell, "per_layer"):
        assert callable(manifest.metric_reader(m["name"]).read)


def test_config_flags_agree_with_the_model_keys():
    """The port's flags of each configuration state what its ``model`` keys
    (the reference's) say."""
    import seqrec_tpu_torch.utils.command_parser as parse

    bench = manifest.Manifest(ROOT)
    for name in bench.configs:
        config = bench.config(name)
        model = config["model"]
        args = parse.command_parser(parse.predictor_command_parser, argv=config["flags"])
        assert (args.method, args.loss, args.recurrent_layer_type) == ("RNN", model["loss"], model["cell"])
        assert [int(x) for x in args.r_l.split("-")] == [model["hidden"]] * model["layers"]
        opt = model["optimizer"]
        assert (args.update_manager, args.u_l, args.u_b1, args.u_b2) == (
            opt["name"], opt["learning_rate"], opt["beta1"], opt["beta2"])
        assert args.diversity_bias == model["diversity_bias"] and args.gradient_clipping == model["grad_clip"]
        assert not args.bf16 and config["precision"] == "float32" and config["tf32"] is False


def test_paths_hold_only_the_benchmark():
    for p in DATA["paths"]:
        assert p == "benchmark" and not p.endswith("_torch")
    for c in DATA["configs"]:
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
    for word in DATA["command"]:
        assert not word.startswith("/") and ".." not in word


def test_no_metric_reader_module_is_unlisted():
    listed = {m["name"] for m in DATA["per_layer"]}
    modules = {f[:-3] for f in os.listdir(os.path.join(BENCH, "metrics")) if f.endswith(".py") and f != "__init__.py"}
    assert modules == listed
    for name in modules:
        importlib.import_module(f"benchmark.metrics.{name}")
