#!/usr/bin/env python3
"""Steady step times of the cells that run G1's backward, the times of the
passes that run K3, or the training loop's steps, for two checkouts in one
run on one CUDA GPU, in turns.

    python3 -m seqrec_tpu_torch.scripts.step_pairs --before DIR [--rounds N] [--cells steps|serving|loop]

DIR is the root of another checkout of the repository (for example a
``git archive`` of the parent commit unpacked under ``build/``). Each round
runs the checkouts as before, this one, this one, before, each in a process
of its own started from its root, so that each measures its own kernels
and wrappers with its own ``chip_smoke.py`` helpers (each checkout builds
its kernels into its own ``build/`` once):

- ``flagship``: GRU-50 CCE at B16 (``chip_smoke.steady_state``, 300 steps);
- ``featured``: the same with ``--rf --mf --uf`` (F = 14 ids a step);
- ``ltm``: LTM's CBOW steps (200 steps of 2,048 positions, host clock to a
  synchronize);
- ``bprmf`` and ``fism``: the factorization family's device-sampled
  dispatches (``chip_smoke.mf_steady``);

or, with ``--cells serving``, the passes that run K3 (GRU models from
seed 0 with random weights; ms a pass, the median of 7 after a warm-up):

- ``serving64`` and ``serving512``: GRU-50 serving of 4096 users of the
  ML-1M-scale dataset at eval chunks of 64 and 512 (the chunks' K3, K4
  and copies back, their inputs encoded and uploaded once, outside the
  time; ``users_per_s`` counts the whole pass with its encoding;
  ``device_ms`` is the profiler's device time of those chunks);
- ``serving_gru256``: GRU-256 serving of 4096 users of the 50k-item
  catalog at chunks of 512, timed the same way;
- ``validation_gru128``: GRU-128's validation pass on that catalog at
  chunks of 1024 (``chip_smoke.steady_state``'s, after 3 steps).

or, with ``--cells loop``, the training loop itself (``model.train``, no
validation; the loop of each checkout: the synchronous one before the
prefetch thread, the prefetch thread and ``--spd`` after it), from seed 0:

- ``flagship_spd1`` / ``_spd8``, ``featured_spd1`` / ``_spd8`` (1,000
  steps each) and ``bpr_b64_spd1`` / ``_spd8`` (``chip_smoke.HEADS_BPR``,
  600 steps) on the ML-1M-scale dataset; ``gru128_spd1`` / ``_spd4``
  (GRU-128 at B=1024 on the 50k-item catalog, 120 steps): ms a step and
  sequences/s over a timed ``train`` call after a warm-up one (host clock
  to a synchronize: thread start, the index store's upload and the
  queue's fill included), the profiler's device ms a step over a shorter
  call and its share of the step (``device_busy_share``). A checkout that
  refuses ``--spd`` > 1 prints no such cell;
- ``load_native`` / ``load_python``: the ML-1M-scale training sequences
  parsed into a ``SequenceStore`` by the native parser and by the Python
  tokenizer (the median of 3; a checkout without the native parser prints
  the tokenizer only).

Prints one JSON line per cell and checkout in each turn, with the card's
name and power limit, and last the medians of each cell's step time by
checkout. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# run in each checkout's root: its own chip_smoke.py and package
CELLS = r"""
import json, sys, time
import numpy as np
import torch
sys.path.insert(0, ".")
import chip_smoke as cs
from seqrec_tpu_torch.ops import _build

torch.backends.cuda.matmul.allow_tf32 = False
_build.build(sorted({src.split("/")[-1][:-3] for _, src, _ in cs.KERNELS.values()}))
card = cs.card_line()


def emit(cell, step_ms, unit, rate, extra):
    print(json.dumps({"cell": cell, "step_ms": step_ms, unit: rate, **extra, "card": card}), flush=True)


for cell, argv, ds in (("flagship", cs.FLAGSHIP, cs.ml1m_dataset()), ("featured", cs.FEATURED, cs.featured_dataset())):
    st = cs.steady_state(argv, ds, steps=300, warmup=20, profile_steps=20, card=card)
    emit(cell, st["step_ms"], "sequences_per_s", st["sequences_per_s"],
         {"device_ms_per_step": st["device_ms_per_step"], "device_busy_share": st["device_busy_share"]})
pp_dir, _ = cs.ml1m_pp_dataset()
model = cs.ltm_model(pp_dir, "cuda")
cs.ltm_steps(model, 20)
torch.cuda.synchronize()
t0 = time.perf_counter()
cs.ltm_steps(model, 200)
torch.cuda.synchronize()
step_s = (time.perf_counter() - t0) / 200
emit("ltm", step_s * 1e3, "steps_per_s", 1.0 / step_s, {})
for cell, flags, dispatches in (("bprmf", cs.MF_RUNS["bprmf"], 20), ("fism", cs.MF_RUNS["fism_bpr"], 4)):
    st = cs.mf_steady(pp_dir, flags, dispatches, card)
    emit(cell, st["chunk_ms"], "samples_per_s", st["samples_per_s"],
         {"device_ms_per_chunk": st["device_ms_per_chunk"], "device_busy_share": st["device_busy_share"]})
"""

# the same preamble, then the passes that run K3
SERVING_CELLS = CELLS[: CELLS.index("for cell, argv, ds in")] + r"""
import statistics
from seqrec_tpu_torch.data import DataHandler
from seqrec_tpu_torch.models.recurrent import RecurrentLayers
from seqrec_tpu_torch.models.rnn_one_hot import RNNOneHot
from seqrec_tpu_torch.models.updates import Adam


def device_ms(fn, reps=5):
    # profiler device time a call: each name's mean time an event times its events a call, at least one
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total / 1e3 / e.count * max(1, round(e.count / reps))
               for e in prof.key_averages() if e.device_type == DeviceType.CUDA)


def median_s(fn, n=7):
    fn()
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


for cell, ds_dir, width, chunk in (("serving64", cs.ml1m_dataset(), 50, 64), ("serving512", cs.ml1m_dataset(), 50, 512),
                                   ("serving_gru256", cs.catalog50k_dataset(), 256, 512)):
    dataset = DataHandler(ds_dir)
    model = RNNOneHot(recurrent_layer=RecurrentLayers(layer_type="GRU", layers=[width]),
                      updater=Adam(learning_rate=0.001), max_length=30, batch_size=16, seed=0, device="cuda")
    model.prepare_model(dataset)
    model.set_dataset(dataset)
    model.params_from_numpy(model._init_params())
    model.eval_batch_size = chunk
    inputs = []
    for seq, _, _ in model._iter_test_instances(dataset.training_set(epochs=1)):
        inputs.append(seq)
        if len(inputs) == 4096:
            break
    staged = model._stage_eval_inputs(inputs)
    pass_s = median_s(lambda: model._topk_from_staged(staged, k=10))
    whole_s = median_s(lambda: model._batched_recommendations(inputs))
    emit(cell, pass_s * 1e3, "users_per_s", len(inputs) / whole_s,
         {"whole_pass_ms": whole_s * 1e3, "device_ms": device_ms(lambda: model._topk_from_staged(staged, k=10))})
st = cs.steady_state(cs.LARGE, cs.catalog50k_dataset(), steps=3, warmup=1, profile_steps=1, card=card, validate=True)
emit("validation_gru128", st["validation_pass"]["wall_s"] * 1e3, "eval_chunk", st["validation_pass"]["eval_chunk"],
     {"device_ms": st["validation_pass"]["device_ms"]})
"""


# the same preamble, then the training loop at --spd 1 and K
LOOP_CELLS = CELLS[: CELLS.index("for cell, argv, ds in")] + r"""
import contextlib
import os
import statistics
import seqrec_tpu_torch.utils.command_parser as parse
from seqrec_tpu_torch.data import DataHandler


def loop_model(argv, ds_dir, spd):
    args = parse.command_parser(parse.predictor_command_parser, argv=argv)
    args.device = "cuda"
    model = parse.get_predictor(args)
    dataset = DataHandler(ds_dir)
    model.prepare_model(dataset)
    model.steps_per_dispatch = spd
    return model, dataset


def run(model, dataset, steps):
    with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
        model.train(dataset, max_iter=steps, progress=10**9, autosave="None")


for cell, argv, ds, steps, profile_steps, spds in (
        ("flagship", cs.FLAGSHIP, cs.ml1m_dataset(), 1000, 160, (1, 8)),
        ("featured", cs.FEATURED, cs.featured_dataset(), 1000, 160, (1, 8)),
        ("bpr_b64", cs.HEADS_BPR, cs.ml1m_dataset(), 600, 160, (1, 8)),
        ("gru128", cs.LARGE, cs.catalog50k_dataset(), 120, 24, (1, 4))):
    for spd in spds:
        model, dataset = loop_model(argv, ds, spd)
        try:
            run(model, dataset, 4 * spd)  # warm-up: the first steps, the store's upload
        except NotImplementedError:
            continue  # this checkout refuses --spd > 1
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(model, dataset, steps)
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / steps
        device_ms = sum(cs.device_events(lambda: run(model, dataset, profile_steps)).values()) / profile_steps
        emit(f"{cell}_spd{spd}", step_s * 1e3, "sequences_per_s", model.batch_size / step_s,
             {"device_ms_per_step": device_ms, "device_busy_share": device_ms / (step_s * 1e3), "steps_timed": steps})
from seqrec_tpu_torch.data import dataset as data_module
fn = os.path.join(cs.ml1m_dataset(), "data", "train_set_sequences")
try:
    from seqrec_tpu_torch.data import native
except ImportError:
    native = None
for how in ("native", "python") if native is not None else ("python",):
    if native is not None:
        native._lib, native._lib_failed = None, how == "python"
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        store = data_module.SequenceStore.from_file(fn)
        times.append(time.perf_counter() - t0)
    emit("load_" + how, statistics.median(times) * 1e3, "interactions", len(store.items), {})
"""


def _medians(by_cell: dict) -> dict:
    return {cell: {name: statistics.median(v) for name, v in by.items()} for cell, by in by_cell.items()}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--before", required=True, help="root of the other checkout")
    parser.add_argument("--rounds", type=int, default=1, help="rounds of before, this, this, before")
    parser.add_argument("--cells", choices=("steps", "serving", "loop"), default="steps",
                        help="G1's training cells, the passes that run K3, or the training loop")
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("step_pairs: no CUDA device is available", file=sys.stderr)
        return 1
    trees = {"before": os.path.abspath(args.before), "this": HERE}
    steps, device = {}, {}
    for r in range(args.rounds):
        for name in ("before", "this", "this", "before"):
            code = {"steps": CELLS, "serving": SERVING_CELLS, "loop": LOOP_CELLS}[args.cells]
            out = subprocess.run([sys.executable, "-c", code], cwd=trees[name], capture_output=True, text=True)
            if out.returncode:
                sys.stderr.write(out.stderr[-4000:])
                return out.returncode
            for line in out.stdout.splitlines():
                if line.startswith('{"cell"'):
                    res = json.loads(line)
                    print(json.dumps({"round": r, "checkout": name, **res}), flush=True)
                    steps.setdefault(res["cell"], {}).setdefault(name, []).append(res["step_ms"])
                    if "device_ms" in res:
                        device.setdefault(res["cell"], {}).setdefault(name, []).append(res["device_ms"])
    print(json.dumps({"median_step_ms": _medians(steps), "median_device_ms": _medians(device)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
