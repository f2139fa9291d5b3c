#!/usr/bin/env python3
"""Chip check of the PyTorch/CUDA port (``seqrec_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. build: compile every CUDA kernel of the port from ``seqrec_tpu_torch/csrc``
   (one ``nvcc`` per source, all at once) and print the build time, the
   compiler's register/shared-memory report and the card's name and power
   limit.
2. kernels: hold each kernel against its plain PyTorch version on the card,
   at the shapes of the serving path and at one large shape, and time the
   kernel, the plain version and a PyTorch library yardstick beside the
   kernel's bound: per call with CUDA events (median of at least 20 runs
   after warm-up; host launch time included) and as device time from
   torch.profiler (mean of 20 calls).
3. main path: write an ML-1M-scale synthetic dataset, save a GRU-50 CCE
   model from seed 0, run the port's test CLI on the card with every launch
   counter at 0, check that every kernel was launched, run the CLI again on
   the CPU and check that both give the same top-10 lists; then time a
   serving pass of 4096 users at eval chunks of 64 and 512.

Any failed check raises, and the script exits non-zero. Without a CUDA
device it exits non-zero before printing any result. The last lines are
the card's name and power limit, the kernels summary, and
``{"ok": true, "device": {...}}``. Builds and the dataset go under
``build/`` of the checkout; TF32 is off throughout.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")

# H100 SXM peaks (NVIDIA data sheet): f32 on the CUDA cores, HBM3 bandwidth
F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
KERNELS = {
    "gru_scan": ("seqrec_tpu_torch/csrc/gru_scan.cu", "seqrec_tpu/ops/pallas_rnn.py:88"),
    "fused_score_topk": ("seqrec_tpu_torch/csrc/score_topk.cu", "seqrec_tpu/ops/pallas_topk.py:57"),
}
SERVING_ARGV = [
    "-m", "RNN", "--loss", "CCE", "--r_t", "GRU", "--r_l", "50", "--max_length", "30",
    "-b", "16", "--u_m", "adam", "--u_l", "0.001", "-i", "1",
]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    """Median time of ``fn`` on the card in ms (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_events(fn, reps: int = 1) -> dict:
    """Device time in ms of each kernel or copy name over ``reps`` calls of
    ``fn``, from torch.profiler's CUDA trace."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {
        e.key: e.self_device_time_total / 1e3
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA
    }


def device_ms(fn, reps: int = 20) -> float:
    """Device time of one call of ``fn`` in ms (profiler; no launch gaps)."""
    fn()
    return sum(device_events(fn, reps).values()) / reps


def bound_ms(flops: float, n_bytes: float):
    """Least time for the work on the card and what sets it."""
    t_ops, t_bytes = flops / F32_FLOPS * 1e3, n_bytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# ----------------------------------------------------------------------
# K3: GRU scan
# ----------------------------------------------------------------------
def gru_inputs(B, L, H, seed, device):
    import torch

    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, L + 1, size=B)
    arrays = {
        "x_pre": rng.normal(0.0, 0.5, size=(B, L, 3 * H)),
        "mask": (np.arange(L)[None, :] < lengths[:, None]),
        "w_hid": rng.normal(0.0, 0.1, size=(H, 3 * H)),
        "h0": rng.normal(0.0, 0.1, size=(B, H)),
    }
    return {k: torch.tensor(v, dtype=torch.float32, device=device) for k, v in arrays.items()}


def cudnn_gru(x_pre, mask, w_hid, h0):
    """torch.nn.GRU (cuDNN) computing the same final state: identity input
    weights (its input is x_pre), zero biases, the update-gate columns
    negated (torch's z is 1 - u), inputs packed by the prefix lengths.
    Returns a call that runs it; it also does a [B*L, 3H] x [3H, 3H]
    input product the kernel does not."""
    import torch

    H = h0.shape[1]
    gru = torch.nn.GRU(3 * H, H, batch_first=True).to(x_pre.device)
    sign = torch.ones(3 * H, device=x_pre.device)
    sign[H : 2 * H] = -1.0
    with torch.no_grad():
        gru.weight_ih_l0.copy_(torch.diag(sign))
        gru.weight_hh_l0.copy_((w_hid * sign).t())
        gru.bias_ih_l0.zero_()
        gru.bias_hh_l0.zero_()
    lengths = mask.sum(1).long().cpu()
    packed = torch.nn.utils.rnn.pack_padded_sequence(x_pre, lengths, batch_first=True, enforce_sorted=False)
    h0 = h0[None]  # nn.GRU permutes the state to and from the packed order itself

    def run():
        with torch.no_grad():
            return gru(packed, h0)[1][0]

    return run


def check_gru(B, L, H, seed):
    import torch

    from seqrec_tpu_torch.ops.rnn_scan import gru_scan, gru_scan_plain

    a = gru_inputs(B, L, H, seed, "cuda")
    args = (a["x_pre"], a["mask"], a["w_hid"], a["h0"])
    got, want = gru_scan(*args), gru_scan_plain(*args)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    if not torch.allclose(got, want, rtol=1e-5, atol=1e-5):
        raise AssertionError(f"gru_scan disagrees with its plain version at {(B, L, H)}: max abs err {err}")
    library = cudnn_gru(*args)
    library_err = (library() - want).abs().max().item()
    flops = 2 * B * L * H * 3 * H
    n_bytes = 4 * (B * L * 3 * H + B * L + 3 * H * H + 2 * B * H)
    bound, bound_by = bound_ms(flops, n_bytes)
    return {
        "kernel": "gru_scan", "shape": {"B": B, "L": L, "H": H}, "max_abs_err": err,
        "tolerance": "rtol 1e-5, atol 1e-5",
        "kernel_ms": time_ms(lambda: gru_scan(*args)),
        "plain_ms": time_ms(lambda: gru_scan_plain(*args)),
        "library_ms": time_ms(library),
        "kernel_device_ms": device_ms(lambda: gru_scan(*args)),
        "plain_device_ms": device_ms(lambda: gru_scan_plain(*args)),
        "library_device_ms": device_ms(library),
        "library": "torch.nn.GRU (cuDNN), packed; includes a [B*L,3H]x[3H,3H] input product",
        "library_max_abs_err": library_err,
        "bound_ms": bound, "bound_by": bound_by,
    }


# ----------------------------------------------------------------------
# K4: fused score + seen mask + top-k
# ----------------------------------------------------------------------
def topk_inputs(B, H, N, S, seed, device, seen_all_rows=0):
    import torch

    rng = np.random.default_rng(seed)
    limit = np.sqrt(6.0 / (H + N))
    seen = rng.integers(0, N, size=(B, S))
    seen_mask = np.arange(S)[None, :] < rng.integers(1, S + 1, size=(B, 1))
    seen[:seen_all_rows] = np.arange(S)[None, :] % N  # every item seen
    seen_mask[:seen_all_rows] = True
    return {
        "h": torch.tensor(rng.uniform(-1, 1, size=(B, H)), dtype=torch.float32, device=device),
        "w_out": torch.tensor(rng.uniform(-limit, limit, size=(H, N)), dtype=torch.float32, device=device),
        "b_out": torch.tensor(rng.normal(0.0, 0.1, size=N), dtype=torch.float32, device=device),
        "seen_ids": torch.tensor(seen, dtype=torch.int32, device=device),
        "seen_mask": torch.tensor(seen_mask, dtype=torch.float32, device=device),
    }


def torch_topk(h, w_out, b_out, seen_ids, seen_mask, k):
    """The library yardstick: h @ W + b, -inf scattered at the seen ids,
    torch.topk."""
    import torch

    scores = h @ w_out + b_out
    neg = torch.where(seen_mask > 0, float("-inf"), 0.0)
    return torch.topk(scores.scatter_add_(1, seen_ids.long(), neg), k)


def compare_topk(got_v, got_i, plain_v, plain_i, next_v, k):
    """Values: rtol 1e-5 (atol 1e-6). Ids: equal, as sets, on every row whose
    k-th and (k+1)-th plain scores differ by more than 1e-4 * max|score|;
    in order wherever neighbouring plain values differ by that much."""
    import torch

    finite = torch.isfinite(plain_v)
    if not torch.equal(finite, torch.isfinite(got_v)) or not torch.allclose(
        got_v[finite], plain_v[finite], rtol=1e-5, atol=1e-6
    ):
        raise AssertionError("fused_score_topk values disagree with the plain version")
    gap = 1e-4 * plain_v[finite].abs().max().item() if finite.any() else 0.0
    clean = (plain_v[:, k - 1] - next_v) > gap
    clean |= ~torch.isfinite(plain_v[:, k - 1])
    same_set = (got_i.sort(1).values == plain_i.sort(1).values).all(1)
    bad = clean & ~same_set
    if bad.any():
        raise AssertionError(f"fused_score_topk ids disagree on {int(bad.sum())} rows")
    apart = torch.ones_like(plain_v, dtype=torch.bool)
    diffs = (plain_v[:, :-1] - plain_v[:, 1:]) > gap
    apart[:, 1:] &= diffs
    apart[:, :-1] &= diffs
    apart &= clean[:, None]
    if not torch.equal(got_i[apart], plain_i[apart]):
        raise AssertionError("fused_score_topk orders ids differently from the plain version")
    return (got_v[finite] - plain_v[finite]).abs().max().item(), int(clean.sum())


def check_topk(B, H, N, S, k, seed, seen_all_rows=0, timed=True, with_seen=True):
    import torch

    from seqrec_tpu_torch.ops.score_topk import fused_score_topk, fused_score_topk_plain

    a = topk_inputs(B, H, N, S, seed, "cuda", seen_all_rows)
    args = (a["h"], a["w_out"], a["b_out"]) + ((a["seen_ids"], a["seen_mask"]) if with_seen else (None, None))
    got_v, got_i = fused_score_topk(*args, k=k)
    plain_v, plain_i = fused_score_topk_plain(*args, k=k + 1)
    torch.cuda.synchronize()
    err, n_clean = compare_topk(got_v, got_i, plain_v[:, :k], plain_i[:, :k], plain_v[:, k], k)
    out = {
        "kernel": "fused_score_topk", "shape": {"B": B, "H": H, "N": N, "S": S if with_seen else 0, "k": k},
        "max_abs_err": err, "rows_with_clean_gap": n_clean, "rows": B,
        "tolerance": "values rtol 1e-5 atol 1e-6; ids equal where the k/k+1 gap > 1e-4 max|score|",
    }
    if timed:
        flops = 2 * B * H * N
        n_bytes = 4 * (B * H + H * N + N + 2 * B * S + 2 * B * k)
        bound, bound_by = bound_ms(flops, n_bytes)
        reps = 20 if N > 100_000 else 30
        out.update(
            kernel_ms=time_ms(lambda: fused_score_topk(*args, k=k), reps=reps),
            plain_ms=time_ms(lambda: fused_score_topk_plain(*args, k=k), reps=reps),
            library_ms=time_ms(lambda: torch_topk(*args, k), reps=reps),
            kernel_device_ms=device_ms(lambda: fused_score_topk(*args, k=k)),
            plain_device_ms=device_ms(lambda: fused_score_topk_plain(*args, k=k)),
            library_device_ms=device_ms(lambda: torch_topk(*args, k)),
            library="h @ W + b, -inf scatter_add at the seen ids, torch.topk",
            bound_ms=bound, bound_by=bound_by,
        )
    return out


# ----------------------------------------------------------------------
# main path: the test CLI on an ML-1M-scale dataset
# ----------------------------------------------------------------------
def serving_predictor(device):
    from seqrec_tpu_torch.models.recurrent import RecurrentLayers
    from seqrec_tpu_torch.models.rnn_one_hot import RNNOneHot
    from seqrec_tpu_torch.models.updates import Adam

    return RNNOneHot(
        recurrent_layer=RecurrentLayers(layer_type="GRU", layers=[50]),
        updater=Adam(learning_rate=0.001), max_length=30, batch_size=16, seed=0, device=device,
    )


def profile_pass(model, inputs, chunk, wall_s):
    """Device time of one serving pass from torch.profiler: its kernels and
    copies, their share of ``wall_s`` (the same pass timed without the
    profiler, whose own cost would swamp the pass), and the five largest."""
    model.eval_batch_size = chunk
    device = device_events(lambda: model._batched_recommendations(inputs))
    device_ms = sum(device.values())
    return {
        "device_ms": device_ms, "device_busy_share": device_ms / (wall_s * 1e3),
        "top_kernels_ms": dict(sorted(device.items(), key=lambda kv: -kv[1])[:5]),
    }


def main_path(card):
    import torch

    from seqrec_tpu_torch.cli import test as test_cli
    from seqrec_tpu_torch.data import DataHandler
    from seqrec_tpu_torch.data.synthetic import make_dataset
    from seqrec_tpu_torch.models.base import pytree_save
    from seqrec_tpu_torch.ops.rnn_scan import gru_scan
    from seqrec_tpu_torch.ops.score_topk import fused_score_topk

    t0 = time.perf_counter()
    # scripts/baseline_run.sh's dataset: 6040 users, 3706 items
    ds_dir = make_dataset(
        os.path.join(WORK, "ml1m_synth"), n_users=6040, n_items=3706, min_len=20, max_len=310,
        markov_strength=0.45, n_val_users=100, n_test_users=100, seed=7,
    )
    dataset = DataHandler(ds_dir)
    model = serving_predictor("cpu")
    model.prepare_model(dataset)
    model_file = ds_dir + "models/" + model._get_model_filename(1)
    pytree_save(model_file, {"params": model._init_params()})
    setup_s = time.perf_counter() - t0

    argv = ["-d", ds_dir] + SERVING_ARGV
    gru_scan.launches = fused_score_topk.launches = 0
    t0 = time.perf_counter()
    ev_gpu = test_cli.main(argv)
    torch.cuda.synchronize()
    gpu_s = time.perf_counter() - t0
    launches = {"gru_scan": gru_scan.launches, "fused_score_topk": fused_score_topk.launches}
    missing = [name for name, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"the serving path launched no {', '.join(missing)} kernel")
    ev_cpu = test_cli.main(argv + ["--device", "cpu"])
    recs_gpu = [pred for _, pred in ev_gpu.instances]
    recs_cpu = [pred for _, pred in ev_cpu.instances]
    if recs_gpu != recs_cpu:
        n_diff = sum(a != b for a, b in zip(recs_gpu, recs_cpu))
        raise AssertionError(f"top-10 lists differ between cuda and cpu on {n_diff} users")
    metrics = {m: ev_gpu.metrics[m]() for m in ("sps", "recall", "item_coverage", "user_coverage")}
    emit({
        "phase": "main_path", "dataset": {"n_users": dataset.n_users, "n_items": dataset.n_items},
        "setup_s": setup_s, "cli_cuda_s": gpu_s, "launches": launches,
        "test_users": len(recs_gpu), "same_top10_as_cpu": True, "metrics@10": metrics,
    })

    # serving pass: 4096 half-split training sequences
    model = serving_predictor("cuda")
    model.prepare_model(dataset)
    model.load(model_file)
    model.set_dataset(dataset)
    inputs = []
    for seq, _, _ in model._iter_test_instances(dataset.training_set(epochs=1)):
        inputs.append(seq)
        if len(inputs) == 4096:
            break
    passes, recs = {}, {}
    for chunk in (64, 512):
        model.eval_batch_size = chunk
        model._batched_recommendations(inputs[:chunk])  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        staged = model._stage_eval_inputs(inputs)
        t1 = time.perf_counter()
        recs[chunk] = model._topk_from_staged(staged, k=10)
        t2 = time.perf_counter()
        passes[chunk] = {
            "users_per_s": len(inputs) / (t2 - t0), "wall_s": t2 - t0,
            "encode_upload_s": t1 - t0, "topk_s": t2 - t1,
        }
    if not np.array_equal(recs[64], recs[512]):
        raise AssertionError("eval chunks of 64 and 512 give different top-10 lists")
    emit({
        "phase": "serving_pass", "users": len(inputs), "card": card,
        "passes": {f"chunk{c}": p for c, p in passes.items()},
        "timed": "host clock; topk_s = GRU scan + fused top-k + copy back of every chunk",
        "profile_chunk64": profile_pass(model, inputs, 64, passes[64]["wall_s"]),
    })
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, ROOT)
    from seqrec_tpu_torch.ops import _build

    t0 = time.perf_counter()
    logs = _build.build([os.path.basename(src)[: -len(".cu")] for src, _ in KERNELS.values()])
    build_s = time.perf_counter() - t0
    card = card_line()
    report = {
        name: [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        for name, log in logs.items()
    }
    emit({"phase": "build", "seconds": build_s, "ptxas": report, "card": card})

    small = {
        "gru_scan": check_gru(64, 30, 50, seed=1),
        "fused_score_topk": check_topk(64, 50, 3706, 30, 10, seed=2),
    }
    for res in small.values():
        emit({"phase": "kernels", "at": "serving shape", **res})
    emit({"phase": "kernels", "at": "large shape", **check_gru(512, 30, 256, seed=3)})
    emit({"phase": "kernels", "at": "large shape", **check_topk(512, 256, 200_000, 30, 10, seed=4)})
    edge = [
        check_topk(6, 50, 25, 30, 10, seed=5, seen_all_rows=2, timed=False),
        check_topk(64, 50, 3706, 30, 10, seed=6, timed=False, with_seen=False),
        check_topk(33, 64, 1000, 5, 64, seed=7, timed=False),
    ]
    emit({"phase": "kernels", "at": "edge cases", "checks": [e["shape"] for e in edge], "ok": True})

    launches = main_path(card)

    summary = []
    for name, (source, replaces) in KERNELS.items():
        res = small[name]
        summary.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": res["max_abs_err"],
            "ms": res["kernel_ms"], "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
            "bound_by": res["bound_by"], "library_ms": res["library_ms"],
        })
    print(card_line(), flush=True)
    emit({"kernels": summary})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
