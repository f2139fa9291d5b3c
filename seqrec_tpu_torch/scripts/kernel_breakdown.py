#!/usr/bin/env python3
"""Where the time of the port's redesigned kernels goes, on one CUDA GPU.

    python3 -m seqrec_tpu_torch.scripts.kernel_breakdown [--parts ...] [--before CSRC]

Builds the committed sources as they are and as variants with one part
cut out (text patches of the sources, compiled into
``build/kernel_breakdown/``), and times each at the shape where the
kernel runs on a path of ``chip_smoke.py``:

- ``k3``: K3's cluster kernel at B=512, L=30, H=256 with its plan's tile:
  without the per-step product, with each new h stored only into the
  CTA's own buffer (no distributed-shared-memory stores), without the
  wait at the cluster barrier;
- ``k2``: K2's gradients at B=1024, H=128, N=50,000: without the
  tensor-core products, without the copies into shared memory, without
  both; and the committed kernels against their plain versions at H=256;
- ``k2_stats``: K2's stats at B=1024/H=128/N=50,000 and B=16/H=50/
  N=3,706: without the tensor-core products, without the online (m, s)
  update (exps and rescales);
- ``k4``: K4 at B=64/H=50/N=3,706 and B=512/H=256 at N=49,999 and
  200,000: without the products, without the epilogue (seen-id mask,
  ballots and inserts), without the seen-id mask alone, without the list
  inserts alone, without the merge
  kernel, with a merge kernel that returns at once; the operand pad timed
  apart, and at B=64 the kernel without row groups;
- ``k4_before``: K4 as it was before its tensor-core redesign (16-row
  tiles, f32 FMA product), from the ``csrc`` directory given by
  ``--before`` (a checkout of that version), at B=64/H=50/N=3,706 and
  B=512/H=256 at N=49,999 and 200,000: without the product, without the
  ballot and insert, without the seen-id compare, without the merge
  kernel, and with a merge kernel that returns at once (its launch alone).

A variant computes wrong values: it is only timed, with CUDA events (the
mean of 50 back-to-back calls after one: launch gaps included) and with
torch.profiler (device time per call, mean of 20 calls, by kernel). The
PyTorch call that computes the same function is timed beside K4. Prints
one JSON line per measurement, with the card's name and power limit.
Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
OUT = os.path.join(ROOT, "build", "kernel_breakdown")

PRODUCT_LOOP = "    for (int k = 0; k < Hp; k += 4) {"
REMOTE_STORE = "for (int p = 0; p < C; ++p) cluster.map_shared_rank(hn, p)[e] = h_new;"
MMA_CALL = "    mma(s, ring + (s % kStages) * kSlot);"
COPY_AHEAD = "    if (s + 2 < n_slices) stage(s + 2, ring + ((s + 2) % kStages) * kSlot);"
COPY_FIRST = "  stage(0, ring);\n  cp_async_commit();\n  if (n_slices > 1) stage(1, ring + kSlot);"

K3_VARIANTS = {
    "committed": [],
    "no_product": [("gru_cluster.cuh", PRODUCT_LOOP, "    for (int k = 0; k < (L < 0 ? Hp : 0); k += 4) {")],
    "own_buffer_stores_only": [("gru_cluster.cuh", REMOTE_STORE, "hn[e] = h_new;")],
    "no_barrier_wait": [("gru_cluster.cuh", "    cluster_wait();\n  }", "  }\n  cluster_wait();")],
}
NO_MMA = ("block_mma.cuh", MMA_CALL, "    if (n_slices < 0) mma(s, ring + (s % kStages) * kSlot);")
NO_COPY = [
    ("block_mma.cuh", COPY_AHEAD, "    if (n_slices < 0) stage(s + 2, ring + ((s + 2) % kStages) * kSlot);"),
    ("block_mma.cuh", COPY_FIRST, "  cp_async_commit();\n  if (n_slices < 0) stage(1, ring + kSlot);"),
]
K2_VARIANTS = {"committed": [], "no_products": [NO_MMA], "no_copies": NO_COPY, "neither": [NO_MMA, *NO_COPY]}
K2_STATS_VARIANTS = {
    "committed": [],
    "no_product": [NO_MMA],
    # the max stays (it keeps the products alive); the exps, sums and rescales go
    "no_online_update": [("streaming_cce.cu",
                          "        const float mx = fmaxf(m_run[mt][half], cm);\n"
                          "        const float ref = mx == -INFINITY ? 0.0f : mx;\n"
                          "        float ps = 0.0f;\n"
                          "#pragma unroll\n"
                          "        for (int j = 0; j < 8; ++j) ps += expf(v[j] - ref);\n"
                          "        s_run[mt][half] = s_run[mt][half] * expf(m_run[mt][half] - ref) + ps;\n"
                          "        m_run[mt][half] = mx;\n",
                          "        m_run[mt][half] = fmaxf(m_run[mt][half], cm);\n")],
}

MERGE_LAUNCH = "  score_topk_merge<<<B, kMergeThreads, merge_smem, s>>>(part_v, part_i, out_v, out_i, n_cand, k);"
NO_MERGE = ("score_topk.cu", MERGE_LAUNCH, "  if (B < 0) " + MERGE_LAUNCH.strip())
EMPTY_MERGE = ("score_topk.cu", "  extern __shared__ float merge_smem[];\n",
               "  if (n_cand > 0) return;\n  extern __shared__ float merge_smem[];\n")
# K4 as committed: 128 x 128 3xTF32 logits tiles, a register list per row
K4_VARIANTS = {
    "committed": [],
    "no_product": [NO_MMA],
    "no_epilogue": [("score_topk.cu", "    for (int r = r_lo + warp; r < r_hi; r += kWarps) {\n      const size_t so",
                     "    for (int r = r_lo + warp; r < (N < 0 ? r_hi : 0); r += kWarps) {\n      const size_t so")],
    "no_seen_mask": [("score_topk.cu", "  for (int s = lane; s < S; s += 32) {\n    const int id = __ldg(seen_ids + s);",
                      "  for (int s = lane; s < (k < 0 ? S : 0); s += 32) {\n    const int id = __ldg(seen_ids + s);")],
    "no_list_insert": [("score_topk.cu", "  WarpList L;\n  load_list<kWide>", "  if (S >= 0) return;\n  WarpList L;\n  load_list<kWide>")],
    "no_merge": [NO_MERGE],
    "empty_merge": [EMPTY_MERGE],
}
# K4 before its redesign: csrc/score_topk.cu with a 16-row, 256-column FMA tile
K4_BEFORE_VARIANTS = {
    "committed": [],
    "no_product": [("score_topk.cu", "      for (int kk = 0; kk < H; ++kk) {",
                    "      for (int kk = 0; kk < (N < 0 ? H : 0); ++kk) {")],
    "no_ballot_insert": [("score_topk.cu", "    for (int r = warp; r < rows; r += kWarps) {",
                          "    for (int r = warp; r < (N < 0 ? rows : 0); r += kWarps) {")],
    "no_seen_compare": [("score_topk.cu", "          for (int s = lane; s < S; s += 32) hit |= sr[s] == cid;\n", "")],
    "no_merge": [NO_MERGE],
    "empty_merge": [EMPTY_MERGE],
}
K4_SHAPES = [(64, 50, 3706), (512, 256, 49_999), (512, 256, 200_000)]  # (B, H, N); S = 30, k = 10


def patched(text: str, patches) -> str:
    for old, new in patches:
        if old not in text:
            raise RuntimeError(f"kernel_breakdown: the source no longer holds {old!r}")
        text = text.replace(old, new)
    return text


def build_variants(source: str, variants: dict, csrc: str | None = None, tag: str = "") -> dict:
    """{variant: loaded library} of ``<csrc>/<source>.cu`` with the
    variant's patches (file, old text, new text) applied to its copy of
    ``csrc``; one nvcc per variant, all started together."""
    from seqrec_tpu_torch.ops import _build

    csrc = csrc or _build.CSRC_DIR
    procs = {}
    for name, patches in variants.items():
        vdir = os.path.join(OUT, f"{source}{tag}-{name}")
        os.makedirs(vdir, exist_ok=True)
        for f in os.listdir(csrc):
            shutil.copy(os.path.join(csrc, f), vdir)
        for target in {p[0] for p in patches}:
            with open(os.path.join(csrc, target)) as f:
                text = f.read()
            with open(os.path.join(vdir, target), "w") as f:
                f.write(patched(text, [(old, new) for file, old, new in patches if file == target]))
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", os.path.join(vdir, "lib.so"), os.path.join(vdir, source + ".cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), vdir)
    libs = {}
    for name, (proc, vdir) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {source} variant {name}:\n{log}")
        libs[name] = ctypes.CDLL(os.path.join(vdir, "lib.so"))
    return libs


def mean_ms(fn, reps: int = 50) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int = 20) -> dict:
    """Device time of one call of ``fn`` in ms by kernel name
    (torch.profiler, mean over ``reps`` calls)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key.replace("(anonymous namespace)::", "").split("(")[0]: e.self_device_time_total / 1e3 / reps
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA}


def timed(fn) -> dict:
    by_kernel = device_ms(fn)
    return {"ms": mean_ms(fn), "device_ms": sum(by_kernel.values()), "device_ms_by_kernel": by_kernel}


def checked(err: int) -> None:
    if err:
        raise RuntimeError(f"a kernel launch failed with CUDA error {err}")


def k3_breakdown(card: str) -> None:
    import torch

    from seqrec_tpu_torch.ops.rnn_scan import _device_plan

    B, L, H = 512, 30, 256
    rng = np.random.default_rng(1)
    lengths = rng.integers(1, L + 1, size=B)
    arrays = [rng.normal(0, 0.5, (B, L, 3 * H)), np.arange(L)[None] < lengths[:, None],
              rng.normal(0, 0.1, (H, 3 * H)), rng.normal(0, 0.1, (B, H))]
    x, m, w, h0 = (torch.tensor(a, dtype=torch.float32, device="cuda") for a in arrays)
    out = torch.empty(B, H, device="cuda")
    path, C, R = _device_plan(B, H, x.device)
    for name, lib in build_variants("gru_scan", K3_VARIANTS).items():
        fn = lib.seqrec_gru_scan_cluster_f32
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        ms = mean_ms(lambda: checked(fn(x.data_ptr(), m.data_ptr(), w.data_ptr(), h0.data_ptr(), out.data_ptr(),
                                        B, L, H, C, R, torch.cuda.current_stream().cuda_stream)))
        print(json.dumps({"kernel": "gru_scan cluster", "variant": name, "shape": [B, L, H],
                          "plan": [path, C, R], "ms": ms, "card": card}), flush=True)


def k2_breakdown(card: str) -> None:
    import torch

    from seqrec_tpu_torch.ops.streaming_cce import cce_grads, cce_grads_plain, cce_stats_plain, grads_plan

    def inputs(B, H, N):
        rng = np.random.default_rng(3)
        limit = np.sqrt(6 / (H + N))
        t = lambda a, dt=torch.float32: torch.tensor(a, dtype=dt, device="cuda")  # noqa: E731
        h, W = t(rng.uniform(-1, 1, (B, H))), t(rng.uniform(-limit, limit, (H, N)))
        b, targets = t(rng.normal(0, 0.1, N)), t(rng.integers(0, N, B), torch.int32)
        g = t(rng.uniform(0.5, 1.5, B) / B)
        m, s = cce_stats_plain(h, W, b)
        return h, W, b, targets, m + torch.log(s), g

    B, H, N = 1024, 128, 50_000  # N a multiple of 4: h and W are passed unpadded
    h, W, b, targets, logz, g = inputs(B, H, N)
    n_splits, cols, _ = grads_plan(B, H, N, torch.cuda.get_device_properties(0).multi_processor_count)
    dh, dW, db = torch.empty(B, H, device="cuda"), torch.empty(H, N, device="cuda"), torch.empty(N, device="cuda")
    part = torch.empty(n_splits, B, H, device="cuda")
    for name, lib in build_variants("streaming_cce", K2_VARIANTS).items():
        fn = lib.seqrec_cce_grads_f32
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int] * 2 + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        ptrs = [t.data_ptr() for t in (b, targets, logz, g, dh, dW, db, part)]
        ms = mean_ms(lambda: checked(fn(h.data_ptr(), H, W.data_ptr(), N, *ptrs, B, H, N, n_splits, cols,
                                        torch.cuda.current_stream().cuda_stream)))
        print(json.dumps({"kernel": "cce_grads", "variant": name, "shape": [B, H, N], "ms": ms, "card": card}),
              flush=True)
    args = inputs(1024, 256, 50_000)
    print(json.dumps({"kernel": "cce_grads", "variant": "committed vs plain", "shape": [1024, 256, 50_000],
                      "ms": mean_ms(lambda: cce_grads(*args)),
                      "plain_ms": mean_ms(lambda: cce_grads_plain(*args)), "card": card}), flush=True)


def topk_inputs(B, H, N, S=30, seed=2):
    """chip_smoke.py's K4 inputs: h uniform, W_out Glorot-uniform, b_out
    normal, S seen ids a row with a ragged mask."""
    import torch

    rng = np.random.default_rng(seed)
    limit = np.sqrt(6.0 / (H + N))
    t = lambda a, dt=torch.float32: torch.tensor(a, dtype=dt, device="cuda")  # noqa: E731
    seen = t(rng.integers(0, N, (B, S)), torch.int32)
    mask = t(np.arange(S)[None] < rng.integers(1, S + 1, (B, 1)))
    return (t(rng.uniform(-1, 1, (B, H))), t(rng.uniform(-limit, limit, (H, N))), t(rng.normal(0, 0.1, N)),
            seen, mask)


def library_topk(h, w, b, seen_ids, seen_mask, k):
    """The PyTorch calls that compute K4's function: h @ W + b, -inf
    scattered at the seen ids, torch.topk."""
    import torch

    neg = torch.where(seen_mask > 0, float("-inf"), 0.0)
    return torch.topk((h @ w + b).scatter_add_(1, seen_ids.long(), neg), k)


def k4_before_breakdown(card: str, csrc: str) -> None:
    """K4 as it was before the redesign (csrc from another checkout), cut
    part by part; its plan (16-row tiles, 256-column splits, about two
    blocks per SM, at most 2048 candidates a row) is repeated here."""
    import torch

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    k = 10
    libs = build_variants("score_topk", K4_BEFORE_VARIANTS, csrc=csrc, tag="-before")
    for B, H, N in K4_SHAPES:
        h, w, b, seen, mask = topk_inputs(B, H, N)
        S = seen.shape[1]
        row_tiles, col_tiles = -(-B // 16), -(-N // 256)
        n_splits = max(1, min(-(-2 * n_sm // row_tiles), col_tiles, 2048 // k))
        cols = -(-col_tiles // n_splits) * 256
        n_splits = -(-N // cols)
        part_v = torch.empty(B, n_splits, k, device="cuda")
        part_i = torch.empty(B, n_splits, k, dtype=torch.int32, device="cuda")
        out_v, out_i = torch.empty(B, k, device="cuda"), torch.empty(B, k, dtype=torch.int32, device="cuda")
        ptrs = [t.data_ptr() for t in (h, w, b, seen, mask, part_v, part_i, out_v, out_i)]
        for name, lib in libs.items():
            fn = lib.seqrec_score_topk_f32
            fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            res = timed(lambda: checked(fn(*ptrs, B, H, N, S, k, n_splits, cols, torch.cuda.current_stream().cuda_stream)))
            print(json.dumps({"kernel": "fused_score_topk before", "variant": name, "shape": [B, H, N, S, k],
                              "plan": [n_splits, cols], **res, "card": card}), flush=True)
        print(json.dumps({"kernel": "fused_score_topk before", "variant": "library", "shape": [B, H, N, S, k],
                          **timed(lambda: library_topk(h, w, b, seen, mask, k)), "card": card}), flush=True)


def k4_breakdown(card: str) -> None:
    """K4 as committed, cut part by part, at the shapes of K4_SHAPES; the
    operand pad (rows of a multiple of 4 floats) timed apart, and at
    B=64 the same kernel without row groups."""
    import torch

    from seqrec_tpu_torch.ops.core import rows_16b
    from seqrec_tpu_torch.ops.score_topk import split_plan

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    k = 10
    libs = build_variants("score_topk", K4_VARIANTS)
    for B, H, N in K4_SHAPES:
        h, w, b, seen, mask = topk_inputs(B, H, N)
        S = seen.shape[1]
        print(json.dumps({"kernel": "fused_score_topk", "variant": "operand pad (rows_16b of h and W_out)",
                          "shape": [B, H, N], **timed(lambda: (rows_16b(h), rows_16b(w))), "card": card}), flush=True)
        hp, wp = rows_16b(h), rows_16b(w)
        plans = {"": split_plan(B, N, k, n_sm)}
        if plans[""][2] > 1:  # the same kernel with one block per logits tile
            col_tiles = -(-N // 128)
            n_splits = max(1, min(col_tiles, 2048 // k, n_sm // -(-B // 128)))
            cols = -(-col_tiles // n_splits) * 128
            plans[", no row groups"] = (-(-N // cols), cols, 1)
        for suffix, (n_splits, cols, groups) in plans.items():
            part_v = torch.empty(B, n_splits, k, device="cuda")
            part_i = torch.empty(B, n_splits, k, dtype=torch.int32, device="cuda")
            out_v, out_i = torch.empty(B, k, device="cuda"), torch.empty(B, k, dtype=torch.int32, device="cuda")
            ptrs = [t.data_ptr() for t in (b, seen, mask, part_v, part_i, out_v, out_i)]
            for name, lib in libs.items():
                if suffix and name != "committed":
                    continue
                fn = lib.seqrec_score_topk_f32
                fn.argtypes = [ctypes.c_void_p, ctypes.c_int] * 2 + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
                fn.restype = ctypes.c_int
                res = timed(lambda: checked(fn(hp.data_ptr(), hp.stride(0), wp.data_ptr(), wp.stride(0), *ptrs,
                                               B, H, N, S, k, n_splits, cols, groups,
                                               torch.cuda.current_stream().cuda_stream)))
                print(json.dumps({"kernel": "fused_score_topk", "variant": name + suffix, "shape": [B, H, N, S, k],
                                  "plan": [n_splits, cols, groups], **res, "card": card}), flush=True)
        print(json.dumps({"kernel": "fused_score_topk", "variant": "library", "shape": [B, H, N, S, k],
                          **timed(lambda: library_topk(h, w, b, seen, mask, k)), "card": card}), flush=True)


def k2_stats_breakdown(card: str) -> None:
    """K2's stats as committed, cut part by part, at B=1024/H=128/N=50,000
    (the large-catalog steps) and B=16/H=50/N=3,706 (the flagship's
    shape), with the library call beside them."""
    import torch

    from seqrec_tpu_torch.ops.core import rows_16b
    from seqrec_tpu_torch.ops.streaming_cce import split_plan

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    libs = build_variants("streaming_cce", K2_STATS_VARIANTS, tag="-stats")
    for B, H, N in ((1024, 128, 50_000), (16, 50, 3706)):
        h, w, b, _, _ = topk_inputs(B, H, N)
        hp, wp = rows_16b(h), rows_16b(w)
        n_splits, cols = split_plan(B, N, n_sm)
        part = torch.empty(2, n_splits, B, device="cuda")
        m, s = torch.empty(B, device="cuda"), torch.empty(B, device="cuda")
        ptrs = [t.data_ptr() for t in (b, part[0], part[1], m, s)]
        for name, lib in libs.items():
            fn = lib.seqrec_cce_stats_f32
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int] * 2 + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            res = timed(lambda: checked(fn(hp.data_ptr(), hp.stride(0), wp.data_ptr(), wp.stride(0), *ptrs,
                                           B, H, N, n_splits, cols, torch.cuda.current_stream().cuda_stream)))
            print(json.dumps({"kernel": "cce_stats", "variant": name, "shape": [B, H, N], "plan": [n_splits, cols],
                              **res, "card": card}), flush=True)
        print(json.dumps({"kernel": "cce_stats", "variant": "library", "shape": [B, H, N],
                          **timed(lambda: torch.logsumexp(h @ w + b, dim=1)), "card": card}), flush=True)


PARTS = ("k3", "k2", "k2_stats", "k4", "k4_before")


def main(argv=None) -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parts", nargs="+", choices=PARTS, default=[p for p in PARTS if p != "k4_before"])
    parser.add_argument("--before", help="csrc directory of K4 before its redesign (for k4_before)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_breakdown: no CUDA device is available", file=sys.stderr)
        return 1
    if "k4_before" in args.parts and not args.before:
        parser.error("k4_before needs --before")
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, ROOT)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    if "k3" in args.parts:
        k3_breakdown(card)
    if "k2" in args.parts:
        k2_breakdown(card)
    if "k2_stats" in args.parts:
        k2_stats_breakdown(card)
    if "k4" in args.parts:
        k4_breakdown(card)
    if "k4_before" in args.parts:
        k4_before_breakdown(card, args.before)
    return 0


if __name__ == "__main__":
    sys.exit(main())
