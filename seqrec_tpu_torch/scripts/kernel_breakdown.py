#!/usr/bin/env python3
"""Where the time of the port's redesigned kernels goes, on one CUDA GPU.

    python3 -m seqrec_tpu_torch.scripts.kernel_breakdown [--parts ...] [--before CSRC]

Builds the committed sources as they are and as variants with one part
cut out (text patches of the sources, compiled into
``build/kernel_breakdown/``), and times each at the shape where the
kernel runs on a path of ``chip_smoke.py``:

- ``k3``: K3 at B=64 and 512/L=30/H=50 (reg path), B=1024/L=30/H=128
  (cluster) and B=512/L=30/H=256 (gru_cluster) on its plan, without its per-step product (what
  is left is the steps' latency floor), through the wrapper per call,
  beside K1's forward (the same kernels with their state stores) and
  cuDNN's GRU; at H=128, 192 and 256 (B=512 and 1024) the training
  forward's cluster kernel on every (C, R) that fits against
  gru_cluster.cuh's kernel on every tile, both without state stores;
  with ``--before`` also K3 of that checkout at H <= 128 (one block per
  row tile, W_hid in shared memory), whole and without its product;
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
  kernel, and with a merge kernel that returns at once (its launch alone);
- ``k1`` and ``k5``: K1 (GRU) and K5 (LSTM) training scans, forward and
  backward, at B=16/L=30/H=50 (reg path; also with 2 to 16 rows a block)
  and B=1024/L=30/H=128 (cluster path): without the hid recompute, without
  the dh product, without the dW sums (reg) or the dW product (cluster),
  with every step's copies reading step 0's rows (cache-hot, so the
  loads' latency is all that goes), with the new h or dhid stored only into the
  CTA's own buffer, and through the wrapper per call; both also at the
  benchmark cells' B=4096/L=200/H=50 with their prefix lengths (wide path):
  without the hid recompute, without the dh product, without the dW sums;
  with ``--before``
  also the kernels of that checkout (one block per row tile, W_hid through
  L2 at H=128, 64 x 64 f32 dW tiles) without the hid recompute, phase 3,
  the step loads, the dW launches or the W_hid reads, its wrapper (device
  properties, dW plan, transpose, allocations, launch) and its transpose
  alone;
- ``k6``: K6 (the LSTM eval scan) at B=1024/L=30/H=128 (cluster path) and
  B=64/L=30/H=50 (reg path): on its plan and on every other cluster shape
  (C, R) or reg row tile that fits, K5's forward (the same kernels with
  their state stores) on its own plan, through the wrapper per call, and
  cuDNN's LSTM; with ``--before`` also K6 of that checkout (one block per
  row tile, W_hid through L2 at H=128);
- ``g1``: the gather-sum pair on real flagship and featured B1024 (F = 14)
  batches (D = 150), GRU-128 and LSTM-128 batches (D = 384 and 512,
  49,999 rows) and on synthetic ids at LTM's shapes (D = 32): the forward
  and the backward through their wrappers; the backward's one library
  call as committed, without its chunk sums, without its dense rows, its
  order kernel alone and that kernel's counting sweep alone; the forward
  and the backward's rows at a warp a row at every width; the plain
  version (``table[ids]`` and its ``indexing_backward_kernel``),
  ``F.embedding_bag`` and ``index_add_``; with ``--before`` also that
  checkout's forward and its backward (its host-side sort and plan, then
  its kernels; and the kernels alone); and how the ids of 20 GRU-128
  batches run (slots at id 0, padded or not, the longest run).

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

# K3 with its per-step product cut out, on every path: the reg forward's
# hid, the cluster forward's gate sums (cluster_hid, shared with the
# backward, which K3's library does not build) and gru_cluster.cuh's
K3_VARIANTS = {
    "committed": [],
    "no_product": [("scan_train_reg.cuh", "    reg_hid(h, hid, wa, rows, H, G);", "    if (L < 0) reg_hid(h, hid, wa, rows, H, G);"),
                   ("scan_train_cluster.cuh", "  for (int k = 0; k < Hp; k += 4) {",
                    "  for (int k = 0; k < (U < 0 ? Hp : 0); k += 4) {"),
                   ("gru_cluster.cuh", PRODUCT_LOOP, "    for (int k = 0; k < (L < 0 ? Hp : 0); k += 4) {")],
}
# K3 before this round's redesign: gru_forward.cuh's single-block kernel, W_hid in shared memory
K3_BEFORE_VARIANTS = {
    "committed": [],
    "no_product": [("gru_forward.cuh", "    rows_product(h, wr, hid, nullptr, rows, H, G);",
                    "    if (L < 0) rows_product(h, wr, hid, nullptr, rows, H, G);")],
}
# the serving chunks (64 and 512), GRU-128's validation chunk, GRU-256's serving chunk
K3_SHAPES = [(64, 30, 50), (512, 30, 50), (1024, 30, 128), (512, 30, 256)]
K3_WIDE_SHAPES = [(B, 30, H) for H in (128, 192, 256) for B in (512, 1024)]  # both cluster kernels
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


def device_ms(fn, reps: int = 20) -> tuple[dict, dict]:
    """Device time of one call of ``fn`` in ms by kernel name
    (torch.profiler, mean over ``reps`` calls): each kernel's mean time an
    event times its events a call, at least one (the profiler loses some
    of a kernel's launches now and then); and the events the trace holds a
    call, by kernel name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = {e.key.replace("(anonymous namespace)::", "").split("(")[0]: (e.self_device_time_total / 1e3, e.count)
              for e in prof.key_averages() if e.device_type == DeviceType.CUDA}
    return ({k: ms / n * max(1, round(n / reps)) for k, (ms, n) in events.items()},
            {k: n / reps for k, (_, n) in events.items()})


def timed(fn) -> dict:
    import chip_smoke

    by_kernel, seen = device_ms(fn)
    return {"ms": chip_smoke.back_to_back_ms(fn), "device_ms": sum(by_kernel.values()),
            "device_ms_by_kernel": by_kernel, "events_a_call": seen}


def checked(err: int) -> None:
    if err:
        raise RuntimeError(f"a kernel launch failed with CUDA error {err}")


def k3_breakdown(card: str, before: str | None) -> None:
    """K3 as committed at K3_SHAPES on its plan, with and without its
    per-step product (the rest is the steps' latency floor), through the
    wrapper, beside K1's forward (the storing form of the same kernels)
    and cuDNN's GRU; at K3_WIDE_SHAPES the training forward's cluster
    kernel on each (C, R) that fits against gru_cluster.cuh's on each of
    its tiles, both without state stores, each plan's shape marked (on
    the card's cluster capacities); with
    ``before`` also that checkout's K3 (W_hid in shared memory up to
    H=128; its C entry point took no plan), whole and without its
    product."""
    import torch

    import chip_smoke
    from seqrec_tpu_torch.ops import rnn_scan as rs
    from seqrec_tpu_torch.ops import rnn_scan_train as rst

    libs = build_variants("gru_scan", K3_VARIANTS, tag="-now")
    old = build_variants("gru_scan", K3_BEFORE_VARIANTS, csrc=before, tag="-before") if before else {}
    vp, ci = ctypes.c_void_p, ctypes.c_int
    n_sm, smem_optin = rs.device_limits(torch.cuda.current_device())

    def launch(lib, ptrs, B, L, H, path, C, R):
        fn = lib.seqrec_gru_scan_f32
        fn.argtypes, fn.restype = [vp] * 5 + [ci] * 6 + [vp], ci
        return lambda: checked(fn(*ptrs, B, L, H, rs.GRU_PATHS[path], C, R, torch.cuda.current_stream().cuda_stream))

    for B, L, H in K3_SHAPES:
        a = scan_inputs("gru", B, L, H)
        out = torch.empty(B, H, device="cuda")
        ptrs = [t.data_ptr() for t in (a["x"], a["m"], a["w"], a["h0"], out)]
        plan = rs.gru_scan_device_plan(B, H, a["x"].device)
        for name, lib in libs.items():
            print(json.dumps({"kernel": "gru_scan", "variant": name, "shape": [B, L, H], "plan": list(plan),
                              **timed(launch(lib, ptrs, B, L, H, *plan)), "card": card}), flush=True)
        args = (a["x"], a["m"], a["w"], a["h0"])
        print(json.dumps({"kernel": "gru_scan", "variant": "committed, through the wrapper", "shape": [B, L, H],
                          "plan": list(plan), **timed(lambda: rs.gru_scan(*args)), "card": card}), flush=True)
        print(json.dumps({"kernel": "gru_scan", "variant": "K1 forward (state stores), its plan", "shape": [B, L, H],
                          "plan": list(rst.gru_train_plan(B, H, a["x"].device, backward=False)),
                          **timed(lambda: rst.gru_scan_train_fwd(*args)), "card": card}), flush=True)
        cudnn = chip_smoke.cudnn_gru(*args)
        print(json.dumps({"kernel": "gru_scan", "variant": "library: cuDNN GRU (packed, an extra input product)",
                          "shape": [B, L, H], **timed(cudnn), "card": card}), flush=True)
        for name, lib in old.items() if H <= 128 else ():  # its path past H=128 was gru_cluster.cuh, as now
            fn = lib.seqrec_gru_scan_f32
            fn.argtypes, fn.restype = [vp] * 5 + [ci] * 3 + [vp], ci
            print(json.dumps({"kernel": "gru_scan before", "variant": name, "shape": [B, L, H],
                              **timed(lambda: checked(fn(*ptrs, B, L, H, torch.cuda.current_stream().cuda_stream))),
                              "card": card}), flush=True)

    lib = libs["committed"]
    lib.seqrec_gru_scan_capacity.argtypes = [ci] * 4 + [ctypes.POINTER(ci)]
    lib.seqrec_gru_cluster_capacity.argtypes = [ci] * 3 + [ctypes.POINTER(ci)]
    for B, L, H in K3_WIDE_SHAPES:
        a = scan_inputs("gru", B, L, H)
        out = torch.empty(B, H, device="cuda")
        ptrs = [t.data_ptr() for t in (a["x"], a["m"], a["w"], a["h0"], out)]
        shapes = [("cluster", C, R) for C in rst.CLUSTER_CTAS for R in rst.CLUSTER_ROWS
                  if H >= C and -(-H // C) <= rst.CLUSTER_UNITS
                  and rst.train_scan_smem("gru", "cluster", H, C, R, False) <= smem_optin]
        shapes += [("gru_cluster", 8, R) for R in rs.CLUSTER_ROWS if rs.gru_cluster_smem(H, 8, R) <= smem_optin]
        held = {}
        for path, C, R in shapes:
            n = ctypes.c_int(0)
            checked(lib.seqrec_gru_scan_capacity(0, H, C, R, ctypes.byref(n)) if path == "cluster"
                    else lib.seqrec_gru_cluster_capacity(H, C, R, ctypes.byref(n)))
            held[path, C, R] = n.value
        plans = {rst.train_scan_plan("gru", B, H, n_sm, smem_optin, False,
                                     {(C, R): n for (p, C, R), n in held.items() if p == "cluster"}, "scan"),
                 ("gru_cluster", 8, rs.gru_cluster_tile(B, H, n_sm, smem_optin,
                                                       {R: n for (p, _, R), n in held.items() if p == "gru_cluster"}))}
        for shape in shapes:
            print(json.dumps({"kernel": "gru_scan", "variant": shape[0] + (", its plan" if shape in plans else ""),
                              "shape": [B, L, H], "plan": list(shape), "clusters_held": held[shape],
                              **timed(launch(lib, ptrs, B, L, H, *shape)), "card": card}), flush=True)


def k2_breakdown(card: str) -> None:
    import torch

    import chip_smoke
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
        ms = chip_smoke.back_to_back_ms(lambda: checked(fn(h.data_ptr(), H, W.data_ptr(), N, *ptrs, B, H, N,
                                                           n_splits, cols, torch.cuda.current_stream().cuda_stream)))
        print(json.dumps({"kernel": "cce_grads", "variant": name, "shape": [B, H, N], "ms": ms, "card": card}),
              flush=True)
    args = inputs(1024, 256, 50_000)
    print(json.dumps({"kernel": "cce_grads", "variant": "committed vs plain", "shape": [1024, 256, 50_000],
                      "ms": chip_smoke.back_to_back_ms(lambda: cce_grads(*args)),
                      "plain_ms": chip_smoke.back_to_back_ms(lambda: cce_grads_plain(*args)), "card": card}), flush=True)


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


# K1 and K5 before their Hopper redesign: one block per tile of at most 8
# rows, W_hid (and a transposed copy for the backward) in shared memory or
# read through L2, the dW product on tile_mma.cuh's 64 x 64 f32 tiles
STEP_LOADS_GRU = ("gru_scan_train.cu", "      if (mask[b * L + t] > 0.0f) {\n        const float* xt = x + (b * L + t) * G;",
                  "      if (t >= 0) {\n        const float* xt = x + b * L * G;")
SCAN_TRAIN_BEFORE_VARIANTS = {
    "gru_fwd": {
        "committed": [],
        "no_product": [("gru_forward.cuh", "    rows_product(h, wr, hid, nullptr, rows, H, G);",
                        "    if (L < 0) rows_product(h, wr, hid, nullptr, rows, H, G);")],
        "no_step_loads": [("gru_forward.cuh", "      if (mask[b * L + t] > 0.0f) {\n        const float* xt = x + (b * L + t) * G;",
                           "      if (t >= 0) {\n        const float* xt = x + b * L * G;")],
        "no_w_reads": [("scan_common.cuh", "const float wk = w[(size_t)k * N + c];", "const float wk = 1e-3f * (float)(k - c);")],
    },
    "gru_bwd": {
        "committed": [],
        "no_hid_recompute": [("gru_scan_train.cu", "    rows_product(hp, wr, hid, nullptr, rows, H, G);",
                              "    if (L < 0) rows_product(hp, wr, hid, nullptr, rows, H, G);")],
        "no_phase3": [("gru_scan_train.cu", "    for (int k = threadIdx.x; k < H; k += kThreads) {",
                       "    for (int k = threadIdx.x; k < (L < 0 ? H : 0); k += kThreads) {")],
        "no_step_loads": [("gru_scan_train.cu", "i < rows * H; i += kThreads) hp[i] = hs_t[i];",
                           "i < (L < 0 ? rows * H : 0); i += kThreads) hp[i] = hs_t[i];"), STEP_LOADS_GRU],
        "no_dw": [("gru_scan_train.cu", "  return launch_atb(hs, dhid, part, dw, L * B, H, 3 * H, n_splits, k_per_split, s);",
                   "  return B < 0 ? launch_atb(hs, dhid, part, dw, L * B, H, 3 * H, n_splits, k_per_split, s) : 0;")],
        "no_w_reads": [("scan_common.cuh", "const float wk = w[(size_t)k * N + c];", "const float wk = 1e-3f * (float)(k - c);"),
                       ("gru_scan_train.cu", "const float wk = wtr[c * H + k];", "const float wk = 1e-3f * (float)(k - c);")],
    },
    "lstm_fwd": {
        "committed": [],
        "no_product": [("lstm_forward.cuh", "    rows_product(h, wr, hid, nullptr, rows, H, G);",
                        "    if (L < 0) rows_product(h, wr, hid, nullptr, rows, H, G);")],
        "no_w_reads": [("scan_common.cuh", "const float wk = w[(size_t)k * N + c];", "const float wk = 1e-3f * (float)(k - c);")],
    },
    "lstm_bwd": {
        "committed": [],
        "no_hid_recompute": [("lstm_scan_train.cu", "    rows_product(hp, wr, hid, nullptr, rows, H, G);",
                              "    if (L < 0) rows_product(hp, wr, hid, nullptr, rows, H, G);")],
        "no_phase3": [("lstm_scan_train.cu", "    rows_product(hid, wtr, dh, keep, rows, G, H);",
                       "    if (L < 0) rows_product(hid, wtr, dh, keep, rows, G, H);")],
        "no_step_loads": [("lstm_scan_train.cu", "      hp[i] = hs[st + i];\n      cp[i] = cs[st + i];",
                           "      hp[i] = hs[i];\n      cp[i] = cs[i];")],
        "no_dw": [("lstm_scan_train.cu", "  err = launch_atb(hs, dpre, part, dw, L * B, H, 4 * H, n_splits, k_per_split, s);",
                   "  err = B < 0 ? launch_atb(hs, dpre, part, dw, L * B, H, 4 * H, n_splits, k_per_split, s) : 0;")],
        "no_w_reads": [("scan_common.cuh", "const float wk = w[(size_t)k * N + c];", "const float wk = 1e-3f * (float)(k - c);")],
    },
}
SCAN_SHAPES = [(16, 30, 50), (1024, 30, 128)]  # (B, L, H): the flagship; GRU-128 and LSTM-128


def scan_inputs(cell: str, B: int, L: int, H: int, seed: int = 5, lengths=None) -> dict:
    """chip_smoke.py's scan inputs (ragged prefix masks, or ``lengths``)
    and an upstream cotangent, on the card."""
    import torch

    rng = np.random.default_rng(seed)
    n_gates = 3 if cell == "gru" else 4
    drawn = rng.integers(1, L + 1, size=B)
    lengths = drawn if lengths is None else np.asarray(lengths)
    arrays = {
        "x": rng.normal(0, 0.5, (B, L, n_gates * H)), "m": np.arange(L)[None] < lengths[:, None],
        "w": rng.normal(0, 0.1, (H, n_gates * H)), "p": rng.normal(0, 0.1, (3, H)),
        "h0": rng.normal(0, 0.1, (B, H)), "c0": rng.normal(0, 0.1, (B, H)), "dh": rng.normal(0, 1, (B, H)),
    }
    return {k: torch.tensor(v, dtype=torch.float32, device="cuda") for k, v in arrays.items()}


def before_dw_split_plan(K, H, G, n_sm, tile=64):
    """The dW split of the kernels before the redesign (about two blocks
    per SM over the 64 x 64 output tiles)."""
    out_tiles = -(-H // tile) * -(-G // tile)
    k_tiles = -(-K // tile)
    n_splits = max(1, min(-(-2 * n_sm // out_tiles), k_tiles))
    per_split = -(-k_tiles // n_splits) * tile
    return -(-K // per_split), per_split


def scan_train_before_breakdown(card: str, cell: str, csrc: str) -> None:
    """K1 (cell "gru") or K5 ("lstm") before the redesign, from ``csrc``:
    forward and backward cut part by part at SCAN_SHAPES, the per-call
    transpose of W_hid apart, and the wrapper as it was (device
    properties, dW plan, transpose, scratch allocations, launch) per call
    against its device time."""
    import torch

    import chip_smoke

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    source = "gru_scan_train" if cell == "gru" else "lstm_scan_train"
    libs = {d: build_variants(source, SCAN_TRAIN_BEFORE_VARIANTS[f"{cell}_{d}"], csrc=csrc, tag=f"-before-{d}")
            for d in ("fwd", "bwd")}
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for B, L, H in SCAN_SHAPES + (WIDE_SHAPES if cell == "lstm" else []):
        wide_shape = (B, L, H) in WIDE_SHAPES
        a = scan_inputs(cell, B, L, H, lengths=chip_smoke.cell_lengths(B, L, 5) if wide_shape else None)
        G = a["w"].shape[1]
        stream = torch.cuda.current_stream().cuda_stream
        e = lambda *s: torch.empty(*s, device="cuda")  # noqa: E731
        out, hs, cs = e(B, H), e(L, B, H), e(L, B, H)
        dx, dh0, dc0, dw, dpeep, scratch = e(B, L, G), e(B, H), e(B, H), e(H, G), e(3, H), e(L, B, G)
        peep_part = e(B, 3 * H)
        wt = a["w"].t().contiguous()
        n_splits, per_split = before_dw_split_plan(L * B, H, G, n_sm)
        part = e(n_splits, H, G)
        P = lambda *ts: [t.data_ptr() for t in ts]  # noqa: E731
        for d, variants in libs.items():
            for name, lib in variants.items():
                if cell == "gru" and d == "fwd":
                    fn = lib.seqrec_gru_train_fwd_f32
                    fn.argtypes = [vp] * 6 + [ci] * 3 + [vp]
                    args = P(a["x"], a["m"], a["w"], a["h0"], out, hs) + [B, L, H, stream]
                elif cell == "gru":
                    fn = lib.seqrec_gru_train_bwd_f32
                    fn.argtypes = [vp] * 11 + [ci] * 5 + [cf, vp]
                    args = P(a["x"], a["m"], a["w"], wt, hs, a["dh"], dx, dh0, dw, scratch, part) + [
                        B, L, H, n_splits, per_split, 100.0, stream]
                elif d == "fwd":
                    fn = lib.seqrec_lstm_train_fwd_f32
                    fn.argtypes = [vp] * 9 + [ci] * 3 + [vp]
                    args = P(a["x"], a["m"], a["w"], a["p"], a["h0"], a["c0"], out, hs, cs) + [B, L, H, stream]
                else:
                    fn = lib.seqrec_lstm_train_bwd_f32
                    fn.argtypes = [vp] * 16 + [ci] * 5 + [cf, vp]
                    args = P(a["x"], a["m"], a["w"], wt, a["p"], hs, cs, a["dh"], dx, dh0, dc0, dw, dpeep, scratch,
                             part, peep_part) + [B, L, H, n_splits, per_split, 100.0, stream]
                fn.restype = ci
                res = timed(lambda: checked(fn(*args)))
                print(json.dumps({"kernel": f"{source} {d} before", "variant": name, "shape": [B, L, H], **res,
                                  "card": card}), flush=True)
            if d == "bwd":  # the wrapper as it was, around the committed variant
                fn = variants["committed"].seqrec_gru_train_bwd_f32 if cell == "gru" else variants[
                    "committed"].seqrec_lstm_train_bwd_f32

                def wrapper():
                    props = torch.cuda.get_device_properties(a["x"].device).multi_processor_count
                    ns, ps = before_dw_split_plan(L * B, H, G, props)
                    w_t = a["w"].t().contiguous()
                    bufs = [e(B, L, G), e(B, H), e(H, G), e(L, B, G), e(ns, H, G)]
                    if cell == "lstm":
                        bufs += [e(B, H), e(3, H), e(B, 3 * H)]
                        ptrs = P(a["x"], a["m"], a["w"], w_t, a["p"], hs, cs, a["dh"], bufs[0], bufs[1], bufs[5],
                                 bufs[2], bufs[6], bufs[3], bufs[4], bufs[7])
                    else:
                        ptrs = P(a["x"], a["m"], a["w"], w_t, hs, a["dh"], *bufs)
                    checked(fn(*ptrs, B, L, H, ns, ps, 100.0, torch.cuda.current_stream().cuda_stream))

                print(json.dumps({"kernel": f"{source} bwd before", "variant": "wrapper as it was", "shape": [B, L, H],
                                  **timed(wrapper), "card": card}), flush=True)
        print(json.dumps({"kernel": f"{source} before", "variant": "transpose w_hid.t().contiguous()", "shape": [B, L, H],
                          **timed(lambda: a["w"].t().contiguous()), "card": card}), flush=True)


# K1 and K5 as committed: W_hid in registers (reg path, H <= 50) or split
# over a thread-block cluster (cluster path), one part cut out at a time
REG, CLU = "scan_train_reg.cuh", "scan_train_cluster.cuh"
SCAN_TRAIN_VARIANTS = {
    "committed": [],
    "no_hid_recompute": [(REG, "    if (t >= 1) reg_hid(", "    if (t >= 1 && L < 0) reg_hid("),
                         (CLU, "  for (int k = 0; k < Hp; k += 4) {", "  for (int k = 0; k < (U < 0 ? Hp : 0); k += 4) {")],
    "no_dh_product": [(REG, "      for (int j = 0; j < kRegCC; ++j) s = fmaf(dr[j], wb[j], s);",
                       "      for (int j = 0; j < (L < 0 ? kRegCC : 0); ++j) s = fmaf(dr[j], wb[j], s);"),
                      (REG, "      for (int m = 1; m < kRegCS; m <<= 1)", "      for (int m = 1; m < (L < 0 ? kRegCS : 1); m <<= 1)"),
                      (CLU, "    for (int c = 0; c < Gp; c += 4) {", "    for (int c = 0; c < (L < 0 ? Gp : 0); c += 4) {")],
    "no_dw": [(REG, "      for (int i = 0; i < kRegKC; ++i) dwa[i] = fmaf(hr[i], dv, dwa[i]);",
               "      for (int i = 0; i < (L < 0 ? kRegKC : 0); ++i) dwa[i] = fmaf(hr[i], dv, dwa[i]);"),
              ("gru_scan_train.cu", "  return launch_dw(hs, dhid, part, dw,", "  if (B >= 0) return 0;\n  return launch_dw(hs, dhid, part, dw,"),
              ("lstm_scan_train.cu", "  return launch_dw(hs, dpre, part, dw,", "  if (B >= 0) return 0;\n  return launch_dw(hs, dpre, part, dw,")],
    # every step's copies read step 0's rows (cache-hot; the mask stays 1)
    "step0_loads": [(REG, "    cp_async4(xb + e, x + ((size_t)(row0 + r) * L + t) * G + c);",
                     "    cp_async4(xb + e, x + (size_t)(row0 + r) * L * G + c);"),
                    (REG, "cp_async4(mb + r, mask + (size_t)(row0 + r) * L + t);", "cp_async4(mb + r, mask + (size_t)(row0 + r) * L);"),
                    (REG, "    reg_prefetch_state(hs + ((size_t)t * B + row0) * H,", "    reg_prefetch_state(hs + (size_t)row0 * H,"),
                    (REG, "    if (kLstm) reg_prefetch_state(cs + ((size_t)t * B + row0) * H,",
                     "    if (kLstm) reg_prefetch_state(cs + (size_t)row0 * H,"),
                    (CLU, "    const float* src = hs + ((size_t)t * B + row0) * H;", "    const float* src = hs + (size_t)row0 * H;")],
    "own_buffer_stores_only": [(CLU, "for (int pr = 0; pr < C; ++pr) cluster.map_shared_rank(dn, pr)[e] = d[g];", "dn[e] = d[g];"),
                               (CLU, "for (int pr = 0; pr < C; ++pr) cluster.map_shared_rank(hn, pr)[e] = h;", "hn[e] = h;")],
}
REG_ROWS = (1, 2, 4, 8, 16)  # reg-path tiles timed at B=16
# K1's and K5's wide path (scan_train_wide.cuh), one part cut out at a time: timed at WIDE_SHAPES alone
WIDE = "scan_train_wide.cuh"
WIDE_VARIANTS = {
    "wide_no_hid_recompute": [(WIDE, "      wide_hid(hc, Wf, H, d, th, hid);", "      wide_hid(hc, Wf, L < 0 ? H : 0, d, th, hid);"),
                              (WIDE, "      if (t >= 1) wide_hid(hpT + ((t - 1) % 3) * d.HQ * S, Wf, H, d, th, hid);",
                               "      if (t >= 1) wide_hid(hpT + ((t - 1) % 3) * d.HQ * S, Wf, L < 0 ? H : 0, d, th, hid);")],
    "wide_no_dh_product": [(WIDE, "      for (int c = 0; c < d.CQ; ++c) {", "      for (int c = 0; c < (L < 0 ? d.CQ : 0); ++c) {")],
    "wide_no_dw": [(WIDE, "      for (int rb = 0; rb < R; rb += 4) {", "      for (int rb = 0; rb < (L < 0 ? R : 0); rb += 4) {")],
}
WIDE_SHAPES = [(4096, 200, 50)]  # the benchmark's GRU and LSTM cells, with their traffic's prefix lengths


def scan_train_breakdown(card: str, cell: str) -> None:
    """K1 (cell "gru") or K5 ("lstm") as committed at SCAN_SHAPES and
    WIDE_SHAPES on its plan's path, forward and backward, cut
    part by part; at B=16 the reg path also with other row tiles; through
    the wrapper per call against its device time."""
    import torch

    from seqrec_tpu_torch.ops import lstm_scan_train as lst
    from seqrec_tpu_torch.ops import rnn_scan_train as rst
    from seqrec_tpu_torch.ops.rnn_scan import device_limits

    import chip_smoke

    source = "gru_scan_train" if cell == "gru" else "lstm_scan_train"
    libs = build_variants(source, {**SCAN_TRAIN_VARIANTS, **WIDE_VARIANTS}, tag="-now")
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    n_sm = device_limits(torch.cuda.current_device())[0]
    plan_fn = rst.gru_train_plan if cell == "gru" else lst.lstm_train_plan
    for B, L, H in SCAN_SHAPES + WIDE_SHAPES:
        wide_shape = (B, L, H) in WIDE_SHAPES
        a = scan_inputs(cell, B, L, H, lengths=chip_smoke.cell_lengths(B, L, 5) if wide_shape else None)
        G = a["w"].shape[1]
        e = lambda *sh: torch.empty(*sh, device="cuda")  # noqa: E731
        out, hs, cs, dx, dh0, dc0 = e(B, H), e(L, B, H), e(L, B, H), e(B, L, G), e(B, H), e(B, H)
        dw, dpeep, scratch, peep_part = e(H, G), e(3, H), e(L, B, G), e(B, 3 * H)
        n_splits, per_split = rst.dw_split_plan(L * B, H, G, n_sm)
        part = e(max(n_splits, B), H, G)
        P = lambda *ts: [t.data_ptr() for t in ts]  # noqa: E731
        plans = {d: plan_fn(B, H, a["x"].device, d == "bwd") for d in ("fwd", "bwd")}

        def call(lib, d, path, C, R):
            stream = torch.cuda.current_stream().cuda_stream
            code = rst.PATHS[path]
            if cell == "gru" and d == "fwd":
                fn = lib.seqrec_gru_train_fwd_f32
                fn.argtypes = [vp] * 6 + [ci] * 6 + [vp]
                args = P(a["x"], a["m"], a["w"], a["h0"], out, hs) + [B, L, H, code, C, R, stream]
            elif cell == "gru":
                fn = lib.seqrec_gru_train_bwd_f32
                fn.argtypes = [vp] * 11 + [ci] * 8 + [cf, vp]
                args = [*P(a["x"], a["m"], a["w"]), None, *P(hs, a["dh"], dx, dh0, dw, scratch, part),
                        B, L, H, code, C, R, n_splits, per_split, 100.0, stream]
            elif d == "fwd":
                fn = lib.seqrec_lstm_train_fwd_f32
                fn.argtypes = [vp] * 9 + [ci] * 6 + [vp]
                args = P(a["x"], a["m"], a["w"], a["p"], a["h0"], a["c0"], out, hs, cs) + [B, L, H, code, C, R, stream]
            else:
                fn = lib.seqrec_lstm_train_bwd_f32
                fn.argtypes = [vp] * 16 + [ci] * 8 + [cf, vp]
                args = [*P(a["x"], a["m"], a["w"]), None, *P(a["p"], hs, cs, a["dh"], dx, dh0, dc0, dw, dpeep,
                                                             scratch, part, peep_part),
                        B, L, H, code, C, R, n_splits, per_split, 100.0, stream]
            fn.restype = ci
            return lambda: checked(fn(*args))

        for d in ("fwd", "bwd"):
            path, C, R = plans[d]
            for name, lib in libs.items():
                if name != "committed" and name.startswith("wide_") != wide_shape:
                    continue  # a variant of the other path's kernels
                print(json.dumps({"kernel": f"{source} {d}", "variant": name, "shape": [B, L, H], "plan": [path, C, R],
                                  **timed(call(lib, d, path, C, R)), "card": card}), flush=True)
            if path == "reg":
                for rows in REG_ROWS:
                    if rows != R and rows <= B:
                        print(json.dumps({"kernel": f"{source} {d}", "variant": f"committed, {rows}-row tiles",
                                          "shape": [B, L, H], "plan": [path, C, rows],
                                          **timed(call(libs["committed"], d, path, C, rows)), "card": card}), flush=True)
        if cell == "gru":
            _, hs_w = rst.gru_scan_train_fwd(a["x"], a["m"], a["w"], a["h0"])
            calls = {"fwd": lambda: rst.gru_scan_train_fwd(a["x"], a["m"], a["w"], a["h0"]),
                     "bwd": lambda: rst.gru_scan_train_bwd(a["x"], a["m"], a["w"], hs_w, a["dh"], 100.0)}
        else:
            _, hs_w, cs_w = lst.lstm_scan_train_fwd(a["x"], a["m"], a["w"], a["p"], a["h0"], a["c0"])
            calls = {"fwd": lambda: lst.lstm_scan_train_fwd(a["x"], a["m"], a["w"], a["p"], a["h0"], a["c0"]),
                     "bwd": lambda: lst.lstm_scan_train_bwd(a["x"], a["m"], a["w"], a["p"], hs_w, cs_w, a["dh"], 100.0)}
        for d, fn in calls.items():
            print(json.dumps({"kernel": f"{source} {d}", "variant": "committed, through the wrapper", "shape": [B, L, H],
                              "plan": list(plans[d]), **timed(fn), "card": card}), flush=True)


K6_SHAPES = [(1024, 30, 128), (64, 30, 50)]  # (B, L, H): LSTM-128's eval chunk; the serving chunk at H=50


def k6_breakdown(card: str, before: str | None) -> None:
    """K6 as committed at K6_SHAPES: on each cluster shape (C, R) or reg
    row tile that fits (its plan's marked), K5's forward (the storing form
    of the same kernels) on its plan, through the wrapper, cuDNN's LSTM;
    with ``before`` also that checkout's K6 (its C entry point took no
    plan)."""
    import torch

    import chip_smoke
    from seqrec_tpu_torch.ops import lstm_scan_train as lst
    from seqrec_tpu_torch.ops import rnn_scan_train as rst
    from seqrec_tpu_torch.ops.rnn_scan import PATHS, _lstm_library, device_limits, lstm_scan, lstm_scan_plan

    lib = _lstm_library()
    smem_optin = device_limits(torch.cuda.current_device())[1]
    old = build_variants("lstm_scan", {"committed": []}, csrc=before, tag="-before")["committed"] if before else None
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for B, L, H in K6_SHAPES:
        a = scan_inputs("lstm", B, L, H)
        out = torch.empty(B, H, device="cuda")
        ptrs = [t.data_ptr() for t in (a["x"], a["m"], a["w"], a["p"], a["h0"], a["c0"], out)]
        plan = lstm_scan_plan(B, H, a["x"].device)
        if plan[0] == "cluster":
            shapes = [("cluster", C, R) for C in rst.CLUSTER_CTAS for R in rst.CLUSTER_ROWS
                      if H >= C and -(-H // C) <= rst.CLUSTER_UNITS
                      and rst.train_scan_smem("lstm", "cluster", H, C, R, False) <= smem_optin]
        else:
            shapes = [(plan[0], 1, R) for R in (1, 2, 4, 8, 16) if R <= B and (plan[0] == "reg" or R == plan[2])]
        for path, C, R in shapes:
            res = timed(lambda: checked(lib.seqrec_lstm_scan_f32(*ptrs, B, L, H, PATHS[path], C, R,
                                                                 torch.cuda.current_stream().cuda_stream)))
            print(json.dumps({"kernel": "lstm_scan", "variant": "committed" + (", its plan" if (path, C, R) == plan else ""),
                              "shape": [B, L, H], "plan": [path, C, R], **res, "card": card}), flush=True)
        train_plan = lst.lstm_train_plan(B, H, a["x"].device, backward=False)
        print(json.dumps({"kernel": "lstm_scan", "variant": "K5 forward (state stores), its plan", "shape": [B, L, H],
                          "plan": list(train_plan),
                          **timed(lambda: lst.lstm_scan_train_fwd(a["x"], a["m"], a["w"], a["p"], a["h0"], a["c0"])),
                          "card": card}), flush=True)
        args = (a["x"], a["m"], a["w"], a["p"], a["h0"], a["c0"])
        print(json.dumps({"kernel": "lstm_scan", "variant": "committed, through the wrapper", "shape": [B, L, H],
                          "plan": list(plan), **timed(lambda: lstm_scan(*args)), "card": card}), flush=True)
        cudnn = chip_smoke.cudnn_lstm({"x_pre": a["x"], "mask": a["m"], "w_hid": a["w"], "h0": a["h0"], "c0": a["c0"]})[0]

        def library():
            with torch.no_grad():
                return cudnn()

        print(json.dumps({"kernel": "lstm_scan", "variant": "library: cuDNN LSTM (no peepholes, an extra input product)",
                          "shape": [B, L, H], **timed(library), "card": card}), flush=True)
        if old is not None:
            fn = old.seqrec_lstm_scan_f32
            fn.argtypes = [vp] * 7 + [ci] * 3 + [vp]
            fn.restype = ci
            print(json.dumps({"kernel": "lstm_scan before", "variant": "committed", "shape": [B, L, H],
                              **timed(lambda: checked(fn(*ptrs, B, L, H, torch.cuda.current_stream().cuda_stream))),
                              "card": card}), flush=True)


# G1, the gather-sum pair, with one part cut out: the backward's chunk sums
# (launch 2), its dense rows (launch 3), both (the order kernel alone), and
# also the order kernel's placement sweep (its counting sweep and scan
# alone); and the forward and dense rows at a warp a row at every width
G1_ORDER_ONLY = [
    ("gather_sum.cu", "    if (n_windows > 0) {", "    if (n_windows < 0) {"),
    ("gather_sum.cu", "  const int lg = lanes_log2(D, V);\n  with_loads<V>(D, lg, [&](auto I) {\n    dense_rows_kernel",
     "  if (D > 0) return;\n  const int lg = lanes_log2(D, V);\n  with_loads<V>(D, lg, [&](auto I) {\n"
     "    dense_rows_kernel"),
]
G1_VARIANTS = {
    "committed": [],
    "no_chunk_sums": G1_ORDER_ONLY[:1],
    "no_dense_rows": G1_ORDER_ONLY[1:],
    "order_kernel_only": G1_ORDER_ONLY,
    "order_kernel_count_sweep_only": G1_ORDER_ONLY + [
        ("gather_sum.cu", "in slot order\n  for (long long s0 = lo; s0 < hi;",
         "in slot order\n  for (long long s0 = lo; s0 < (N < 0 ? hi : lo);")],
    "one_warp_a_row": [("gather_sum.cu", "  int lg = 0;\n  while (lg < 5", "  int lg = 5;\n  while (lg < 5")],
}


def _before_order(ids, n_rows):
    """The earlier backward's host-side plan (its ``segment_order`` and
    ``segment_plan`` at S = 32): the slots sorted stably by id, pads last;
    row_start and row_chunk [N + 1]."""
    import torch

    flat = ids.reshape(-1).to(torch.int32)
    sorted_ids, perm = torch.sort(torch.where(flat >= 0, flat, n_rows), stable=True)
    row_start = torch.searchsorted(sorted_ids, torch.arange(n_rows + 1, dtype=torch.int32, device=ids.device),
                                   out_int32=True)
    run = row_start[1:] - row_start[:-1]
    row_chunk = torch.zeros(n_rows + 1, dtype=torch.int32, device=ids.device)
    torch.cumsum((run + 31) // 32 * (run > 32), 0, dtype=torch.int32, out=row_chunk[1:])
    return perm, row_start, row_chunk


def g1_cases() -> list:
    """(label, ids, D, N, id_mask or None) of the shapes G1's redesign
    aims at: chip_smoke.py's real flagship, featured B1024 (F = 14) and
    GRU-128 batches, and synthetic ids (seed 6) at LTM's context and
    target shapes."""
    import chip_smoke

    rng = np.random.default_rng(6)
    flagship_rows, [(ids_f, _)] = chip_smoke.real_batch_ids(chip_smoke.FLAGSHIP, chip_smoke.ml1m_dataset())
    featured_rows, [(ids_b, _)] = chip_smoke.real_batch_ids([{"16": "1024"}.get(a, a) for a in chip_smoke.FEATURED],
                                                            chip_smoke.featured_dataset())
    large_rows, [(ids_l, _)] = chip_smoke.real_batch_ids(chip_smoke.LARGE, chip_smoke.catalog50k_dataset())
    ctx = rng.integers(0, 3706, size=(2048, 10)).astype(np.int32)
    ctx[rng.random(size=ctx.shape) < 0.2] = -1
    targets = rng.integers(0, 3706, size=(12288, 1)).astype(np.int32)
    return [("flagship batch", ids_f, 150, flagship_rows, None),
            ("LTM-shaped contexts (synthetic ids)", ctx, 32, 3706, (ctx >= 0).astype(np.float32)),
            ("LTM-shaped targets (synthetic ids)", targets, 32, 3706, None),
            ("featured B1024 batch", ids_b, 150, featured_rows, None),
            ("GRU-128 batch", ids_l, 384, large_rows, None),
            ("LSTM-128 batch", ids_l, 512, large_rows, None)]


def g1_breakdown(card: str, before: str | None) -> None:
    """G1 at g1_cases' shapes: the forward and the backward through their
    wrappers, the backward's library call with one part cut out at a time,
    the plain version and the library calls (``F.embedding_bag``,
    ``index_add_``); with ``before`` also that checkout's kernels (its
    backward behind the host-side sort and plan it needed) in the same
    run; and the id runs of 20 GRU-128 batches."""
    import torch
    import torch.nn.functional as nnf

    import chip_smoke
    from seqrec_tpu_torch.ops.core import gather_sum as plain
    from seqrec_tpu_torch.ops.gather_sum import _ID_BYTES, bwd_scratch_bytes, gather_sum_fwd, gather_sum_table_grad

    _, batches = chip_smoke.real_batch_ids(chip_smoke.LARGE, chip_smoke.catalog50k_dataset(), n_batches=20)
    runs = [chip_smoke.id_runs(ids, lengths) for ids, lengths in batches]
    print(json.dumps({"kernel": "gather_sum", "variant": "id runs of 20 GRU-128 batches", "first": runs[0],
                      **{f"mean_{k}": float(np.mean([r[k] for r in runs])) for k in runs[0]},
                      "max_longest_run": max(r["longest_run"] for r in runs), "card": card}), flush=True)
    libs = build_variants("gather_sum", G1_VARIANTS)
    old = build_variants("gather_sum", {"committed": []}, csrc=before, tag="-before")["committed"] if before else None
    vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for lib in [*libs.values(), *([old] if old else [])]:
        lib.seqrec_gather_sum_fwd_f32.argtypes = [vp, vp, ci, vp, vp, ll, ci, ci, ci, vp]
        lib.seqrec_gather_sum_fwd_f32.restype = ci
        lib.seqrec_gather_sum_bwd_f32.restype = ci
    for lib in libs.values():
        lib.seqrec_gather_sum_bwd_f32.argtypes = [vp, vp, ci, vp, vp, ll, vp, ll, ci, ci, ci, vp]
    if old:
        old.seqrec_gather_sum_bwd_f32.argtypes = [vp] * 7 + [ci] * 5 + [vp]
    rng = np.random.default_rng(7)
    for label, ids_np, D, N, mask_np in g1_cases():
        ids = torch.from_numpy(np.ascontiguousarray(ids_np)).cuda()
        m = None if mask_np is None else torch.from_numpy(mask_np).cuda()
        F, P0 = ids.shape[-1], ids.numel() // ids.shape[-1]
        table = torch.tensor(rng.normal(0, 0.1, (N, D)), dtype=torch.float32, device="cuda")
        g = torch.tensor(rng.normal(size=(*ids.shape[:-1], D)), dtype=torch.float32, device="cuda")
        shape = {"at": label, "ids": list(ids.shape), "ids_dtype": str(ids_np.dtype), "D": D, "N": N}
        n_bytes = bwd_scratch_bytes(ids.numel(), N, D)
        scratch = torch.empty(n_bytes, dtype=torch.uint8, device="cuda")
        out, dtable = torch.empty(P0, D, device="cuda"), torch.empty(N, D, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        mp = None if m is None else m.data_ptr()
        leaf = table.clone().requires_grad_()
        out_p = plain(leaf, ids, m)
        keep = ids.reshape(-1) >= 0
        rows = (g.unsqueeze(-2).expand(*ids.shape, D) * (1.0 if m is None else m.unsqueeze(-1))).reshape(-1, D)[keep]
        bag_w = (ids >= 0).float().reshape(-1, F) * (1.0 if m is None else m.reshape(-1, F))
        timings = {
            "forward (gather_sum_fwd)": lambda: gather_sum_fwd(table, ids, m),
            "backward (gather_sum_table_grad: one library call)": lambda: gather_sum_table_grad(g, ids, m, N),
            "plain forward": lambda: plain(table, ids, m),
            "plain backward (indexing_backward_kernel)": lambda: torch.autograd.grad(out_p, leaf, g, retain_graph=True),
            "library: F.embedding_bag": lambda: nnf.embedding_bag(ids.reshape(-1, F).clamp_min(0).long(), table,
                                                                  mode="sum", per_sample_weights=bag_w),
            "library: index_add_": lambda: torch.zeros(N, D, device="cuda").index_add_(
                0, ids.reshape(-1)[keep].long(), rows),
        }
        for name, lib in libs.items():
            timings[f"library call, {name}: backward"] = lambda lib=lib: checked(lib.seqrec_gather_sum_bwd_f32(
                g.data_ptr(), ids.data_ptr(), _ID_BYTES[ids.dtype], mp, scratch.data_ptr(), n_bytes,
                dtable.data_ptr(), P0, F, N, D, stream))
        timings["library call, one_warp_a_row: forward"] = lambda: checked(
            libs["one_warp_a_row"].seqrec_gather_sum_fwd_f32(table.data_ptr(), ids.data_ptr(), _ID_BYTES[ids.dtype],
                                                             mp, out.data_ptr(), P0, F, N, D, stream))
        if old:
            part = torch.empty(2 * ids.numel() // 32 + 1, D, device="cuda")

            def old_bwd():
                perm, row_start, row_chunk = _before_order(ids, N)
                checked(old.seqrec_gather_sum_bwd_f32(
                    g.data_ptr(), perm.data_ptr(), mp, row_start.data_ptr(), row_chunk.data_ptr(), part.data_ptr(),
                    dtable.data_ptr(), part.shape[0], N, 32, F, D, stream))

            plan = _before_order(ids, N)
            timings["before: forward kernel"] = lambda: checked(old.seqrec_gather_sum_fwd_f32(
                table.data_ptr(), ids.data_ptr(), _ID_BYTES[ids.dtype], mp, out.data_ptr(), P0, F, N, D, stream))
            timings["before: backward (host-side sort and plan, then its two kernels)"] = old_bwd
            timings["before: backward's two kernels alone"] = lambda: checked(old.seqrec_gather_sum_bwd_f32(
                g.data_ptr(), plan[0].data_ptr(), mp, plan[1].data_ptr(), plan[2].data_ptr(), part.data_ptr(),
                dtable.data_ptr(), part.shape[0], N, 32, F, D, stream))
        for name, fn in timings.items():
            print(json.dumps({"kernel": "gather_sum", "variant": name, "shape": shape, **timed(fn), "card": card}),
                  flush=True)


PARTS = ("k3", "k2", "k2_stats", "k4", "k4_before", "k1", "k5", "k6", "g1")


def main(argv=None) -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parts", nargs="+", choices=PARTS, default=[p for p in PARTS if p != "k4_before"])
    parser.add_argument("--before", help="csrc directory of an older checkout: K4 before its redesign (for k4_before), "
                        "K1, K3, K5, K6 and G1 before theirs (timed beside the committed ones by k1, k3, k5, k6 and g1)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_breakdown: no CUDA device is available", file=sys.stderr)
        return 1
    if "k4_before" in args.parts and not args.before:
        parser.error("k4_before needs --before")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False  # the cuDNN GRU and LSTM yardsticks in f32
    sys.path.insert(0, ROOT)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    if "k3" in args.parts:
        k3_breakdown(card, args.before)
    if "k2" in args.parts:
        k2_breakdown(card)
    if "k2_stats" in args.parts:
        k2_stats_breakdown(card)
    if "k4" in args.parts:
        k4_breakdown(card)
    if "k4_before" in args.parts:
        k4_before_breakdown(card, args.before)
    for part, cell in (("k1", "gru"), ("k5", "lstm")):
        if part in args.parts:
            if args.before:
                scan_train_before_breakdown(card, cell, args.before)
            scan_train_breakdown(card, cell)
    if "k6" in args.parts:
        k6_breakdown(card, args.before)
    if "g1" in args.parts:
        g1_breakdown(card, args.before)
    return 0


if __name__ == "__main__":
    sys.exit(main())
