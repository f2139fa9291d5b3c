#!/usr/bin/env python3
"""Where the time of K3's cluster kernel and K2's gradient kernels goes, on
one CUDA GPU.

    python3 -m seqrec_tpu_torch.scripts.kernel_breakdown

Builds the committed sources of ``csrc/gru_scan.cu`` and
``csrc/streaming_cce.cu`` as they are and as variants with one part cut
out (text patches of the sources, compiled into
``build/kernel_breakdown/``), and times each at the shape where the
kernel runs on a path of ``chip_smoke.py``:

- K3 at B=512, L=30, H=256 with its plan's tile: without the per-step
  product, with each new h stored only into the CTA's own buffer (no
  distributed-shared-memory stores), without the wait at the cluster
  barrier;
- K2's gradients at B=1024, H=128, N=50,000: without the tensor-core
  products, without the copies into shared memory, without both.

A variant computes wrong values: it is only timed (CUDA events, mean of
50 calls after one). The committed kernels are also timed against their
plain versions at K2's H=256 shape. Prints one JSON line per
measurement, with the card's name and power limit. Exits non-zero
without a CUDA device.
"""

from __future__ import annotations

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
    "no_product": [(PRODUCT_LOOP, "    for (int k = 0; k < (L < 0 ? Hp : 0); k += 4) {")],
    "own_buffer_stores_only": [(REMOTE_STORE, "hn[e] = h_new;")],
    "no_barrier_wait": [("    cluster_wait();\n  }", "  }\n  cluster_wait();")],
}
NO_MMA = (MMA_CALL, "    if (n_slices < 0) mma(s, ring + (s % kStages) * kSlot);")
NO_COPY = [
    (COPY_AHEAD, "    if (n_slices < 0) stage(s + 2, ring + ((s + 2) % kStages) * kSlot);"),
    (COPY_FIRST, "  cp_async_commit();\n  if (n_slices < 0) stage(1, ring + kSlot);"),
]
K2_VARIANTS = {"committed": [], "no_products": [NO_MMA], "no_copies": NO_COPY, "neither": [NO_MMA, *NO_COPY]}


def patched(text: str, patches) -> str:
    for old, new in patches:
        if old not in text:
            raise RuntimeError(f"kernel_breakdown: the source no longer holds {old!r}")
        text = text.replace(old, new)
    return text


def build_variants(source: str, header: str, variants: dict) -> dict:
    """{variant: loaded library} of ``csrc/<source>`` with ``header``
    patched per variant; one nvcc per variant, all started together."""
    from seqrec_tpu_torch.ops import _build

    csrc = _build.CSRC_DIR
    text = open(os.path.join(csrc, header)).read()
    procs = {}
    for name, patches in variants.items():
        vdir = os.path.join(OUT, f"{source}-{name}")
        os.makedirs(vdir, exist_ok=True)
        for f in os.listdir(csrc):
            shutil.copy(os.path.join(csrc, f), vdir)
        with open(os.path.join(vdir, header), "w") as f:
            f.write(patched(text, patches))
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
    for name, lib in build_variants("gru_scan", "gru_cluster.cuh", K3_VARIANTS).items():
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
    for name, lib in build_variants("streaming_cce", "block_mma.cuh", K2_VARIANTS).items():
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("kernel_breakdown: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, ROOT)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    k3_breakdown(card)
    k2_breakdown(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
