#!/usr/bin/env python3
"""Chip check of the PyTorch/CUDA port (``seqrec_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line with its seconds:

1. build: compile every CUDA kernel of the port from ``seqrec_tpu_torch/csrc``
   (one ``nvcc`` per source, all at once) and print the build time, the
   compiler's register/shared-memory report and the card's name and power
   limit.
2. kernels: hold each kernel against its plain PyTorch version on the card
   (the training kernels against autograd through the plain scan and the
   dense head), at the shapes of the main paths and at large shapes, plus
   edge cases (K3 on each path of its plan, told by its path counters: reg
   at B64/H50 and B9/L7/H12 with a row of length 0, cluster at B1024/H128,
   a ragged B with holes, H=130 and 250 (uneven unit splits),
   gru_cluster.cuh at H=256 (ragged tiles, empty rows, masks with holes)
   and H=300 (two units a lane), l2 at H=512, the same bits on two calls;
   K4: one row, a ragged row tile, k = 64, a catalog under one tile, rows
   with every item seen, a ragged 200,001-item catalog; K2's stats and
   gradients: H=256, ragged
   shapes, a row with g = 0, the same bits on two calls; K1 and K5 on
   each path of their plan (reg, cluster, and K1's l2 backward): one row,
   a ragged cluster tile, H not divisible by the cluster, a row of length
   0, a mask with holes, a clip that binds at H=128, the same bits on two
   calls; K6 on each path of its plan: reg at B64/H50 and B9/L7/H12 with
   a row of length 0, cluster at B1024/H128 and a ragged B with holes, l2
   at H=300, the same bits on two calls; the gather-sum pair on real
   batches of the flagship and the large catalog and at F=2 with id_mask
   and pad slots, forward bit for bit at F=1, the same bits on two calls;
   K1 and the gather-sum on a real -b 64 batch of the sampled head, at
   B64/L30/H50)
   and a
   bidirectional LSTM tower against the same tower on the CPU, and time
   the kernel, the plain version and a PyTorch library yardstick beside
   the kernel's bound (for the 3xTF32 kernels K2 and K4 also the f32
   bound): per call with CUDA events (median
   of at least 20 runs after warm-up; host launch time included) and as
   device time from torch.profiler (mean of 20 calls); the plain version
   over PLAIN_REPS calls each way.
3. main_path (serving): write an ML-1M-scale synthetic dataset, save a
   GRU-50 CCE model from seed 0, run the port's test CLI on the card with
   every launch counter at 0, check that K3 and K4 were launched, run the
   CLI again on the CPU and check that both give the same top-10 lists;
   then time a serving pass of 4096 users at eval chunks of 64 and 512.
4. main_path_train (flagship): with every counter at 0, train GRU-50 CCE
   (L=30, B=16, Adam 1e-3) through the train CLI on the card for 1,000
   steps, with two validations; check that K1 (forward and backward), K3
   and K4 ran and K2 did not (dense head), and the gather-sum kernels
   ran; check that the first 20 step costs agree with the CLI on the CPU;
   test the trained checkpoint with the test CLI on the card; time steady
   training steps and profile them.
5. main_path_train (large catalog): write a synthetic dataset of about
   50,000 items (streaming head), with every counter at 0 train GRU-128 at
   B=1024 for 30 steps and one validation through the train CLI; check
   that K1, K2 (stats and gradients) and the gather-sum kernels ran; time
   and profile steady steps (no step may run PyTorch's
   ``indexing_backward_kernel``).
6. main_path_train (LSTM): on the same dataset, with every counter at 0
   train LSTM-128 at B=1024, Adam 2e-3 for 30 steps and one validation
   through the train CLI, saving the best checkpoint; check that K5
   (forward and backward), K2 and the gather-sum kernels ran and no GRU
   kernel did; check that the first 5 step costs agree with the CLI on the
   CPU; with the counters at 0 again run the test CLI on the checkpoint on
   the card, check that K6 (on its cluster path) and K4 ran and that the
   top-10 lists equal the CPU run's; time and profile steady steps.
   Then main_path_train_hstu: HSTU (--r_t HSTU) at small widths on the
   same catalog: the tower on packed tokens against float64 on the CPU
   (output, every gradient, token counters) at dqk != dv with empty, full
   and one-step rows and at the HSTU cell's prefix lengths; its first 3
   step costs against the CPU's, 20 steps at
   --spd 2 and a validation through the train CLI (the attention kernels,
   G1 and K2, no scan), the test CLI on its checkpoint (G1, the attention
   forward, K4) with the CPU's top-10 lists. The kernels phase checks the
   attention at the HSTU cell's shape and two odd ones.
7. serving_pass_gru256: GRU-256 (``bench_matrix.json`` row
   GRU-256-50000-f32-B1024) from seed 0 on the same catalog; with every
   counter at 0 serve 4096 users at eval chunks of 512, check that K3 ran
   on its path at H=256 (K3_PATH_H256) and K4 ran, and that the top-10
   lists of the first 512 users equal the same model's on the CPU; print
   users/s and the profiler's top kernels.
8. main_path_train_heads: the sampled and margin heads at
   scripts/quality_run_regime2.sh's GRU-50, B=64, Adam 2e-3 on the
   ML-1M-scale dataset. With every counter at 0 before each run, train
   through the train CLI on the card: BPR with 256 samples (100 steps, one
   validation), Blackout with 256 pop^0.5 samples (50 steps, one
   validation) and the dense hinge margin (100 steps, one validation);
   check that K1 (forward and backward), the gather-sum kernels, K3 and K4
   ran and K2 did not, and that the first 20 step costs agree with the CLI
   on the CPU within 1e-4; run the test CLI on the BPR and hinge
   checkpoints on the card (K3 and K4) and the CPU (the same top-10 lists);
   time and profile steady BPR and hinge steps.
9. main_path_train_heads_large: at the large catalog's GRU-128, B=1024,
   the streaming hinge margin (30 steps, one validation) and BPR with 256
   samples and --lazy_updates (30 steps), with the same launch checks (K3
   and K4 only where a validation runs) and the first 3 step costs against
   the CPU's; steady steps (no ``indexing_backward_kernel``); the
   streaming margin's chunk loop and correction timed beside the dense
   margin (and held against it), and the lazy head update beside dense
   Adam on W_out and b_out.
10. main_path_train_cluster: RNNCluster at scripts/baseline_run2.sh's
   flags (GRU-50, B=64, 10 clusters, Blackout with 256 samples and 256
   cluster samples, Adam 1e-3, --csn 0) on the ML-1M-scale dataset: 100
   steps and one validation through the train CLI on the card (K1, the
   gather-sum kernels and K3 must run, K2 and K4 not), the first 20 step
   costs against the CPU's within 1e-4, the test CLI with --clusters 10 on
   the card and the CPU (the same top-10 lists and ASSR), steady steps.
11. main_path_train_cluster_large: the same model at GRU-128, B=1024 on
   the 50k-item catalog: 30 steps and one validation (K1 on its cluster
   path, the gather-sum kernels, K3); steady steps and one validation pass
   timed alone.
12. main_path_fism_cluster: FISMCluster (H=50, alpha 0.2, 10 clusters,
   Blackout with 256 samples, B=64, Adam 1e-3): 100 steps and one
   validation, 20 step costs against the CPU's, the test CLI against the
   CPU's lists, steady steps. Its bag is a plain gather and einsum, as in
   the JAX package: every counter must stay at 0.
13. main_path_train_sdae: the autoencoder at scripts/baseline_run2.sh's
   flags (-L 64-32-64, --in_do 0.2, B=64, Adam 1e-3): 20 step costs at
   --do 0 against the CPU's, 100 steps at --do 0.3 and one validation,
   the test CLI against the CPU's lists, steady steps; every counter at 0.
14. main_path_train_ltm: a second ML-1M-scale dataset, ml1m_pp: the same
   generator rows written as ratings.dat and split by the port's numpy
   preprocess as scripts/baseline_run.sh splits them (its seconds
   printed). LTM at scripts/baseline_run2.sh:84's flags (-H 32,
   --ltm_window 5, lr 0.01, 2,048 positions a step): the gather-sum pair
   on its first step's contexts and, at F=1, its targets, and K4 at its
   validation shape; with every counter at 0, 2 epochs with a validation
   after each through the train CLI (G1's forward once and its backward
   twice a step, K4 once a validation, nothing else), the first 20 step
   losses against the CPU CLI's within 1e-4, the test CLI on the last
   checkpoint on the card (K4 only) and the CPU (the same top-10 lists),
   a steady epoch timed and 50 steps profiled.
15. floors: POP, the Markov model and user-KNN through the test CLI on
   ml1m_pp: no kernel launches, the CPU's lists and metrics, and test
   sps@10 / recall@10 equal to the JAX package's on preprocess.py's split
   of the same rows (BASELINE.md:49-51).
16. main_path_train_mf: the factorization family on ml1m_pp at
   scripts/baseline_run.sh's and baseline_run3.sh's flags (BPRMF uniform
   and adaptive, FPMC, FISM-BPR, Fossil; 512 samples a chunk, 16 chunks a
   dispatch): with every counter at 0 before each, two dispatches and one
   validation through the train CLI on the card (G1's backward carries
   the table scatters; nothing else launches: 3,706 items score on the
   host), the first 20 host-sampled chunk costs against the CPU's within
   1e-4, the test CLI against the CPU's lists, steady dispatches (samples/s,
   device ms and busy share per chunk); G1's backward at the scatters'
   shapes; then BPRMF and FPMC validations at the 50k-item catalog through
   the train CLI (K4 must launch) and their lists against the host route's
   on the same tables, ties checked apart; K4 at that shape.
17. main_path_train_features: the flagship with --rf --mf --uf (F = 14
   ids a step) on the ML-1M-scale dataset with side tables drawn from a
   seed at ML-1M's widths (18 genres, 1-6 an item): the gather-sum pair
   on a real featured B16 and B1024 batch (timed, with their id runs);
   with every counter at 0, 200 steps and two validations through the
   train CLI with the optimizer state saved through the async queue
   (K1, G1, K3, K4 > 0, K2 = 0), then a resume of 100 steps with
   --load_last_model under --profile whose checkpoint's Adam count goes
   on from 200;
   the first 20 step costs against the CPU's within 1e-4; the test CLI
   with --save --save_rank on the last checkpoint on the card (K3 and
   G1; K4 stops at k = 64) and on the CPU: the same _full_rank lines,
   ties apart; steady steps.
18. main_path_train_bf16: GRU-128 at B=1024 on the 50k-item catalog with
   --bf16 --u_moments bfloat16: 30 steps and one validation through the
   train CLI (K1, G1, K3, K4 > 0; K2 = 0: the bf16 loss runs the chunk
   loop, K2 is f32 only), the first 3 step costs against the CPU's
   within BF16_COST_TOL, and steady steps without and with --bf16 in
   paired runs (f32, bf16, bf16, f32; K2 > 0 only in the f32 ones).
19. main_path_train_spd: the K-step dispatch. With every counter at 0
   before each run, through the train CLI on the card and then the CPU:
   the flagship at --spd 8 on the index wire (160 steps, two validations;
   K1, G1, K3, K4 > 0, K2 = 0), BPR with 256 samples and RNNCluster (--csn
   0) at scripts/baseline_run2.sh:30-33's and :53-56's flags at --spd 8
   (96 steps, three validations): the same checkpoint names (epoch
   stamps) and progress costs within 1e-4 of the CPU's, and the
   flagship's first 10 dispatch costs too; GRU-128 at B=1024 on the
   50k-item catalog at --spd 4 (32 steps: K2 > 0). The native sequence
   parser: the train CLI's dataset loaded through it (its counter), its
   arrays equal to the Python tokenizer's, both load times.
20. main_path_mesh: the main path over a ("data", "model") mesh of
   torch.distributed ranks, one process a rank (this script with
   ``--mesh-rank``). One rank under NCCL: the flagship at --mesh 1,1 for
   150 steps and three validations. Two ranks sharing the one card over
   gloo (NCCL refuses two ranks on one device): the flagship at --mesh
   2,1 and 1,2 (50 steps, one validation; the vocab-parallel dense head,
   W_in by rows), GRU-128 at B=1024 on a 50,000-item catalog (seed 9:
   an even catalog, so W_out shards and K2 runs on each shard) at --mesh
   1,2 --spd 4 (16 steps, one validation), and the test CLI at --mesh 1,2
   on the single-device flagship checkpoint. Checks: each run's progress
   costs within 1e-4 of the single-device card run's, the mesh
   checkpoints written by rank 0 alone with the single-device keys and
   shapes, the test CLI's top-10 lists equal to the single-device test
   CLI's (ties apart), and in each rank every counter of K1, K2, K3, K4
   and G1 above 0 (each rank zeroes and reads its own around each run
   and reports them). A rank that fails or outlasts MESH_TIMEOUT fails
   the phase, and every rank process is killed. The other heads on the
   same two gloo ranks, each against a one-card run of its flags (the
   progress costs within 1e-4, the validation metrics equal, ASSR within
   1e-5): BPR at --mesh 2,1 and 1,2 (50 steps, one validation, --save
   Best; the test CLI at 1,2 on the one-card checkpoint, its lists equal,
   ties apart), the dense hinge at 1,2, the streaming hinge at GRU-128,
   B=1024 on the even 50,000-item catalog at 1,2 (8 steps), RNNCluster
   at its default --csn, FISMCluster and SDA at --do 0.3, all at 1,2; in
   each rank K1, G1, K3 and K4 above 0 for the sampled and margin heads,
   K1, G1 and K3 for RNNCluster, G1 for FISMCluster, none for SDA. Then
   --lazy_updates and --bf16 on the same two ranks, each against its
   one-card run alike: the flagship with --lazy_updates at 2,1 (50
   steps; W_in's rows from both data ranks' ids), at GRU-128, B=1024 on
   the even catalog at 1,2 (8 steps) lazy BPR (W_out's columns on
   25,000-column shards) and the lazy CCE (K2 on each shard, the rows of
   a row-sharded W_in), --bf16 --u_moments bfloat16 (K2 at 0: the bf16
   chunk loop on each shard; the moments' noise drawn in the full
   shapes), and the dense hinge with --bf16 at 1,2 (50 steps); in each
   rank K1, G1, K3 and K4 above 0, K2 too for the lazy CCE. Then K2
   (every other target -1), K4 and G1 at their per-shard shapes (and G1
   on FISM's bag and on the cluster rows of a shard, K1 and K4 at the 32
   rows of a data rank), timed.

Any failed check raises, and the script exits non-zero. Without a CUDA
device it exits non-zero before printing any result. The last lines are
the run's total seconds (with each phase's), the card's name and power
limit, the kernels summary, and
``{"ok": true, "device": {...}}``. The whole run takes about seven to ten
minutes on an H100 (PERF.md section 5 has the newest run's seconds); it
must end within 1,200 s. Builds and datasets go under ``build/`` of the checkout; TF32 is
off throughout.
"""

from __future__ import annotations

import contextlib
import functools
import io
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
TF32_FLOPS = 495e12  # dense, tensor cores
HBM_BYTES_PER_S = 3.35e12
# K3's path at H=256 on an H100: gru_cluster.cuh's kernel, which measured faster there than the
# training forward's cluster kernel (ops/rnn_scan.py GRU_CLUSTER_MIN_H)
K3_PATH_H256 = "gru_cluster"
K3_COUNTERS = {"reg": "reg_launches", "cluster": "cluster_launches", "gru_cluster": "gru_cluster_launches"}
# wrapper name -> (module, CUDA source, TPU kernel it replaces)
KERNELS = {
    "gru_scan": ("rnn_scan", "seqrec_tpu_torch/csrc/gru_scan.cu", "seqrec_tpu/ops/pallas_rnn.py:88"),
    "fused_score_topk": ("score_topk", "seqrec_tpu_torch/csrc/score_topk.cu", "seqrec_tpu/ops/pallas_topk.py:57"),
    "gru_scan_train_fwd": ("rnn_scan_train", "seqrec_tpu_torch/csrc/gru_scan_train.cu",
                           "seqrec_tpu/ops/pallas_rnn_train.py:67"),
    "gru_scan_train_bwd": ("rnn_scan_train", "seqrec_tpu_torch/csrc/gru_scan_train.cu",
                           "seqrec_tpu/ops/pallas_rnn_train.py:96"),
    "cce_stats": ("streaming_cce", "seqrec_tpu_torch/csrc/streaming_cce.cu",
                  "seqrec_tpu/ops/pallas_streaming_cce.py:60"),
    "cce_grads": ("streaming_cce", "seqrec_tpu_torch/csrc/streaming_cce.cu",
                  "seqrec_tpu/ops/pallas_streaming_cce.py:140"),
    "lstm_scan": ("rnn_scan", "seqrec_tpu_torch/csrc/lstm_scan.cu", "seqrec_tpu/ops/pallas_rnn.py:165"),
    "lstm_scan_train_fwd": ("lstm_scan_train", "seqrec_tpu_torch/csrc/lstm_scan_train.cu",
                            "seqrec_tpu/ops/pallas_lstm_train.py:80"),
    "lstm_scan_train_bwd": ("lstm_scan_train", "seqrec_tpu_torch/csrc/lstm_scan_train.cu",
                            "seqrec_tpu/ops/pallas_lstm_train.py:111"),
    # not a Pallas kernel: the JAX package's gather-sum is XLA's gather and scatter-add
    "gather_sum_fwd": ("gather_sum", "seqrec_tpu_torch/csrc/gather_sum.cu", "seqrec_tpu/ops/core.py:54"),
    "gather_sum_bwd": ("gather_sum", "seqrec_tpu_torch/csrc/gather_sum.cu", "seqrec_tpu/ops/core.py:54"),
    # not a Pallas kernel: the JAX package has no attention model (models/hstu.py)
    "hstu_attention_fwd": ("hstu_attention", "seqrec_tpu_torch/csrc/hstu_attention.cu", "none"),
    "hstu_attention_bwd": ("hstu_attention", "seqrec_tpu_torch/csrc/hstu_attention.cu", "none"),
}
FLAGSHIP = [
    "-m", "RNN", "--loss", "CCE", "--r_t", "GRU", "--r_l", "50", "--max_length", "30",
    "-b", "16", "--u_m", "adam", "--u_l", "0.001",
]
SERVING_ARGV = FLAGSHIP + ["-i", "1"]
# bench_matrix.json row GRU-128-50000-f32-B1024
LARGE = [
    "-m", "RNN", "--loss", "CCE", "--r_t", "GRU", "--r_l", "128", "--max_length", "30",
    "-b", "1024", "--u_m", "adam", "--u_l", "0.001",
]
# bench_matrix.json row LSTM-128-50000-f32-B1024, scripts/convergence_run.sh's LSTM leg
LSTM_LARGE = [
    "-m", "RNN", "--loss", "CCE", "--r_t", "LSTM", "--r_l", "128", "--max_length", "30",
    "-b", "1024", "--u_m", "adam", "--u_l", "0.002",
]
# HSTU (models/hstu.py) at small widths on the large catalog: the attention kernels, G1 and K2 in training, G1, the
# attention forward and K4 in the test CLI
HSTU_SMALL = ["-m", "RNN", "--loss", "CCE", "--r_t", "HSTU", "--r_l", "64", "--hstu_blocks", "2", "--hstu_heads", "2",
              "--hstu_dqk", "32", "--hstu_dv", "32", "--max_length", "30", "-b", "256", "--u_m", "adam", "--u_l", "0.001"]
# the flagship with every side feature (--rf --mf --uf) on write_side_features' ML-1M-width tables:
# F = 1 + 1 + (3 + 6) + 3 = 14 ids a step
FEATURED = FLAGSHIP + ["--rf", "--mf", "--uf"]
# the large catalog's GRU-128 in bf16 with bf16 Adam moments (K2 is f32 only: the bf16 chunk loop runs)
LARGE_BF16 = LARGE + ["--bf16", "--u_moments", "bfloat16"]
# the bf16 run's first step costs against the CPU's: bf16 operands of f32 values that differ in the
# last bits round apart, and the moments' stochastic rounding draws other noise on each device; an
# H100 at 700 W measured 1.8e-7 (PERF.md), this leaves 50x
BF16_COST_TOL = 1e-5
# scripts/quality_run_regime2.sh's sampled (BPR) and margin (hinge) runs: GRU-50, B=64, Adam 2e-3
HEADS = ["-m", "RNN", "--r_t", "GRU", "--r_l", "50", "--max_length", "30", "-b", "64", "--u_m", "adam", "--u_l", "0.002"]
HEADS_BPR = HEADS + ["--loss", "BPR", "--sampling", "256"]
HEADS_BLACKOUT = HEADS + ["--loss", "Blackout", "--sampling", "256", "--sampling_bias", "0.5"]
HEADS_HINGE = HEADS + ["--loss", "hinge"]
# the GRU large catalog's shape with the other heads: the streaming margin, the lazy sampled head
LARGE_HEADS = [a for a in LARGE if a not in ("--loss", "CCE")]
LARGE_HINGE = LARGE_HEADS + ["--loss", "hinge"]
LARGE_BPR_LAZY = LARGE_HEADS + ["--loss", "BPR", "--sampling", "256", "--lazy_updates"]
# scripts/baseline_run2.sh's RNNCluster (:53-56) and SDA (:76-78) runs, and FISMCluster at the same sampling
CLUSTER = ["-m", "RNN", "--clusters", "10", "--loss", "Blackout", "--sampling", "256", "--c_sampling", "256",
           "--r_t", "GRU", "--r_l", "50", "--max_length", "30", "-b", "64", "--u_m", "adam", "--u_l", "0.001"]
CLUSTER_LARGE = [{"50": "128", "64": "1024"}.get(a, a) for a in CLUSTER]
FISM_CLUSTER = ["-m", "FISM", "--clusters", "10", "-H", "50", "--fism_alpha", "0.2", "--loss", "Blackout",
                "--sampling", "256", "-b", "64", "--u_m", "adam", "--u_l", "0.001"]
SDA = ["-m", "SDA", "-L", "64-32-64", "--in_do", "0.2", "-b", "64", "--u_m", "adam", "--u_l", "0.001"]
# the K-step dispatch: scripts/baseline_run2.sh trains BPR (:30-33) and RNNCluster (:53-56) at --spd 8
SPD = 8
SPD_BPR = ["-m", "RNN", "--loss", "BPR", "--sampling", "256", "--r_t", "GRU", "--r_l", "50", "--max_length", "30",
           "-b", "64", "--u_m", "adam", "--u_l", "0.001", "--spd", str(SPD)]
SPD_CLUSTER = CLUSTER + ["--csn", "0", "--spd", str(SPD)]
# scripts/baseline_run2.sh:84's LTM (lr 0.01: -l's default; 2,048 positions a step)
LTM = ["-m", "LTM", "-H", "32", "--ltm_window", "5", "-l", "0.01"]
# test sps@10 and recall@10 of the JAX package's floors on preprocess.py's split of
# ml1m_pp_dataset()'s rows: seqrec_tpu's preprocess.py with PP_FLAGS, then
# `test.py -m POP|MM|UKNN`, run on a CPU (PERF.md §6); BASELINE.md:49-51
# prints them rounded
JAX_FLOORS = {"POP": (0.14, 0.07598658413110682), "MM": (0.5, 0.05913237889413948),
              "UKNN": (0.13, 0.07468881555223694)}
BASELINE_FLOORS = {"POP": (0.14, 0.0760), "MM": (0.50, 0.0591), "UKNN": (0.13, 0.0747)}
PP_FLAGS = ["--columns", "uirt", "--sep", "::", "--min_item_pop", "5", "--val_size", "100", "--test_size", "100"]
# the factorization family at scripts/baseline_run.sh:37-47's and scripts/baseline_run3.sh's flags
# (Fossil at BASELINE.md:59's lr 0.01: baseline_run3.sh's 0.05 diverges in the JAX package too);
# trained with --extended_set, as there
MF_RUNS = {
    "bprmf": ["-m", "BPRMF", "-H", "32", "-l", "0.1", "-r", "0.0025", "--no_adaptive_sampling"],
    "bprmf_adaptive": ["-m", "BPRMF", "-H", "32", "-l", "0.1", "-r", "0.0025"],
    "fpmc": ["-m", "FPMC", "--k_cf", "32", "--k_mc", "32", "-l", "0.1", "--no_adaptive_sampling"],
    "fism_bpr": ["-m", "FISM", "-H", "32", "-l", "0.01", "-r", "0.0025", "--init_sigma", "0.1", "--loss", "BPR",
                 "--fism_alpha", "0.2"],
    "fossil": ["-m", "Fossil", "-H", "32", "-l", "0.01", "-r", "0.0025", "--init_sigma", "0.1",
               "--fossil_order", "1"],
}


# each phase's seconds, for the run's total line
PHASE_SECONDS: dict = {}


def wrapper(name):
    import importlib

    return getattr(importlib.import_module("seqrec_tpu_torch.ops." + KERNELS[name][0]), name)


def zero_counters() -> None:
    for name in KERNELS:
        wrapper(name).launches = 0
    k3 = wrapper("gru_scan")
    k3.reg_launches = k3.cluster_launches = k3.gru_cluster_launches = 0
    for name in ("gru_scan_train_fwd", "gru_scan_train_bwd"):
        wrapper(name).cluster_launches = wrapper(name).wide_launches = 0
    for name in ("lstm_scan_train_fwd", "lstm_scan_train_bwd"):
        wrapper(name).wide_launches = 0
    wrapper("lstm_scan").reg_launches = wrapper("lstm_scan").cluster_launches = 0


def read_counters() -> dict:
    return {name: wrapper(name).launches for name in KERNELS}


def emit(obj) -> None:
    if "phase" in obj and "seconds" in obj:
        PHASE_SECONDS.setdefault(obj["phase"], []).append(obj["seconds"])
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


def device_events(fn, reps: int = 1, tries: int = 3, counts: bool = False) -> dict:
    """Device time in ms of each kernel or copy name over ``reps`` calls of
    ``fn``, from torch.profiler's CUDA trace (with ``counts``, each name's
    (ms, events in the trace)). A trace with no device event (the profiler
    drops one now and then) is taken again, up to ``tries`` times in all;
    after that ``fn`` is taken to launch nothing (as the operand pad of
    already aligned rows does)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = {
            e.key: (e.self_device_time_total / 1e3, e.count) if counts else e.self_device_time_total / 1e3
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
        }
        if events:
            break
    return events


def kernel_name(key: str) -> str:
    """A profiler key's function name, without namespace, template or
    arguments."""
    return key.replace("(anonymous namespace)::", "").split("(")[0].split("<")[0].split()[-1]


def port_kernel_names() -> set:
    """Names of the kernels in the port's CUDA sources."""
    import glob
    import re

    names = set()
    for path in glob.glob(os.path.join(ROOT, "seqrec_tpu_torch", "csrc", "*.cu*")):
        with open(path) as f:
            names.update(re.findall(r"__global__ void (?:__\w+__\([^)]*\) )*(\w+)\(", f.read()))
    return names


def device_ms(fn, reps: int = 20) -> float:
    """Device time of one call of ``fn`` in ms (profiler; no launch gaps):
    each name's mean time an event times its events a call, at least one,
    so that an event the trace dropped (the profiler loses some of a
    kernel's launches now and then) is not counted as no time."""
    fn()
    return sum(ms / n * max(1, round(n / reps)) for ms, n in device_events(fn, reps, counts=True).values())


# calls of a plain version in its per-call and device times: a plain scan launches hundreds of
# kernels a call, each an event for the profiler to sort, and no check reads the plain time
PLAIN_REPS = 3


def timings(*parts: dict) -> list:
    """For each dict ``{label: fn}`` of ``parts``: ``{label}_ms`` per call
    (CUDA events: the median of 30 calls) and ``{label}_device_ms``
    (device_ms over 20 calls), both over PLAIN_REPS calls for the label
    "plain"."""
    return [{**{f"{label}_ms": time_ms(fn, reps=PLAIN_REPS, warmup=1) if label == "plain" else time_ms(fn)
                for label, fn in fns.items()},
             **{f"{label}_device_ms": device_ms(fn, reps=PLAIN_REPS if label == "plain" else 20)
                for label, fn in fns.items()}} for fns in parts]


def back_to_back_ms(fn, reps: int = 50) -> float:
    """Mean time in ms of ``reps`` calls of ``fn`` launched back to back
    after one, between two CUDA events: the device time where the kernel
    outlasts its launch, with no profiler."""
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


def bound_ms(flops: float, n_bytes: float):
    """Least time for the work on the card and what sets it."""
    t_ops, t_bytes = flops / F32_FLOPS * 1e3, n_bytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def product_bounds(flops: float, n_bytes: float, f32_flops: float = 0.0) -> dict:
    """Bounds of work whose products of ``flops`` run as 3xTF32 on the
    tensor cores (block_mma.cuh) beside ``f32_flops`` of f32 FMA: three
    TF32 passes at the TF32 peak, and, beside it, every product as f32 FMA
    on the CUDA cores. ``bound_ms`` is the 3xTF32 one, the lesser."""
    t_tf32 = (3 * flops / TF32_FLOPS + f32_flops / F32_FLOPS) * 1e3
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_tf32, t_bytes), "bound_by": "operations" if t_tf32 >= t_bytes else "bytes",
            "bound_f32_ms": bound_ms(flops + f32_flops, n_bytes)[0], "bound_tf32x3_ms": max(t_tf32, t_bytes)}


def train_scan_bwd_bounds(fwd_flops: float, n_bytes: float, path: str) -> dict:
    """Bounds of a training scan's backward: the hid recompute (it is given
    the states hs, not the gates) and the dh product as f32 FMA, and dW =
    hs^T dhid as 3xTF32 where it runs on block_mma.cuh (the cluster and l2
    paths); on the reg and wide paths dW is f32 FMA in registers, and
    ``bound_ms`` is the f32 one."""
    out = product_bounds(fwd_flops, n_bytes, f32_flops=2 * fwd_flops)
    if path in ("reg", "wide"):
        out["bound_ms"], out["bound_by"] = bound_ms(3 * fwd_flops, n_bytes)
    return out


# ----------------------------------------------------------------------
# K3: GRU scan
# ----------------------------------------------------------------------
def gru_inputs(B, L, H, seed, device, empty_row=False, holes=False, lengths=None):
    """Random scan inputs; ``lengths`` (a real batch's prefix lengths)
    replaces the drawn ones."""
    import torch

    rng = np.random.default_rng(seed)
    drawn = rng.integers(1, L + 1, size=B)
    lengths = drawn if lengths is None else np.asarray(lengths)
    if empty_row:
        lengths[0] = 0  # keeps h0
    mask = np.arange(L)[None, :] < lengths[:, None]
    if holes:
        mask[:, [3, 7]] = False  # interior steps skipped: h carried through
    arrays = {
        "x_pre": rng.normal(0.0, 0.5, size=(B, L, 3 * H)),
        "mask": mask,
        "w_hid": rng.normal(0.0, 0.1, size=(H, 3 * H)),
        "h0": rng.normal(0.0, 0.1, size=(B, H)),
    }
    return {k: torch.tensor(v, dtype=torch.float32, device=device) for k, v in arrays.items()}


def cudnn_gru_module(w_hid):
    """torch.nn.GRU (cuDNN) computing the kernels' GRU from x_pre: identity
    input weights, zero biases, the update-gate columns negated (torch's z
    is 1 - u). It also does a [B*L, 3H] x [3H, 3H] input product the
    kernels do not."""
    import torch

    H = w_hid.shape[0]
    gru = torch.nn.GRU(3 * H, H, batch_first=True).to(w_hid.device)
    sign = torch.ones(3 * H, device=w_hid.device)
    sign[H : 2 * H] = -1.0
    with torch.no_grad():
        gru.weight_ih_l0.copy_(torch.diag(sign))
        gru.weight_hh_l0.copy_((w_hid * sign).t())
        gru.bias_ih_l0.zero_()
        gru.bias_hh_l0.zero_()
    return gru


def cudnn_gru(x_pre, mask, w_hid, h0):
    """A call that runs cudnn_gru_module's final state, the inputs packed
    by the prefix lengths."""
    import torch

    gru = cudnn_gru_module(w_hid)
    lengths = mask.sum(1).long().cpu()
    packed = torch.nn.utils.rnn.pack_padded_sequence(x_pre, lengths, batch_first=True, enforce_sorted=False)
    h0 = h0[None]  # nn.GRU permutes the state to and from the packed order itself

    def run():
        with torch.no_grad():
            return gru(packed, h0)[1][0]

    return run


def check_gru(B, L, H, seed, path, timed=True, empty_row=False, holes=False):
    """K3 against gru_scan_plain on the card, on ``path``, the path its
    plan must pick and its launch must take (told by the path counters);
    two calls give the same bits."""
    import torch

    from seqrec_tpu_torch.ops.rnn_scan import gru_scan, gru_scan_device_plan, gru_scan_plain

    a = gru_inputs(B, L, H, seed, "cuda", empty_row, holes)
    args = (a["x_pre"], a["mask"], a["w_hid"], a["h0"])
    plan = gru_scan_device_plan(B, H, a["x_pre"].device)
    before = {p: getattr(gru_scan, c) for p, c in K3_COUNTERS.items()}
    got, want = gru_scan(*args), gru_scan_plain(*args)
    took = [p for p, c in K3_COUNTERS.items() if getattr(gru_scan, c) > before[p]]
    same_bits_twice("gru_scan", (B, L, H), (got,), (gru_scan(*args),))
    torch.cuda.synchronize()
    took = took[0] if len(took) == 1 else "l2" if not took else "+".join(took)
    if took != plan[0] or took != path:
        raise AssertionError(f"gru_scan at {(B, L, H)} took the {took} path, plan {plan}, wanted {path}")
    err = (got - want).abs().max().item()
    if not torch.allclose(got, want, rtol=1e-5, atol=1e-5):
        raise AssertionError(f"gru_scan disagrees with its plain version at {(B, L, H)}: max abs err {err}")
    if empty_row and not torch.equal(got[0], a["h0"][0]):
        raise AssertionError("gru_scan changed the state of a row of length 0")
    out = {"kernel": "gru_scan", "shape": {"B": B, "L": L, "H": H}, "plan": list(plan), "max_abs_err": err,
           "tolerance": "rtol 1e-5, atol 1e-5", "same_bits_twice": True}
    if not timed:
        return out
    library = cudnn_gru(*args)
    library_err = (library() - want).abs().max().item()
    flops = 2 * B * L * H * 3 * H
    n_bytes = 4 * (B * L * 3 * H + B * L + 3 * H * H + 2 * B * H)
    bound, bound_by = bound_ms(flops, n_bytes)
    out.update(
        **timings({"kernel": lambda: gru_scan(*args), "plain": lambda: gru_scan_plain(*args), "library": library})[0],
        kernel_back_to_back_ms=back_to_back_ms(lambda: gru_scan(*args)),
        library="torch.nn.GRU (cuDNN), packed; includes a [B*L,3H]x[3H,3H] input product",
        library_max_abs_err=library_err,
        bound_ms=bound, bound_by=bound_by,
    )
    return out


# ----------------------------------------------------------------------
# K1: GRU training scan, forward and backward
# ----------------------------------------------------------------------
def close(got, want, rtol, atol_rel):
    """max |got - want| and whether |got - want| <= atol_rel * max|want|
    + rtol * |want| everywhere."""
    import torch

    err = (got - want).abs().max().item()
    atol = atol_rel * max(want.abs().max().item(), 1e-30)
    return err, bool(torch.allclose(got, want, rtol=rtol, atol=atol))


def cudnn_gru_train(x_pre, mask, w_hid, h0, dh):
    """The cuDNN yardstick for K1: cudnn_gru_module differentiated with
    retain_graph, so its backward can be timed alone. It does not clip the
    hidden cotangent. Returns (run forward, run backward)."""
    import torch

    gru = cudnn_gru_module(w_hid)
    lengths = mask.sum(1).long().cpu()
    x = x_pre.detach().clone().requires_grad_()
    h0 = h0[None].detach().clone().requires_grad_()

    def forward():
        packed = torch.nn.utils.rnn.pack_padded_sequence(x, lengths, batch_first=True, enforce_sorted=False)
        return gru(packed, h0)[1][0]

    out = forward()
    inputs = [x, h0, gru.weight_hh_l0]

    def backward():
        return torch.autograd.grad(out, inputs, dh, retain_graph=True)

    return forward, backward


def same_bits_twice(name, shape, first, again) -> None:
    import torch

    if not all(torch.equal(a, b) for a, b in zip(first, again)):
        raise AssertionError(f"two calls of {name} at {shape} give different bits")


def check_empty_row(name, dx, dh0, dh) -> None:
    """A row of length 0 (row 0) gets no dx and passes dh through to dh0."""
    import torch

    if dx[0].any() or not torch.equal(dh0[0], dh[0]):
        raise AssertionError(f"{name} gave a row of length 0 a gradient")


def cell_lengths(B, L, seed):
    """Prefix lengths drawn as the benchmark cells' traffic draws them
    (benchmark/traffic/l200_b4096.json): a history of 50-400 items, a cut
    at 2 .. n - 1, the last L items of the prefix (mean about 102 at L
    200; the cells read about 105, after rare items are dropped)."""
    rng = np.random.default_rng(seed)
    n = rng.integers(50, 401, size=B)
    return np.minimum(rng.integers(2, n), L)


def k1_blocks_per_sm() -> dict:
    """Blocks an SM holds of K1's reg kernels at 16 rows and of its wide
    kernels at their rows (H 50), forward and backward."""
    from seqrec_tpu_torch.ops.rnn_scan_train import REG_MAX_ROWS, WIDE_ROWS, gru_train_blocks_per_sm

    return {"reg": {d: gru_train_blocks_per_sm("reg", 50, REG_MAX_ROWS, d == "bwd") for d in ("fwd", "bwd")},
            "wide": {d: gru_train_blocks_per_sm("wide", 50, WIDE_ROWS[d == "bwd"], d == "bwd") for d in ("fwd", "bwd")}}


def check_gru_train(B, L, H, clip, seed, timed=True, empty_row=False, holes=False, lengths=None):
    """K1 forward (final state) and backward (dx, dh0, dW) against autograd
    through the plain scan, for a random upstream cotangent dh; both on the
    path their plan picks, each called twice for the same bits; the wide
    path's launches of the four calls (> 0 where the plan takes it)."""
    import torch

    from seqrec_tpu_torch.ops.rnn_scan_train import (
        gru_scan_train_bwd,
        gru_scan_train_fwd,
        gru_scan_train_plain,
        gru_train_plan,
    )

    a = gru_inputs(B, L, H, seed, "cuda", empty_row, holes, lengths)
    x, m, w, h0 = a["x_pre"], a["mask"], a["w_hid"], a["h0"]
    dh = torch.tensor(np.random.default_rng(seed + 100).normal(0, 1, size=(B, H)),
                      dtype=torch.float32, device="cuda")
    wide_before = [gru_scan_train_fwd.wide_launches, gru_scan_train_bwd.wide_launches]
    h_k, hs = gru_scan_train_fwd(x, m, w, h0)
    dx_k, dh0_k, dw_k = gru_scan_train_bwd(x, m, w, hs, dh, clip)
    same_bits_twice("gru_scan_train_fwd", (B, L, H), (h_k, hs), gru_scan_train_fwd(x, m, w, h0))
    same_bits_twice("gru_scan_train_bwd", (B, L, H), (dx_k, dh0_k, dw_k), gru_scan_train_bwd(x, m, w, hs, dh, clip))
    wide = {"fwd": gru_scan_train_fwd.wide_launches - wide_before[0],
            "bwd": gru_scan_train_bwd.wide_launches - wide_before[1]}
    plan = {d: list(gru_train_plan(B, H, x.device, d == "bwd")) for d in ("fwd", "bwd")}
    if any((plan[d][0] == "wide") != (wide[d] == 2) for d in ("fwd", "bwd")):
        raise AssertionError(f"gru_scan_train at {(B, L, H)}: plan {plan}, wide launches {wide}")
    if empty_row:
        check_empty_row("gru_scan_train", dx_k, dh0_k, dh)
        if not torch.equal(h_k[0], h0[0]):
            raise AssertionError("gru_scan_train_fwd changed the state of a row of length 0")
    leaves = [t.clone().requires_grad_() for t in (x, w, h0)]
    h_p = gru_scan_train_plain(leaves[0], m, leaves[1], leaves[2], clip)
    dx_p, dw_p, dh0_p = torch.autograd.grad(h_p, leaves, dh, retain_graph=True)
    torch.cuda.synchronize()
    # f32 with other summation orders: dW sums B*L products per entry
    errs, ok = {}, True
    for name, got, want in (("h", h_k, h_p), ("dx", dx_k, dx_p), ("dh0", dh0_k, dh0_p), ("dW", dw_k, dw_p)):
        errs[name], good = close(got, want.detach(), rtol=1e-4, atol_rel=1e-5)
        ok &= good
    if not ok:
        raise AssertionError(f"gru_scan_train disagrees with its plain version at {(B, L, H, clip)}: {errs}")
    # a clip that binds changes dW against the unclipped plain gradient
    leaves2 = [t.clone().requires_grad_() for t in (x, w, h0)]
    dw_free = torch.autograd.grad(gru_scan_train_plain(leaves2[0], m, leaves2[1], leaves2[2], 0.0), leaves2[1], dh)[0]
    out = {
        "kernel": "gru_scan_train", "shape": {"B": B, "L": L, "H": H}, "grad_clip": clip,
        "plan": plan, "wide_launches": wide,
        "max_abs_err": errs, "clip_moves_dW_by": (dw_p - dw_free).abs().max().item(),
        "tolerance": "rtol 1e-4 + atol 1e-5*max|plain| (f32; dW sums B*L products in another order)",
        "same_bits_twice": True,
    }
    if not timed:
        return out
    fwd_flops = 2 * B * L * H * 3 * H
    fwd_bytes = 4 * (B * L * 3 * H + B * L + 3 * H * H + 2 * B * H + L * B * H)
    bwd_bytes = 4 * (2 * B * L * 3 * H + B * L + 2 * 3 * H * H + L * B * H + 2 * B * H)
    lib_fwd, lib_bwd = cudnn_gru_train(x, m, w, h0, dh)

    def plain_fwd():
        with torch.no_grad():
            return gru_scan_train_plain(x, m, w, h0, clip)

    def plain_bwd():
        return torch.autograd.grad(h_p, leaves, dh, retain_graph=True)

    fwd = lambda: gru_scan_train_fwd(x, m, w, h0)  # noqa: E731
    bwd = lambda: gru_scan_train_bwd(x, m, w, hs, dh, clip)  # noqa: E731
    t_fwd, t_bwd = timings({"kernel": fwd, "plain": plain_fwd, "library": lib_fwd},
                           {"kernel": bwd, "plain": plain_bwd, "library": lib_bwd})
    out["fwd"] = dict(zip(("bound_ms", "bound_by"), bound_ms(fwd_flops, fwd_bytes)), **t_fwd)
    out["bwd"] = dict(train_scan_bwd_bounds(fwd_flops, bwd_bytes, out["plan"]["bwd"][0]), **t_bwd)
    out["library"] = "torch.nn.GRU (cuDNN), packed; forward, and backward alone (no hidden-cotangent clip)"
    return out


# ----------------------------------------------------------------------
# K6 and K5: LSTM eval scan, LSTM training scan forward and backward
# ----------------------------------------------------------------------
def lstm_inputs(B, L, H, seed, device, empty_row=False, holes=False, lengths=None):
    """Random LSTM scan inputs; ``lengths`` (prefix lengths) replaces the
    drawn ones."""
    import torch

    rng = np.random.default_rng(seed)
    drawn = rng.integers(1, L + 1, size=B)
    lengths = drawn if lengths is None else np.asarray(lengths)
    if empty_row:
        lengths[0] = 0  # keeps (h0, c0)
    mask = np.arange(L)[None, :] < lengths[:, None]
    if holes:
        mask[:, [3, 7]] = False  # interior steps skipped: (h, c) carried through
    arrays = {
        "x_pre": rng.normal(0.0, 0.5, size=(B, L, 4 * H)),
        "mask": mask,
        "w_hid": rng.normal(0.0, 0.1, size=(H, 4 * H)),
        "peep": rng.normal(0.0, 0.1, size=(3, H)),
        "h0": rng.normal(0.0, 0.1, size=(B, H)),
        "c0": rng.normal(0.0, 0.1, size=(B, H)),
    }
    return {k: torch.tensor(v, dtype=torch.float32, device=device) for k, v in arrays.items()}


def cudnn_lstm_module(w_hid):
    """torch.nn.LSTM (cuDNN) with identity input weights, zero biases and
    W_hh = W_hid^T (the same i|f|g|o gate order): the kernels' LSTM
    without its peepholes and its clip. It also does a [B*L, 4H] x [4H, 4H]
    input product the kernels do not. A nearby function, not the same."""
    import torch

    H = w_hid.shape[0]
    lstm = torch.nn.LSTM(4 * H, H, batch_first=True).to(w_hid.device)
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(torch.eye(4 * H, device=w_hid.device))
        lstm.weight_hh_l0.copy_(w_hid.t())
        lstm.bias_ih_l0.zero_()
        lstm.bias_hh_l0.zero_()
    return lstm


def cudnn_lstm(a, requires_grad=False):
    """(forward, module inputs) of cudnn_lstm_module's final state, the
    inputs packed by the prefix lengths (rows of length >= 1)."""
    import torch

    lstm = cudnn_lstm_module(a["w_hid"])
    lengths = a["mask"].sum(1).long().cpu()
    x = a["x_pre"].detach().clone().requires_grad_(requires_grad)
    state = tuple(a[k][None].detach().clone().requires_grad_(requires_grad) for k in ("h0", "c0"))

    def forward():
        packed = torch.nn.utils.rnn.pack_padded_sequence(x, lengths, batch_first=True, enforce_sorted=False)
        return lstm(packed, state)[1][0][0]

    return forward, [x, *state, lstm.weight_hh_l0]


def check_lstm(B, L, H, seed, path, timed=True, empty_row=False, holes=False):
    """K6 against lstm_scan_plain on the card, on ``path``, the path its
    plan must pick and its launch must take; two calls give the same
    bits."""
    import torch

    from seqrec_tpu_torch.ops.rnn_scan import lstm_scan, lstm_scan_plain, lstm_scan_plan

    a = lstm_inputs(B, L, H, seed, "cuda", empty_row, holes)
    args = (a["x_pre"], a["mask"], a["w_hid"], a["peep"], a["h0"], a["c0"])
    plan = lstm_scan_plan(B, H, a["x_pre"].device)
    before = (lstm_scan.reg_launches, lstm_scan.cluster_launches)
    got, want = lstm_scan(*args), lstm_scan_plain(*args)
    same_bits_twice("lstm_scan", (B, L, H), (got,), (lstm_scan(*args),))
    torch.cuda.synchronize()
    took = {0: "l2", 1: "reg", 2: "cluster"}[
        (lstm_scan.reg_launches > before[0]) + 2 * (lstm_scan.cluster_launches > before[1])]
    if took != plan[0] or took != path:
        raise AssertionError(f"lstm_scan at {(B, L, H)} took the {took} path, plan {plan}, wanted {path}")
    err = (got - want).abs().max().item()
    if not torch.allclose(got, want, rtol=1e-5, atol=1e-5):
        raise AssertionError(f"lstm_scan disagrees with its plain version at {(B, L, H)}: max abs err {err}")
    if empty_row and not torch.equal(got[0], a["h0"][0]):
        raise AssertionError("lstm_scan changed the state of a row of length 0")
    out = {"kernel": "lstm_scan", "shape": {"B": B, "L": L, "H": H}, "plan": list(plan), "max_abs_err": err,
           "tolerance": "rtol 1e-5, atol 1e-5", "same_bits_twice": True}
    if not timed:
        return out
    library = cudnn_lstm(a)[0]
    flops = 2 * B * L * H * 4 * H
    n_bytes = 4 * (B * L * 4 * H + B * L + 4 * H * H + 3 * H + 3 * B * H)

    def lib():
        with torch.no_grad():
            return library()

    out.update(
        dict(zip(("bound_ms", "bound_by"), bound_ms(flops, n_bytes))),
        **timings({"kernel": lambda: lstm_scan(*args), "plain": lambda: lstm_scan_plain(*args), "library": lib})[0],
        library="torch.nn.LSTM (cuDNN), packed; no peepholes; includes a [B*L,4H]x[4H,4H] input product",
    )
    return out


def check_lstm_train(B, L, H, clip, seed, timed=True, empty_row=False, holes=False, lengths=None):
    """K5 forward (final state) and backward (dx, dW, dpeep, dh0, dc0)
    against autograd through the plain scan, for a random upstream
    cotangent dh; both on the path their plan picks, each called twice for
    the same bits; the wide path's launches of the four calls (> 0 where
    the plan takes it)."""
    import torch

    from seqrec_tpu_torch.ops.lstm_scan_train import (
        lstm_scan_train_bwd,
        lstm_scan_train_fwd,
        lstm_scan_train_plain,
        lstm_train_plan,
    )

    a = lstm_inputs(B, L, H, seed, "cuda", empty_row, holes, lengths)
    x, m, w, p, h0, c0 = (a[k] for k in ("x_pre", "mask", "w_hid", "peep", "h0", "c0"))
    dh = torch.tensor(np.random.default_rng(seed + 100).normal(0, 1, size=(B, H)),
                      dtype=torch.float32, device="cuda")
    wide_before = [lstm_scan_train_fwd.wide_launches, lstm_scan_train_bwd.wide_launches]
    h_k, hs, cs = lstm_scan_train_fwd(x, m, w, p, h0, c0)
    grads_k = lstm_scan_train_bwd(x, m, w, p, hs, cs, dh, clip)
    same_bits_twice("lstm_scan_train_fwd", (B, L, H), (h_k, hs, cs), lstm_scan_train_fwd(x, m, w, p, h0, c0))
    same_bits_twice("lstm_scan_train_bwd", (B, L, H), grads_k, lstm_scan_train_bwd(x, m, w, p, hs, cs, dh, clip))
    wide = {"fwd": lstm_scan_train_fwd.wide_launches - wide_before[0],
            "bwd": lstm_scan_train_bwd.wide_launches - wide_before[1]}
    plan = {d: list(lstm_train_plan(B, H, x.device, d == "bwd")) for d in ("fwd", "bwd")}
    if any((plan[d][0] == "wide") != (wide[d] == 2) for d in ("fwd", "bwd")):
        raise AssertionError(f"lstm_scan_train at {(B, L, H)}: plan {plan}, wide launches {wide}")
    if empty_row:
        check_empty_row("lstm_scan_train", grads_k[0], grads_k[3], dh)
        if grads_k[4][0].any() or not torch.equal(h_k[0], h0[0]):
            raise AssertionError("lstm_scan_train changed a row of length 0 or gave it a dc0")
    leaves = [t.clone().requires_grad_() for t in (x, w, p, h0, c0)]
    h_p = lstm_scan_train_plain(leaves[0], m, *leaves[1:], clip)
    grads_p = torch.autograd.grad(h_p, leaves, dh, retain_graph=True)
    torch.cuda.synchronize()
    # f32 with other summation orders: dW and dpeep sum B*L products per entry
    names = ("dx", "dW", "dpeep", "dh0", "dc0")
    errs, ok = {}, True
    for name, got, want in (("h", h_k, h_p), *zip(names, grads_k, grads_p)):
        errs[name], good = close(got, want.detach(), rtol=1e-4, atol_rel=1e-5)
        ok &= good
    if not ok:
        raise AssertionError(f"lstm_scan_train disagrees with its plain version at {(B, L, H, clip)}: {errs}")
    # a clip that binds changes dW against the unclipped plain gradient
    leaves2 = [t.clone().requires_grad_() for t in (x, w, p, h0, c0)]
    free = lstm_scan_train_plain(leaves2[0], m, *leaves2[1:], 0.0)
    dw_free = torch.autograd.grad(free, leaves2[1], dh)[0]
    out = {
        "kernel": "lstm_scan_train", "shape": {"B": B, "L": L, "H": H}, "grad_clip": clip,
        "plan": plan, "wide_launches": wide, "same_bits_twice": True, "max_abs_err": errs,
        "clip_moves_dW_by": (grads_p[1] - dw_free).abs().max().item(),
        "tolerance": "rtol 1e-4 + atol 1e-5*max|plain| (f32; dW and dpeep sum B*L products in another order)",
    }
    if not timed:
        return out
    flops = 2 * B * L * H * 4 * H
    fwd_bytes = 4 * (B * L * 4 * H + B * L + 4 * H * H + 3 * H + 3 * B * H + 2 * L * B * H)
    bwd_bytes = 4 * (2 * B * L * 4 * H + B * L + 2 * 4 * H * H + 2 * 3 * H + 2 * L * B * H + 3 * B * H)
    lib_fwd, lib_inputs = cudnn_lstm(a, requires_grad=True)
    lib_out = lib_fwd()

    def lib_bwd():
        return torch.autograd.grad(lib_out, lib_inputs, dh, retain_graph=True)

    def plain_fwd():
        with torch.no_grad():
            return lstm_scan_train_plain(x, m, w, p, h0, c0, clip)

    def plain_bwd():
        return torch.autograd.grad(h_p, leaves, dh, retain_graph=True)

    fwd = lambda: lstm_scan_train_fwd(x, m, w, p, h0, c0)  # noqa: E731
    bwd = lambda: lstm_scan_train_bwd(x, m, w, p, hs, cs, dh, clip)  # noqa: E731
    t_fwd, t_bwd = timings({"kernel": fwd, "plain": plain_fwd, "library": lib_fwd},
                           {"kernel": bwd, "plain": plain_bwd, "library": lib_bwd})
    out["fwd"] = dict(zip(("bound_ms", "bound_by"), bound_ms(flops, fwd_bytes)), **t_fwd)
    out["bwd"] = dict(train_scan_bwd_bounds(flops, bwd_bytes, out["plan"]["bwd"][0]), **t_bwd)
    out["library"] = ("torch.nn.LSTM (cuDNN), packed; forward, and backward alone; no peepholes, no clip, "
                      "an extra [B*L,4H]x[4H,4H] input product")
    return out


def check_lstm_tower():
    """A 2-layer bidirectional LSTM tower ([16, 12]) on the card against the
    same tower on the CPU: eval forward (plain first layer, K6 last) and
    the training forward and gradients (plain first layer, K5 last)."""
    import torch

    from seqrec_tpu_torch.models.recurrent import RecurrentLayers

    n_ids, B, L = 300, 48, 20
    rng = np.random.default_rng(31)
    params = RecurrentLayers("LSTM", [16, 12], True).init_params(rng, n_ids)
    flat = {}
    for key, val in params.items():
        for name, arr in (val.items() if isinstance(val, dict) else [(None, val)]):
            flat[key if name is None else f"{key}.{name}"] = torch.from_numpy(arr)
    ids = rng.integers(0, n_ids, size=(B, L, 1)).astype(np.int32)
    lengths = rng.integers(1, L + 1, size=B)
    mask = (np.arange(L)[None, :] < lengths[:, None]).astype(np.float32)
    ct = rng.normal(size=(B, 24)).astype(np.float32)
    results = {}
    for device in ("cpu", "cuda"):
        tower = RecurrentLayers("LSTM", [16, 12], True)
        tower.build(n_ids, device)
        tower.load_state_dict({k: v.to(device) for k, v in flat.items()})
        inputs = (torch.from_numpy(ids).to(device), torch.from_numpy(mask).to(device))
        with torch.no_grad():
            ev = tower(*inputs)
        tr = tower(*inputs, train=True)
        grads = torch.autograd.grad(tr, list(tower.parameters()), torch.from_numpy(ct).to(device))
        results[device] = [t.detach().cpu() for t in (ev, tr, *grads)]
    names = ["eval", "train"] + [n for n, _ in tower.named_parameters()]
    errs, ok = {}, True
    for name, got, want in zip(names, results["cuda"], results["cpu"]):
        errs[name], good = close(got, want, rtol=1e-4, atol_rel=1e-5)
        ok &= good
    if not ok:
        raise AssertionError(f"the bidirectional LSTM tower differs between cuda and cpu: {errs}")
    return {"check": "bidirectional LSTM tower [16, 12], cuda vs cpu", "max_abs_err": max(errs.values()),
            "tolerance": "rtol 1e-4 + atol 1e-5*max|cpu|"}


# ----------------------------------------------------------------------
# the gather-sum pair (not a Pallas kernel: XLA in the JAX package)
# ----------------------------------------------------------------------
def real_batch_ids(argv, ds_dir, n_batches=1) -> list:
    """(rows of the input table, [(ids [B, L, F], prefix lengths [B])]) of
    the first ``n_batches`` training batches of the CLI's predictor on
    ``ds_dir``, as its packed batcher draws them (generator seed 1, as
    steady_state's; the compact wire's dtype, id 0 at every padded step)."""
    import seqrec_tpu_torch.utils.command_parser as parse
    from seqrec_tpu_torch.data import DataHandler

    args = parse.command_parser(parse.predictor_command_parser, argv=argv)
    args.device = "cpu"
    model = parse.get_predictor(args)
    dataset = DataHandler(ds_dir)
    model.prepare_model(dataset)
    model.set_dataset(dataset)
    gen = model._gen_packed_mini_batch(dataset.training_set, np.random.default_rng(1))
    return model._input_size(), [(b["ids"], b["lengths"]) for b in (next(gen) for _ in range(n_batches))]


def id_runs(ids, lengths) -> dict:
    """What the batch's ids ask of the backward: slots, distinct ids, the
    slots at id 0 (padded steps and real ones), the longest run of one id."""
    valid = np.arange(ids.shape[1])[None, :] < lengths[:, None]
    flat = ids[..., 0]
    counts = np.bincount(ids[ids >= 0].astype(np.int64))
    return {"slots": int(ids.size), "distinct_ids": int((counts > 0).sum()),
            "id0_slots": int((flat == 0).sum()), "id0_padded_slots": int(((flat == 0) & ~valid).sum()),
            "longest_run": int(counts.max()), "longest_run_id": int(counts.argmax())}


def two_slot_ids(ids, lengths, n_items, seed=69):
    """(ids [B, L, 2], id_mask [B, L, 2]) from a one-slot batch: the second
    slot a rating bucket (n_items + 0..9, as --rating features give), a pad
    slot (-1) on every third step and past each prefix, and an id_mask of
    the prefix mask times uniform weights."""
    rng = np.random.default_rng(seed)
    valid = np.arange(ids.shape[1])[None, :] < lengths[:, None]
    second = n_items + rng.integers(0, 10, size=ids.shape[:2])
    second[:, ::3] = -1
    second[~valid] = -1
    both = np.stack([ids[..., 0].astype(np.int32), second.astype(np.int32)], axis=-1)
    id_mask = valid[..., None] * rng.uniform(0.5, 1.5, size=both.shape)
    return both, id_mask.astype(np.float32)


def check_gather_sum(ids, D, N, seed, id_mask=None, timed=True):
    """The gather-sum kernels against the plain version (ops/core.py:
    gather_sum under autograd, whose CUDA backward is PyTorch's
    indexing_backward_kernel): the forward bit for bit at F=1 (at F=2 to
    rtol 1e-6), the table gradient within rtol 1e-5 + atol 1e-5*max|plain|
    (f32 sums of up to ~10^4 rows in another order), the same bits on two
    calls, and the autograd wrapper giving the kernels' own gradient.
    Timed: the forward; the backward as one call (its order kernel, chunk
    sums and dense rows), with its device time split by kernel and every
    kernel of its trace one of the port's own (no sort, no PyTorch op);
    the plain version, the library calls (the forward: one
    ``F.embedding_bag(mode="sum", per_sample_weights=...)`` with the pad
    slots at id 0 and weight 0; the backward: the plain version's) and
    index_add_."""
    import torch
    import torch.nn.functional as nnf

    from seqrec_tpu_torch.ops.core import gather_sum as plain
    from seqrec_tpu_torch.ops.gather_sum import (
        gather_sum,
        gather_sum_fwd,
        gather_sum_table_grad,
    )

    rng = np.random.default_rng(seed)
    F = ids.shape[-1]
    ids_t = torch.from_numpy(np.ascontiguousarray(ids)).cuda()
    m = None if id_mask is None else torch.tensor(id_mask, dtype=torch.float32, device="cuda")
    table = torch.tensor(rng.normal(0.0, 0.1, (N, D)), dtype=torch.float32, device="cuda")
    g = torch.tensor(rng.normal(size=(*ids.shape[:-1], D)), dtype=torch.float32, device="cuda")
    out_k = gather_sum_fwd(table, ids_t, m)
    dt_k = gather_sum_table_grad(g, ids_t, m, N)
    same_bits_twice("gather_sum_fwd", ids.shape, (out_k,), (gather_sum_fwd(table, ids_t, m),))
    same_bits_twice("gather_sum_bwd", ids.shape, (dt_k,), (gather_sum_table_grad(g, ids_t, m, N),))
    leaf = table.clone().requires_grad_()
    dt_w = torch.autograd.grad(gather_sum(leaf, ids_t, m), leaf, g)[0]
    out_p = plain(leaf, ids_t, m)
    dt_p = torch.autograd.grad(out_p, leaf, g, retain_graph=True)[0]
    torch.cuda.synchronize()
    if not torch.equal(dt_w, dt_k):
        raise AssertionError(f"gather_sum's autograd backward differs from its kernels at {ids.shape}")
    fwd_err, fwd_ok = close(out_k, out_p.detach(), rtol=1e-6, atol_rel=1e-6)
    if not (torch.equal(out_k, out_p) if F == 1 else fwd_ok):
        raise AssertionError(f"gather_sum_fwd disagrees with its plain version at {ids.shape}: {fwd_err}")
    bwd_err, bwd_ok = close(dt_k, dt_p, rtol=1e-5, atol_rel=1e-5)
    if not bwd_ok:
        raise AssertionError(f"gather_sum_bwd disagrees with its plain version at {ids.shape}: {bwd_err}")
    out = {"kernel": "gather_sum", "shape": {"ids": list(ids.shape), "ids_dtype": str(ids.dtype), "D": D, "N": N},
           "max_abs_err": {"fwd": fwd_err, "bwd": bwd_err}, "fwd_bit_equal": F == 1, "same_bits_twice": True,
           "tolerance": "fwd bit-equal at F=1, else rtol 1e-6; table gradient rtol 1e-5 + atol 1e-5*max|plain| "
                        "(f32 sums of up to ~10^4 rows in another order)"}
    if not timed:
        return out
    P0 = int(np.prod(ids.shape[:-1]))
    valid = ids >= 0
    id_bytes = ids.dtype.itemsize * ids.size + (4 * ids.size if id_mask is not None else 0)
    fwd_bytes = 4 * D * (len(np.unique(ids[valid])) + P0) + id_bytes
    bwd_bytes = 4 * D * (P0 + N) + id_bytes
    flops = 2 * int(valid.sum()) * D

    def plain_fwd():
        with torch.no_grad():
            return plain(table, ids_t, m)

    def plain_bwd():
        return torch.autograd.grad(out_p, leaf, g, retain_graph=True)

    fwd = lambda: gather_sum_fwd(table, ids_t, m)  # noqa: E731
    bwd = lambda: gather_sum_table_grad(g, ids_t, m, N)  # noqa: E731
    # the library's one call for the forward: fixed-size bags of F ids, each
    # slot weighted by its mask (a pad slot: id 0, weight 0)
    bag_ids = ids_t.reshape(-1, F).clamp_min(0).long()
    bag_w = (ids_t >= 0).float().reshape(-1, F) * (1.0 if m is None else m.reshape(-1, F))
    bag = lambda: nnf.embedding_bag(bag_ids, table, mode="sum", per_sample_weights=bag_w)  # noqa: E731
    bag_err = (bag().reshape(out_k.shape) - out_k).abs().max().item()

    # index_add_ over the real slots' rows (times their mask), gathered outside the timing
    keep = ids_t.reshape(-1) >= 0
    flat_ids = ids_t.reshape(-1)[keep].long()
    rows = g.unsqueeze(-2).expand(*ids.shape, D) * (1.0 if m is None else m.unsqueeze(-1))
    rows = rows.reshape(-1, D)[keep].contiguous()
    index_add = lambda: torch.zeros(N, D, device="cuda").index_add_(0, flat_ids, rows)  # noqa: E731

    def bwd_parts(fn):
        fn()
        events = {}
        for key, ms in device_events(fn, reps=20).items():
            events[kernel_name(key)] = events.get(kernel_name(key), 0.0) + ms / 20
        foreign = set(events) - port_kernel_names()
        if foreign:
            raise AssertionError(f"gather_sum_bwd ran kernels that are not the port's at {ids.shape}: {sorted(foreign)}")
        return dict(kernel_ms=time_ms(fn), kernel_device_ms=sum(events.values()),
                    kernel_device_ms_by_kernel=dict(sorted(events.items(), key=lambda kv: -kv[1])))
    t_fwd, t_bwd = timings({"kernel": fwd, "plain": plain_fwd, "library": bag},
                           {"plain": plain_bwd, "index_add": index_add})
    out["fwd"] = dict(
        zip(("bound_ms", "bound_by"), bound_ms(flops, fwd_bytes)), **t_fwd, library_max_abs_err=bag_err,
        library="F.embedding_bag(mode='sum', per_sample_weights=mask) over [P0, F] bags",
    )
    out["bwd"] = dict(
        zip(("bound_ms", "bound_by"), bound_ms(flops, bwd_bytes)), **bwd_parts(bwd), **t_bwd,
        library_ms=t_bwd["plain_ms"], library_device_ms=t_bwd["plain_device_ms"],
        library="the plain version's backward (autograd of table[ids]: indexing_backward_kernel)",
        index_add="one index_add_ of the real slots' rows times their mask, gathered beforehand",
    )
    return out


# ----------------------------------------------------------------------
# K2: streaming CCE stats and gradients
# ----------------------------------------------------------------------
def check_cce(B, H, N, seed, timed=True, foreign=False):
    """K2 stats (m, s) and grads (dh, dW, db) against the plain dense
    versions, for in-range targets and a random upstream cotangent. With
    ``foreign``, every other row's target is -1, another shard's under a
    mesh (sharded_streaming_cce): it matches no column."""
    import torch
    import torch.nn.functional as F

    from seqrec_tpu_torch.ops.streaming_cce import cce_grads, cce_grads_plain, cce_stats, cce_stats_plain

    a = topk_inputs(B, H, N, 1, seed, "cuda")
    h, w, b = a["h"], a["w_out"], a["b_out"]
    rng = np.random.default_rng(seed + 100)
    targets = torch.tensor(rng.integers(0, N, size=B), dtype=torch.int32, device="cuda")
    if foreign:
        targets[1::2] = -1
    g = torch.tensor(rng.uniform(0.5, 1.5, size=B) / B, dtype=torch.float32, device="cuda")
    g[0] = 0.0  # a row with no cotangent contributes nothing
    m_k, s_k = cce_stats(h, w, b)
    m_again, s_again = cce_stats(h, w, b)
    m_p, s_p = cce_stats_plain(h, w, b)
    logz = m_p + torch.log(s_p)
    grads_k = cce_grads(h, w, b, targets, logz, g)
    grads_again = cce_grads(h, w, b, targets, logz, g)
    grads_p = cce_grads_plain(h, w, b, targets, logz, g)
    torch.cuda.synchronize()
    errs, ok = {}, True
    for name, got, want in (("m", m_k, m_p), ("s", s_k, s_p), *zip(("dh", "dW", "db"), grads_k, grads_p)):
        errs[name], good = close(got, want, rtol=1e-4, atol_rel=1e-5)
        ok &= good
    if not ok:
        raise AssertionError(f"streaming cce disagrees with its plain version at {(B, H, N)}: {errs}")
    if not all(torch.equal(x, y) for x, y in zip(grads_k, grads_again)):
        raise AssertionError(f"two calls of cce_grads at {(B, H, N)} give different bits")
    if not (torch.equal(m_k, m_again) and torch.equal(s_k, s_again)):
        raise AssertionError(f"two calls of cce_stats at {(B, H, N)} give different bits")
    if grads_k[0][0].any():
        raise AssertionError("cce_grads gave a row with g = 0 a gradient")
    if foreign:  # a row with target -1 gets g * softmax, the dense one-hot of no column
        p = torch.softmax(h @ w + b, dim=1)
        want_db = (g[:, None] * p).sum(0) - torch.zeros_like(b).index_add_(
            0, targets[::2].long(), g[::2])
        if not close(grads_k[2], want_db, rtol=1e-4, atol_rel=1e-5)[1]:
            raise AssertionError(f"cce_grads matched a column for target -1 at {(B, H, N)}")
    out = {
        "kernel": "streaming_cce", "shape": {"B": B, "H": H, "N": N, "foreign_targets": foreign},
        "max_abs_err": errs,
        "tolerance": "rtol 1e-4 + atol 1e-5*max|plain| (3xTF32 products; sums over N or B in another order)",
        "stats_same_bits_twice": True, "grads_same_bits_twice": True, "g0_row_dh_zero": True,
    }
    if not timed:
        return out
    tl = targets.long()

    def lib_stats():
        return torch.logsumexp(h @ w + b, dim=1)

    leaves = [t.clone().requires_grad_() for t in (h, w, b)]

    def lib_grads():
        loss = (F.cross_entropy(leaves[0] @ leaves[1] + leaves[2], tl, reduction="none") * g).sum()
        return torch.autograd.grad(loss, leaves)

    stats = lambda: cce_stats(h, w, b)  # noqa: E731
    grads = lambda: cce_grads(h, w, b, targets, logz, g)  # noqa: E731
    plain_stats = lambda: cce_stats_plain(h, w, b)  # noqa: E731
    plain_grads = lambda: cce_grads_plain(h, w, b, targets, logz, g)  # noqa: E731
    t_stats, t_grads = timings({"kernel": stats, "plain": plain_stats, "library": lib_stats},
                               {"kernel": grads, "plain": plain_grads, "library": lib_grads})
    out["stats"] = dict(product_bounds(2 * B * H * N, 4 * (B * H + H * N + N + 2 * B)), **t_stats)
    # three products (6 B H N)
    out["grads"] = dict(product_bounds(6 * B * H * N, 4 * (2 * (B * H + H * N + N) + 3 * B)), **t_grads)
    out["library"] = "stats: torch.logsumexp(h@W+b); grads: autograd of g-weighted F.cross_entropy on h@W+b (forward included)"
    return out


# ----------------------------------------------------------------------
# HSTU's causal pointwise attention, forward and backward
# ----------------------------------------------------------------------
def hstu_cell_lengths(B, L, seed):
    """Prefix lengths drawn as the HSTU cell's traffic draws them
    (benchmark/traffic/l200_b512.json): a history of 20-300 items, a cut
    at 2 .. n - 1, the last L items of the prefix."""
    rng = np.random.default_rng(seed)
    n = rng.integers(20, 301, size=B)
    return np.minimum(rng.integers(2, n), L)


def hstu_attention_work(lengths, heads, dqk, dv):
    """(matrix flops forward, bytes forward, bytes backward) of the
    attention over rows of ``lengths`` valid steps: m (m + 1) / 2 causal
    pairs a row and head, 2 (dqk + dv) flops a pair forward; Q, K, V and O
    forward, and Q, K, V, dO, dQ, dK, dV backward, at the valid steps."""
    m = np.asarray(lengths, dtype=np.float64)
    pairs = float((m * (m + 1) / 2).sum()) * heads
    steps = float(m.sum()) * heads
    return 2 * pairs * (dqk + dv), 4 * steps * (2 * dqk + 2 * dv), 4 * steps * (4 * dqk + 3 * dv)


def check_hstu_attention(B, L, heads, dqk, dv, seed, lengths=None, timed=True, empty_row=False):
    """The attention's forward (O) and backward (dQ, dK, dV, dbias) kernels
    against autograd through the plain version in float64, for q, k, v
    taken as views of one SiLU projection's output (as the tower passes
    them), a random bias and upstream cotangent; both called twice for the
    same bits, their launch counters risen by two each."""
    import torch

    from seqrec_tpu_torch.ops.hstu_attention import (
        hstu_attention_bwd,
        hstu_attention_fwd,
        hstu_attention_plain,
    )

    rng = np.random.default_rng(seed)
    if lengths is None:
        lengths = rng.integers(0 if empty_row else 1, L + 1, size=B)
        lengths[-1] = L
    if empty_row:
        lengths[0] = 0
    dev = "cuda"
    uvqk = torch.nn.functional.silu(torch.tensor(rng.normal(0, 1, size=(B, L, heads * (2 * dqk + 2 * dv))),
                                                 dtype=torch.float32, device=dev))
    v, q, k = torch.split(uvqk[..., heads * dv:], [heads * dv, heads * dqk, heads * dqk], dim=-1)
    bias = torch.tensor(rng.normal(0, 0.5, size=L), dtype=torch.float32, device=dev)
    m = torch.tensor(lengths, dtype=torch.int32, device=dev)
    dout = torch.tensor(rng.normal(0, 1, size=(B, L, heads * dv)), dtype=torch.float32, device=dev)
    scale = 1.0 / L
    before = [hstu_attention_fwd.launches, hstu_attention_bwd.launches]
    o_k = hstu_attention_fwd(q, k, v, bias, m, heads, scale)
    grads_k = hstu_attention_bwd(q, k, v, bias, m, heads, scale, dout)
    same_bits_twice("hstu_attention_fwd", (B, L), (o_k,), (hstu_attention_fwd(q, k, v, bias, m, heads, scale),))
    same_bits_twice("hstu_attention_bwd", (B, L), grads_k, hstu_attention_bwd(q, k, v, bias, m, heads, scale, dout))
    if [hstu_attention_fwd.launches - before[0], hstu_attention_bwd.launches - before[1]] != [2, 2]:
        raise AssertionError("the hstu_attention launch counters did not rise by 2 each")
    leaves = [t.detach().double().requires_grad_() for t in (q, k, v, bias)]
    o_p = hstu_attention_plain(*leaves[:3], leaves[3], m, heads, scale)
    grads_p = torch.autograd.grad(o_p, leaves, dout.double())
    torch.cuda.synchronize()
    errs, ok = {}, True
    for name, got, want in (("o", o_k, o_p), *zip(("dq", "dk", "dv", "dbias"), grads_k, grads_p)):
        errs[name], good = close(got.double(), want.detach(), rtol=1e-4, atol_rel=1e-5)
        ok &= good
    if not ok:
        raise AssertionError(f"hstu_attention disagrees with its plain version at {(B, L, heads, dqk, dv)}: {errs}")
    pad = torch.arange(L, device=dev)[None, :, None] >= m[:, None, None].long()
    if o_k.masked_select(pad).any() or any(g.masked_select(pad).any() for g in grads_k[:3]):
        raise AssertionError("hstu_attention gave a padded step an output or a gradient")
    out = {
        "kernel": "hstu_attention", "shape": {"B": B, "L": L, "heads": heads, "dqk": dqk, "dv": dv},
        "mean_length": float(np.mean(lengths)), "max_abs_err": errs,
        "tolerance": "rtol 1e-4 + atol 1e-5*max|plain| against the plain version in float64 (3xTF32 products; "
                     "dbias sums B*heads*pairs terms)",
        "same_bits_twice": True, "padded_steps_zero": True,
    }
    if not timed:
        return out
    fwd_flops, fwd_bytes, bwd_bytes = hstu_attention_work(lengths, heads, dqk, dv)
    leaves32 = [t.detach().clone().requires_grad_() for t in (q, k, v, bias)]
    o_32 = hstu_attention_plain(*leaves32[:3], leaves32[3], m, heads, scale)

    def plain_fwd():
        with torch.no_grad():
            return hstu_attention_plain(q, k, v, bias, m, heads, scale)

    def plain_bwd():
        return torch.autograd.grad(o_32, leaves32, dout, retain_graph=True)

    fwd = lambda: hstu_attention_fwd(q, k, v, bias, m, heads, scale)  # noqa: E731
    bwd = lambda: hstu_attention_bwd(q, k, v, bias, m, heads, scale, dout)  # noqa: E731
    t_fwd, t_bwd = timings({"kernel": fwd, "plain": plain_fwd}, {"kernel": bwd, "plain": plain_bwd})
    out["fwd"] = dict(product_bounds(fwd_flops, fwd_bytes), **t_fwd, library_ms=None)
    out["bwd"] = dict(product_bounds(2 * fwd_flops, bwd_bytes), **t_bwd, library_ms=None)
    out["library"] = "none: no PyTorch call computes a pointwise (SiLU, no softmax) attention"
    return out


def check_hstu_tower(lengths, L, hidden, blocks, heads, dqk, dv, seed, slots=1, dev="cuda"):
    """The HSTU tower (``models/hstu.py``) on packed tokens, on ``dev``
    (the attention kernels on the card), against the same parameters in
    float64 on the CPU (the attention's plain version): the last valid
    step's output and every leaf's gradient, the output at every step
    (zeros at the padded steps but an empty row's step 0), the attention's
    launch counters and the tower's token counters, which rise by
    sum(max(m, 1)) and B L a forward. ``slots`` id slots a step, with an
    id_mask where there are more than one."""
    import copy

    import torch

    from seqrec_tpu_torch.models.hstu import HSTULayers
    from seqrec_tpu_torch.ops.hstu_attention import hstu_attention_bwd, hstu_attention_fwd

    n_items = 300
    B = len(lengths)
    tower = HSTULayers(hidden, blocks, heads, dqk, dv, L)
    tower.build(n_items, "cpu")
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in tower.parameters():
            p.copy_(0.3 * torch.randn(p.shape, generator=g))
    want_tower = copy.deepcopy(tower).double()
    tower.to(dev)
    m = torch.tensor(np.asarray(lengths), dtype=torch.int64)
    mask = (torch.arange(L)[None, :] < m[:, None]).float()
    ids = torch.randint(0, n_items, (B, L, slots), generator=g).int()
    id_mask = torch.rand(B, L, slots, generator=g) if slots > 1 else None
    up = torch.randn(B, hidden, generator=g)
    before = [hstu_attention_fwd.launches, hstu_attention_bwd.launches, tower.tokens_run, tower.tokens_padded]
    dev_args = (ids.to(dev), mask.to(dev), None if id_mask is None else id_mask.to(dev))
    got = tower(*dev_args)
    got_grads = torch.autograd.grad((got * up.to(dev)).sum(), list(tower.parameters()))
    got_every = tower(*dev_args, only_return_final=False).detach()
    T = int(torch.clamp(m, min=1).sum())
    counted = [tower.tokens_run - before[2], tower.tokens_padded - before[3]]
    if counted != [2 * T, 2 * B * L]:
        raise AssertionError(f"the HSTU tower counted {counted} tokens in two forwards, not {[2 * T, 2 * B * L]}")
    ran = [hstu_attention_fwd.launches - before[0], hstu_attention_bwd.launches - before[1]]
    if dev == "cuda" and ran != [2 * blocks, blocks]:
        raise AssertionError(f"the HSTU tower launched the attention kernels {ran} times, not {[2 * blocks, blocks]}")
    cpu_args = (ids, mask.double(), None if id_mask is None else id_mask.double())
    want = want_tower(*cpu_args)
    want_grads = torch.autograd.grad((want * up.double()).sum(), list(want_tower.parameters()))
    want_every = want_tower(*cpu_args, only_return_final=False).detach()
    errs, ok = {}, True
    for name, a, b in (("out", got, want), ("every_step", got_every, want_every),
                       *zip((n for n, _ in tower.named_parameters()), got_grads, want_grads)):
        errs[name], good = close(a.detach().cpu().double(), b.detach(), rtol=1e-4, atol_rel=1e-5)
        ok &= good
    if not ok:
        raise AssertionError(f"the HSTU tower disagrees with the CPU's at {(B, L, heads, dqk, dv)}: {errs}")
    kept = torch.arange(L)[None, :] < torch.clamp(m, min=1)[:, None]
    if got_every.cpu()[~kept].any():
        raise AssertionError("the HSTU tower gave a padded step an output")
    return {
        "model": "hstu_tower", "shape": {"B": B, "L": L, "d": hidden, "blocks": blocks, "heads": heads,
                                         "dqk": dqk, "dv": dv, "slots": slots},
        "tokens_run_share": counted[0] / counted[1], "max_abs_err": errs,
        "tolerance": "rtol 1e-4 + atol 1e-5*max|cpu| against the same parameters in float64 on the CPU",
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
    """K4 against its plain version; timed, also the wrapper's operand
    pad alone (rows of a multiple of 4 floats), which its times include."""
    import torch

    from seqrec_tpu_torch.ops.core import rows_16b
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
        n_bytes = 4 * (B * H + H * N + N + 2 * B * S + 2 * B * k)
        out.update(
            product_bounds(2 * B * H * N, n_bytes),
            **timings({"kernel": lambda: fused_score_topk(*args, k=k),
                       "plain": lambda: fused_score_topk_plain(*args, k=k), "library": lambda: torch_topk(*args, k),
                       "pad": lambda: (rows_16b(a["h"]), rows_16b(a["w_out"]))})[0],
            library="h @ W + b, -inf scatter_add at the seen ids, torch.topk",
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

    t_phase = t0 = time.perf_counter()
    ds_dir = ml1m_dataset()
    dataset = DataHandler(ds_dir)
    model = serving_predictor("cpu")
    model.prepare_model(dataset)
    model_file = ds_dir + "models/" + model._get_model_filename(1)
    pytree_save(model_file, {"params": model._init_params()})
    setup_s = time.perf_counter() - t0

    argv = ["-d", ds_dir] + SERVING_ARGV
    zero_counters()
    t0 = time.perf_counter()
    ev_gpu = test_cli.main(argv)
    torch.cuda.synchronize()
    gpu_s = time.perf_counter() - t0
    launches = read_counters()
    missing = [name for name in ("gru_scan", "fused_score_topk") if launches[name] == 0]
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
        "seconds": time.perf_counter() - t_phase,
    })
    return launches


@functools.lru_cache(maxsize=1)
def ml1m_rows() -> np.ndarray:
    """scripts/baseline_run.sh's rows: 6040 users over 3706 items (drawn
    once a run: ml1m_dataset and ml1m_pp_dataset split them)."""
    from seqrec_tpu_torch.data.synthetic import generate_interactions

    return generate_interactions(n_users=6040, n_items=3706, min_len=20, max_len=310, markov_strength=0.45, seed=7)


def ml1m_dataset() -> str:
    """scripts/baseline_run.sh's dataset: 6040 users, 3706 items
    (``make_dataset``'s split of ml1m_rows)."""
    from seqrec_tpu_torch.data.synthetic import write_dataset

    path = os.path.join(WORK, "ml1m_synth")
    if os.path.exists(os.path.join(path, "data", "stats")):
        return path + "/"
    return write_dataset(path, ml1m_rows().copy(), n_val_users=100, n_test_users=100, seed=7)


def ml1m_pp_dataset() -> tuple[str, dict]:
    """scripts/baseline_run.sh's rows (ml1m_dataset()'s generator), written as
    ratings.dat and split by the port's preprocess with PP_FLAGS, as
    preprocess.py splits them there; returns (the directory, the seconds of
    each step, None when the dataset was already there)."""
    from seqrec_tpu_torch.data import preprocess

    path = os.path.join(WORK, "ml1m_pp")
    if os.path.exists(os.path.join(path, "data", "stats")):
        return path + "/", {"generate_s": None, "preprocess_s": None}
    os.makedirs(path, exist_ok=True)
    t0 = time.perf_counter()
    np.savetxt(os.path.join(path, "ratings.dat"), ml1m_rows(), fmt="%d", delimiter="::")
    t1 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        preprocess.main(["-f", os.path.join(path, "ratings.dat"), *PP_FLAGS, "--yes"])
    return path + "/", {"generate_s": t1 - t0, "preprocess_s": time.perf_counter() - t1}


# ----------------------------------------------------------------------
# main path, training: the train CLI at two configurations
# ----------------------------------------------------------------------
def run_cli(main, argv):
    """Run a CLI entry point with its standard output captured; returns
    (its result, the text)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = main(argv)
    os.makedirs(WORK, exist_ok=True)
    with open(os.path.join(WORK, "cli.log"), "a") as f:
        f.write("$ " + " ".join(argv) + "\n" + buf.getvalue())
    return result, buf.getvalue()


def progress_values(text, key) -> list:
    """Numbers of the train CLI's progress lines ``key :  value ...``."""
    return [float(ln.split(":", 1)[1].split()[0]) for ln in text.splitlines() if ln.startswith(key + " :")]


def cpu_step_costs(ds_dir, flags, n_costs, tol=1e-4, steps_a_cost=1) -> float:
    """The largest relative difference between the first ``n_costs`` step
    costs of the train CLI on the card and on the CPU (one progress line a
    dispatch: one step, or the mean of ``steps_a_cost`` under --spd); raises
    beyond ``tol``."""
    from seqrec_tpu_torch.cli import train as train_cli

    short = ["-d", ds_dir, *flags, "--max_iter", str(n_costs * steps_a_cost), "--progress", "1", "--save", "None"]
    gpu = progress_values(run_cli(train_cli.main, short)[1], "Last train cost")
    cpu = progress_values(run_cli(train_cli.main, short + ["--device", "cpu"])[1], "Last train cost")
    rel = max(abs(a - b) / abs(b) for a, b in zip(gpu, cpu))
    if len(gpu) != n_costs or len(cpu) != n_costs or rel > tol:
        raise AssertionError(f"{' '.join(flags)}: step costs differ between cuda and cpu: {gpu} vs {cpu}")
    return rel


def train_run(ds_dir, flags, iters, save_dir=None, validates=True):
    """The train CLI on the card with every counter at 0 (one validation
    after ``iters`` steps when ``validates``); returns (its output, its
    seconds, the counts, K1's cluster-path launches among them)."""
    import torch

    from seqrec_tpu_torch.cli import train as train_cli

    argv = ["-d", ds_dir, *flags, "--max_iter", str(iters), "--progress", str(iters if validates else iters + 1),
            "--save", "Best" if save_dir else "None", *(["--dir", save_dir] if save_dir else [])]
    zero_counters()
    t0 = time.perf_counter()
    text = run_cli(train_cli.main, argv)[1]
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = read_counters()
    launches["gru_scan_train_cluster"] = [wrapper(f"gru_scan_train_{d}").cluster_launches for d in ("fwd", "bwd")]
    return text, cli_s, launches


def test_cli_lists(ds_dir, flags, save_dir, ran=()) -> dict:
    """The test CLI on a trained checkpoint on the card with every counter at
    0 (each kernel of ``ran`` must launch, and no other), then on the CPU:
    the same top-10 lists and the same metrics, ASSR included."""
    from seqrec_tpu_torch.cli import test as test_cli

    argv = ["-d", ds_dir, *flags, "--dir", save_dir, "--metrics", "sps,recall,item_coverage,user_coverage,assr"]
    zero_counters()
    t0 = time.perf_counter()
    ev_gpu = run_cli(test_cli.main, argv)[0]
    cuda_s = time.perf_counter() - t0
    launches = read_counters()
    if any(launches[k] == 0 for k in ran) or any(n for k, n in launches.items() if k not in ran):
        raise AssertionError(f"the test CLI of {' '.join(flags)} launched {launches}")
    ev_cpu = run_cli(test_cli.main, argv + ["--device", "cpu"])[0]
    recs_gpu = [pred for _, pred in ev_gpu.instances]
    recs_cpu = [pred for _, pred in ev_cpu.instances]
    if not recs_gpu or recs_gpu != recs_cpu:
        n_diff = sum(a != b for a, b in zip(recs_gpu, recs_cpu))
        raise AssertionError(f"{' '.join(flags)}: top-10 lists differ between cuda and cpu on {n_diff} users")
    metrics = {m: ev_gpu.metrics[m]() for m in ("sps", "recall", "item_coverage", "user_coverage", "assr")}
    if metrics != {m: ev_cpu.metrics[m]() for m in metrics}:
        raise AssertionError(f"{' '.join(flags)}: test metrics differ between cuda and cpu")
    return {"launches": {k: launches[k] for k in ran}, "cuda_s": cuda_s, "test_users": len(recs_gpu),
            "same_top10_as_cpu": True, "same_assr_as_cpu": True, "metrics@10": metrics}


def steady_state(argv, ds_dir, steps, warmup, profile_steps, card, validate=False):
    """Train steps of the CLI's predictor outside the CLI: sequences/s over
    ``steps`` steps after ``warmup`` (host clock to a synchronize), then the
    device time of ``profile_steps`` steps from torch.profiler, its share of
    the same steps' wall time, the largest kernels and every kernel of the
    port's CUDA sources (ms per step). Models without the packed batcher
    draw from their per-sequence one, inside the timed steps as well. With
    ``validate``, one validation pass after the steps: its wall time (host
    clock to a synchronize, after a warm-up pass) and its device time. No
    step may run PyTorch's ``indexing_backward_kernel``: the towers' input
    gather-sum is a kernel pair, and FISM's bag gathers with
    ``index_select``."""
    import torch

    import seqrec_tpu_torch.utils.command_parser as parse
    from seqrec_tpu_torch.data import DataHandler

    args = parse.command_parser(parse.predictor_command_parser, argv=argv)
    args.device = "cuda"
    model = parse.get_predictor(args)
    dataset = DataHandler(ds_dir)
    model.prepare_model(dataset)
    model.set_dataset(dataset)
    model.params_from_numpy(model._init_params())
    if model._fast_batching_ok():
        gen = model._gen_packed_mini_batch(dataset.training_set, np.random.default_rng(1))
    else:
        gen = model._gen_mini_batch(model.sequence_noise(dataset.training_set()))
    for _ in range(warmup):
        model.train_function(next(gen))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        model.train_function(next(gen))
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / steps
    batches = [next(gen) for _ in range(profile_steps)]
    events = device_events(lambda: [model.train_function(b) for b in batches])
    per_step = {k: v / profile_steps for k, v in events.items()}
    if any("indexing_backward" in k for k in per_step):
        raise AssertionError("a training step ran PyTorch's indexing_backward_kernel")
    device_ms = sum(per_step.values())
    ours, port_ms = port_kernel_names(), {}
    for key, ms in per_step.items():  # template instances summed under one name
        if kernel_name(key) in ours:
            port_ms[kernel_name(key)] = port_ms.get(kernel_name(key), 0.0) + ms
    torch.cuda.reset_peak_memory_stats()
    model.train_function(next(gen))
    out = {
        "sequences_per_s": model.batch_size / step_s, "step_ms": step_s * 1e3, "steps_timed": steps,
        "device_ms_per_step": device_ms, "device_busy_share": device_ms / (step_s * 1e3),
        "top_kernels_ms_per_step": dict(sorted(per_step.items(), key=lambda kv: -kv[1])[:8]),
        "port_kernels_ms_per_step": dict(sorted(port_ms.items(), key=lambda kv: -kv[1])),
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9, "card": card,
    }
    if validate:
        def validation():
            model._compute_validation_metrics({m: [] for m in model.metrics})

        validation()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        validation()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        events = device_events(validation)
        out["validation_pass"] = {
            "wall_s": wall_s, "device_ms": sum(events.values()), "eval_chunk": model.eval_batch_size,
            "top_kernels_ms": dict(sorted(events.items(), key=lambda kv: -kv[1])[:6]),
        }
    return out


def main_path_train_flagship(card) -> dict:
    import torch

    from seqrec_tpu_torch.cli import test as test_cli
    from seqrec_tpu_torch.cli import train as train_cli

    t_phase = time.perf_counter()
    ds_dir = ml1m_dataset()
    argv = ["-d", ds_dir, *FLAGSHIP, "--max_iter", "1000", "--progress", "500", "--save", "Best",
            "--dir", "chip_train/"]
    zero_counters()
    t0 = time.perf_counter()
    (best, _, _), text = run_cli(train_cli.main, argv)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = read_counters()
    ran = ("gru_scan_train_fwd", "gru_scan_train_bwd", "gru_scan", "fused_score_topk", "gather_sum_fwd",
           "gather_sum_bwd")
    if any(launches[k] == 0 for k in ran) or launches["cce_stats"] or launches["cce_grads"]:
        raise AssertionError(f"the flagship's training path launched {launches}")
    costs = progress_values(text, "Last train cost")
    if len(costs) != 2 or not costs[1] < costs[0]:
        raise AssertionError(f"train cost did not fall: {costs}")

    rel = cpu_step_costs(ds_dir, FLAGSHIP, 20)
    ev = run_cli(test_cli.main, ["-d", ds_dir, *FLAGSHIP, "--dir", "chip_train/"])[0]
    emit({
        "phase": "main_path_train", "config": "flagship GRU-50 CCE, L=30, B=16, Adam 1e-3, dense head",
        "launches": launches, "cli_cuda_s": cli_s, "iterations": 1000,
        "throughput_sequences_per_s": progress_values(text, "Throughput"),
        "train_cost": costs, "validation_sps@10": progress_values(text, "sps"), "best": best,
        "test_cli_metrics@10": {m: ev.metrics[m]() for m in ("sps", "recall", "item_coverage", "user_coverage")},
        "first_20_step_costs_cuda_vs_cpu_max_rel_diff": rel,
        "tolerance": "rel 1e-4 (f32 kernels vs the CPU's plain versions, 20 Adam steps)",
        "steady": steady_state(FLAGSHIP, ds_dir, steps=150, warmup=20, profile_steps=20, card=card),
        "seconds": time.perf_counter() - t_phase,
    })
    return launches


def main_path_train_large(card) -> dict:
    import torch

    from seqrec_tpu_torch.cli import train as train_cli
    from seqrec_tpu_torch.data import DataHandler

    t_phase = time.perf_counter()
    ds_dir = catalog50k_dataset()
    n_items = DataHandler(ds_dir).n_items
    if n_items < 16384:
        raise AssertionError(f"the large catalog has {n_items} items, under the streaming switch")
    setup_s = time.perf_counter() - t_phase
    argv = ["-d", ds_dir, *LARGE, "--max_iter", "30", "--progress", "30", "--save", "None"]
    zero_counters()
    t0 = time.perf_counter()
    text = run_cli(train_cli.main, argv)[1]
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = read_counters()
    ran = ("gru_scan_train_fwd", "gru_scan_train_bwd", "cce_stats", "cce_grads", "gather_sum_fwd", "gather_sum_bwd")
    if any(launches[k] == 0 for k in ran):
        raise AssertionError(f"the large catalog's training path launched {launches}")
    emit({
        "phase": "main_path_train", "config": "GRU-128, 50k-item synthetic catalog, L=30, B=1024, Adam 1e-3, streaming head",
        "n_items": n_items, "launches": launches, "setup_s": setup_s, "cli_cuda_s": cli_s, "iterations": 30,
        "throughput_sequences_per_s": progress_values(text, "Throughput"),
        "train_cost": progress_values(text, "Last train cost"), "validation_sps@10": progress_values(text, "sps"),
        "steady": steady_state(LARGE, ds_dir, steps=10, warmup=3, profile_steps=2, card=card),
        "seconds": time.perf_counter() - t_phase,
    })
    return launches


def catalog50k_dataset() -> str:
    """The large catalog: 25,000 users over about 50,000 items (written
    once, then reused)."""
    from seqrec_tpu_torch.data.synthetic import catalog_interactions, write_dataset

    path = os.path.join(WORK, "catalog50k")
    if os.path.exists(os.path.join(path, "data", "stats")):
        return path + "/"
    rows = catalog_interactions(n_users=25_000, n_items=50_000, min_len=20, max_len=100, seed=8)
    return write_dataset(path, rows, n_val_users=500, n_test_users=500, seed=8)


def main_path_train_hstu(card) -> dict:
    """HSTU at small widths (HSTU_SMALL) on the 50k-item catalog: first
    the tower on packed tokens against the CPU (``check_hstu_tower``) at
    dqk != dv with empty, full and one-step rows, and at dqk = dv with the
    HSTU cell's prefix lengths; its first 3 step costs against the CLI on
    the CPU; with every counter at 0, 20
    steps at --spd 2 and a validation through the train CLI (the attention
    forward and backward, G1 and K2 launched, no recurrence's kernel); the
    test CLI on the saved checkpoint (G1, the attention forward and K4
    alone) with the CPU's top-10 lists. Returns the training run's counts."""
    t_phase = time.perf_counter()
    # the tower on packed tokens: dqk != dv (V, Q, K in one padded buffer) with empty, full and one-step rows and
    # two id slots; dqk = dv (three buffers) at the cell's prefix lengths, whose share of packed tokens it reads
    towers = [check_hstu_tower([0, 37, 5, 12, 1, 0, 29], 37, 64, 2, 2, 32, 16, seed=98, slots=2),
              check_hstu_tower(hstu_cell_lengths(512, 200, 95), 200, 64, 2, 2, 32, 32, seed=99)]
    ds_dir = catalog50k_dataset()
    rel = cpu_step_costs(ds_dir, HSTU_SMALL, 3)
    text, cli_s, launches = train_run(ds_dir, HSTU_SMALL + ["--spd", "2"], 20, save_dir="chip_hstu/")
    ran = ("hstu_attention_fwd", "hstu_attention_bwd", "cce_stats", "cce_grads", "gather_sum_fwd", "gather_sum_bwd")
    scans = ("gru_scan_train_fwd", "gru_scan_train_bwd", "lstm_scan_train_fwd", "lstm_scan_train_bwd", "gru_scan",
             "lstm_scan")
    if any(launches[k] == 0 for k in ran) or any(launches[k] for k in scans):
        raise AssertionError(f"the HSTU training path launched {launches}")
    served = test_cli_lists(ds_dir, HSTU_SMALL, "chip_hstu/", ran=("hstu_attention_fwd", "gather_sum_fwd",
                                                                    "fused_score_topk"))
    emit({
        "phase": "main_path_train_hstu", "config": "HSTU d 64, 2 blocks, 2 heads of 32, L=30, B=256, --spd 2, "
        "50k-item catalog, streaming head", "launches": launches, "cli_cuda_s": cli_s,
        "progress_costs_cuda_vs_cpu_max_rel_diff": rel, "train_cost": progress_values(text, "Last train cost"),
        "validation_sps@10": progress_values(text, "sps"), "test_cli": served, "towers": towers,
        "seconds": time.perf_counter() - t_phase,
    })
    return launches


def main_path_train_lstm(card) -> tuple[dict, dict]:
    """The LSTM path: train LSTM-128 on the 50k-item catalog through the
    train CLI (K5 and K2), compare its first 5 step costs with the CPU,
    then serve the saved checkpoint through the test CLI (K6 and K4) on the
    card and on the CPU. Returns the launch counts of the training run and
    of the test CLI run."""
    import torch

    from seqrec_tpu_torch.cli import test as test_cli
    from seqrec_tpu_torch.cli import train as train_cli

    t_phase = time.perf_counter()
    ds_dir = catalog50k_dataset()
    argv = ["-d", ds_dir, *LSTM_LARGE, "--max_iter", "30", "--progress", "30", "--save", "Best",
            "--dir", "chip_lstm/"]
    zero_counters()
    t0 = time.perf_counter()
    text = run_cli(train_cli.main, argv)[1]
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    train_launches = read_counters()
    ran = ("lstm_scan_train_fwd", "lstm_scan_train_bwd", "cce_stats", "cce_grads", "gather_sum_fwd", "gather_sum_bwd")
    if any(train_launches[k] == 0 for k in ran) or any(train_launches[k] for k in KERNELS if k.startswith("gru_")):
        raise AssertionError(f"the LSTM training path launched {train_launches}")

    rel = cpu_step_costs(ds_dir, LSTM_LARGE, 5)
    test_argv = ["-d", ds_dir, *LSTM_LARGE, "--dir", "chip_lstm/"]
    zero_counters()
    t0 = time.perf_counter()
    ev_gpu = run_cli(test_cli.main, test_argv)[0]
    torch.cuda.synchronize()
    test_s = time.perf_counter() - t0
    serve_launches = read_counters()
    serve_launches["lstm_scan_cluster"] = wrapper("lstm_scan").cluster_launches
    if serve_launches["lstm_scan_cluster"] == 0 or serve_launches["fused_score_topk"] == 0:
        raise AssertionError(f"the LSTM serving path launched {serve_launches}")
    ev_cpu = run_cli(test_cli.main, test_argv + ["--device", "cpu"])[0]
    recs_gpu = [pred for _, pred in ev_gpu.instances]
    recs_cpu = [pred for _, pred in ev_cpu.instances]
    if not recs_gpu or recs_gpu != recs_cpu:
        n_diff = sum(a != b for a, b in zip(recs_gpu, recs_cpu))
        raise AssertionError(f"LSTM top-10 lists differ between cuda and cpu on {n_diff} users")
    emit({
        "phase": "main_path_train", "config": "LSTM-128, 50k-item synthetic catalog, L=30, B=1024, Adam 2e-3, streaming head",
        "launches": train_launches, "cli_cuda_s": cli_s, "iterations": 30,
        "throughput_sequences_per_s": progress_values(text, "Throughput"),
        "train_cost": progress_values(text, "Last train cost"), "validation_sps@10": progress_values(text, "sps"),
        "first_5_step_costs_cuda_vs_cpu_max_rel_diff": rel,
        "tolerance": "rel 1e-4 (f32 kernels vs the CPU's plain versions, 5 Adam steps)",
        "test_cli": {"launches": serve_launches, "cuda_s": test_s, "test_users": len(recs_gpu),
                     "same_top10_as_cpu": True,
                     "metrics@10": {m: ev_gpu.metrics[m]() for m in ("sps", "recall", "item_coverage", "user_coverage")}},
        "steady": steady_state(LSTM_LARGE, ds_dir, steps=10, warmup=3, profile_steps=2, card=card),
        "seconds": time.perf_counter() - t_phase,
    })
    return train_launches, serve_launches


# ----------------------------------------------------------------------
# main path, training: the sampled and margin heads, --lazy_updates
# ----------------------------------------------------------------------
GRU_TRAIN_PATH = ("gru_scan_train_fwd", "gru_scan_train_bwd", "gather_sum_fwd", "gather_sum_bwd")
GRU_EVAL_PATH = ("gru_scan", "fused_score_topk")


def head_run(ds_dir, flags, iters, n_costs, validates=True, save_dir=None) -> dict:
    """Train ``flags`` through the train CLI on the card with every counter
    at 0 (one validation after ``iters`` steps when ``validates``), check
    that K1, the gather-sum and (with the validation) K3 and K4 ran and K2
    did not, then that the first ``n_costs`` step costs equal the CPU CLI's
    within 1e-4 relative (one step per progress line)."""
    text, cli_s, launches = train_run(ds_dir, flags, iters, save_dir=save_dir, validates=validates)
    ran = GRU_TRAIN_PATH + (GRU_EVAL_PATH if validates else ())
    if any(launches[k] == 0 for k in ran) or launches["cce_stats"] or launches["cce_grads"]:
        raise AssertionError(f"{' '.join(flags)} launched {launches}")
    rel = cpu_step_costs(ds_dir, flags, n_costs)
    return {
        "flags": " ".join(flags), "launches": launches, "cli_cuda_s": cli_s, "iterations": iters,
        "throughput_sequences_per_s": progress_values(text, "Throughput"),
        "train_cost": progress_values(text, "Last train cost"), "validation_sps@10": progress_values(text, "sps"),
        f"first_{n_costs}_step_costs_cuda_vs_cpu_max_rel_diff": rel,
    }


def main_path_train_heads(card) -> dict:
    """The sampled and margin heads at scripts/quality_run_regime2.sh's
    GRU-50/B64 on the ML-1M-scale dataset: BPR (100 steps, one validation),
    Blackout with pop^0.5 samples (50 steps, one validation) and the dense
    hinge margin (100 steps, one validation) through the train CLI on the
    card, each against the CPU's first 20 step costs; the test CLI on the
    BPR and hinge checkpoints against the CPU's top-10 lists; steady steps
    of BPR and hinge. Returns each run's launches."""
    t_phase = time.perf_counter()
    ds_dir = ml1m_dataset()
    runs = {
        "bpr": head_run(ds_dir, HEADS_BPR, 100, 20, save_dir="chip_bpr/"),
        "blackout": head_run(ds_dir, HEADS_BLACKOUT, 50, 20),
        "hinge": head_run(ds_dir, HEADS_HINGE, 100, 20, save_dir="chip_hinge/"),
    }
    runs["bpr"]["test_cli"] = test_cli_lists(ds_dir, HEADS_BPR, "chip_bpr/", ran=GRU_EVAL_PATH + ("gather_sum_fwd",))
    runs["hinge"]["test_cli"] = test_cli_lists(ds_dir, HEADS_HINGE, "chip_hinge/", ran=GRU_EVAL_PATH + ("gather_sum_fwd",))
    for name, flags in (("bpr", HEADS_BPR), ("hinge", HEADS_HINGE)):
        runs[name]["steady"] = steady_state(flags, ds_dir, steps=100, warmup=20, profile_steps=20, card=card)
    emit({
        "phase": "main_path_train_heads", "config": "GRU-50, L=30, B=64, Adam 2e-3, ML-1M-scale synthetic (3,706 items)",
        "runs": runs, "tolerance": "step costs rel 1e-4 (f32 kernels and atomic column-gather backwards vs the CPU)",
        "seconds": time.perf_counter() - t_phase,
    })
    return {name: run["launches"] for name, run in runs.items()}


def streaming_margin_parts(B, H, N, L, seed) -> dict:
    """The streaming margin at B/H/N: its chunk loop (the uniform part,
    forward and backward) and its special-column correction, per call
    (CUDA events) and device time, beside the dense margin on the same
    inputs; the streaming value and gradients held against the dense
    ones (rtol 1e-4 + atol 1e-5*max|dense|)."""
    import torch

    from seqrec_tpu_torch.models.rnn_margin import dense_margin
    from seqrec_tpu_torch.ops.streaming_margin import margin_special_correction, pick_chunk, streaming_margin_uniform

    rng = np.random.default_rng(seed)
    f32 = torch.float32
    h = torch.tensor(rng.normal(0, 0.5, (B, H)), dtype=f32, device="cuda", requires_grad=True)
    W = torch.tensor(rng.normal(0, 0.05, (H, N)), dtype=f32, device="cuda", requires_grad=True)
    b = torch.tensor(rng.normal(0, 0.05, N), dtype=f32, device="cuda", requires_grad=True)
    lengths = rng.integers(2, L + 1, size=B)
    seen = np.where(np.arange(L)[None, :] < lengths[:, None], rng.integers(0, N, (B, L)), N)
    tgt = torch.tensor(rng.integers(0, N, (B, 1)), device="cuda")
    seen = torch.tensor(seen, device="cuda")
    w_neg = torch.tensor(1.0 / (N - 1.0 - lengths), dtype=f32, device="cuda")
    dt = torch.zeros(N, dtype=f32, device="cuda")
    chunk = pick_chunk(N)
    leaves = (h, W, b)

    def loop():
        return torch.autograd.grad(streaming_margin_uniform(h, W, b, w_neg, dt, "hinge", chunk).sum(), leaves)

    def corr():
        out = margin_special_correction(h, W, b, tgt, seen, w_neg, dt, "hinge", True, N)
        return torch.autograd.grad(out.sum(), leaves)

    def dense():
        return torch.autograd.grad(dense_margin(h @ W + b, tgt, seen, w_neg, dt, "hinge", True).sum(), leaves)

    parts = {"chunk_loop": loop, "correction": corr, "dense_margin": dense}
    with torch.no_grad():
        got = (streaming_margin_uniform(h, W, b, w_neg, dt, "hinge", chunk)
               + margin_special_correction(h, W, b, tgt, seen, w_neg, dt, "hinge", True, N))
        want = dense_margin(h @ W + b, tgt, seen, w_neg, dt, "hinge", True)
    errs = {"loss": close(got, want, rtol=1e-4, atol_rel=1e-5)}
    for name, a, c, d in zip("hWb", loop(), corr(), dense()):
        errs["d" + name] = close(a + c, d, rtol=1e-4, atol_rel=1e-5)
    if not all(ok for _, ok in errs.values()):
        raise AssertionError(f"the streaming margin disagrees with the dense margin at {(B, H, N)}: {errs}")
    return {
        "shape": {"B": B, "H": H, "N": N, "chunk": chunk, "n_chunks": -(-N // chunk)},
        "max_abs_err": {k: v for k, (v, _) in errs.items()},
        **{f"{part}_ms": time_ms(fn, reps=10) for part, fn in parts.items()},
        **{f"{part}_device_ms": device_ms(fn, reps=5) for part, fn in parts.items()},
        "timed": "forward and backward of the hinge loss with respect to h, W and b",
    }


def lazy_update_parts(H, N, n_cols, seed) -> dict:
    """One lazy Adam step of the sampled head (``n_cols`` = B+S columns of
    W_out [H, N] and entries of b_out, drawn with repeats) against the
    dense Adam step on both, per call and device time."""
    import torch

    from seqrec_tpu_torch.models.base import RNNBase
    from seqrec_tpu_torch.models.updates import Adam

    rng = np.random.default_rng(seed)
    model = RNNBase(updater=Adam(0.001), device="cuda")
    f32 = torch.float32
    W = torch.tensor(rng.normal(0, 0.05, (H, N)), dtype=f32, device="cuda")
    b = torch.zeros(N, dtype=f32, device="cuda")
    gW = torch.tensor(rng.normal(0, 1e-3, (H, N)), dtype=f32, device="cuda")
    gb = torch.tensor(rng.normal(0, 1e-3, N), dtype=f32, device="cuda")
    cols = torch.tensor(rng.integers(0, N, n_cols), device="cuda")
    states = [{"m": torch.zeros_like(t), "v": torch.zeros_like(t), "count": 0} for t in (W, b)]
    dense_state = model.updater.init([W, b])

    def lazy():
        model._lazy_adam_update(W, states[0], gW, cols, 1)
        model._lazy_adam_update(b, states[1], gb, cols, 0)

    def dense():
        model.updater.step([W, b], [gW, gb], dense_state)

    return {"shape": {"H": H, "N": N, "columns": n_cols}, **timings({"lazy": lazy, "dense_adam": dense})[0]}


def main_path_train_heads_large(card) -> dict:
    """The other heads at the GRU large catalog's shape (GRU-128, B=1024,
    49,999 items): the streaming hinge margin (30 steps, one validation)
    and BPR with 256 samples on the lazy head (30 steps), each against the
    CPU's first 3 step costs; steady steps of both (no step may run
    ``indexing_backward_kernel``); the streaming margin's chunk loop and the
    lazy update timed alone. Returns each run's launches."""
    from seqrec_tpu_torch.data import DataHandler
    from seqrec_tpu_torch.ops.streaming_margin import STREAMING_MARGIN_MIN_ITEMS

    t_phase = time.perf_counter()
    ds_dir = catalog50k_dataset()
    n_items = DataHandler(ds_dir).n_items
    if n_items < STREAMING_MARGIN_MIN_ITEMS:
        raise AssertionError(f"the large catalog has {n_items} items, under the streaming margin's switch")
    runs = {
        "hinge_streaming": head_run(ds_dir, LARGE_HINGE, 30, 3),
        "bpr_lazy": head_run(ds_dir, LARGE_BPR_LAZY, 30, 3, validates=False),
    }
    for name, flags in (("hinge_streaming", LARGE_HINGE), ("bpr_lazy", LARGE_BPR_LAZY)):
        runs[name]["steady"] = steady_state(flags, ds_dir, steps=10, warmup=3, profile_steps=2, card=card)
    emit({
        "phase": "main_path_train_heads_large", "config": "GRU-128, 50k-item synthetic catalog, L=30, B=1024, Adam 1e-3",
        "n_items": n_items, "runs": runs,
        "streaming_margin": streaming_margin_parts(1024, 128, n_items, 30, seed=80),
        "lazy_update": lazy_update_parts(128, n_items, 1024 + 256, seed=81),
        "tolerance": "step costs rel 1e-4 (f32 kernels and atomic column-gather backwards vs the CPU)",
        "seconds": time.perf_counter() - t_phase,
    })
    return {name: run["launches"] for name, run in runs.items()}


# ----------------------------------------------------------------------
# main path, training: the cluster models and the autoencoder
# ----------------------------------------------------------------------
CLUSTER_VALIDATION = ("recall", "cluster_recall", "sps", "cluster_sps", "assr", "cluster_use_std")


def main_path_train_cluster(card) -> dict:
    """RNNCluster at scripts/baseline_run2.sh's flags (GRU-50, B=64, 10
    clusters, Blackout with 256 samples and 256 cluster samples, Adam 1e-3)
    on the ML-1M-scale dataset: 100 steps and one validation through the
    train CLI on the card (K1, G1 and K3 must launch, K2 and K4 not), the
    first 20 step costs against the CPU's, the test CLI with --clusters 10
    on the card and the CPU (the same lists and ASSR), steady steps.
    Returns the launches of the training run and of the test CLI."""
    t_phase = time.perf_counter()
    ds_dir = ml1m_dataset()
    text, cli_s, launches = train_run(ds_dir, CLUSTER, 100, save_dir="chip_cluster/")
    ran = GRU_TRAIN_PATH + ("gru_scan",)
    if any(launches[k] == 0 for k in ran) or any(launches[k] for k in ("cce_stats", "cce_grads", "fused_score_topk")):
        raise AssertionError(f"RNNCluster's training path launched {launches}")
    rel = cpu_step_costs(ds_dir, CLUSTER, 20)
    test = test_cli_lists(ds_dir, CLUSTER, "chip_cluster/", ran=("gru_scan", "gather_sum_fwd"))
    emit({
        "phase": "main_path_train_cluster", "config": "RNNCluster GRU-50, 10 clusters (mix), Blackout s256 cs256, "
        "L=30, B=64, Adam 1e-3, ML-1M-scale synthetic (3,706 items)",
        "launches": launches, "cli_cuda_s": cli_s, "iterations": 100,
        "train_cost": progress_values(text, "Last train cost"),
        "validation": {m: progress_values(text, m) for m in CLUSTER_VALIDATION},
        "first_20_step_costs_cuda_vs_cpu_max_rel_diff": rel, "csn": 0.0,
        "tolerance": "step costs rel 1e-4 (f32 kernels and atomic column-gather backwards vs the CPU)",
        "test_cli": test,
        "steady": steady_state(CLUSTER, ds_dir, steps=100, warmup=20, profile_steps=20, card=card),
        "seconds": time.perf_counter() - t_phase,
    })
    return {"cluster": launches, "cluster_test_cli": test["launches"]}


def main_path_train_cluster_large(card) -> dict:
    """The same RNNCluster at GRU-128, B=1024 on the 49,999-item catalog: 30
    steps and one validation through the train CLI (K1 on its cluster path,
    G1, K3); steady steps and one validation pass (two stable sorts of
    [1024, 49,999] rows) timed alone. Returns the launches."""
    from seqrec_tpu_torch.data import DataHandler

    t_phase = time.perf_counter()
    ds_dir = catalog50k_dataset()
    text, cli_s, launches = train_run(ds_dir, CLUSTER_LARGE, 30)
    if (any(launches[k] == 0 for k in GRU_TRAIN_PATH + ("gru_scan",)) or 0 in launches["gru_scan_train_cluster"]
            or any(launches[k] for k in ("cce_stats", "cce_grads", "fused_score_topk"))):
        raise AssertionError(f"RNNCluster's large-catalog path launched {launches}")
    emit({
        "phase": "main_path_train_cluster_large", "config": "RNNCluster GRU-128, 10 clusters (mix), Blackout s256 "
        "cs256, L=30, B=1024, Adam 1e-3, 50k-item synthetic catalog",
        "n_items": DataHandler(ds_dir).n_items, "launches": launches, "cli_cuda_s": cli_s, "iterations": 30,
        "train_cost": progress_values(text, "Last train cost"),
        "validation": {m: progress_values(text, m) for m in CLUSTER_VALIDATION},
        "steady": steady_state(CLUSTER_LARGE, ds_dir, steps=10, warmup=3, profile_steps=2, card=card, validate=True),
        "seconds": time.perf_counter() - t_phase,
    })
    return launches


def main_path_fism_cluster(card) -> dict:
    """FISMCluster (H=50, alpha 0.2, 10 clusters, Blackout with 256 samples,
    B=64, Adam 1e-3) on the ML-1M-scale dataset: 100 steps and one
    validation through the train CLI on the card, the first 20 step costs
    against the CPU's, the test CLI on the card and the CPU. FISM's bag is a
    gather and an einsum, as the JAX package leaves it to XLA: no kernel of
    the port launches, which the counters show. Returns the launches."""
    t_phase = time.perf_counter()
    ds_dir = ml1m_dataset()
    text, cli_s, launches = train_run(ds_dir, FISM_CLUSTER, 100, save_dir="chip_fism/")
    if any(n for k, n in launches.items() if k != "gru_scan_train_cluster") or any(launches["gru_scan_train_cluster"]):
        raise AssertionError(f"FISMCluster launched a port kernel: {launches}")
    rel = cpu_step_costs(ds_dir, FISM_CLUSTER, 20)
    emit({
        "phase": "main_path_fism_cluster", "config": "FISMCluster H=50, alpha 0.2, 10 clusters (mix), Blackout s256, "
        "B=64, Adam 1e-3, ML-1M-scale synthetic (3,706 items)",
        "launches": launches, "no_port_kernel": "by the JAX package's design: an XLA gather and einsum",
        "cli_cuda_s": cli_s, "iterations": 100, "train_cost": progress_values(text, "Last train cost"),
        "validation": {m: progress_values(text, m) for m in CLUSTER_VALIDATION},
        "first_20_step_costs_cuda_vs_cpu_max_rel_diff": rel,
        "tolerance": "step costs rel 1e-4 (f32 products and index backwards vs the CPU)",
        "test_cli": test_cli_lists(ds_dir, FISM_CLUSTER, "chip_fism/"),
        "steady": steady_state(FISM_CLUSTER, ds_dir, steps=100, warmup=10, profile_steps=10, card=card),
        "seconds": time.perf_counter() - t_phase,
    })
    return launches


def main_path_train_sdae(card) -> dict:
    """The autoencoder at scripts/baseline_run2.sh's flags (-L 64-32-64,
    --in_do 0.2, B=64, Adam 1e-3) on the ML-1M-scale dataset: the first 20
    step costs at --do 0 against the CPU's (the layer dropout draws other
    bits on each device), then 100 steps at --do 0.3 and one validation
    through the train CLI, steady steps, and the test CLI on the card and
    the CPU. Its dense stack is plain matmuls (no port kernel, as in the JAX
    package), which the counters show. Returns the launches."""
    t_phase = time.perf_counter()
    ds_dir = ml1m_dataset()
    rel = cpu_step_costs(ds_dir, SDA + ["--do", "0"], 20)
    flags = SDA + ["--do", "0.3"]
    text, cli_s, launches = train_run(ds_dir, flags, 100, save_dir="chip_sda/")
    if any(n for k, n in launches.items() if k != "gru_scan_train_cluster") or any(launches["gru_scan_train_cluster"]):
        raise AssertionError(f"the autoencoder launched a port kernel: {launches}")
    emit({
        "phase": "main_path_train_sdae", "config": "SDA 64-32-64, --do 0.3, --in_do 0.2, B=64, Adam 1e-3, "
        "ML-1M-scale synthetic (3,706 items)",
        "launches": launches, "no_port_kernel": "by the JAX package's design: XLA matmuls",
        "first_20_step_costs_at_do0_cuda_vs_cpu_max_rel_diff": rel,
        "tolerance": "step costs rel 1e-4 (f32 products vs the CPU)",
        "cli_cuda_s": cli_s, "iterations": 100, "train_cost": progress_values(text, "Last train cost"),
        "validation_sps@10": progress_values(text, "sps"), "throughput_sequences_per_s": progress_values(text, "Throughput"),
        "test_cli": test_cli_lists(ds_dir, flags, "chip_sda/"),
        "steady": steady_state(flags, ds_dir, steps=100, warmup=20, profile_steps=20, card=card),
        "seconds": time.perf_counter() - t_phase,
    })
    return launches


@contextlib.contextmanager
def recorded_ltm_losses():
    """The loss tensor of every LTM CBOW step taken while the context is
    open, in order (the class's step is wrapped; nothing is synchronized)."""
    from seqrec_tpu_torch.models.ltm import LTM as LTMModel

    losses, step = [], LTMModel._cbow_step

    def recording(self, *args):
        losses.append(step(self, *args))
        return losses[-1]

    LTMModel._cbow_step = recording
    try:
        yield losses
    finally:
        LTMModel._cbow_step = step


def ltm_model(ds_dir, device):
    """The train CLI's LTM on ``ds_dir``, with its tables and noise
    distribution initialized."""
    import seqrec_tpu_torch.utils.command_parser as parse
    from seqrec_tpu_torch.data import DataHandler

    args = parse.command_parser(parse.predictor_command_parser, argv=LTM)
    args.device = device
    model = parse.get_predictor(args)
    dataset = DataHandler(ds_dir)
    model.prepare_model(dataset)
    model._init_w2v()
    model._init_training_aux()
    return model


def ltm_steps(model, n: int, lr: float = 0.01) -> None:
    """The first ``n`` CBOW steps of a new epoch, drawn as
    ``LTM._train_one_epoch`` draws them."""
    chunks = model._epoch_positions()
    for _ in range(n):
        ctx, mask, center, row_mask = next(chunks)
        negs = np.searchsorted(model._noise_cdf, model.rng.random((len(center), model.negative)), side="right")
        model._cbow_step(*map(model._tensor, (ctx, mask, center, negs.astype(np.int32), row_mask)), lr)


def ltm_kernel_checks(ds_dir) -> dict:
    """G1 and K4 at the shapes LTM gives them, on its first step's real ids:
    the forward over the contexts [2048, 10] (pad slots -1, the mask as
    id_mask), the backward there (syn0's update) and at F=1 over the
    2,048 x 6 targets (syn1neg's: long runs on popular negatives), K4 at the
    validation's B=100 users, H=32, the catalog and the longest seen list."""
    model = ltm_model(ds_dir, "cpu")
    ctx, mask, center, _ = next(model._epoch_positions())
    negs = np.searchsorted(model._noise_cdf, model.rng.random((len(center), model.negative)), side="right")
    targets = np.concatenate([center[:, None], negs.astype(np.int32)], axis=1).reshape(-1, 1)
    S = max(len(seq) // 2 for seq, _ in model.dataset.validation_set(epochs=1))
    out = {
        "ctx": check_gather_sum(ctx, model.k, model.n_items, seed=75, id_mask=mask),
        "targets": check_gather_sum(targets, model.k, model.n_items, seed=76),
        "topk": check_topk(100, model.k, model.n_items, S, 10, seed=77),
    }
    counts = np.bincount(targets[:, 0], minlength=model.n_items)
    out["targets"]["id_runs"] = {"slots": int(targets.size), "distinct_ids": int((counts > 0).sum()),
                                 "longest_run": int(counts.max()), "longest_run_id": int(counts.argmax())}
    return out


def main_path_train_ltm(card) -> tuple[dict, dict, dict]:
    """LTM at scripts/baseline_run2.sh:84's flags on ml1m_pp_dataset(): G1
    and K4 at its shapes; with every counter at 0, 2 epochs and a validation
    after each through the train CLI on the card (G1's forward once and its
    backward twice a step, K4 once a validation, nothing else), the first 20
    step losses against the same CLI's first epoch on the CPU (within 1e-4
    relative); with the counters at 0 again, the test CLI on the last
    checkpoint on the card (K4 only) and the CPU (the same top-10 lists and
    metrics); a steady epoch timed, 50 steps profiled. Returns the train and
    test CLIs' launches and the kernel checks."""
    import torch

    from seqrec_tpu_torch.cli import test as test_cli
    from seqrec_tpu_torch.cli import train as train_cli
    from seqrec_tpu_torch.data import DataHandler

    t_phase = time.perf_counter()
    ds_dir, made = ml1m_pp_dataset()
    checks = ltm_kernel_checks(ds_dir)
    argv = ["-d", ds_dir, *LTM, "--max_iter", "2", "--progress", "1", "--save", "All", "--dir", "chip_ltm/"]
    zero_counters()
    with recorded_ltm_losses() as losses:
        t0 = time.perf_counter()
        text = run_cli(train_cli.main, argv)[1]
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
    launches = read_counters()
    steps = len(losses)
    expected = {"gather_sum_fwd": steps, "gather_sum_bwd": 2 * steps, "fused_score_topk": 2}
    if steps == 0 or any(launches[k] != expected.get(k, 0) for k in KERNELS):
        raise AssertionError(f"LTM's {steps} steps and 2 validations launched {launches}")
    gpu = torch.stack(losses).cpu().numpy().astype(np.float64)
    with recorded_ltm_losses() as cpu_losses:
        cpu_text = run_cli(train_cli.main, argv[:-2] + ["--max_iter", "1", "--save", "None", "--device", "cpu"])[1]
    cpu = torch.stack(cpu_losses).numpy().astype(np.float64)
    rel = np.abs(gpu[: len(cpu)] - cpu) / np.abs(cpu)
    if len(cpu) != steps // 2 or rel[:20].max() > 1e-4:
        raise AssertionError(f"LTM step losses differ between cuda and cpu: {gpu[:20]} vs {cpu[:20]}")

    test_argv = ["-d", ds_dir, *LTM, "--dir", "chip_ltm/", "-i", "2"]
    zero_counters()
    t0 = time.perf_counter()
    ev_gpu = run_cli(test_cli.main, test_argv)[0]
    test_s = time.perf_counter() - t0
    test_launches = read_counters()
    if test_launches["fused_score_topk"] != 1 or sum(test_launches.values()) != 1:
        raise AssertionError(f"LTM's test CLI launched {test_launches}")
    ev_cpu = run_cli(test_cli.main, test_argv + ["--device", "cpu"])[0]
    recs_gpu, recs_cpu = ([pred for _, pred in ev.instances] for ev in (ev_gpu, ev_cpu))
    if not recs_gpu or recs_gpu != recs_cpu:
        n_diff = sum(a != b for a, b in zip(recs_gpu, recs_cpu))
        raise AssertionError(f"LTM's top-10 lists differ between cuda and cpu on {n_diff} users")
    metrics = {m: ev_gpu.metrics[m]() for m in ("sps", "recall", "item_coverage", "user_coverage")}
    if metrics != {m: ev_cpu.metrics[m]() for m in metrics}:
        raise AssertionError("LTM's test metrics differ between cuda and cpu")
    # test users whose trajectory is all zero (fewer than 2 items seen): every item
    # scores 0, and both devices list the lowest unseen ids (K4's ties by id)
    zero_query_users = sum(len(seq) // 2 < 2 for seq, _ in DataHandler(ds_dir).test_set(epochs=1))

    # steady: one epoch timed on the host clock (the CLI runs above warmed the
    # kernels up), then 50 steps of the next profiled
    model = ltm_model(ds_dir, "cuda")
    store = model.dataset.training_set.store
    positions = int(store.lengths.sum() - (store.lengths == 1).sum())
    with recorded_ltm_losses() as timed:
        t0 = time.perf_counter()
        model._train_one_epoch(0.01)
        torch.cuda.synchronize()
        epoch_s = time.perf_counter() - t0
    n, n_profiled = len(timed), 50
    per_step = {k: v / n_profiled for k, v in device_events(lambda: ltm_steps(model, n_profiled)).items()}
    step_device_ms = sum(per_step.values())
    ours, port_ms = port_kernel_names(), {}
    for key, ms in per_step.items():
        if kernel_name(key) in ours:
            port_ms[kernel_name(key)] = port_ms.get(kernel_name(key), 0.0) + ms
    emit({
        "phase": "main_path_train_ltm", "config": "LTM -H 32 --ltm_window 5, lr 0.01, 2,048 positions a step, "
        "5 negatives, trajectory (damping 0.8); ml1m_pp (the port's preprocess of baseline_run.sh's rows)",
        "dataset": {"n_items": model.n_items, "training_sequences": len(store), "positions_per_epoch": positions,
                    **made},
        "kernel_checks": {"gather_sum_ctx": checks["ctx"], "gather_sum_targets_F1": checks["targets"],
                          "fused_score_topk": checks["topk"]},
        "launches": launches, "steps": steps, "validations": 2, "cli_cuda_s": cli_s,
        "train_cost": progress_values(text, "Last train cost"),
        "train_cost_cpu_epoch1": progress_values(cpu_text, "Last train cost"),
        "validation_sps@10": progress_values(text, "sps"), "validation_recall@10": progress_values(text, "recall"),
        "first_20_step_losses_cuda_vs_cpu_max_rel_diff": float(rel[:20].max()),
        "epoch1_step_losses_cuda_vs_cpu_max_rel_diff": float(rel.max()),
        "tolerance": "step losses rel 1e-4 (f32 sums in another order: G1's fixed order vs index_add_)",
        "test_cli": {"launches": {"fused_score_topk": 1}, "cuda_s": test_s, "test_users": len(recs_gpu),
                     "same_top10_as_cpu": True, "metrics@10": metrics, "all_zero_query_users": zero_query_users},
        "steady": {
            "epoch_s": epoch_s, "steps": n, "step_ms": epoch_s * 1e3 / n, "positions_per_s": positions / epoch_s,
            "sequences_per_s": len(store) / epoch_s, "device_ms_per_step": step_device_ms,
            "device_busy_share": step_device_ms * n / (epoch_s * 1e3), "steps_profiled": n_profiled,
            "top_kernels_ms_per_step": dict(sorted(per_step.items(), key=lambda kv: -kv[1])[:8]),
            "port_kernels_ms_per_step": dict(sorted(port_ms.items(), key=lambda kv: -kv[1])), "card": card,
        },
        "seconds": time.perf_counter() - t_phase,
    })
    return launches, test_launches, checks


def floors(card) -> dict:
    """POP, the Markov model and user-KNN through the test CLI on
    ml1m_pp_dataset(), on the card with every counter at 0 (they do no
    device work: every counter stays at 0) and on the CPU (the same lists
    and metrics); the test sps@10 and recall@10 must equal the JAX
    package's on preprocess.py's split of the same rows (JAX_FLOORS).
    Returns each model's launches."""
    from seqrec_tpu_torch.cli import test as test_cli

    t_phase = time.perf_counter()
    ds_dir, _ = ml1m_pp_dataset()
    runs = {}
    for method in ("POP", "MM", "UKNN"):
        argv = ["-d", ds_dir, "-m", method]
        zero_counters()
        t0 = time.perf_counter()
        ev_gpu = run_cli(test_cli.main, argv)[0]
        cli_s = time.perf_counter() - t0
        launches = read_counters()
        if any(launches.values()):
            raise AssertionError(f"-m {method} launched {launches}")
        ev_cpu = run_cli(test_cli.main, argv + ["--device", "cpu"])[0]
        names = ("sps", "recall", "item_coverage", "user_coverage", "blockbuster_share")
        metrics = {m: ev_gpu.metrics[m]() for m in names}
        if metrics != {m: ev_cpu.metrics[m]() for m in names} or ev_gpu.instances != ev_cpu.instances:
            raise AssertionError(f"-m {method}: the lists or metrics differ between --device cuda and cpu")
        if (metrics["sps"], metrics["recall"]) != JAX_FLOORS[method]:
            raise AssertionError(f"-m {method}: test sps@10, recall@10 {metrics['sps']}, {metrics['recall']} "
                                 f"differ from the JAX package's {JAX_FLOORS[method]}")
        runs[method] = {"launches": launches, "cli_s": cli_s, "metrics@10": metrics,
                        "jax_sps_recall@10": JAX_FLOORS[method], "baseline_md_sps_recall@10": BASELINE_FLOORS[method],
                        "same_as_cpu": True, "same_as_jax": True}
    emit({"phase": "floors", "dataset": "ml1m_pp", "runs": runs, "card": card,
          "baseline": "BASELINE.md:49-51", "seconds": time.perf_counter() - t_phase})
    return {method: run["launches"] for method, run in runs.items()}


def mf_model(ds_dir, flags, device, extended=True):
    """The CLI's factorization model on ``ds_dir``, its tables initialized."""
    import seqrec_tpu_torch.utils.command_parser as parse
    from seqrec_tpu_torch.data import DataHandler

    args = parse.command_parser(parse.predictor_command_parser, argv=flags)
    args.device = device
    model = parse.get_predictor(args)
    dataset = DataHandler(ds_dir, extended_training_set=extended)
    model.prepare_model(dataset)
    model.change_data_format(dataset)
    model.init_model()
    return model


def mf_host_costs(ds_dir, flags, n_chunks) -> float:
    """The largest relative difference between the first ``n_chunks`` chunk
    costs on the host-sampling path (the same draws from one seed) on the
    card and on the CPU; raises beyond 1e-4."""
    import torch

    costs = {}
    for device in ("cuda", "cpu"):
        model = mf_model(ds_dir, flags, device)
        model.device_sampling = model.device_adaptive = False
        out, it = [], 0
        for _ in range(n_chunks):
            cost, n = model.training_step(it)
            out.append(cost)
            it += n
        costs[device] = torch.stack(out).cpu().numpy().astype(np.float64)
    rel = np.abs(costs["cuda"] - costs["cpu"]) / np.abs(costs["cpu"])
    if rel.max() > 1e-4:
        raise AssertionError(f"{' '.join(flags)}: host-sampled chunk costs differ: {costs['cuda']} vs {costs['cpu']}")
    return float(rel.max())


def mf_steady(ds_dir, flags, dispatches, card) -> dict:
    """Dispatches of device-sampled training outside the CLI: samples/s over
    ``dispatches`` after one warm-up (host clock to a synchronize), then a
    dispatch of 2 chunks profiled (a whole one would trace ~10^4 kernels):
    device ms and busy share per chunk, the largest kernels."""
    import torch

    model = mf_model(ds_dir, flags, "cuda")
    model.training_step(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    samples = 0
    for _ in range(dispatches):
        samples += model.training_step(samples)[1]
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    chunks, model.chunks_per_dispatch = model.chunks_per_dispatch, 2
    events = {k: v / 2 for k, v in device_events(lambda: model.training_step(samples)).items()}
    dev_ms = sum(events.values())
    ours, port_ms = port_kernel_names(), {}
    for key, ms in events.items():
        if kernel_name(key) in ours:
            port_ms[kernel_name(key)] = port_ms.get(kernel_name(key), 0.0) + ms
    chunk_ms = wall_s * 1e3 / (dispatches * chunks)
    return {"samples_per_s": samples / wall_s, "chunk_ms": chunk_ms, "dispatches_timed": dispatches,
            "chunks_per_dispatch": chunks, "samples_per_chunk": samples // (dispatches * chunks),
            "device_ms_per_chunk": dev_ms, "device_busy_share": dev_ms / chunk_ms,
            "top_kernels_ms_per_chunk": dict(sorted(events.items(), key=lambda kv: -kv[1])[:8]),
            "port_kernels_ms_per_chunk": dict(sorted(port_ms.items(), key=lambda kv: -kv[1])), "card": card}


def same_lists_ties_apart(got, want, scores) -> dict:
    """K4's lists against the host route's on the same tables: the host's
    scores of the two lists equal (rtol 1e-5, atol 1e-4 max|score|) on every
    row, and the lists themselves equal, in order, on each row whose top k+1
    scores are all more than 1e-4 max|score| apart."""
    got, want = np.asarray(got, np.int64), np.asarray(want, np.int64)
    k, exact = got.shape[1], 0
    if got.shape != want.shape:
        raise AssertionError(f"list shapes differ: {got.shape} vs {want.shape}")
    for r, row in enumerate(scores):
        finite = row[np.isfinite(row)]
        tol = 1e-4 * np.abs(finite).max()
        if not np.allclose(row[got[r]], row[want[r]], rtol=1e-5, atol=tol):
            raise AssertionError(f"row {r}: K4's list scores {row[got[r]]} against the host's {row[want[r]]}")
        top = -np.sort(-finite)[: k + 1]
        if np.all(-np.diff(top) > tol):
            if not np.array_equal(got[r], want[r]):
                raise AssertionError(f"row {r}: K4's list {got[r]} differs from the host's {want[r]}")
            exact += 1
    return {"rows": len(got), "rows_compared_in_order": exact, "rows_with_ties_compared_by_score": len(got) - exact}


def mf_eval_routes(model) -> dict:
    """One validation pass of a factorization model on the card both ways,
    each timed on the host clock: K4 (``DEVICE_TOPK_MIN_ITEMS`` lowered to 1
    on the instance, its launches counted) and the host route (numpy scores
    and argpartition); K4's lists against the host's, ties checked apart."""
    import torch

    instances = [(s[: len(s) // 2], u) for s, u in model.dataset.validation_set(epochs=1)]
    threshold = model.DEVICE_TOPK_MIN_ITEMS
    model.DEVICE_TOPK_MIN_ITEMS = 1
    model.top_k_batch(instances)  # warm-up
    zero_counters()
    t0 = time.perf_counter()
    dev = model.top_k_batch(instances)
    torch.cuda.synchronize()
    device_s = time.perf_counter() - t0
    k4 = wrapper("fused_score_topk").launches
    model.DEVICE_TOPK_MIN_ITEMS = np.inf
    t0 = time.perf_counter()
    host = model.top_k_batch(instances)
    host_s = time.perf_counter() - t0
    model.DEVICE_TOPK_MIN_ITEMS = threshold
    user_ids = np.array([int(u) for _, u in instances], dtype=np.int64)
    scores = model._batch_scores(user_ids, [s for s, _ in instances])
    for row, (seq, _) in zip(scores, instances):
        row[[int(x[0]) for x in seq]] = -np.inf
    return {"n_items": model.n_items, "validation_users": len(instances), "k4_launches": k4,
            "k4_route_s": device_s, "host_route_s": host_s, "same_as_host_route": same_lists_ties_apart(dev, host, scores)}


def mf_test_cli_k4(ds_dir, flags, save_dir) -> dict:
    """The test CLI on a checkpoint at 49,999 items, on the card with every
    counter at 0 (K4 must launch, and nothing else), then on the CPU (K4's
    plain version): the same lists, ties checked apart on the host scores
    of the loaded tables (same_lists_ties_apart). Then the same with
    ``--save --save_rank`` (k = 49,999: the device scores sorted, no
    launch) on the card and the CPU: the same ``_full_rank`` lines, ties
    apart (rank_lines_ties_apart)."""
    import glob
    import shutil

    from seqrec_tpu_torch.cli import test as test_cli

    argv = ["-d", ds_dir, *flags, "--dir", save_dir]
    zero_counters()
    t0 = time.perf_counter()
    ev_gpu = run_cli(test_cli.main, argv)[0]
    cuda_s = time.perf_counter() - t0
    launches = read_counters()
    if launches["fused_score_topk"] == 0 or any(n for k, n in launches.items() if k != "fused_score_topk"):
        raise AssertionError(f"the test CLI of {' '.join(flags)} at 49,999 items launched {launches}")
    ev_cpu = run_cli(test_cli.main, argv + ["--device", "cpu"])[0]
    model = mf_model(ds_dir, flags, "cpu", extended=False)
    [ckpt] = glob.glob(os.path.join(ds_dir, "models", save_dir, "*.npz"))
    model.load(ckpt)
    viewed, users = zip(*[(s[: len(s) // 2], u) for s, u in model.dataset.test_set(epochs=1)])
    scores = model._batch_scores(np.array([int(u) for u in users], dtype=np.int64), list(viewed))
    for row, seq in zip(scores, viewed):
        row[[int(x[0]) for x in seq]] = -np.inf
    same = same_lists_ties_apart([p for _, p in ev_gpu.instances], [p for _, p in ev_cpu.instances], scores)
    # --save_rank: k = n_items, past K4's k <= 64, so the device scores are sorted (no kernel launches)
    results = os.path.join(ds_dir, "results")
    ranks, rank_launches, rank_s = {}, None, None
    for device in ("cuda", "cpu"):
        shutil.rmtree(results, ignore_errors=True)
        zero_counters()
        t0 = time.perf_counter()
        run_cli(test_cli.main, argv + ["--save", "--save_rank", "--device", device])
        if device == "cuda":
            rank_s, rank_launches = time.perf_counter() - t0, read_counters()
        [rank_file] = glob.glob(os.path.join(results, "**", "*_full_rank"), recursive=True)
        with open(rank_file) as f:
            ranks[device] = f.read().splitlines()
    shutil.rmtree(results, ignore_errors=True)
    if any(rank_launches.values()):
        raise AssertionError(f"the --save_rank test CLI of {' '.join(flags)} launched {rank_launches}")
    goals = [(row, int(x[0])) for row, (s, _) in zip(scores, model.dataset.test_set(epochs=1))
             for x in s[len(s) // 2:]]
    return {"k4_launches": launches["fused_score_topk"], "cuda_s": cuda_s, "test_users": len(viewed),
            "same_as_cpu": same, "metrics@10": {m: ev_gpu.metrics[m]() for m in ("sps", "recall")},
            "save_rank": {"launches": rank_launches, "cuda_s": rank_s, "k": model.n_items,
                          "same_as_cpu": rank_lines_ties_apart(ranks["cuda"], ranks["cpu"], goals)}}


def main_path_train_mf(card) -> tuple[dict, dict]:
    """The factorization family on ml1m_pp_dataset() at MF_RUNS' flags:
    for each model (BPRMF uniform and adaptive, FPMC, FISM-BPR, Fossil),
    with every counter at 0, two dispatches (16,384 samples) and one
    validation through the train CLI on the card (G1's backward carries the
    table scatters; nothing else launches, K4 neither: 3,706 items score on
    the host); the first 20 chunk costs of the host-sampling path on the
    card against the CPU's (rel 1e-4); the test CLI on the checkpoint on
    the card and the CPU (the same top-10 lists); steady dispatches; one
    validation pass on the checkpoint through K4 and through the host, timed
    and compared (mf_eval_routes). G1's
    backward at the scatters' shapes (BPRMF's H rows, FISM's baskets with
    pad slots) against its plain version. Then on catalog50k_dataset() a
    BPRMF and an FPMC validation through the train CLI (K4 must launch), and
    the two routes again on each checkpoint; the test CLI on each checkpoint
    on the card (through K4) and the CPU (mf_test_cli_k4: at 3,706 items
    both devices score on the host, so this is the check that holds the
    test CLI's K4 route to the CPU); K4 at that shape against its plain
    version. Returns the runs' launches and the kernel checks."""
    import glob

    import torch

    t_phase = time.perf_counter()
    ds_dir, _ = ml1m_pp_dataset()
    runs = {}
    for name, flags in MF_RUNS.items():
        text, cli_s, launches = train_run(ds_dir, flags + ["--extended_set"], 16384, save_dir=f"chip_mf_{name}/")
        if launches["gather_sum_bwd"] == 0 or any(n for k, n in launches.items()
                                                  if k not in ("gather_sum_bwd", "gru_scan_train_cluster")):
            raise AssertionError(f"{name}'s two dispatches and validation launched {launches}")
        runs[name] = {
            "flags": " ".join(flags), "launches": launches, "cli_cuda_s": cli_s, "samples": 16384,
            "throughput_samples_per_s": progress_values(text, "Throughput"),
            "train_cost": progress_values(text, "Last train cost"), "validation_sps@10": progress_values(text, "sps"),
            "validation_recall@10": progress_values(text, "recall"),
            "first_20_host_chunk_costs_cuda_vs_cpu_max_rel_diff": mf_host_costs(ds_dir, flags, 20),
            "test_cli": test_cli_lists(ds_dir, flags, f"chip_mf_{name}/"),
            "steady": mf_steady(ds_dir, flags, 4 if name in ("fism_bpr", "fossil") else 20, card),
        }
        model = mf_model(ds_dir, flags, "cuda")
        [ckpt] = glob.glob(os.path.join(ds_dir, "models", f"chip_mf_{name}", "*.npz"))
        model.load(ckpt)
        runs[name]["eval_routes"] = mf_eval_routes(model)
    # G1's backward at the scatters' shapes, on real first chunks
    bprmf = mf_model(ds_dir, MF_RUNS["bprmf"], "cpu")
    _, i, j = bprmf._sample_chunk(bprmf.samples_per_step)
    fism = mf_model(ds_dir, MF_RUNS["fism_bpr"], "cpu")
    basket = fism._sample_baskets(fism.samples_per_step // fism.sub_chunks)[0]
    checks = {
        "gather_sum_bprmf_H": check_gather_sum(np.concatenate([i, j])[:, None], 32, bprmf.n_items, seed=78),
        "gather_sum_fism_basket": check_gather_sum(basket.reshape(-1, 1), 32, fism.n_items, seed=79),
    }

    ds50 = catalog50k_dataset()
    large = {}
    for name in ("bprmf", "fpmc"):
        flags = MF_RUNS[name]
        text, cli_s, launches = train_run(ds50, flags, 8192, save_dir=f"chip_mf50k_{name}/")
        if launches["fused_score_topk"] == 0 or launches["gather_sum_bwd"] == 0 or any(
            n for k, n in launches.items() if k not in ("gather_sum_bwd", "fused_score_topk", "gru_scan_train_cluster")
        ):
            raise AssertionError(f"{name}'s dispatch and validation at 49,999 items launched {launches}")
        model = mf_model(ds50, flags, "cuda", extended=False)
        [ckpt] = glob.glob(os.path.join(ds50, "models", f"chip_mf50k_{name}", "*.npz"))
        model.load(ckpt)
        large[name] = {"launches": launches, "cli_cuda_s": cli_s, "validation_sps@10": progress_values(text, "sps"),
                       "eval_routes": mf_eval_routes(model),
                       "test_cli": mf_test_cli_k4(ds50, flags, f"chip_mf50k_{name}/")}
    B = large["fpmc"]["eval_routes"]["validation_users"]
    S = -(-max(len(s) // 2 for s, _ in model.dataset.validation_set(epochs=1)) // 16) * 16
    checks["fused_score_topk_bprmf"] = check_topk(B, 32, model.n_items, S, 10, seed=80)
    checks["fused_score_topk_fpmc"] = check_topk(B, 64, model.n_items, S, 10, seed=81, timed=False)
    emit({
        "phase": "main_path_train_mf", "dataset": "ml1m_pp (--extended_set), catalog50k for K4",
        "config": "scripts/baseline_run.sh:37-47 / baseline_run3.sh flags; 512 samples a chunk, 16 chunks a "
        "dispatch (FISM/Fossil: 16 sub-chunks of 32 a chunk)",
        "runs": runs, "large_catalog": large, "kernel_checks": checks,
        "tolerance": "host-sampled chunk costs rel 1e-4 (G1's fixed order and atomic bias index_add_ vs the CPU)",
        "seconds": time.perf_counter() - t_phase,
    })
    return {**{n: r["launches"] for n, r in runs.items()}, **{n + "_50k": r["launches"] for n, r in large.items()}}, checks


# ----------------------------------------------------------------------
# main path, training: the side features, --bf16 and bf16 Adam moments
# ----------------------------------------------------------------------
def featured_dataset() -> str:
    """ml1m_dataset()'s split with side tables at ML-1M's widths
    (``write_side_features``, seed 7: 18 genres, 1-6 an item), in a
    directory of its own."""
    import shutil

    from seqrec_tpu_torch.data import DataHandler
    from seqrec_tpu_torch.data.synthetic import write_side_features

    path = os.path.join(WORK, "ml1m_feat")
    if not os.path.exists(os.path.join(path, "data", "user_features")):
        shutil.rmtree(path, ignore_errors=True)
        shutil.copytree(ml1m_dataset(), path, ignore=shutil.ignore_patterns("models", "results"))
        for sub in ("models", "results"):
            os.makedirs(os.path.join(path, sub), exist_ok=True)
        handler = DataHandler(path + "/")
        write_side_features(path, handler.n_items, handler.n_users, seed=7)
    return path + "/"


def checkpoint_files(save_dir) -> list:
    import glob

    from seqrec_tpu_torch.cli import test as test_cli

    return sorted(glob.glob(os.path.join(save_dir, "*_ne*")), key=test_cli.extract_number_of_epochs)


def opt_count(path) -> int:
    """The Adam step count a checkpoint's optimizer leaves hold (leaf 0)."""
    from seqrec_tpu_torch.models.base import pytree_load

    tree = pytree_load(path)
    if "opt" not in tree:
        raise AssertionError(f"{path} holds no optimizer state")
    return int(np.asarray(tree["opt"]["0"]))


def rank_lines_ties_apart(got_lines, want_lines, goals) -> dict:
    """Two ``_full_rank`` files of one checkpoint (the card's, the CPU's)
    line by line, ``goals`` the (CPU scores with the seen items at -inf,
    goal item) of each line: equal, or both goal positions inside the band
    of items whose CPU scores lie within 1e-4 max|score| of the goal's (a
    -inf goal, seen before, anywhere in the -inf block)."""
    if not (len(got_lines) == len(want_lines) == len(goals)):
        raise AssertionError(f"full-rank files of {len(got_lines)} and {len(want_lines)} lines for {len(goals)} goals")
    exact = 0
    for g_line, w_line, (row, goal) in zip(got_lines, want_lines, goals):
        if g_line == w_line:
            exact += 1
            continue
        finite = row[np.isfinite(row)]
        tol = 1e-4 * np.abs(finite).max()
        s = row[goal]
        lo, hi = (len(finite), len(row)) if s == -np.inf else (int((row > s + tol).sum()), int((row >= s - tol).sum()))
        positions = [int(line.split("\t")[1]) for line in (g_line, w_line)]
        if g_line.split("\t")[0] != w_line.split("\t")[0] or not all(lo <= p < hi for p in positions):
            raise AssertionError(f"full rank: {g_line!r} against the CPU's {w_line!r}, tie band [{lo}, {hi})")
    return {"lines": len(goals), "lines_equal": exact, "lines_in_one_tie_band": len(goals) - exact}


def full_rank_ties_apart(got_lines, want_lines, ds_dir, flags, save_dir) -> dict:
    """``rank_lines_ties_apart`` of an RNN checkpoint's two ``_full_rank``
    files, on the CPU's ranking scores of its test instances."""
    import torch

    import seqrec_tpu_torch.utils.command_parser as parse
    from seqrec_tpu_torch.data import DataHandler

    args = parse.command_parser(parse.predictor_command_parser, argv=flags)
    args.device = "cpu"
    model = parse.get_predictor(args)
    dataset = DataHandler(ds_dir)
    model.prepare_model(dataset)
    model.set_dataset(dataset)
    [ckpt] = checkpoint_files(os.path.join(ds_dir, "models", save_dir))
    model.load(ckpt)
    instances = list(model._iter_test_instances(dataset.test_set(epochs=1)))
    ids, id_mask, mask = model._encode_sequences([s for s, _, _ in instances], user_ids=[u for _, _, u in instances])
    with torch.inference_mode():
        scores = model._rank_scores(*(torch.from_numpy(a) for a in (ids, id_mask, mask))).numpy().copy()
    goals = []
    for row, (seq, goal, _) in zip(scores, instances):
        row[[int(x[0]) for x in seq]] = -np.inf
        goals += [(row, int(g)) for g in goal]
    return rank_lines_ties_apart(got_lines, want_lines, goals)


def main_path_train_features(card) -> tuple[dict, dict]:
    """The featured flagship (FEATURED: GRU-50 CCE, --rf --mf --uf, F=14)
    on the ML-1M-scale dataset with seeded side tables: G1 on one real
    featured B16 batch and one B1024 batch (timed, id runs); with every
    counter at 0, 200 steps and two validations through the train CLI,
    saving with the optimizer state through the async queue (K1, G1, K3,
    K4 > 0, K2 = 0); a resume with --load_last_model under --profile (the
    checkpoint's Adam count continues: the optimizer state was read); the
    first 20 step costs against the CPU's within 1e-4; the test CLI with
    --save --save_rank on the last checkpoint on the card and on the CPU
    (the same _full_rank lines, ties apart); steady steps. Returns the
    launches of its CLI runs and the G1 checks."""
    import glob
    import json
    import shutil

    import torch

    from seqrec_tpu_torch.cli import test as test_cli
    from seqrec_tpu_torch.cli import train as train_cli
    from seqrec_tpu_torch.models.base import RNNBase

    t_phase = time.perf_counter()
    ds_dir = featured_dataset()
    rows, [(ids16, len16)] = real_batch_ids(FEATURED, ds_dir)
    _, [(ids1024, len1024)] = real_batch_ids([{"16": "1024"}.get(a, a) for a in FEATURED], ds_dir)
    if ids16.shape[-1] != 14:
        raise AssertionError(f"the featured batch has {ids16.shape[-1]} ids a step, not 14")
    checks = {}
    for name, ids, lengths, seed in (("B16", ids16, len16, 90), ("B1024", ids1024, len1024, 91)):
        checks[name] = check_gather_sum(ids, 150, rows, seed=seed)
        checks[name]["id_runs"] = id_runs(ids, lengths)
    save_dir = os.path.join(ds_dir, "models", "chip_feat")
    shutil.rmtree(save_dir, ignore_errors=True)
    prof_dir = os.path.join(WORK, "profile_features")
    shutil.rmtree(prof_dir, ignore_errors=True)
    ran = ("gru_scan_train_fwd", "gru_scan_train_bwd", "gru_scan", "fused_score_topk", "gather_sum_fwd",
           "gather_sum_bwd")
    runs, texts = {}, {}
    RNNBase.save_optimizer_state = True
    try:
        for run, extra in (("train_cli", ["--max_iter", "200", "--progress", "100"]),
                           ("resume_cli", ["--max_iter", "100", "--progress", "100", "--load_last_model",
                                           "--profile", prof_dir])):
            argv = ["-d", ds_dir, *FEATURED, *extra, "--save", "All", "--dir", "chip_feat/"]
            zero_counters()
            t0 = time.perf_counter()
            text = texts[run] = run_cli(train_cli.main, argv)[1]
            torch.cuda.synchronize()
            launches = read_counters()
            if any(launches[k] == 0 for k in ran) or launches["cce_stats"] or launches["cce_grads"]:
                raise AssertionError(f"the featured {run} launched {launches}")
            runs[run] = {"launches": launches, "cli_cuda_s": time.perf_counter() - t0,
                         "throughput_sequences_per_s": progress_values(text, "Throughput"),
                         "train_cost": progress_values(text, "Last train cost"),
                         "validation_sps@10": progress_values(text, "sps"),
                         "checkpoints": [os.path.basename(f) for f in checkpoint_files(save_dir)],
                         "opt_counts": [opt_count(f) for f in checkpoint_files(save_dir)]}
    finally:
        RNNBase.save_optimizer_state = False
    counts = runs["resume_cli"]["opt_counts"]
    if runs["train_cli"]["opt_counts"] != [100, 200] or counts != [100, 200, 300]:
        raise AssertionError(f"async saves with optimizer state: {runs['train_cli']['opt_counts']}, then {counts}")
    if "Starting from model" not in texts["resume_cli"]:
        raise AssertionError("--load_last_model did not start from the last checkpoint")
    with open(os.path.join(prof_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    runs["resume_cli"]["profile"] = {
        "trace_mb": os.path.getsize(os.path.join(prof_dir, "trace.json")) / 1e6, "events": len(events),
        "cuda_kernel_events": sum(e.get("cat") == "kernel" for e in events)}
    if runs["resume_cli"]["profile"]["cuda_kernel_events"] == 0:
        raise AssertionError("--profile recorded no CUDA kernel")
    rel = cpu_step_costs(ds_dir, FEATURED, 20)

    # --save_rank on the last checkpoint: the card, then the CPU
    rank_dir = os.path.join(ds_dir, "models", "chip_feat_rank")
    shutil.rmtree(rank_dir, ignore_errors=True)
    os.makedirs(rank_dir)
    shutil.copy(checkpoint_files(save_dir)[-1], rank_dir)
    argv = ["-d", ds_dir, *FEATURED, "--dir", "chip_feat_rank/", "--save", "--save_rank"]
    results = os.path.join(ds_dir, "results")
    ranks = {}
    for device in ("cuda", "cpu"):
        shutil.rmtree(results, ignore_errors=True)
        zero_counters()
        t0 = time.perf_counter()
        ev = run_cli(test_cli.main, argv + ["--device", device])[0]
        if device == "cuda":
            torch.cuda.synchronize()
            test_s, test_launches = time.perf_counter() - t0, read_counters()
            metrics = {m: ev.metrics[m]() for m in ("sps", "recall", "item_coverage", "user_coverage")}
        [rank_file] = glob.glob(os.path.join(results, "**", "*_full_rank"), recursive=True)
        with open(rank_file) as f:
            ranks[device] = f.read().splitlines()
    if not test_launches["gru_scan"] or not test_launches["gather_sum_fwd"] or test_launches["fused_score_topk"]:
        raise AssertionError(f"the --save_rank test CLI launched {test_launches}")
    same = full_rank_ties_apart(ranks["cuda"], ranks["cpu"], ds_dir, FEATURED, "chip_feat_rank/")
    emit({
        "phase": "main_path_train_features",
        "config": "flagship GRU-50 CCE --rf --mf --uf (F=14), L=30, B=16, Adam 1e-3, ML-1M-scale synthetic with "
                  "seeded ML-1M-width side tables",
        "input_rows": rows, "runs": runs, "first_20_step_costs_cuda_vs_cpu_max_rel_diff": rel,
        "tolerance": "step costs rel 1e-4 (f32 kernels vs the CPU's plain versions, 20 Adam steps); full rank: "
                     "equal lines, or both positions in the goal's band of CPU scores within 1e-4 max|score|",
        "async_saves_with_optimizer_state": {"opt_counts": counts, "resumed_from_count": 200},
        "save_rank": {"launches": test_launches, "cuda_s": test_s, "full_rank_file_lines": len(ranks["cuda"]),
                      "same_as_cpu": same, "metrics@10": metrics},
        "gather_sum": {name: {"ids": c["shape"]["ids"], "id_runs": c["id_runs"], "fwd": c["fwd"], "bwd": c["bwd"],
                              "max_abs_err": c["max_abs_err"]} for name, c in checks.items()},
        "steady": steady_state(FEATURED, ds_dir, steps=150, warmup=20, profile_steps=20, card=card),
        "seconds": time.perf_counter() - t_phase,
    })
    return {run: r["launches"] for run, r in runs.items()} | {"test_cli": test_launches}, checks


def main_path_train_bf16(card) -> dict:
    """The large catalog's GRU-128 at B=1024 with --bf16 --u_moments
    bfloat16 (LARGE_BF16): with every counter at 0, 30 steps and one
    validation through the train CLI (K1, G1, K3, K4 > 0; K2 = 0: the
    bf16 loss runs the chunk loop); the first 3 step costs against the
    CPU's within BF16_COST_TOL; then steady steps without and with --bf16
    in paired runs (f32, bf16, bf16, f32), each with the counters from 0
    (K2 > 0 in the f32 runs, 0 in the bf16 ones). Returns the launches."""
    t_phase = time.perf_counter()
    ds_dir = catalog50k_dataset()
    text, cli_s, launches = train_run(ds_dir, LARGE_BF16, 30)
    ran = ("gru_scan_train_fwd", "gru_scan_train_bwd", "gather_sum_fwd", "gather_sum_bwd", "gru_scan",
           "fused_score_topk")
    if any(launches[k] == 0 for k in ran) or launches["cce_stats"] or launches["cce_grads"]:
        raise AssertionError(f"the bf16 large catalog's training path launched {launches}")
    rel = cpu_step_costs(ds_dir, LARGE_BF16, 3, tol=BF16_COST_TOL)
    paired = []
    for flags in (LARGE, LARGE_BF16, LARGE_BF16, LARGE):
        bf16 = "--bf16" in flags
        zero_counters()
        st = steady_state(flags, ds_dir, steps=10, warmup=3, profile_steps=2, card=card)
        k2 = wrapper("cce_stats").launches + wrapper("cce_grads").launches
        if (k2 > 0) == bf16:
            raise AssertionError(f"K2 launched {k2} times in a {'bf16' if bf16 else 'f32'} run")
        paired.append({"bf16": bf16, "k2_launches": k2, **{k: st[k] for k in (
            "sequences_per_s", "step_ms", "device_ms_per_step", "device_busy_share", "top_kernels_ms_per_step",
            "port_kernels_ms_per_step", "peak_memory_gb")}})
    emit({
        "phase": "main_path_train_bf16",
        "config": "GRU-128, 50k-item synthetic catalog, L=30, B=1024, Adam 1e-3, --bf16 --u_moments bfloat16",
        "launches": launches, "cli_cuda_s": cli_s, "iterations": 30,
        "throughput_sequences_per_s": progress_values(text, "Throughput"),
        "train_cost": progress_values(text, "Last train cost"), "validation_sps@10": progress_values(text, "sps"),
        "first_3_step_costs_cuda_vs_cpu_max_rel_diff": rel,
        "tolerance": f"rel {BF16_COST_TOL} (bf16 operands and stochastically rounded moments, other noise a device)",
        "paired_steady_f32_bf16_bf16_f32": paired,
        "sequences_per_s_bf16_over_f32": (paired[1]["sequences_per_s"] + paired[2]["sequences_per_s"])
        / (paired[0]["sequences_per_s"] + paired[3]["sequences_per_s"]),
        "card": card, "seconds": time.perf_counter() - t_phase,
    })
    return launches


# ----------------------------------------------------------------------
# main path, training: the K-step dispatch (--spd) and the native parser
# ----------------------------------------------------------------------
def spd_run(ds_dir, flags, iters, progress, sub, device) -> tuple[list, list, dict, float]:
    """The train CLI with --save All into models/``sub``, every counter at 0
    before it: (its progress costs, its checkpoint names, the counts, its
    seconds)."""
    import shutil

    import torch

    from seqrec_tpu_torch.cli import train as train_cli

    shutil.rmtree(os.path.join(ds_dir, "models", sub), ignore_errors=True)
    argv = ["-d", ds_dir, *flags, "--max_iter", str(iters), "--progress", str(progress), "--save", "All",
            "--dir", sub, "--device", device]
    zero_counters()
    t0 = time.perf_counter()
    text = run_cli(train_cli.main, argv)[1]
    if device == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    names = sorted(os.listdir(os.path.join(ds_dir, "models", sub)))
    return progress_values(text, "Last train cost"), names, read_counters(), seconds


def spd_against_cpu(ds_dir, flags, iters, progress, sub, ran, tol=1e-4) -> dict:
    """``spd_run`` on the card (each kernel of ``ran`` must launch, and no
    other kernel of the port) and on the CPU: the same checkpoint names
    (epoch stamps) and progress costs within ``tol``, relative."""
    costs, names, launches, cuda_s = spd_run(ds_dir, flags, iters, progress, sub + "cuda/", "cuda")
    if any(launches[k] == 0 for k in ran) or any(n for k, n in launches.items() if k not in ran):
        raise AssertionError(f"{' '.join(flags)} launched {launches}")
    cpu_costs, cpu_names, _, cpu_s = spd_run(ds_dir, flags, iters, progress, sub + "cpu/", "cpu")
    rel = max(abs(a - b) / abs(b) for a, b in zip(costs, cpu_costs)) if costs else None
    if not costs or len(costs) != len(cpu_costs) or rel > tol or names != cpu_names:
        raise AssertionError(f"{' '.join(flags)}: cuda {costs} {names} against cpu {cpu_costs} {cpu_names}")
    return {"flags": " ".join(flags), "steps": iters, "launches": launches, "cli_cuda_s": cuda_s, "cli_cpu_s": cpu_s,
            "progress_costs": costs, "progress_costs_cuda_vs_cpu_max_rel_diff": rel, "checkpoints": names,
            "same_checkpoint_names_as_cpu": True}


def native_parser_check() -> dict:
    """The native sequence parser on this machine: built and taken (its
    counter moves), the same arrays as the Python tokenizer and the load
    time of both on the ML-1M-scale training sequences."""
    from seqrec_tpu_torch.data import native
    from seqrec_tpu_torch.data.dataset import SequenceStore

    fn = os.path.join(ml1m_dataset(), "data", "train_set_sequences")
    t0 = time.perf_counter()
    lib = native.get_lib()
    build_s = time.perf_counter() - t0
    if lib is None:
        raise AssertionError("the native sequence parser did not build or load")
    times = {"native": [], "python": []}
    stores = {}
    for _ in range(3):
        for how in ("native", "python"):
            before = native.native_loads
            failed, native._lib_failed = native._lib_failed, how == "python"
            lib_saved, native._lib = native._lib, (lib if how == "native" else None)
            t0 = time.perf_counter()
            stores[how] = SequenceStore.from_file(fn)
            times[how].append(time.perf_counter() - t0)
            native._lib, native._lib_failed = lib_saved, failed
            if native.native_loads - before != (how == "native"):
                raise AssertionError(f"the {how} load moved the native counter by {native.native_loads - before}")
    a, b = stores["native"], stores["python"]
    for key in ("items", "offsets", "user_ids"):
        if not np.array_equal(getattr(a, key), getattr(b, key)) or getattr(a, key).dtype != getattr(b, key).dtype:
            raise AssertionError(f"native and Python parses differ in {key}")
    if not np.allclose(a.ratings, b.ratings, rtol=1e-6, atol=0):
        raise AssertionError("native and Python parses differ in ratings")
    return {"file": "ml1m_synth/data/train_set_sequences", "sequences": len(a), "interactions": len(a.items),
            "build_and_load_s": build_s, "load_s": {k: statistics.median(v) for k, v in times.items()},
            "python_over_native": statistics.median(times["python"]) / statistics.median(times["native"]),
            "same_arrays_as_tokenizer": True}


def main_path_train_spd(card) -> dict:
    """The K-step dispatch through the train CLI on the card, each run with
    every counter at 0: the flagship at --spd 8 (the index wire: K1 and G1
    a step, K3 and K4 in its two validations, no K2) against the CPU's
    progress costs and checkpoint names; BPR and RNNCluster at
    scripts/baseline_run2.sh's flags at --spd 8 (RNNCluster at --csn 0),
    96 steps each; GRU-128 at B=1024 on the 50k-item catalog at --spd 4
    (K2 must launch); the native sequence parser on this machine."""
    from seqrec_tpu_torch.data import native

    t_phase = time.perf_counter()
    ds_dir = ml1m_dataset()
    loads = native.native_loads
    flagship = FLAGSHIP + ["--spd", str(SPD)]
    runs = {
        "flagship": spd_against_cpu(ds_dir, flagship, 160, 80, "chip_spd_flagship_",
                                    ("gru_scan_train_fwd", "gru_scan_train_bwd", "gather_sum_fwd", "gather_sum_bwd",
                                     "gru_scan", "fused_score_topk")),
        "bpr": spd_against_cpu(ds_dir, SPD_BPR, 96, 32, "chip_spd_bpr_",
                               ("gru_scan_train_fwd", "gru_scan_train_bwd", "gather_sum_fwd", "gather_sum_bwd",
                                "gru_scan", "fused_score_topk")),
        "cluster": spd_against_cpu(ds_dir, SPD_CLUSTER, 96, 32, "chip_spd_cluster_",
                                   ("gru_scan_train_fwd", "gru_scan_train_bwd", "gather_sum_fwd", "gather_sum_bwd",
                                    "gru_scan")),
    }
    runs["flagship"]["first_10_dispatch_costs_cuda_vs_cpu_max_rel_diff"] = cpu_step_costs(
        ds_dir, flagship, 10, steps_a_cost=SPD)
    costs, _, launches, cli_s = spd_run(catalog50k_dataset(), LARGE + ["--spd", "4"], 32, 32, "chip_spd_large/", "cuda")
    ran = ("gru_scan_train_fwd", "gru_scan_train_bwd", "cce_stats", "cce_grads", "gather_sum_fwd", "gather_sum_bwd",
           "gru_scan", "fused_score_topk")
    if any(launches[k] == 0 for k in ran) or not np.isfinite(costs).all() or len(costs) != 1:
        raise AssertionError(f"GRU-128 at --spd 4 launched {launches}, costs {costs}")
    runs["large"] = {"flags": " ".join(LARGE + ["--spd", "4"]), "steps": 32, "launches": launches, "cli_cuda_s": cli_s,
                     "progress_costs": costs}
    if native.native_loads == loads:
        raise AssertionError("the train CLI's dataset did not load through the native parser")
    emit({
        "phase": "main_path_train_spd",
        "config": "--spd 8: flagship (index wire), BPR and RNNCluster at scripts/baseline_run2.sh:30-33, :53-56; "
                  "--spd 4: GRU-128 B1024 at 49,999 items",
        "runs": runs, "native_loads_in_training": native.native_loads - loads, "native_parser": native_parser_check(),
        "tolerance": "progress costs (means of K-step dispatches) rel 1e-4 against the CPU CLI at the same --spd",
        "seconds": time.perf_counter() - t_phase,
    })
    return {name: r["launches"] for name, r in runs.items()}


def serving_pass_gru256(card) -> dict:
    """GRU-256 serving on the 50k-item catalog: 4096 users at eval chunks
    of 512 with every counter at 0 (K3 on K3_PATH_H256, K4), the
    first 512 users' top-10 lists against the same model on the CPU.
    Returns the launch counts of the pass."""
    import torch

    from seqrec_tpu_torch.data import DataHandler
    from seqrec_tpu_torch.models.recurrent import RecurrentLayers
    from seqrec_tpu_torch.models.rnn_one_hot import RNNOneHot
    from seqrec_tpu_torch.models.updates import Adam
    from seqrec_tpu_torch.ops.rnn_scan import gru_scan_device_plan

    t_phase = t0 = time.perf_counter()
    dataset = DataHandler(catalog50k_dataset())
    models = {}
    for device in ("cpu", "cuda"):
        model = RNNOneHot(
            recurrent_layer=RecurrentLayers(layer_type="GRU", layers=[256]),
            updater=Adam(learning_rate=0.001), max_length=30, batch_size=1024, seed=0, device=device,
        )
        model.prepare_model(dataset)
        model.set_dataset(dataset)
        model.eval_batch_size = 512
        models[device] = model
    params = models["cpu"]._init_params()
    for model in models.values():
        model.params_from_numpy(params)
    inputs = []
    for seq, _, _ in models["cuda"]._iter_test_instances(dataset.training_set(epochs=1)):
        inputs.append(seq)
        if len(inputs) == 4096:
            break
    gpu = models["cuda"]
    gpu._batched_recommendations(inputs[:512])  # warm-up
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    zero_counters()
    t0 = time.perf_counter()
    staged = gpu._stage_eval_inputs(inputs)
    t1 = time.perf_counter()
    recs = gpu._topk_from_staged(staged, k=10)
    t2 = time.perf_counter()
    launches = read_counters()
    on_path = getattr(wrapper("gru_scan"), K3_COUNTERS[K3_PATH_H256])
    if launches["gru_scan"] == 0 or launches["fused_score_topk"] == 0 or on_path != launches["gru_scan"]:
        raise AssertionError(f"the GRU-256 serving pass launched {launches}, {on_path} on K3's {K3_PATH_H256} path")
    recs_cpu = models["cpu"]._batched_recommendations(inputs[:512])
    if not np.array_equal(recs[:512], recs_cpu):
        n_diff = int((recs[:512] != recs_cpu).any(axis=1).sum())
        raise AssertionError(f"GRU-256 top-10 lists differ between cuda and cpu on {n_diff} of 512 users")
    wall_s = t2 - t0
    device = device_events(lambda: gpu._batched_recommendations(inputs))
    dev_ms = sum(device.values())
    emit({
        "phase": "serving_pass_gru256", "config": "GRU-256 RNNOneHot from seed 0, 50k-item synthetic catalog, eval chunk 512",
        "n_items": dataset.n_items, "users": len(inputs), "card": card, "launches": launches,
        f"gru_scan_{K3_PATH_H256}_launches": on_path,
        "gru_scan_plan": list(gru_scan_device_plan(512, 256, torch.device("cuda", torch.cuda.current_device()))),
        "same_top10_as_cpu_first_512": True, "users_per_s": len(inputs) / wall_s, "wall_s": wall_s,
        "encode_upload_s": t1 - t0, "topk_s": t2 - t1, "setup_s": setup_s,
        "timed": "host clock; topk_s = GRU scan + fused top-k + copy back of every chunk",
        "profile": {"device_ms": dev_ms, "device_busy_share": dev_ms / (wall_s * 1e3),
                    "top_kernels_ms": dict(sorted(device.items(), key=lambda kv: -kv[1])[:5])},
        "seconds": time.perf_counter() - t_phase,
    })
    return {**launches, "gru_scan_on_path": on_path}


# ----------------------------------------------------------------------
# the main path over a mesh: torch.distributed ranks on the one card
# ----------------------------------------------------------------------
# seconds one group of rank processes may take before the phase fails (and kills them)
MESH_TIMEOUT = 420
MESH_RAN = ("gru_scan_train_fwd", "gru_scan_train_bwd", "gather_sum_fwd", "gather_sum_bwd", "gru_scan",
            "fused_score_topk")
# the other heads on the two gloo ranks: (flags, dataset ("ml1m" or "big"), steps, mesh, save, the
# kernels each rank must launch); every other counter of the port must stay 0
MESH_HEADS = {
    "bpr_2x1": (HEADS_BPR, "ml1m", 50, "2,1", True, MESH_RAN),
    "bpr_1x2": (HEADS_BPR, "ml1m", 50, "1,2", True, MESH_RAN),
    "hinge_1x2": (HEADS_HINGE, "ml1m", 50, "1,2", False, MESH_RAN),
    "large_hinge_1x2": (LARGE_HINGE, "big", 8, "1,2", False, MESH_RAN),
    "cluster_1x2": (CLUSTER, "ml1m", 50, "1,2", False, MESH_RAN[:5]),
    "fism_cluster_1x2": (FISM_CLUSTER, "ml1m", 50, "1,2", False, ("gather_sum_fwd", "gather_sum_bwd")),
    "sda_1x2": (SDA + ["--do", "0.3"], "ml1m", 50, "1,2", False, ()),
    # --lazy_updates and --bf16 (K2 must stay 0 in the bf16 run: its loss is the bf16 chunk loop)
    "lazy_flagship_2x1": (FLAGSHIP + ["--lazy_updates"], "ml1m", 50, "2,1", False, MESH_RAN),
    "lazy_large_bpr_1x2": (LARGE_BPR_LAZY, "big", 8, "1,2", False, MESH_RAN),
    "lazy_large_cce_1x2": (LARGE + ["--lazy_updates"], "big", 8, "1,2", False, MESH_RAN + ("cce_stats", "cce_grads")),
    "bf16_large_1x2": (LARGE_BF16, "big", 8, "1,2", False, MESH_RAN),
    "bf16_hinge_1x2": (HEADS_HINGE + ["--bf16"], "ml1m", 50, "1,2", False, MESH_RAN),
}
# the --bf16 runs, whose validation may differ from the one-card run's in one user's list (their
# validation users): a bf16 rounding turns the shards' f32 sums in another order into a whole bf16
# ulp now and then (the dense product's dh; with --u_moments bfloat16 the moments' stochastic
# rounding), and a near tie in a top-10 list may swap. On an H100 the two ranks' ndcg differed from
# the one-card run's by one swap, recall and sps equal: 0.0081591 against 0.0081655 (bf16 large),
# 0.3327973 against 0.3326448 (bf16 hinge)
MESH_ONE_USER = {"bf16_large_1x2": 500, "bf16_hinge_1x2": 100}
# the validation metrics a progress line prints, of the RNN family and of the cluster models
MESH_VALIDATION = ("recall", "sps", "ndcg", "user_coverage", "item_coverage", "blockbuster_share", "cluster_recall",
                   "cluster_sps", "assr", "cluster_use_std")


def catalog50k_even_dataset() -> str:
    """The large catalog's generator at seed 9, which keeps 50,000 items: a
    catalog that divides a model axis of 2 (seed 8's 49,999 items leave
    W_out whole on every rank, and K2 would never run on a shard)."""
    from seqrec_tpu_torch.data.synthetic import catalog_interactions, write_dataset

    path = os.path.join(WORK, "catalog50k_even")
    if os.path.exists(os.path.join(path, "data", "stats")):
        return path + "/"
    rows = catalog_interactions(n_users=25_000, n_items=50_000, min_len=20, max_len=100, seed=9)
    return write_dataset(path, rows, n_val_users=500, n_test_users=500, seed=9)


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def start_ranks(tag: str, n_ranks: int, backend: str, runs: list) -> list:
    """Start ``n_ranks`` processes of this script as the ranks of one
    ``backend`` process group on this host (torchrun's variables set here),
    each running ``runs`` (``mesh_rank``). Returns (tag, rank, process,
    log file, result file) per rank."""
    os.makedirs(WORK, exist_ok=True)
    cfg = os.path.join(WORK, f"mesh_{tag}.json")
    with open(cfg, "w") as f:
        json.dump({"backend": backend, "runs": runs, "out": os.path.join(WORK, f"mesh_{tag}")}, f)
    port = free_port()
    ranks = []
    for rank in range(n_ranks):
        env = {**os.environ, "RANK": str(rank), "WORLD_SIZE": str(n_ranks), "LOCAL_RANK": str(rank),
               "LOCAL_WORLD_SIZE": str(n_ranks), "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}
        log = open(os.path.join(WORK, f"mesh_{tag}_rank{rank}.log"), "w+")
        proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--mesh-rank", cfg], env=env,
                                stdout=log, stderr=subprocess.STDOUT, cwd=ROOT)
        ranks.append((tag, rank, proc, log, os.path.join(WORK, f"mesh_{tag}_rank{rank}.json")))
    return ranks


def wait_ranks(ranks: list, timeout: float) -> dict:
    """Wait for every rank; the first that fails, or the time limit, kills
    them all and raises with the end of each log. Returns {tag: [each
    rank's results]}."""
    deadline = time.monotonic() + timeout
    try:
        while any(proc.poll() is None for _, _, proc, _, _ in ranks):
            if any(proc.poll() not in (None, 0) for _, _, proc, _, _ in ranks) or time.monotonic() > deadline:
                break
            time.sleep(0.1)
    finally:
        for _, _, proc, _, _ in ranks:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
    failed = [(tag, rank, proc.returncode) for tag, rank, proc, _, _ in ranks if proc.returncode != 0]
    logs = []
    for tag, rank, proc, log, _ in ranks:
        log.seek(0)
        logs.append(f"--- {tag} rank {rank} (rc {proc.returncode}) ---\n{log.read()[-3000:]}")
        log.close()
    if failed:
        raise AssertionError(f"mesh ranks failed or timed out after {timeout} s: {failed}\n" + "\n".join(logs))
    out: dict = {}
    for tag, _, _, _, path in ranks:
        with open(path) as f:
            out.setdefault(tag, []).append(json.load(f))
    return out


def mesh_rank(cfg_path: str) -> int:
    """One rank (``python3 chip_smoke.py --mesh-rank CFG``): join the
    process group with the configured backend, then run each CLI of the
    configuration with every counter at 0 before it, recording its
    progress costs or top-10 lists, its seconds and the counts."""
    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, ROOT)
    from seqrec_tpu_torch.cli import test as test_cli
    from seqrec_tpu_torch.cli import train as train_cli
    from seqrec_tpu_torch.parallel import init_distributed

    with open(cfg_path) as f:
        cfg = json.load(f)
    if not init_distributed(backend=cfg["backend"]):
        raise RuntimeError("no process group")
    rank = dist.get_rank()
    results = {}
    for run in cfg["runs"]:
        argv = [a.replace("{rank}", str(rank)) for a in run["argv"]]
        zero_counters()
        t0 = time.perf_counter()
        result, text = run_cli(train_cli.main if run["cli"] == "train" else test_cli.main, argv)
        torch.cuda.synchronize()
        rec = {"seconds": time.perf_counter() - t0, "launches": read_counters()}
        if run["cli"] == "train":
            rec["costs"] = progress_values(text, "Last train cost")
            rec["validation"] = {m: progress_values(text, m) for m in MESH_VALIDATION}
        else:
            rec["lists"] = [[int(i) for i in pred] for _, pred in result.instances]
        results[run["name"]] = rec
    with open(cfg["out"] + f"_rank{rank}.json", "w") as f:
        json.dump(results, f)
    dist.destroy_process_group()
    return 0


def checkpoint_layout(path) -> dict:
    from seqrec_tpu_torch.models.base import _flatten, pytree_load

    return {key: list(np.shape(value)) for key, value in _flatten(pytree_load(path))}


def same_layout(ds_dir, mesh_dir, single_dir) -> dict:
    """The mesh run's checkpoints are rank 0's alone (rank 1's directory
    holds nothing) and have the single-device run's keys and shapes."""
    models = os.path.join(ds_dir, "models")
    got = sorted(os.listdir(os.path.join(models, mesh_dir + "0")))
    other = os.path.join(models, mesh_dir + "1")
    other = os.listdir(other) if os.path.exists(other) else []
    if not got or other:
        raise AssertionError(f"{mesh_dir}: rank 0 wrote {got}, rank 1 wrote {other}")
    want = checkpoint_layout(os.path.join(models, single_dir, sorted(os.listdir(os.path.join(models, single_dir)))[0]))
    for name in got:
        layout = checkpoint_layout(os.path.join(models, mesh_dir + "0", name))
        if layout != want:
            raise AssertionError(f"{mesh_dir}{name}: keys and shapes {layout} against {want}")
    return {"files_rank0": len(got), "files_rank1": 0, "same_keys_and_shapes_as_single_device": True,
            "leaves": len(want)}


def same_validation(name: str, got: dict, want: dict) -> dict:
    """A mesh run's validation metrics against the one-card run's: equal,
    ASSR within 1e-5 (a float sum of used-item counts over the shards);
    for a run of MESH_ONE_USER, within what one user's top-10 list can move
    them (the mean metrics by 1 / users, item coverage by 10 items)."""
    users = MESH_ONE_USER.get(name)
    for m, values in want.items():
        rtol = 1e-5 if m == "assr" else 0.0
        atol = 0.0 if users is None else (10.0 if m == "item_coverage" else 1.0 / users)
        if len(got[m]) != len(values) or not np.allclose(got[m], values, rtol=rtol, atol=atol):
            raise AssertionError(f"{name}: validation {m}: {got[m]} against the one-card run's {values}")
    out = {m: v for m, v in want.items() if v}
    if users is not None:
        out["max_abs_diff"] = {m: max(abs(a - b) for a, b in zip(got[m], v)) for m, v in out.items()}
    return out


def flagship_test_scores(ds_dir, save_dir, flags=FLAGSHIP):
    """The logits, seen items at -inf, of every test user of the last
    checkpoint of ``flags`` (the flagship's by default) in
    models/``save_dir`` on the card (the test CLI's inputs and file
    order)."""
    import glob
    import re

    import torch

    import seqrec_tpu_torch.utils.command_parser as parse
    from seqrec_tpu_torch.data import DataHandler

    args = parse.command_parser(parse.predictor_command_parser, argv=flags)
    model = parse.get_predictor(args)
    dataset = DataHandler(ds_dir)
    model.prepare_model(dataset)
    model.set_dataset(dataset)
    files = sorted(glob.glob(os.path.join(ds_dir, "models", save_dir, "*")),
                   key=lambda f: float(re.search(r"_ne([0-9]+(\.[0-9]+)?)_", f).group(1)))
    model.load(files[-1])
    instances = list(model._iter_test_instances(dataset.test_set(epochs=1)))
    ids, id_mask, mask = model._encode_sequences([seq for seq, _, _ in instances],
                                                 user_ids=[u for _, _, u in instances])
    with torch.inference_mode():
        scores = model._logits(model._tensor(ids), model._tensor(id_mask), model._tensor(mask)).cpu().numpy()
    for row, (seq, _, _) in zip(scores, instances):
        row[[int(i[0]) for i in seq]] = -np.inf
    return scores


def mesh_shard_kernels(ds_dir, big_dir, n_big) -> dict:
    """K2, K4 and G1 at the shapes a rank gives them at --mesh 1,2: K2 on
    half the even catalog's columns (timed), and again with every other
    target another shard's (-1); K4 on half of each catalog at the validation chunk (64
    rows of GRU-50, 1,024 of GRU-128); G1 on a real batch's ids localized
    to one shard of the input table (another shard's slot: -1), on FISM's
    bag and on the cluster rows of a shard; K1 and K4 at a data rank's 32
    rows of the heads' batch at --mesh 2,1."""
    def shard_ids(argv, ds, shard, D, seed):
        rows, [(ids, _)] = real_batch_ids(argv, ds)
        n = rows // 2
        local = ids.astype(np.int64) - shard * n
        return check_gather_sum(np.where((local >= 0) & (local < n), local, -1).astype(ids.dtype), D, n, seed=seed)

    heads_rows, [(ids_h, len_h)] = real_batch_ids(HEADS_BPR, ds_dir)
    fism_ids, fism_w, cluster_ids, n_half = head_shard_ids(ds_dir)
    return {
        "cce": check_cce(1024, 128, n_big // 2, seed=80),
        "cce_foreign_targets": check_cce(1024, 128, n_big // 2, seed=85, timed=False, foreign=True),
        "topk_flagship": check_topk(64, 50, 3706 // 2, 30, 10, seed=81),
        "topk_large": check_topk(1024, 128, n_big // 2, 30, 10, seed=82),
        "gather_sum_flagship": shard_ids(FLAGSHIP, ds_dir, 1, 150, seed=84),
        "gather_sum_large": shard_ids(LARGE, big_dir, 0, 384, seed=83),
        # the other heads' shapes: a data rank's 32 rows of the heads' B64 at --mesh 2,1 (K1, and K4 on
        # its half of the validation chunk), FISM's bag and the cluster rows on a shard at 1,2
        "train_scan_rows_B32": check_gru_train(32, 30, 50, 100.0, seed=86, lengths=len_h[:32]),
        "topk_rows_B32": check_topk(32, 50, 3706, 30, 10, seed=87),
        "gather_sum_fism_bag": check_gather_sum(fism_ids, 50, n_half, seed=88, id_mask=fism_w),
        "gather_sum_cluster_rows": check_gather_sum(cluster_ids, 10, n_half, seed=89),
    }


def head_shard_ids(ds_dir):
    """(FISM's bag ids [64, 1, P] and slot weights mask / len^0.2 of a real
    FISM_CLUSTER batch, localized to the second shard of item_embeddings;
    the cluster rows [64 + 256, 1] of a real CLUSTER batch (its targets and
    cluster samples) localized to the first shard of cluster_repartition;
    the rows of a shard): G1's inputs on one rank at --mesh 1,2."""
    import seqrec_tpu_torch.utils.command_parser as parse
    from seqrec_tpu_torch.data import DataHandler

    dataset = DataHandler(ds_dir)
    n_half = dataset.n_items // 2
    models = {}
    for name, flags in (("fism", FISM_CLUSTER), ("cluster", CLUSTER)):
        args = parse.command_parser(parse.predictor_command_parser, argv=flags)
        args.device = "cpu"
        models[name] = parse.get_predictor(args)
        models[name].prepare_model(dataset)
        models[name].set_dataset(dataset)
    fism = models["fism"]
    batch = next(fism._gen_mini_batch(fism.sequence_noise(dataset.training_set())))
    mask = batch["mask"]
    weights = mask / np.power(np.maximum(mask.sum(-1, keepdims=True), 1.0), fism.alpha)
    local = np.minimum(batch["ids"], dataset.n_items - 1).astype(np.int64) - n_half
    fism_ids = np.where((local >= 0) & (local < n_half), local, -1).astype(np.int32)[:, None, :]
    cluster = models["cluster"]
    packed = next(cluster._gen_packed_mini_batch(dataset.training_set, np.random.default_rng(1)))
    rows = np.concatenate([packed["targets"], packed["cluster_samples"]]).astype(np.int64)
    cluster_ids = np.where(rows < n_half, rows, -1)[:, None]
    return fism_ids, weights[:, None, :].astype(np.float32), cluster_ids, n_half


def main_path_mesh(card) -> dict:
    """The main path over a ("data", "model") mesh of torch.distributed
    ranks, one process a rank, on this machine's one card: the flagship
    (150 steps, three validations) at --mesh 1,1 under NCCL, and two ranks
    sharing the card over gloo (NCCL refuses two ranks on one device): the
    flagship (GRU-50, 3,706 items: the vocab-parallel dense head, W_in by
    rows) at --mesh 2,1 and 1,2 for 50 steps and a validation, GRU-128 at
    B=1024 on the 50,000-item catalog (the streaming head, K2 on each
    shard) at --mesh 1,2 --spd 4 for 16 steps and a validation, and the
    test CLI at --mesh 1,2 on the single-device flagship checkpoint; the
    other heads of MESH_HEADS on the same two ranks (BPR at 2,1 and 1,2
    and its test CLI at 1,2, the dense hinge, the streaming hinge,
    RNNCluster, FISMCluster and SDA at 1,2), and the --lazy_updates and
    --bf16 runs of MESH_HEADS. Each run's progress costs against the
    single-device card run's (rel 1e-4) and, for the other heads, its
    validation metrics (equal, ASSR rel 1e-5), the mesh
    checkpoints' keys and shapes against its, the test CLIs' lists
    against the single-device test CLI's (ties apart), and in every rank
    the counts of K1, K2, K3, K4 and G1 above 0 over the runs, each other
    head's kernels above 0 in its run and the port's others at 0 (K2 in
    every run that does not name it). Then K2, K4 and G1 at their
    per-shard shapes."""
    import glob
    import shutil

    import torch

    from seqrec_tpu_torch.cli import test as test_cli
    from seqrec_tpu_torch.cli import train as train_cli
    from seqrec_tpu_torch.data import DataHandler

    t_phase = time.perf_counter()
    ds_dir, big_dir = ml1m_dataset(), catalog50k_even_dataset()
    n_big = DataHandler(big_dir).n_items
    if n_big % 2:
        raise AssertionError(f"the even catalog has {n_big} items")
    big = LARGE + ["--spd", "4"]
    fl_single = ["-d", ds_dir, *FLAGSHIP, "--max_iter", "150", "--progress", "50"]
    fl_mesh = ["-d", ds_dir, *FLAGSHIP, "--max_iter", "50", "--progress", "50", "--save", "Best"]
    big_argv = ["-d", big_dir, *big, "--max_iter", "16", "--progress", "16", "--save", "Best"]
    for path in {p for d in (ds_dir, big_dir) for p in glob.glob(os.path.join(d, "models", "chip_mesh_*"))}:
        shutil.rmtree(path)
    nccl = start_ranks("nccl", 1, "nccl", [
        {"name": "flagship_1x1", "cli": "train", "argv": fl_single + ["--save", "None", "--mesh", "1,1"]},
    ])
    # the single-device references on the card, while the NCCL rank starts
    t0 = time.perf_counter()
    zero_counters()
    fl_text = run_cli(train_cli.main, fl_single + ["--save", "Best", "--dir", "chip_mesh_single/"])[1]
    fl_costs, single_launches = progress_values(fl_text, "Last train cost"), read_counters()
    big_costs = progress_values(run_cli(train_cli.main, big_argv + ["--dir", "chip_mesh_big_single/"])[1],
                                "Last train cost")
    test_argv = ["-d", ds_dir, *FLAGSHIP, "--dir", "chip_mesh_single/"]
    single_lists = [[int(i) for i in pred] for _, pred in run_cli(test_cli.main, test_argv)[0].instances]
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t0
    cuda0 = ["--device", "cuda:0"]
    t0 = time.perf_counter()
    # the other heads: each run's argv without its --dir and --mesh
    heads_argv = {
        name: ["-d", ds_dir if data == "ml1m" else big_dir, *flags, "--max_iter", str(steps), "--progress", str(steps),
               "--save", "Best" if save else "None"]
        for name, (flags, data, steps, _, save, _) in MESH_HEADS.items()
    }
    bpr_test_argv = ["-d", ds_dir, *HEADS_BPR, "--dir", "chip_mesh_bpr_single/"]
    # the one-card references of the other heads: BPR's (its checkpoint is the ranks' test CLI's)
    # before the gloo ranks start, the others while they run
    t1 = time.perf_counter()
    heads_single = {}

    def head_reference(name, extra=()):
        text = run_cli(train_cli.main, heads_argv[name] + list(extra))[1]
        heads_single[name] = {"costs": progress_values(text, "Last train cost"),
                              "validation": {m: progress_values(text, m) for m in MESH_VALIDATION}}

    head_reference("bpr_2x1", ["--dir", "chip_mesh_bpr_single/"])
    heads_single["bpr_1x2"] = heads_single["bpr_2x1"]
    gloo = start_ranks("gloo", 2, "gloo", [
        {"name": "flagship_2x1", "cli": "train",
         "argv": fl_mesh + ["--dir", "chip_mesh_2x1_r{rank}/", "--mesh", "2,1", *cuda0]},
        {"name": "flagship_1x2", "cli": "train",
         "argv": fl_mesh + ["--dir", "chip_mesh_1x2_r{rank}/", "--mesh", "1,2", *cuda0]},
        {"name": "large_1x2_spd4", "cli": "train",
         "argv": big_argv + ["--dir", "chip_mesh_big_r{rank}/", "--mesh", "1,2", *cuda0]},
        {"name": "test_cli_1x2", "cli": "test", "argv": test_argv + ["--mesh", "1,2", *cuda0]},
        *({"name": name, "cli": "train",
           "argv": heads_argv[name] + ["--dir", f"chip_mesh_{name}_r{{rank}}/", "--mesh", MESH_HEADS[name][3], *cuda0]}
          for name in MESH_HEADS),
        {"name": "bpr_test_cli_1x2", "cli": "test", "argv": bpr_test_argv + ["--mesh", "1,2", *cuda0]},
    ])
    for name in MESH_HEADS:
        if name not in heads_single:
            head_reference(name)
    bpr_lists = [[int(i) for i in pred] for _, pred in run_cli(test_cli.main, bpr_test_argv)[0].instances]
    torch.cuda.synchronize()
    heads_single_s = time.perf_counter() - t1
    results = wait_ranks(nccl + gloo, MESH_TIMEOUT)
    ranks_s = time.perf_counter() - t0

    def rel(got, want):
        if len(got) != len(want) or not np.isfinite(got).all():
            raise AssertionError(f"mesh costs {got} against {want}")
        return max(abs(a - b) / abs(b) for a, b in zip(got, want))

    runs = {}
    for tag, rank_results in results.items():
        for rank, res in enumerate(rank_results):
            for name, rec in res.items():
                entry = runs.setdefault(name, {"backend": tag, "ranks": len(rank_results), "seconds": [],
                                               "launches": []})
                entry["seconds"].append(rec["seconds"])
                entry["launches"].append(rec["launches"])
                if "costs" in rec:
                    want = {"flagship_1x1": fl_costs, "large_1x2_spd4": big_costs,
                            **{n: h["costs"] for n, h in heads_single.items()}}.get(name, fl_costs[:1])
                    diff = rel(rec["costs"], want)
                    if diff > 1e-4:
                        raise AssertionError(f"{name} rank {rank}: costs {rec['costs']} against {want}")
                    entry["progress_costs"] = rec["costs"]
                    entry["costs_vs_single_device_max_rel_diff"] = max(
                        entry.get("costs_vs_single_device_max_rel_diff", 0.0), diff)
                    if name in heads_single:
                        entry["validation_equal_to_single_device"] = same_validation(
                            name, rec["validation"], heads_single[name]["validation"])
                else:
                    want, flags, save = ((bpr_lists, HEADS_BPR, "chip_mesh_bpr_single/") if name == "bpr_test_cli_1x2"
                                         else (single_lists, FLAGSHIP, "chip_mesh_single/"))
                    if rec["lists"] != want:
                        entry["lists_vs_single_device"] = same_lists_ties_apart(
                            rec["lists"], want, flagship_test_scores(ds_dir, save, flags))
                    else:
                        entry["lists_vs_single_device"] = {"rows": len(want), "equal": True}
    eval_ran = ("gru_scan", "fused_score_topk", "gather_sum_fwd")
    for name, entry in runs.items():
        ran = {"large_1x2_spd4": MESH_RAN + ("cce_stats", "cce_grads"), "test_cli_1x2": eval_ran,
               "bpr_test_cli_1x2": eval_ran, **{n: h[5] for n, h in MESH_HEADS.items()}}.get(name, MESH_RAN)
        for rank, launches in enumerate(entry["launches"]):
            streaming = launches["cce_stats"] + launches["cce_grads"]
            others = [k for k in KERNELS if k not in ran and launches[k]] if name in MESH_HEADS else []
            if any(launches[k] == 0 for k in ran) or ("cce_stats" not in ran and streaming) or others:
                raise AssertionError(f"{name} rank {rank} launched {launches}")
    per_rank = [{k: sum(runs[name]["launches"][rank][k] for name in runs if runs[name]["backend"] == "gloo")
                 for k in KERNELS} for rank in range(2)]
    for rank, counts in enumerate(per_rank):
        missing = [k for k in KERNELS if k.startswith(("gru_scan", "cce_", "gather_sum", "fused")) and counts[k] == 0]
        if missing:
            raise AssertionError(f"gloo rank {rank} launched no {missing}")
    layouts = {"flagship_2x1": same_layout(ds_dir, "chip_mesh_2x1_r", "chip_mesh_single"),
               "flagship_1x2": same_layout(ds_dir, "chip_mesh_1x2_r", "chip_mesh_single"),
               "large_1x2_spd4": same_layout(big_dir, "chip_mesh_big_r", "chip_mesh_big_single"),
               "bpr_2x1": same_layout(ds_dir, "chip_mesh_bpr_2x1_r", "chip_mesh_bpr_single"),
               "bpr_1x2": same_layout(ds_dir, "chip_mesh_bpr_1x2_r", "chip_mesh_bpr_single")}
    t0 = time.perf_counter()
    shard = mesh_shard_kernels(ds_dir, big_dir, n_big)
    emit({
        "phase": "main_path_mesh", "card": card,
        "config": "flagship GRU-50 (3,706 items) at --mesh 1,1 (NCCL, 150 steps), 2,1 and 1,2 (gloo, 50 steps); "
                  f"GRU-128 B1024 streaming head at {n_big} items, --mesh 1,2 --spd 4 (gloo, 16 steps); test CLI 1,2; "
                  "BPR (GRU-50 B64, 256 samples) at 2,1 and 1,2 and its test CLI at 1,2, the dense hinge, "
                  f"the streaming hinge (GRU-128 B1024, {n_big} items, 8 steps), RNNCluster, FISMCluster and SDA "
                  "(--do 0.3) at 1,2 (gloo, 50 steps); the flagship with --lazy_updates at 2,1 (50 steps), at "
                  "GRU-128 B1024 on the same catalog lazy BPR, the lazy CCE and --bf16 --u_moments bfloat16 at 1,2 "
                  "(8 steps), the dense hinge with --bf16 at 1,2 (50 steps)",
        "note": "two ranks on one shared H100 over gloo: wall seconds, not a scaling number",
        "single_device": {"flagship_costs": fl_costs, "large_costs": big_costs, "seconds": single_s,
                          "launches_flagship": single_launches, "heads": heads_single,
                          "heads_seconds": heads_single_s},
        "runs": runs, "launches_per_gloo_rank": per_rank, "checkpoints": layouts, "ranks_wall_s": ranks_s,
        "shard_kernels": {name: {k: v for k, v in res.items() if k in ("shape", "max_abs_err")}
                          for name, res in shard.items()},
        "shard_kernels_s": time.perf_counter() - t0,
        "tolerance": "progress costs rel 1e-4 against the single-device card run; validation metrics equal (ASSR "
                     "rel 1e-5: a float sum over the shards); lists equal, ties apart",
        "seconds": time.perf_counter() - t_phase,
    })
    return {"runs": {name: entry["launches"] for name, entry in runs.items()}, "shard": shard}


def main() -> int:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, ROOT)
    from seqrec_tpu_torch.ops import _build

    t0 = time.perf_counter()
    sources = sorted({os.path.basename(src)[: -len(".cu")] for _, src, _ in KERNELS.values()})
    logs = _build.build(sources)
    build_s = time.perf_counter() - t0
    card = card_line()
    report = {
        name: [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        for name, log in logs.items()
    }
    emit({"phase": "build", "seconds": build_s, "ptxas": report, "card": card})

    t0 = time.perf_counter()
    k3_large = check_gru(512, 30, 256, seed=3, path=K3_PATH_H256)  # GRU-256 serving's eval chunk
    k1 = check_gru_train(16, 30, 50, 100.0, seed=11)  # the flagship's shape, clip inactive
    k2 = check_cce(1024, 128, 50_000, seed=15)  # the large catalog's shape
    # the LSTM path's shapes: its eval chunk is -b 1024 too, so K6 has one shape there
    k6 = check_lstm(1024, 30, 128, seed=21, path="cluster")
    k6_small = check_lstm(64, 30, 50, seed=22, path="reg")  # the GRU serving chunk's shape in an LSTM
    k3_gru128 = check_gru(1024, 30, 128, seed=5, path="cluster")  # GRU-128's validation chunk
    # the gather-sum pair on real batches: the flagship (int16 wire), GRU-128 and LSTM-128 (one batcher)
    flagship_rows, [(ids_f, len_f)] = real_batch_ids(FLAGSHIP, ml1m_dataset())
    large_rows, [(ids_l, len_l)] = real_batch_ids(LARGE, catalog50k_dataset())
    gs_large = check_gather_sum(ids_l, 384, large_rows, seed=70)
    gs_large["id_runs"] = id_runs(ids_l, len_l)
    gs_lstm = check_gather_sum(ids_l, 512, large_rows, seed=71)
    gs_flagship = check_gather_sum(ids_f, 150, flagship_rows, seed=72)
    ids_2, mask_2 = two_slot_ids(ids_f, len_f, flagship_rows)
    # the sampled and margin heads' shape: K1 and the gather-sum on a real -b 64 batch
    heads_rows, [(ids_h, len_h)] = real_batch_ids(HEADS_BPR, ml1m_dataset())
    k1_b64 = check_gru_train(64, 30, 50, 100.0, seed=29, lengths=len_h)
    gs_b64 = check_gather_sum(ids_h, 150, heads_rows, seed=74)
    k5 = check_lstm_train(1024, 30, 128, 100.0, seed=23)
    k1_large = check_gru_train(1024, 30, 128, 100.0, seed=13)  # GRU-128's shape
    k5_small = check_lstm_train(16, 30, 50, 100.0, seed=28)  # the flagship's shape in an LSTM
    # the benchmark cells' shape: K1 on its wide path, prefix lengths drawn as the cells' traffic draws them
    k1_cell = check_gru_train(4096, 200, 50, 100.0, seed=90, lengths=cell_lengths(4096, 200, 90))
    k1_cell["blocks_per_sm"] = k1_blocks_per_sm()
    # and K5 there, on its wide path
    k5_cell = check_lstm_train(4096, 200, 50, 100.0, seed=94, lengths=cell_lengths(4096, 200, 94))
    # the HSTU cell's attention (B 512, L 200, 4 heads of 64) with its traffic's prefix lengths
    hstu = check_hstu_attention(512, 200, 4, 64, 64, seed=95, lengths=hstu_cell_lengths(512, 200, 95))
    main_shape = {
        "gru_scan": check_gru(64, 30, 50, seed=1, path="reg"),
        "fused_score_topk": check_topk(64, 50, 3706, 30, 10, seed=2),
        "gru_scan_train_fwd": {**k1, **k1["fwd"], "max_abs_err": k1["max_abs_err"]["h"]},
        "gru_scan_train_bwd": {**k1, **k1["bwd"], "max_abs_err": max(k1["max_abs_err"][k] for k in ("dx", "dh0", "dW"))},
        "cce_stats": {**k2, **k2["stats"], "max_abs_err": max(k2["max_abs_err"][k] for k in ("m", "s"))},
        "cce_grads": {**k2, **k2["grads"], "max_abs_err": max(k2["max_abs_err"][k] for k in ("dh", "dW", "db"))},
        "lstm_scan": k6,
        "lstm_scan_train_fwd": {**k5, **k5["fwd"], "max_abs_err": k5["max_abs_err"]["h"]},
        "lstm_scan_train_bwd": {**k5, **k5["bwd"], "max_abs_err": max(
            k5["max_abs_err"][k] for k in ("dx", "dW", "dpeep", "dh0", "dc0"))},
        "gather_sum_fwd": {**gs_large, **gs_large["fwd"], "max_abs_err": gs_large["max_abs_err"]["fwd"]},
        "gather_sum_bwd": {**gs_large, **gs_large["bwd"], "max_abs_err": gs_large["max_abs_err"]["bwd"]},
        "hstu_attention_fwd": {**hstu, **hstu["fwd"], "max_abs_err": hstu["max_abs_err"]["o"]},
        "hstu_attention_bwd": {**hstu, **hstu["bwd"], "max_abs_err": max(
            hstu["max_abs_err"][k] for k in ("dq", "dk", "dv", "dbias"))},
    }
    for res in (main_shape["gru_scan"], main_shape["fused_score_topk"], k1, k2, k6, k5, gs_large):
        emit({"phase": "kernels", "at": "main-path shape", **res})
    emit({"phase": "kernels", "at": "LSTM-128 batch", **gs_lstm})
    emit({"phase": "kernels", "at": "flagship batch", **gs_flagship})
    emit({"phase": "kernels", "at": "heads' B64 batch", **k1_b64})
    emit({"phase": "kernels", "at": "heads' B64 batch", **gs_b64})
    emit({"phase": "kernels", "at": "GRU-128 validation shape", **k3_gru128})
    emit({"phase": "kernels", "at": "large shape", **k3_large})
    k4_gru256 = check_topk(512, 256, 49_999, 30, 10, seed=8)  # the GRU-256 serving pass's chunk
    k4_large = check_topk(512, 256, 200_000, 30, 10, seed=4)
    emit({"phase": "kernels", "at": "GRU-256 serving shape", **k4_gru256})
    emit({"phase": "kernels", "at": "large shape", **k4_large})
    emit({"phase": "kernels", "at": "large shape", **k1_large})
    emit({"phase": "kernels", "at": "benchmark cell shape", **k1_cell})
    emit({"phase": "kernels", "at": "benchmark cell shape", **k5_cell})
    emit({"phase": "kernels", "at": "HSTU cell shape", **hstu})
    emit({"phase": "kernels", "at": "flagship shape", **k5_small})
    # K6 at the GRU serving shape, beside K3's
    emit({"phase": "kernels", "at": "serving shape", **k6_small})
    # K2 at the flagship's shape: the dense head's cost against the streaming kernels
    k2_flagship = check_cce(16, 50, 3706, seed=14)
    emit({"phase": "kernels", "at": "flagship shape", **k2_flagship})
    edge = [
        # K4: under one tile with every item seen in two rows, no seen ids,
        # k = 64, one row, a ragged row tile, every item of a two-tile
        # catalog seen (S = 200), a ragged 200,001-item catalog
        check_topk(6, 50, 25, 30, 10, seed=5, seen_all_rows=2, timed=False),
        check_topk(64, 50, 3706, 30, 10, seed=6, timed=False, with_seen=False),
        check_topk(33, 64, 1000, 5, 64, seed=7, timed=False),
        check_topk(64, 50, 3706, 30, 64, seed=9, timed=False),
        check_topk(1, 50, 3706, 30, 10, seed=10, timed=False),
        check_topk(129, 50, 3706, 30, 10, seed=19, timed=False),
        check_topk(16, 50, 150, 200, 10, seed=20, seen_all_rows=3, timed=False),
        check_topk(64, 256, 200_001, 30, 10, seed=27, timed=False),
        check_gru_train(16, 30, 50, 0.01, seed=12, timed=False),  # the clip binds
        check_gru_train(9, 7, 12, 0.05, seed=17, timed=False),
        check_cce(70, 12, 1000, seed=16, timed=False),
        check_cce(5, 256, 300, seed=18, timed=False),  # four register tiles of H
        check_lstm_train(16, 30, 50, 0.01, seed=24, timed=False),  # the clip binds
        check_lstm_train(9, 7, 12, 0.05, seed=25, timed=False),
        check_lstm(9, 7, 12, seed=26, path="reg", timed=False, empty_row=True),  # a row of length 0 keeps h0
        # K6's cluster path (one row; a ragged tile with holes and a row of
        # length 0) and its l2 path (H=300: no cluster slice fits)
        check_lstm(1, 30, 128, seed=65, path="cluster", timed=False),
        check_lstm(1025, 30, 128, seed=66, path="cluster", timed=False, empty_row=True, holes=True),
        check_lstm(64, 30, 300, seed=67, path="l2", timed=False, empty_row=True, holes=True),
        # the gather-sum pair at F=2: a rating-bucket slot, pad slots, id_mask
        check_gather_sum(ids_2, 150, flagship_rows + 10, seed=68, id_mask=mask_2, timed=False),
        # K1 and K5 on their reg path (one row; a row of length 0 and a mask
        # with holes), their cluster path (one row, a ragged tile, H not
        # divisible by C, a row of length 0, holes, a clip that binds at
        # GRU-128's and LSTM-128's shapes) and K1's l2 backward (H=256)
        check_gru_train(1, 30, 50, 100.0, seed=50, timed=False),
        check_lstm_train(1, 30, 50, 100.0, seed=51, timed=False),
        check_gru_train(16, 30, 50, 100.0, seed=52, timed=False, empty_row=True, holes=True),
        check_lstm_train(16, 30, 50, 100.0, seed=53, timed=False, empty_row=True, holes=True),
        check_gru_train(1, 30, 128, 100.0, seed=54, timed=False),
        check_lstm_train(1, 30, 128, 100.0, seed=55, timed=False),
        check_gru_train(1025, 30, 128, 100.0, seed=56, timed=False),
        check_lstm_train(1025, 30, 130, 100.0, seed=57, timed=False),
        check_gru_train(64, 30, 100, 100.0, seed=58, timed=False, empty_row=True),
        check_lstm_train(64, 30, 100, 100.0, seed=59, timed=False, holes=True),
        check_gru_train(64, 30, 130, 100.0, seed=60, timed=False, holes=True),
        check_lstm_train(64, 30, 130, 100.0, seed=61, timed=False, empty_row=True),
        check_gru_train(1024, 30, 128, 0.01, seed=62, timed=False),  # the clip binds
        check_lstm_train(1024, 30, 128, 0.01, seed=63, timed=False),  # the clip binds
        check_gru_train(64, 30, 256, 100.0, seed=64, timed=False),
        # K1's wide path (more than 16 rows an SM, H <= 50): a clip that binds at the cells' shape, a
        # last CTA of one row with a row of length 0 and holes, an odd H (a unit pair of one unit)
        check_gru_train(4096, 200, 50, 0.01, seed=91, timed=False, lengths=cell_lengths(4096, 200, 91)),
        check_gru_train(2113, 30, 50, 100.0, seed=92, timed=False, empty_row=True, holes=True),
        check_gru_train(3000, 20, 37, 100.0, seed=93, timed=False, holes=True),
        # and K5's: the same four shapes
        check_lstm_train(4096, 200, 50, 0.01, seed=98, timed=False, lengths=cell_lengths(4096, 200, 98)),
        check_lstm_train(2113, 30, 50, 100.0, seed=99, timed=False, empty_row=True, holes=True),
        check_lstm_train(3000, 20, 37, 100.0, seed=100, timed=False, holes=True),
        # K3 on its reg path (a row of length 0), its cluster path (a ragged
        # tile with holes; H=130 and 250, C not dividing H), gru_cluster.cuh
        # at H=256 (one row, a ragged tile, a row of length 0, a mask with
        # holes, a small batch) and H=300 (two units a lane), its l2 path at
        # H=512
        check_gru(9, 7, 12, seed=75, path="reg", timed=False, empty_row=True),
        check_gru(1023, 30, 128, seed=76, path="cluster", timed=False, holes=True),
        check_gru(64, 30, 130, seed=77, path="cluster", timed=False),
        check_gru(1, 30, 256, seed=40, path=K3_PATH_H256, timed=False),
        check_gru(513, 30, 256, seed=41, path=K3_PATH_H256, timed=False),
        check_gru(300, 30, 250, seed=42, path="cluster", timed=False),
        check_gru(64, 30, 256, seed=43, path=K3_PATH_H256, timed=False, empty_row=True),
        check_gru(64, 30, 256, seed=44, path=K3_PATH_H256, timed=False, holes=True),
        check_gru(64, 30, 256, seed=45, path=K3_PATH_H256, timed=False),
        check_gru(64, 30, 300, seed=48, path="gru_cluster", timed=False),
        check_gru(64, 30, 512, seed=49, path="l2", timed=False, empty_row=True, holes=True),
        # K2: two H chunks at the large catalog; ragged B, H and N (a padded
        # W); every check_cce has a row with g = 0 and compares two calls of
        # the stats and of the gradients bit for bit
        check_cce(1024, 256, 50_000, seed=46, timed=False),
        check_cce(1000, 100, 50_001, seed=47, timed=False),
        # HSTU's attention: an odd length with a row of length 0, and narrow heads over three row tiles
        check_hstu_attention(9, 37, 4, 64, 64, seed=96, timed=False, empty_row=True),
        check_hstu_attention(5, 130, 2, 32, 16, seed=97, timed=False),
    ]
    small_clip = [e for e in edge if e.get("grad_clip", 1.0) < 0.1]
    if len(small_clip) != 8 or not all(e["clip_moves_dW_by"] > 0 for e in small_clip):
        raise AssertionError("a small grad_clip did not bind")
    tower = check_lstm_tower()
    emit({"phase": "kernels", "at": "edge cases", "checks": [e["shape"] for e in edge],
          "max_abs_err": [e["max_abs_err"] for e in edge], "tower": tower,
          "clip_moves_dW_by": [e["clip_moves_dW_by"] for e in small_clip],
          "train_scan_plans": [[e["kernel"], e["shape"], e["plan"]] for e in edge if "plan" in e and "grad_clip" in e],
          "ok": True, "seconds": time.perf_counter() - t0})

    serving = main_path(card)
    flagship = main_path_train_flagship(card)
    large = main_path_train_large(card)
    lstm_train, lstm_serve = main_path_train_lstm(card)
    hstu_train = main_path_train_hstu(card)
    gru256 = serving_pass_gru256(card)
    heads = main_path_train_heads(card)
    heads_large = main_path_train_heads_large(card)
    heads_runs = {**heads, **{name + "_large": counts for name, counts in heads_large.items()}}
    cluster_runs = {**main_path_train_cluster(card), "cluster_large": main_path_train_cluster_large(card),
                    "fism_cluster": main_path_fism_cluster(card), "sdae": main_path_train_sdae(card)}
    ltm_train, ltm_test, ltm_checks = main_path_train_ltm(card)
    floor_runs = floors(card)
    mf_runs, mf_checks = main_path_train_mf(card)
    feature_runs, feature_checks = main_path_train_features(card)
    bf16_train = main_path_train_bf16(card)
    spd_runs = main_path_train_spd(card)
    mesh = main_path_mesh(card)
    path_of = {"gru_scan": serving, "fused_score_topk": serving, "gru_scan_train_fwd": flagship,
               "gru_scan_train_bwd": flagship, "cce_stats": large, "cce_grads": large,
               "lstm_scan": lstm_serve, "lstm_scan_train_fwd": lstm_train, "lstm_scan_train_bwd": lstm_train,
               "gather_sum_fwd": large, "gather_sum_bwd": large, "hstu_attention_fwd": hstu_train,
               "hstu_attention_bwd": hstu_train}

    summary = []
    for name, (_, source, replaces) in KERNELS.items():
        res = main_shape[name]
        summary.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": path_of[name][name], "max_abs_err": res["max_abs_err"],
            "ms": res["kernel_ms"], "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
            "bound_by": res["bound_by"], "library_ms": res["library_ms"],
            "launches_heads": {run: counts[name] for run, counts in heads_runs.items()},
            "launches_cluster_phases": {run: counts.get(name, 0) for run, counts in cluster_runs.items()},
            "launches_ltm": {"train_cli": ltm_train[name], "test_cli": ltm_test[name]},
            "launches_floors": {run: counts[name] for run, counts in floor_runs.items()},
            "launches_mf": {run: counts[name] for run, counts in mf_runs.items()},
            "launches_features": {run: counts[name] for run, counts in feature_runs.items()},
            "launches_bf16": bf16_train[name],
            "launches_spd": {run: counts[name] for run, counts in spd_runs.items()},
            "launches_mesh": {run: [counts[name] for counts in ranks] for run, ranks in mesh["runs"].items()},
        })
    # K3 on the training forward's kernels: the serving chunk (reg), GRU-128's validation chunk
    # (cluster), GRU-256 serving's chunk (K3_PATH_H256)
    k3 = summary[0]
    k3_keys = ("plan", "kernel_ms", "kernel_device_ms", "kernel_back_to_back_ms", "plain_device_ms",
               "library_device_ms", "bound_ms", "max_abs_err")
    k3.update(
        kernel_device_ms=main_shape["gru_scan"]["kernel_device_ms"],
        kernel_back_to_back_ms=main_shape["gru_scan"]["kernel_back_to_back_ms"],
        library_device_ms=main_shape["gru_scan"]["library_device_ms"], path=main_shape["gru_scan"]["plan"][0],
        plan=main_shape["gru_scan"]["plan"], same_bits_twice=True,
        at_B512_L30_H256={
            "path": k3_large["plan"][0], **{key: k3_large[key] for key in k3_keys},
            "launches_serving_pass_gru256": gru256["gru_scan"],
            f"{K3_PATH_H256}_launches_serving_pass_gru256": gru256["gru_scan_on_path"],
        },
        at_B1024_L30_H128={  # GRU-128's validation chunk
            "path": k3_gru128["plan"][0], **{key: k3_gru128[key] for key in k3_keys},
            "launches_gru128_path": large["gru_scan"],
        },
    )
    # this PR's redesigns: K4 and K2's stats on 3xTF32 tensor-core tiles
    topk = next(e for e in summary if e["name"] == "fused_score_topk")
    device_keys = ("kernel_device_ms", "plain_device_ms", "library_device_ms", "bound_f32_ms", "bound_tf32x3_ms")
    topk.update({key: main_shape["fused_score_topk"][key] for key in device_keys},
                pad_device_ms=main_shape["fused_score_topk"]["pad_device_ms"])
    for at, res in (("at_B512_H256_N49999", k4_gru256), ("at_B512_H256_N200000", k4_large)):
        topk[at] = {key: res[key] for key in ("kernel_ms", *device_keys, "pad_device_ms", "max_abs_err")}
    topk["launches_serving_pass_gru256"] = gru256["fused_score_topk"]
    topk["at_B100_H32_N3706_ltm"] = {key: ltm_checks["topk"][key]
                                     for key in ("kernel_ms", *device_keys, "shape", "max_abs_err")}
    topk["at_mf_validation_H32_N49999"] = {key: mf_checks["fused_score_topk_bprmf"][key]
                                           for key in ("kernel_ms", *device_keys, "shape", "max_abs_err")}
    stats = next(e for e in summary if e["name"] == "cce_stats")
    stats.update({key: k2["stats"][key] for key in device_keys},
                 at_B16_H50_N3706={key: k2_flagship["stats"][key] for key in ("kernel_ms", *device_keys)},
                 launches_lstm_path=lstm_train["cce_stats"])
    grads = next(e for e in summary if e["name"] == "cce_grads")
    grads.update(
        kernel_device_ms=k2["grads"]["kernel_device_ms"], plain_device_ms=k2["grads"]["plain_device_ms"],
        library_device_ms=k2["grads"]["library_device_ms"], bound_f32_ms=k2["grads"]["bound_f32_ms"],
        bound_tf32x3_ms=k2["grads"]["bound_tf32x3_ms"],
        at_B16_H50_N3706={k: k2_flagship["grads"][k] for k in ("kernel_ms", "kernel_device_ms", "plain_ms",
                                                                "plain_device_ms", "library_ms", "library_device_ms",
                                                                "bound_ms")},
    )
    # this PR's redesigns: K1 and K5 at the flagship's and the large paths' shapes
    scan_keys = ("kernel_ms", "kernel_device_ms", "plain_device_ms", "library_device_ms", "bound_ms")
    for name, res, other, at in (("gru_scan_train", k1, k1_large, "at_B1024_L30_H128"),
                                 ("lstm_scan_train", k5, k5_small, "at_B16_L30_H50")):
        for d in ("fwd", "bwd"):
            keys = scan_keys + (("bound_f32_ms", "bound_tf32x3_ms") if d == "bwd" else ())
            entry = next(e for e in summary if e["name"] == f"{name}_{d}")
            entry.update({key: res[d][key] for key in keys[1:]}, plan=res["plan"][d], same_bits_twice=True)
            entry[at] = {**{key: other[d][key] for key in keys}, "plan": other["plan"][d]}
    for name in ("gru_scan_train_fwd", "gru_scan_train_bwd"):
        entry = next(e for e in summary if e["name"] == name)
        entry["launches_gru128_path"] = large[name]
        d = name.split("_")[-1]
        entry["at_B64_L30_H50"] = {**{key: k1_b64[d][key] for key in scan_keys + ("plain_ms", "library_ms")},
                                   "plan": k1_b64["plan"][d], "real_batch_lengths": True,
                                   "max_abs_err": k1_b64["max_abs_err"]}
        entry["at_B4096_L200_H50"] = {**{key: k1_cell[d][key] for key in scan_keys + ("plain_ms", "library_ms")},
                                      "plan": k1_cell["plan"][d], "wide_launches": k1_cell["wide_launches"][d],
                                      "blocks_per_sm": {p: n[d] for p, n in k1_cell["blocks_per_sm"].items()},
                                      "max_abs_err": k1_cell["max_abs_err"]}
    for name in ("lstm_scan_train_fwd", "lstm_scan_train_bwd"):
        entry = next(e for e in summary if e["name"] == name)
        d = name.split("_")[-1]
        entry["at_B4096_L200_H50"] = {**{key: k5_cell[d][key] for key in scan_keys + ("plain_ms", "library_ms")},
                                      "plan": k5_cell["plan"][d], "wide_launches": k5_cell["wide_launches"][d],
                                      "max_abs_err": k5_cell["max_abs_err"]}
    # this PR's redesigns: K6 on the training forward's kernels, the gather-sum pair
    lstm = next(e for e in summary if e["name"] == "lstm_scan")
    k6_keys = ("kernel_ms", "kernel_device_ms", "plain_device_ms", "library_device_ms", "bound_ms", "plan")
    lstm.update({key: k6[key] for key in k6_keys[1:]}, same_bits_twice=True,
                cluster_launches_test_cli=lstm_serve["lstm_scan_cluster"],
                at_B64_L30_H50={key: k6_small[key] for key in k6_keys})
    for name in ("gather_sum_fwd", "gather_sum_bwd"):
        d = name.split("_")[-1]
        entry = next(e for e in summary if e["name"] == name)
        keys = ("kernel_ms", "kernel_device_ms", "plain_device_ms", "library_ms", "library_device_ms", "bound_ms")
        keys += ("kernel_device_ms_by_kernel",) if d == "bwd" else ()
        extra = ("plain_ms",) + (("index_add_ms", "index_add_device_ms") if d == "bwd" else ())
        entry.update({key: gs_large[d][key] for key in keys[1:]}, not_a_pallas_kernel=True,
                     jax_counterpart="XLA gather and scatter-add (seqrec_tpu/ops/core.py:54)",
                     id_runs_gru128=gs_large["id_runs"], same_bits_twice=True,
                     launches_flagship=flagship[name], launches_lstm_path=lstm_train[name],
                     at_LSTM128_D512={key: gs_lstm[d][key] for key in keys},
                     at_flagship_D150={key: gs_flagship[d][key] for key in keys},
                     at_heads_B64_D150={**{key: gs_b64[d][key] for key in keys + ("plain_ms",)},
                                        "max_abs_err": gs_b64["max_abs_err"][d]},
                     **{at: {**{key: feature_checks[part][d][key] for key in keys + extra},
                             "ids": feature_checks[part]["shape"]["ids"], "id_runs": feature_checks[part]["id_runs"],
                             "max_abs_err": feature_checks[part]["max_abs_err"][d]}
                        for at, part in (("at_featured_B16_F14_D150", "B16"), ("at_featured_B1024_F14_D150", "B1024"))},
                     **{at: {**{key: checks[part][d][key] for key in keys + extra},
                             "ids": checks[part]["shape"]["ids"], "max_abs_err": checks[part]["max_abs_err"][d]}
                        for at, part, checks in (("at_ltm_ctx_D32", "ctx", ltm_checks),
                                                 ("at_ltm_targets_D32", "targets", ltm_checks),
                                                 ("at_mf_bprmf_H_D32", "gather_sum_bprmf_H", mf_checks),
                                                 ("at_mf_fism_basket_D32", "gather_sum_fism_basket", mf_checks))})
    # the per-shard shapes of --mesh 1,2 (main_path_mesh)
    shard_keys = ("kernel_ms", "kernel_device_ms", "plain_ms", "plain_device_ms", "library_ms", "library_device_ms",
                  "bound_ms", "bound_by")
    for name, part, at in (("cce_stats", "stats", "at_shard_B1024_H128_N25000"),
                           ("cce_grads", "grads", "at_shard_B1024_H128_N25000")):
        res = mesh["shard"]["cce"]
        next(e for e in summary if e["name"] == name)[at] = {
            **{key: res[part][key] for key in shard_keys if key in res[part]}, "shape": res["shape"],
            "max_abs_err": res["max_abs_err"]}
    for part, at in (("topk_flagship", "at_shard_B64_H50_N1853"), ("topk_large", "at_shard_B1024_H128_N25000")):
        res = mesh["shard"][part]
        topk[at] = {**{key: res[key] for key in shard_keys if key in res}, "max_abs_err": res["max_abs_err"]}
    for name in ("gather_sum_fwd", "gather_sum_bwd"):
        d = name.split("_")[-1]
        entry = next(e for e in summary if e["name"] == name)
        for part, at in (("gather_sum_flagship", "at_shard_flagship_D150"), ("gather_sum_large", "at_shard_large_D384"),
                         ("gather_sum_fism_bag", "at_shard_fism_bag_D50"),
                         ("gather_sum_cluster_rows", "at_shard_cluster_rows_D10")):
            res = mesh["shard"][part]
            entry[at] = {**{key: res[d][key] for key in shard_keys + ("index_add_ms", "index_add_device_ms")
                            if key in res[d]},
                         "ids": res["shape"]["ids"], "rows": res["shape"]["N"], "max_abs_err": res["max_abs_err"][d]}
    # a data rank's 32 rows at --mesh 2,1: K1 on the heads' batch, K4 on its half of the validation chunk
    res = mesh["shard"]["train_scan_rows_B32"]
    for d in ("fwd", "bwd"):
        next(e for e in summary if e["name"] == f"gru_scan_train_{d}")["at_rows_B32_L30_H50"] = {
            **{key: res[d][key] for key in shard_keys + ("plain_ms",) if key in res[d]}, "plan": res["plan"][d],
            "max_abs_err": res["max_abs_err"]}
    res = mesh["shard"]["topk_rows_B32"]
    topk["at_rows_B32_H50_N3706"] = {**{key: res[key] for key in shard_keys if key in res},
                                     "max_abs_err": res["max_abs_err"]}
    emit({"total_seconds": time.perf_counter() - t_start, "phase_seconds": PHASE_SECONDS})
    print(card_line(), flush=True)
    emit({"kernels": summary})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-rank"]:
        sys.exit(mesh_rank(sys.argv[2]))
    sys.exit(main())
