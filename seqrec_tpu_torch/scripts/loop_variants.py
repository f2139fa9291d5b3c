#!/usr/bin/env python3
"""The training loop's ms a step with parts of its host path swapped out,
one process a variant, on one CUDA GPU:

    python3 PATH/TO/loop_variants.py VARIANT

run from the root of the checkout to measure (its package and its
``chip_smoke.py`` are imported from there, so one copy of this script
measures another checkout too). VARIANT names what is swapped (a checkout
without the prefetch thread runs ``parent``, unchanged):

- ``this``: the loop as it is (batches from the prefetch thread, uploads
  from pinned memory without blocking);
- ``pageable``: uploads from pageable memory, synchronous (``_tensor``);
- ``nothread``: ``_prefetch`` runs its generator on the calling thread;
- ``nothread_pageable``: both;
- ``switch``: the interpreter's switch interval at 0.1 ms (5 ms by
  default), so a thread waiting for the GIL asks for it sooner.

Cells, from seed 0 on ``chip_smoke.ml1m_dataset()``: the flagship at
``--spd 1`` (1,000 steps) and ``--spd 8`` (1,000 steps; not in a checkout
that refuses it) and BPR B64 at ``--spd 1`` (600 steps), each a timed
``train`` call after a warm-up one (host clock to a synchronize), with the
main thread's CPU time a step (``time.thread_time``). Prints one JSON line
a cell with the card's name and power limit.
"""

import contextlib
import json
import os
import sys
import time


def main(variant: str) -> int:
    sys.path.insert(0, os.getcwd())  # the measured checkout
    import torch

    import chip_smoke as cs
    import seqrec_tpu_torch.utils.command_parser as parse
    from seqrec_tpu_torch.data import DataHandler
    from seqrec_tpu_torch.models.base import RNNBase
    from seqrec_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("loop_variants: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build(sorted({src.split("/")[-1][:-3] for _, src, _ in cs.KERNELS.values()}))
    if "pageable" in variant:
        RNNBase._tensor_async = RNNBase._tensor
    if "nothread" in variant:
        RNNBase._prefetch = staticmethod(lambda generator, depth=4: generator)
    if "switch" in variant:
        sys.setswitchinterval(1e-4)

    def run(model, dataset, steps):
        with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
            model.train(dataset, max_iter=steps, progress=10**9, autosave="None")

    for cell, argv, steps, spd in (("flagship_spd1", cs.FLAGSHIP, 1000, 1), ("bpr_b64_spd1", cs.HEADS_BPR, 600, 1),
                                   ("flagship_spd8", cs.FLAGSHIP, 1000, 8)):
        args = parse.command_parser(parse.predictor_command_parser, argv=argv)
        args.device = "cuda"
        model = parse.get_predictor(args)
        dataset = DataHandler(cs.ml1m_dataset())
        model.prepare_model(dataset)
        model.steps_per_dispatch = spd
        try:
            run(model, dataset, 4 * spd)  # warm-up
        except NotImplementedError:
            continue  # this checkout refuses --spd > 1
        torch.cuda.synchronize()
        t0, c0 = time.perf_counter(), time.thread_time()
        run(model, dataset, steps)
        torch.cuda.synchronize()
        wall, main_cpu = time.perf_counter() - t0, time.thread_time() - c0
        print(json.dumps({"variant": variant, "cell": cell, "step_ms": wall / steps * 1e3,
                          "main_thread_cpu_ms_a_step": main_cpu / steps * 1e3, "card": cs.card_line()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
