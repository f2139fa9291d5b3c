"""seqrec_tpu_torch: the PyTorch/CUDA port of seqrec_tpu for NVIDIA Hopper.

The JAX package ``seqrec_tpu`` stays the reference. This package keeps its
module names, its CLI flags, its model-filename scheme and its ``.npz``
checkpoint keys, so a checkpoint written by either package loads in the
other. Plain tensor code is PyTorch; every Pallas TPU kernel on a ported
path becomes a CUDA C++ kernel for ``sm_90a`` under ``csrc/``, built with
``nvcc`` at first use (``ops/_build.py``) and checked against a plain
PyTorch version of the same function kept beside its wrapper.

Ported so far: the RNN family's single-model heads on GRU, LSTM and
Vanilla towers: ``RNNOneHot`` (CCE), ``RNNSampling`` (BPR, TOP1,
Blackout over shared negative samples) and ``RNNMargin`` (hinge, logit,
logsig; dense, or the streaming margin at large catalogs), each with or
without ``--lazy_updates``; the clustered-softmax models ``RNNCluster``
(``-m RNN --clusters K``) and ``FISMCluster`` (``-m FISM --clusters K``);
the stacked denoising autoencoder (``-m SDA``); ``LTM`` (``-m LTM``,
word2vec CBOW with a latent trajectory); the factorization family
``BPRMF``, ``FPMC``, ``FISM`` and ``Fossil`` (vectorized SGD chunks whose
table scatters run through the gather-sum backward kernel, scored through
K4 at large catalogs); and the lazy baselines ``Pop``, ``MarkovModel`` and
``UserKNN`` (``-m POP|MM|UKNN``). They train through
``cli/train.py`` (GRU training scan K1 or LSTM training scan K5, the
gather-sum kernel pair, which LTM's CBOW steps also run, streaming CCE K2
for the CCE head at large catalogs) and serve through ``cli/test.py`` (GRU
scan K3 or LSTM scan K6, fused masked top-k K4, which LTM scores
through), on the card by default and on the CPU with ``--device cpu``.
The Vanilla tower, FISM's bag of items and the autoencoder's dense stack
are plain PyTorch, as the JAX package leaves them to XLA; the lazy
baselines are numpy and scipy on the host, as there. ``data/preprocess.py``
writes the JAX package's preprocessed files with numpy only. The RNN
family takes the side features (``--mf``/``--uf``, ``data/features.py``),
``--bf16`` and bf16 Adam moments; checkpoints carry the optimizer state
where asked, and the CLIs take ``--save_rank`` and ``--profile``.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. CUDA unless the caller asks for
    the CPU; a missing card raises instead of running on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass --device cpu (device='cpu') "
            "to run on the CPU"
        )
    return device
