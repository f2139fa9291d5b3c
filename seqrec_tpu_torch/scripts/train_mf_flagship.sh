#!/bin/bash
# The factorization family on the split of scripts/baseline_run.sh, through
# the port on one GPU: the port's numpy generator writes ratings.dat (the
# JAX package's rows), the port's preprocess splits it as preprocess.py does
# (--min_item_pop 5, 100 validation and 100 test users), and each model is
# trained on the extended training set with the flags of
# scripts/baseline_run.sh:37-47 (BPRMF, FPMC) and scripts/baseline_run3.sh
# (FISM-RMSE, FISM-BPR, Fossil at lr 0.05): --save Best, a validation every
# 400,000 samples, at most 4,000,000, early stopping after 2 validations
# without a gain; then the test CLI scores every kept checkpoint. Fossil
# also runs at BASELINE.md:59's lr 0.01: at 0.05 the JAX package's run
# aborts on a NaN cost, and a NaN abort here does not stop the script.
#
#   bash seqrec_tpu_torch/scripts/train_mf_flagship.sh [dataset_dir] [extra train/test flags, e.g. --device cpu]
#
# SEED=N replaces the models' seed 42 (the CLI has no flag for it; checkpoints
# then go under models/seedN/), to measure the spread of one configuration
# over runs; MODELS="Fossil-lr0.01 FISM-RMSE" runs only the named models;
# FULL=1 trains to max_iter without early stopping (--es_m None; checkpoints
# under models/seedN_full/, or models/full/ without SEED).
cd "$(dirname "$0")/../.."
DS=${1:-build/flagship/ml1m_pp}
shift
EXTRA="$*"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
set -e
python3 - <<PY
import os
import numpy as np
from seqrec_tpu_torch.data.synthetic import generate_interactions
os.makedirs("$DS", exist_ok=True)
if not os.path.exists("$DS/ratings.dat"):
    rows = generate_interactions(n_users=6040, n_items=3706, min_len=20, max_len=310,
                                 markov_strength=0.45, seed=7)
    np.savetxt("$DS/ratings.dat", rows, fmt="%d", delimiter="::")
PY
if [ ! -f "$DS/data/stats" ]; then
  python3 -m seqrec_tpu_torch.data.preprocess -f "$DS/ratings.dat" --columns uirt --sep :: \
      --min_item_pop 5 --val_size 100 --test_size 100 --yes
fi
set +e
train() {
  if [ -z "$SEED" ]; then
    python3 -m seqrec_tpu_torch.cli.train "$@"
    return
  fi
  python3 - "$@" <<PY
import sys
import seqrec_tpu_torch.models.factorization as f
init = f.MFBase.__init__
f.MFBase.__init__ = lambda self, *a, **kw: init(self, *a, **{**kw, "seed": $SEED})
from seqrec_tpu_torch.cli.train import main
main(sys.argv[1:])
PY
}
DIRS=${SEED:+--dir seed$SEED/}
ES="--es_m StopAfterN --es_n 2"
if [ -n "$FULL" ]; then ES="--es_m None"; DIRS="--dir ${SEED:+seed${SEED}_}full/"; fi
run() {
  name=$1; shift
  if [ -n "$MODELS" ] && [[ " $MODELS " != *" $name "* ]]; then return; fi
  echo "==== $name${SEED:+ (seed $SEED)} ===="
  time train -d "$DS/" "$@" --extended_set --save Best \
      --progress 400000 --max_iter 4000000 $ES $DIRS $EXTRA \
      || echo "train exited with $?"
  python3 -m seqrec_tpu_torch.cli.test -d "$DS/" "$@" --save $DIRS $EXTRA
}
run BPRMF -m BPRMF -H 32 -l 0.1 -r 0.0025 --no_adaptive_sampling
run FPMC -m FPMC --k_cf 32 --k_mc 32 -l 0.1 --no_adaptive_sampling
run FISM-RMSE -m FISM -H 32 -l 0.01 -r 0.0025 --init_sigma 0.1 --loss RMSE --fism_alpha 0.2
run FISM-BPR -m FISM -H 32 -l 0.01 -r 0.0025 --init_sigma 0.1 --loss BPR --fism_alpha 0.2
run Fossil -m Fossil -H 32 -l 0.05 -r 0.0025 --init_sigma 0.1 --fossil_order 1
run Fossil-lr0.01 -m Fossil -H 32 -l 0.01 -r 0.0025 --init_sigma 0.1 --fossil_order 1
echo DONE
