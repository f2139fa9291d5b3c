#!/bin/bash
# The floors (POP, the Markov model, user-KNN) and LTM on the split of
# scripts/baseline_run.sh, all through the port on one GPU: the port's
# numpy generator writes ratings.dat (the JAX package's rows, "::"), the
# port's preprocess splits it as preprocess.py does (--min_item_pop 5,
# 100 validation and 100 test users), the test CLI scores the floors, and
# LTM is trained with scripts/baseline_run2.sh's flags (-H 32,
# --ltm_window 5, --save Best, a validation every 2 epochs, at most 14,
# early stopping after 2 validations without a gain) and tested.
#
#   bash seqrec_tpu_torch/scripts/train_floors_flagship.sh [dataset_dir]
set -e
cd "$(dirname "$0")/../.."
DS=${1:-build/flagship/ml1m_pp}
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
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
for m in POP MM UKNN; do
  echo "==== $m ===="
  python3 -m seqrec_tpu_torch.cli.test -d "$DS/" -m $m
done
echo "==== LTM ===="
time python3 -m seqrec_tpu_torch.cli.train -d "$DS/" -m LTM -H 32 --ltm_window 5 \
    --save Best --progress 2 --max_iter 14 --es_m StopAfterN --es_n 2
python3 -m seqrec_tpu_torch.cli.test -d "$DS/" -m LTM -H 32 --ltm_window 5 --save
