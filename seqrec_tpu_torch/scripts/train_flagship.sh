#!/bin/bash
# The parity flagship trained and tested by the port on one GPU, with the
# schedule of scripts/baseline_run.sh (GRU-50 CCE, max_length 30, batch 16,
# Adam 1e-3, --save Best, progress every 4000 steps, at most 60000 steps,
# early stopping after 3 validations without a gain), on the same
# ML-1M-scale synthetic dataset. A dataset_dir that holds a preprocessed
# dataset is used as it is (for example the one scripts/baseline_run.sh
# writes with the JAX package's generator and preprocess.py, which need
# pandas); otherwise the port's numpy generator writes one there.
#
#   bash seqrec_tpu_torch/scripts/train_flagship.sh [dataset_dir] [max_time_s]
set -e
cd "$(dirname "$0")/../.."
DS=${1:-build/flagship/ml1m_synth}
MAX_TIME=${2:-1200}
python3 - <<PY
import os
from seqrec_tpu_torch.data.synthetic import make_dataset
if not os.path.exists("$DS/data/stats"):
    make_dataset("$DS", n_users=6040, n_items=3706, min_len=20, max_len=310,
                 markov_strength=0.45, n_val_users=100, n_test_users=100, seed=7)
PY
FLAGS="-m RNN --loss CCE --r_t GRU --r_l 50 --max_length 30 -b 16 --u_m adam --u_l 0.001"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
time python3 -m seqrec_tpu_torch.cli.train -d "$DS/" $FLAGS --save Best \
    --progress 4000 --max_iter 60000 --es_m StopAfterN --es_n 3 --max_time "$MAX_TIME" --dir flagship/
python3 -m seqrec_tpu_torch.cli.test -d "$DS/" $FLAGS --dir flagship/
