#!/bin/bash
# The stacked denoising autoencoder trained and tested by the port on one
# GPU with scripts/baseline_run2.sh's flags (-L 64-32-64, --do 0.3,
# --in_do 0.2, batch 64, Adam 1e-3, --save Best, a validation every 2000
# steps, at most 30000 steps, early stopping after 2 validations without a
# gain), on the ML-1M-scale dataset that train_flagship.sh writes (written
# here when it is missing).
#
#   bash seqrec_tpu_torch/scripts/train_sdae_flagship.sh [dataset_dir] [max_time_s]
set -e
cd "$(dirname "$0")/../.."
DS=${1:-build/flagship/ml1m_synth}
MAX_TIME=${2:-900}
python3 - <<PY
import os
from seqrec_tpu_torch.data.synthetic import make_dataset
if not os.path.exists("$DS/data/stats"):
    make_dataset("$DS", n_users=6040, n_items=3706, min_len=20, max_len=310,
                 markov_strength=0.45, n_val_users=100, n_test_users=100, seed=7)
PY
FLAGS="-m SDA -L 64-32-64 --do 0.3 --in_do 0.2 -b 64 --u_m adam --u_l 0.001"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
time python3 -m seqrec_tpu_torch.cli.train -d "$DS/" $FLAGS --save Best \
    --progress 2000 --max_iter 30000 --es_m StopAfterN --es_n 2 --max_time "$MAX_TIME" --dir sdae/
python3 -m seqrec_tpu_torch.cli.test -d "$DS/" $FLAGS --dir sdae/ --save
