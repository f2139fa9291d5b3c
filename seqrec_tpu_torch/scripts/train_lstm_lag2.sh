#!/bin/bash
# LSTM-128 CCE trained and tested by the port on one GPU, with the data and
# schedule of scripts/convergence_run.sh's LSTM leg: the lag-2 successor
# dataset (50,000 users, 50,000 items, lengths 20-100, markov_strength 0.6,
# seed 4; 100 validation and 100 test users), max_length 30, batch 1024,
# Adam 2e-3, --save Best, a validation every 1000 steps, early stopping
# after 8 validations without a gain. The 50k catalog trains through the
# streaming CCE head. A dataset_dir that holds a preprocessed dataset is
# used as it is; otherwise the port's numpy writer draws the JAX package's
# interactions (generate_interactions_lag2) and writes its own val/test
# split there.
#
#   bash seqrec_tpu_torch/scripts/train_lstm_lag2.sh [dataset_dir] [max_time_s]
set -e
cd "$(dirname "$0")/../.."
DS=${1:-build/lag2_50k}
MAX_TIME=${2:-1500}
python3 - <<PY
import os
from seqrec_tpu_torch.data.synthetic import generate_interactions_lag2, write_dataset
if not os.path.exists("$DS/data/stats"):
    rows = generate_interactions_lag2(n_users=50_000, n_items=50_000, min_len=20, max_len=100,
                                      markov_strength=0.6, seed=4)
    write_dataset("$DS", rows, n_val_users=100, n_test_users=100, min_user_activity=2,
                  min_item_pop=1, seed=4)
PY
FLAGS="-m RNN --loss CCE --r_t LSTM --r_l 128 --max_length 30 -b 1024 --u_m adam --u_l 0.002"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
time python3 -m seqrec_tpu_torch.cli.train -d "$DS/" $FLAGS --save Best \
    --progress 1000 --max_iter 50000 --es_m StopAfterN --es_n 8 --max_time "$MAX_TIME" --dir lstm_lag2/
python3 -m seqrec_tpu_torch.cli.test -d "$DS/" $FLAGS --dir lstm_lag2/
