#!/bin/bash
# The sampled (BPR, 256 samples) and margin (hinge) heads trained and tested
# by the port on one GPU, with the flags of scripts/quality_run_regime2.sh's
# two runs: GRU-50, max_length 30, batch 64, Adam 2e-3, --save Best, a
# validation every 1500 steps, at most 60000 steps, early stopping after 6
# validations without a gain; the test CLI appends its results under the
# dataset's results/. The data is the lag-2 successor regime at that
# script's scale (6,040 users, 3,600 items, lengths 20-310, markov_strength
# 0.6, seed 9; 100 validation and 100 test users), drawn with the JAX
# package's generator (generate_interactions_lag2) and written by the
# port's numpy writer with its own validation/test split. A dataset_dir
# that holds a preprocessed dataset is used as it is.
#
#   bash seqrec_tpu_torch/scripts/train_heads_lag2.sh [dataset_dir] [max_time_s per head]
set -e
cd "$(dirname "$0")/../.."
DS=${1:-build/lag2_heads}
MAX_TIME=${2:-900}
python3 - <<PY
import os
from seqrec_tpu_torch.data.synthetic import generate_interactions_lag2, write_dataset
if not os.path.exists("$DS/data/stats"):
    rows = generate_interactions_lag2(n_users=6040, n_items=3600, min_len=20, max_len=310,
                                      markov_strength=0.6, seed=9)
    write_dataset("$DS", rows, n_val_users=100, n_test_users=100, min_user_activity=2,
                  min_item_pop=1, seed=9)
PY
COMMON="-m RNN --r_t GRU --r_l 50 --max_length 30 -b 64 --u_m adam --u_l 0.002"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
for HEAD in "--loss BPR --sampling 256" "--loss hinge"; do
    echo "==== $HEAD ===="
    time python3 -m seqrec_tpu_torch.cli.train -d "$DS/" $COMMON $HEAD --save Best \
        --progress 1500 --max_iter 60000 --es_m StopAfterN --es_n 6 --max_time "$MAX_TIME" --dir heads_lag2/
    python3 -m seqrec_tpu_torch.cli.test -d "$DS/" $COMMON $HEAD --dir heads_lag2/ --save
done
