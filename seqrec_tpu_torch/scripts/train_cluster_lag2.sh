#!/bin/bash
# RNNCluster (10 clusters, Blackout) trained and tested by the port on one
# GPU with scripts/quality_run_regime2.sh's flags (GRU-50, max_length 30,
# batch 64, Adam 2e-3, --save Best, a validation every 1500 steps, at most
# 60000 steps, early stopping after 6 validations without a gain), on the
# lag-2 dataset that train_heads_lag2.sh writes (written here when it is
# missing). The test CLI runs twice on the best checkpoint: scoring the
# argmax cluster's items (sps, recall and ASSR, appended under the
# dataset's results/) and the whole catalog (--ignore_clusters).
#
#   bash seqrec_tpu_torch/scripts/train_cluster_lag2.sh [dataset_dir] [max_time_s]
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
FLAGS="-m RNN --clusters 10 --loss Blackout --r_t GRU --r_l 50 --max_length 30 -b 64 --u_m adam --u_l 0.002"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
time python3 -m seqrec_tpu_torch.cli.train -d "$DS/" $FLAGS --save Best \
    --progress 1500 --max_iter 60000 --es_m StopAfterN --es_n 6 --max_time "$MAX_TIME" --dir cluster_lag2/
python3 -m seqrec_tpu_torch.cli.test -d "$DS/" $FLAGS --dir cluster_lag2/ --metrics sps,recall,assr --save
python3 -m seqrec_tpu_torch.cli.test -d "$DS/" $FLAGS --dir cluster_lag2/ --metrics sps,recall,assr --ignore_clusters
