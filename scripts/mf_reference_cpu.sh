#!/bin/bash
# The JAX package's factorization runs on the CPU, as the reference for the
# PyTorch port's scripts/train_mf_flagship.sh (seqrec_tpu_torch/scripts/):
# scripts/baseline_run.sh's rows split by preprocess.py, then BPRMF and FPMC
# with baseline_run.sh:37-47's flags, FISM-RMSE, FISM-BPR and Fossil with
# baseline_run3.sh's, and Fossil at BASELINE.md:59's lr 0.01, each trained
# then tested (a NaN abort does not stop the script). SEED replaces the
# models' seed 42 (the JAX CLI has no flag for it), to measure the spread
# of one configuration over runs; checkpoints go under models/seedSEED/.
# MODEL names (BPRMF FPMC FISM-RMSE FISM-BPR Fossil Fossil-lr0.01) run
# only those; none runs all six. FULL=1 trains every model to max_iter
# without early stopping (--es_m None; checkpoints under models/seedSEED_full/).
#
#   bash scripts/mf_reference_cpu.sh [OUT] [SEED] [MODEL ...]
#
# OUT (default build/mf_reference/ml1m_synth) is taken relative to the root
# of the checkout; the rows and the split are written once and reused.
cd "$(dirname "$0")/.."
OUT=${1:-build/mf_reference/ml1m_synth}
SEED=${2:-42}
shift 2 2>/dev/null
ONLY=" $* "
ES="--es_m StopAfterN --es_n 2"
DIR="seed$SEED/"
if [ -n "$FULL" ]; then ES="--es_m None"; DIR="seed${SEED}_full/"; fi
export JAX_PLATFORMS=cpu
python - <<EOF2
from seqrec_tpu.data.synthetic import generate_interactions
import numpy as np, os
os.makedirs("$OUT", exist_ok=True)
if not os.path.exists("$OUT/ratings.dat"):
    rows = generate_interactions(n_users=6040, n_items=3706, min_len=20,
                                 max_len=310, markov_strength=0.45, seed=7)
    np.savetxt("$OUT/ratings.dat", rows, fmt="%d", delimiter="::")
EOF2
if [ ! -f "$OUT/data/stats" ]; then
  python preprocess.py -f "$OUT/ratings.dat" --columns uirt --sep :: \
      --min_item_pop 5 --val_size 100 --test_size 100 --yes
fi
train() {
  python - "$@" <<EOF2
import sys
import seqrec_tpu.models.factorization as f
init = f.MFBase.__init__
f.MFBase.__init__ = lambda self, *a, **kw: init(self, *a, **{**kw, "seed": $SEED})
from seqrec_tpu.cli.train import main
main(sys.argv[1:])
EOF2
}
run() {
  name=$1; shift
  if [ "$ONLY" != "  " ] && [[ "$ONLY" != *" $name "* ]]; then return; fi
  echo "==== $name (seed $SEED) ===="
  time train -d "$OUT/" "$@" --extended_set --save Best --progress 400000 --max_iter 4000000 \
      $ES --dir "$DIR" || echo "train exited with $?"
  python test.py -d "$OUT/" "$@" --dir "$DIR" --save
}
run BPRMF -m BPRMF -H 32 -l 0.1 -r 0.0025 --no_adaptive_sampling
run FPMC -m FPMC --k_cf 32 --k_mc 32 -l 0.1 --no_adaptive_sampling
run FISM-RMSE -m FISM -H 32 -l 0.01 -r 0.0025 --init_sigma 0.1 --loss RMSE --fism_alpha 0.2
run FISM-BPR -m FISM -H 32 -l 0.01 -r 0.0025 --init_sigma 0.1 --loss BPR --fism_alpha 0.2
run Fossil -m Fossil -H 32 -l 0.05 -r 0.0025 --init_sigma 0.1 --fossil_order 1
run Fossil-lr0.01 -m Fossil -H 32 -l 0.01 -r 0.0025 --init_sigma 0.1 --fossil_order 1
echo DONE
