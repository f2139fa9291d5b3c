"""The JAX package's autoencoder and the port's, trained on the same data with
the same flags on the CPU, then tested: a check that the port's SDA reaches
the JAX package's quality (the layer dropout draws other bits in each
package, so only the scores compare, not the trajectories). Reduced scale
(1,500 users, 800 items, 200 test users, 4,000 steps), about four minutes
on a few cores; not collected by pytest.

    python tests/compare_sdae_quality.py [work_dir]
"""

import contextlib
import io
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import seqrec_tpu.cli.test as jax_test_cli  # noqa: E402
import seqrec_tpu.cli.train as jax_train_cli  # noqa: E402
import seqrec_tpu_torch.cli.test as torch_test_cli  # noqa: E402
import seqrec_tpu_torch.cli.train as torch_train_cli  # noqa: E402
from seqrec_tpu_torch.data.synthetic import make_dataset  # noqa: E402

FLAGS = ["-m", "SDA", "-L", "64-32-64", "--do", "0.3", "--in_do", "0.2", "-b", "64", "--u_m", "adam", "--u_l", "0.001"]


def run(package, train_main, test_main, ds, extra):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        train_main(["-d", ds, *FLAGS, "--save", "All", "--progress", "1000", "--max_iter", "4000",
                    "--dir", package + "/", *extra])
        test_main(["-d", ds, *FLAGS, "--dir", package + "/", *extra])
    lines = out.getvalue().splitlines()
    val = [ln.split(":", 1)[1].strip() for ln in lines if ln.startswith("sps :")]
    test = [ln.split(":", 1)[1].strip() for ln in lines if ln.startswith(("sps@10", "recall@10"))]
    print(package, "validation sps@10 every 1000 steps:", val)
    print(package, "test (sps@10, recall@10) of the checkpoints:", list(zip(test[::2], test[1::2])))


def main():
    work = sys.argv[1] if len(sys.argv) > 1 else os.path.join(ROOT, "build", "sdae_quality")
    ds = os.path.join(work, "ds") + "/"
    if not os.path.exists(os.path.join(ds, "data", "stats")):
        make_dataset(ds, n_users=1500, n_items=800, min_len=20, max_len=120, markov_strength=0.45,
                     n_val_users=100, n_test_users=200, seed=7)
    run("jax", jax_train_cli.main, jax_test_cli.main, ds, [])
    run("port", torch_train_cli.main, torch_test_cli.main, ds, ["--device", "cpu"])


if __name__ == "__main__":
    main()
