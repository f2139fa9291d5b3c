"""The port's lazy baselines (POP, the Markov model, user-KNN) against the
JAX package's on the CPU: the same top-10 lists on every test user of a
small dataset, with and without ``exclude``, and the same metrics through
both test CLIs. They are numpy and scipy in both packages, so the lists
are compared exactly.
"""

import numpy as np
import pytest

import seqrec_tpu.cli.test as jax_test_cli
from seqrec_tpu.data import DataHandler as JaxDataHandler
from seqrec_tpu.models import lazy as jax_lazy
from seqrec_tpu_torch.cli import test as torch_test_cli
from seqrec_tpu_torch.data import DataHandler
from seqrec_tpu_torch.data.synthetic import make_dataset
from seqrec_tpu_torch.models import lazy


@pytest.fixture(scope="module")
def dataset_dir(tmp_path_factory):
    return make_dataset(str(tmp_path_factory.mktemp("lazy")), n_users=150, n_items=70, min_len=6,
                        max_len=30, n_val_users=20, n_test_users=40, seed=9)


@pytest.mark.parametrize(
    "name, kwargs",
    [("Pop", {}), ("MarkovModel", {}), ("UserKNN", {}), ("UserKNN", {"neighborhood_size": 10})],
    ids=["POP", "MM", "UKNN", "UKNN_ns10"],
)
def test_lists_equal_jax_on_every_test_user(dataset_dir, name, kwargs):
    want_model = getattr(jax_lazy, name)(**kwargs)
    got_model = getattr(lazy, name)(**kwargs)
    want_model.prepare_model(JaxDataHandler(dataset_dir))
    got_model.prepare_model(DataHandler(dataset_dir))
    assert got_model._get_model_filename(3) == want_model._get_model_filename(3)
    rng = np.random.default_rng(0)
    n_users = 0
    for sequence, user_id in DataHandler(dataset_dir).test_set(epochs=1):
        viewed = sequence[: len(sequence) // 2]
        exclude = rng.integers(0, 70, 5).tolist()
        for kw in ({}, {"exclude": exclude}):
            want = want_model.top_k_recommendations(viewed, user_id=user_id, k=10, **kw)
            got = got_model.top_k_recommendations(viewed, user_id=user_id, k=10, **kw)
            assert [int(i) for i in got] == [int(i) for i in want], (user_id, kw)
            if name != "MarkovModel":  # its zero-ranked slots may hold seen items (the quirk)
                assert not set(map(int, got)) & ({int(i[0]) for i in viewed} | set(kw.get("exclude", [])))
        n_users += 1
    assert n_users == 40


@pytest.mark.parametrize("method", ["POP", "MM", "UKNN"])
def test_test_cli_prints_the_jax_metrics(dataset_dir, method, capsys):
    argv = ["-d", dataset_dir, "-m", method]
    jax_test_cli.main(argv)
    want = [line for line in capsys.readouterr().out.splitlines() if "@10:" in line]
    torch_test_cli.main(argv + ["--device", "cpu"])
    got = [line for line in capsys.readouterr().out.splitlines() if "@10:" in line]
    assert len(want) == 5 and got == want

