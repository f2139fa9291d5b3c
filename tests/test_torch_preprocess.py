"""The port's numpy preprocess against the JAX package's pandas one: the
same raw file through both gives the same files, byte for byte (the id
mappings, the triplets, the sequences, ``train_set_sequences+``, ``stats``
and both READMEs). Three inputs, each made from a seed with numpy: integer
ids and ratings with ``::`` (``scripts/baseline_run.sh``'s format),
whitespace with no rating column, and text ids with decimal ratings and
ISO-8601 dates; rows are shuffled and timestamps tied, so the stable time
sort matters. Also a split given as fractions, ``main`` with ``--yes``,
and the refusal of a date format the port does not read.
"""

import os

import numpy as np
import pytest

from seqrec_tpu.data import preprocess as jax_preprocess
from seqrec_tpu_torch.data import preprocess as torch_preprocess
from seqrec_tpu_torch.data.synthetic import generate_interactions

FILES = [
    "data/user_id_mapping", "data/item_id_mapping",
    "data/train_set_triplets", "data/val_set_triplets", "data/test_set_triplets",
    "data/train_set_sequences", "data/val_set_sequences", "data/test_set_sequences",
    "data/train_set_sequences+", "data/stats", "data/README", "results/README",
]


def _rows(seed):
    """(user, item, rating, time) rows, shuffled, with sparse original ids,
    timestamps tied in threes and 8 users of one row each."""
    rows = generate_interactions(n_users=90, n_items=50, min_len=2, max_len=16, seed=seed)
    rng = np.random.default_rng(seed)
    single = np.stack([np.arange(90, 98), rows[rng.integers(0, len(rows), 8), 1],
                       np.full(8, 3), rng.integers(0, rows[-1, 3], 8)], axis=1)
    rows = np.concatenate([rows, single])
    rows[:, 0] = rows[:, 0] * 7 + 1000
    rows[:, 1] = rows[:, 1] * 13 + 5
    rows[:, 3] //= 3
    return rows[rng.permutation(len(rows))]


def _write_int_colons(path, seed):
    np.savetxt(path, _rows(seed), fmt="%d", delimiter="::")


def _write_whitespace_uit(path, seed):
    rows = _rows(seed)
    rng = np.random.default_rng(seed + 1)
    gaps = [" ", "  ", "\t", " \t "]
    with open(path, "w") as f:
        for u, i, _, t in rows:
            g = [gaps[j] for j in rng.integers(0, len(gaps), 3)]
            f.write(f"{u}{g[0]}{i}{g[1]}{t}{g[2]}extra\n")


def _write_text_ids(path, seed):
    """Text ids whose code-point order is not their numeric order, ratings
    like 3.5 and 4.0, ISO-8601 dates with ties, a comma separator."""
    rows = _rows(seed)
    rng = np.random.default_rng(seed + 2)
    ratings = rng.integers(2, 11, len(rows)) / 2
    days = np.datetime64("2001-03-01T00:00:00") + rows[:, 3].astype("timedelta64[h]")
    with open(path, "w") as f:
        for (u, i, _, _), r, t in zip(rows, ratings, days):
            f.write(f"u{u % 97},it{i},{r},{str(t).replace('T', ' ')}\n")


INPUTS = {
    "int_colons_uirt": (_write_int_colons, dict(columns="uirt", sep="::")),
    "whitespace_uit": (_write_whitespace_uit, dict(columns="uit")),
    "text_ids_decimal_ratings": (_write_text_ids, dict(columns="uirt", sep=",")),
}


def _run_both(tmp_path, name, data_seed, **kwargs):
    write, flags = INPUTS[name]
    dirs = []
    for pkg, module in (("jax", jax_preprocess), ("port", torch_preprocess)):
        d = tmp_path / pkg
        d.mkdir()
        write(d / "ratings.dat", data_seed)
        dirs.append(module.preprocess(str(d / "ratings.dat"), dirname=str(d) + "/", **flags, **kwargs))
    return dirs


def _assert_same_files(want_dir, got_dir):
    for name in FILES:
        with open(os.path.join(want_dir, name), "rb") as f:
            want = f.read()
        with open(os.path.join(got_dir, name), "rb") as f:
            got = f.read()
        assert got == want, name


@pytest.mark.parametrize(
    "name, kwargs",
    [
        ("int_colons_uirt", dict(min_item_pop=3, val_size=10, test_size=10)),
        ("int_colons_uirt", dict(min_user_activity=1, min_item_pop=2, val_size=10, test_size=12, seed=4)),
        ("whitespace_uit", dict(min_item_pop=4, val_size=8, test_size=9, seed=2)),
        ("text_ids_decimal_ratings", dict(min_item_pop=3, val_size=10, test_size=10, seed=3)),
        ("int_colons_uirt", dict(min_item_pop=3, val_size=0.1, test_size=0.15)),
    ],
    ids=["int_colons", "one_item_users", "whitespace_uit", "text_ids", "fraction_split"],
)
def test_files_equal_jax_byte_for_byte(tmp_path, name, kwargs):
    _assert_same_files(*_run_both(tmp_path, name, data_seed=11, **kwargs))


def test_one_item_users_reach_the_quirk(tmp_path):
    """min_user_activity=1 keeps users with one item: the sequences drop
    them except for the last user, as the JAX package does."""
    _, got = _run_both(tmp_path, "int_colons_uirt", data_seed=11, min_user_activity=1, min_item_pop=2,
                       val_size=10, test_size=12)
    triplets = np.loadtxt(os.path.join(got, "data", "train_set_triplets"), dtype=np.int64)
    users, counts = np.unique(triplets[:, 0], return_counts=True)
    with open(os.path.join(got, "data", "train_set_sequences")) as f:
        written = [int(line.split()[0]) for line in f]
    single = set(users[counts == 1].tolist())
    assert single and not (single - {users.max()}) & set(written)


def test_main_with_yes_matches_jax(tmp_path, capsys):
    argv_tail = ["--columns", "uirt", "--sep", "::", "--min_item_pop", "3", "--val_size", "10",
                 "--test_size", "10", "--yes"]
    for pkg, module in (("jax", jax_preprocess), ("port", torch_preprocess)):
        (tmp_path / pkg).mkdir()
        _write_int_colons(tmp_path / pkg / "ratings.dat", 5)
        module.main(["-f", str(tmp_path / pkg / "ratings.dat"), *argv_tail])
        assert capsys.readouterr().out.strip() == "Data ready!"
    _assert_same_files(str(tmp_path / "jax") + "/", str(tmp_path / "port") + "/")


def test_unknown_date_format_raises(tmp_path):
    path = tmp_path / "ratings.csv"
    path.write_text("1,2,3,03/01/2001\n")
    with pytest.raises(NotImplementedError, match="ISO-8601"):
        torch_preprocess.load_data(str(path), "uirt", ",")
