"""The traffic of a training cell: interaction logs drawn from the seed and
written in the preprocessed dataset layout that the port reads.

``catalog_interactions`` is a frozen copy of the arithmetic of
``seqrec_tpu_torch/data/synthetic.py:catalog_interactions`` (one numpy pass
a time step over all users: the planted successor with probability
``successor_strength``, else a popularity draw of rank^-``pop_exponent``),
so that later changes to the port do not move the benchmark's data.
``write_dataset`` follows ``data/synthetic.py:write_dataset`` (inactive
users and rare items dropped, ids renumbered in the order of the old ones,
validation and test users drawn from the seed) and writes the files with
vectorised text formatting instead of ``np.savetxt``. It also writes
``data/training_set_item_popularity.npy``, the cache of item counts that
``DataHandler.item_popularity`` keeps beside the data after its first run.

The training store (``Dataset.train_items``, ``train_offsets``) is what the
port parses from ``data/train_set_sequences``: users in id order, items in
time order. The reference takes it from here, not from the port.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np


def catalog_interactions(n_users, n_items, min_len, max_len, successor_strength, pop_exponent, rng):
    """Rows ``(user, item, rating, time)``, users in order, times 0..n-1."""
    succ = rng.permutation(n_items)
    cdf = np.cumsum(np.arange(1, n_items + 1, dtype=np.float64) ** -pop_exponent)
    cdf /= cdf[-1]
    lengths = rng.integers(min_len, max_len + 1, size=n_users)
    items = np.zeros((n_users, max_len), dtype=np.int64)
    items[:, 0] = cdf.searchsorted(rng.random(n_users), side="right")
    for t in range(1, max_len):
        follow = rng.random(n_users) < successor_strength
        drawn = cdf.searchsorted(rng.random(n_users), side="right")
        items[:, t] = np.where(follow, succ[items[:, t - 1]], drawn)
    valid = np.arange(max_len)[None, :] < lengths[:, None]
    users = np.broadcast_to(np.arange(n_users)[:, None], items.shape)[valid]
    n = int(valid.sum())
    return np.stack([users, items[valid], rng.integers(1, 6, size=n), np.arange(n)], axis=1)


def _keep_frequent(col: np.ndarray, least: int) -> np.ndarray:
    return np.bincount(col)[col] >= least


def _renumber(col: np.ndarray) -> np.ndarray:
    """Ids 0..n-1 in the order of the old ids (``np.unique``'s inverse)."""
    present = np.bincount(col) > 0
    return (np.cumsum(present) - 1)[col]


def _digits(values: np.ndarray):
    """(uint8 [n, w] right-aligned ASCII digits, bool [n, w] marking the
    digits that belong to each number) of non-negative integers below 2**31."""
    v = np.asarray(values).astype(np.int32)
    width = len(str(int(v.max()))) if v.size else 1
    digits = np.empty((len(v), width), dtype=np.uint8)
    n_digits = np.ones(len(v), dtype=np.int32)
    for k in range(width - 1, -1, -1):
        v, r = np.divmod(v, 10)
        digits[:, k] = r + 48
        if k:
            n_digits += v > 0
    used = np.arange(width)[None, :] >= (width - n_digits)[:, None]
    return digits, used


def _join(parts) -> bytes:
    """Rows of text: ``parts`` is a list of (uint8 [n, w] bytes, bool [n, w]
    kept); the kept bytes of each row, row after row."""
    return np.concatenate([p[0] for p in parts], axis=1)[np.concatenate([p[1] for p in parts], axis=1)].tobytes()


def _sequences_text(part: np.ndarray) -> bytes:
    """``user i1 r1 i2 r2 ...`` lines of rows sorted by user, time order kept."""
    n = len(part)
    if n == 0:
        return b""
    first = np.r_[True, part[1:, 0] != part[:-1, 0]]
    last = np.r_[part[1:, 0] != part[:-1, 0], True]
    u_digits, u_used = _digits(part[:, 0])
    space = np.full((n, 1), 32, dtype=np.uint8)
    ones = np.ones((n, 1), dtype=bool)
    end = np.where(last, 10, 32).astype(np.uint8)[:, None]
    return _join([(u_digits, u_used & first[:, None]), (space, first[:, None]), _digits(part[:, 1]),
                  (space, ones), _digits(part[:, 2]), (end, ones)])


def _triplets_text(part: np.ndarray) -> bytes:
    """``user<TAB>item<TAB>rating`` lines (``np.savetxt(fmt="%d")``'s)."""
    n = len(part)
    tab = np.full((n, 1), 9, dtype=np.uint8)
    newline = np.full((n, 1), 10, dtype=np.uint8)
    ones = np.ones((n, 1), dtype=bool)
    return _join([_digits(part[:, 0]), (tab, ones), _digits(part[:, 1]), (tab, ones), _digits(part[:, 2]),
                  (newline, ones)])


@dataclass
class Dataset:
    dirname: str
    n_items: int
    train_items: np.ndarray  # int64, the training sequences concatenated in user order
    train_offsets: np.ndarray  # int64 [n_train_users + 1]


def _stats_row(name: str, rows: np.ndarray) -> str:
    counts = np.bincount(rows[:, 0])
    counts = counts[counts > 0]
    return "\t".join(map(str, [name, len(counts), int((np.bincount(rows[:, 1]) > 0).sum()), len(rows),
                               int(counts.max())]))


def write_dataset(dirname: str, rows: np.ndarray, n_val_users: int, n_test_users: int, min_user_activity: int,
                  min_item_pop: int, rng) -> Dataset:
    rows = rows[_keep_frequent(rows[:, 0], min_user_activity)]
    rows = rows[_keep_frequent(rows[:, 1], min_item_pop)]
    rows = rows[_keep_frequent(rows[:, 0], min_user_activity)]
    rows = rows[np.argsort(rows[:, 3], kind="stable")]
    rows[:, 0] = _renumber(rows[:, 0])
    rows[:, 1] = _renumber(rows[:, 1])
    n_items = int(rows[:, 1].max()) + 1

    users = np.unique(rows[:, 0])
    if len(users) <= n_val_users + n_test_users:
        raise ValueError("not enough users for the validation and test splits")
    test_users = rng.choice(users, n_test_users, replace=False)
    val_users = rng.choice(np.setdiff1d(users, test_users), n_val_users, replace=False)
    is_test = np.isin(rows[:, 0], test_users)
    is_val = np.isin(rows[:, 0], val_users)
    splits = {"train": rows[~(is_test | is_val)], "val": rows[is_val], "test": rows[is_test]}

    data = os.path.join(dirname, "data")
    for sub in ("data", "models", "results"):
        os.makedirs(os.path.join(dirname, sub), exist_ok=True)
    for name, part in splits.items():
        part = part[np.argsort(part[:, 0], kind="stable")]  # user-major, time order kept
        splits[name] = part
        with open(os.path.join(data, name + "_set_sequences"), "wb") as f:
            f.write(_sequences_text(part))
    train = splits["train"]
    with open(os.path.join(data, "train_set_triplets"), "wb") as f:
        f.write(_triplets_text(train))
    np.save(os.path.join(data, "training_set_item_popularity.npy"),
            np.bincount(train[:, 1], minlength=n_items).astype(np.float64))
    with open(os.path.join(data, "stats"), "w") as f:
        f.write("set\tn_users\tn_items\tn_interactions\tlongest_sequence\n")
        for name, part in (("Full", rows), ("Train", train), ("Val", splits["val"]), ("Test", splits["test"])):
            f.write(_stats_row(name, part) + "\n")

    offsets = np.r_[0, np.cumsum(np.bincount(train[:, 0])[np.unique(train[:, 0])])].astype(np.int64)
    return Dataset(dirname.rstrip("/") + "/", n_items, train[:, 1].astype(np.int64), offsets)


def generate(dirname: str, traffic: dict, n_items: int, seed: int) -> Dataset:
    """The cell's dataset from ``seed``, written into ``dirname``."""
    rng = np.random.default_rng([seed, 1])
    rows = catalog_interactions(
        traffic["n_users"], n_items, traffic["min_len"], traffic["max_len"], traffic["successor_strength"],
        traffic["pop_exponent"], rng,
    )
    return write_dataset(dirname, rows, traffic["n_val_users"], traffic["n_test_users"],
                         traffic["min_user_activity"], traffic["min_item_pop"], np.random.default_rng([seed, 2]))
