"""Synthetic datasets with planted sequential structure, numpy only.

``generate_interactions`` draws the same interactions as
``seqrec_tpu.data.synthetic.generate_interactions`` for the same arguments
(a first-order Markov chain over items plus a Zipf-like popularity skew).
``catalog_interactions`` draws interactions of the same kind vectorized
over users, with a flatter popularity, for catalogs of tens of thousands
of items. ``generate_interactions_lag2`` draws the JAX package's lag-2
successor regime. ``make_dataset`` (through ``write_dataset``) writes them
straight into the preprocessed directory layout that
:class:`seqrec_tpu_torch.data.DataHandler` reads, with a split of its own
(``data/preprocess.py`` writes the JAX package's split of a ratings
file):

- ``data/{train,val,test}_set_sequences``: one ``user i1 r1 i2 r2 ...`` line
  per user, in time order;
- ``data/train_set_triplets``: ``user item rating`` per line, in time order
  (the evaluator's item popularity counts it);
- ``data/stats``: header, then Full/Train/Val/Test rows of
  ``n_users n_items n_interactions longest_sequence``;
- empty ``models/`` and ``results/``.

``write_side_features`` adds the --mf/--uf side tables of
``data/features.py``'s contract, drawn from a seed at MovieLens-1M's
widths.
"""

from __future__ import annotations

import os

import numpy as np


def generate_interactions(
    n_users: int = 500,
    n_items: int = 200,
    min_len: int = 10,
    max_len: int = 40,
    markov_strength: float = 0.7,
    seed: int = 0,
) -> np.ndarray:
    """Return an interactions array of rows ``(user, item, rating, time)``.

    With probability ``markov_strength`` the next item follows a planted
    deterministic successor chain (with a small random jump); otherwise it
    is drawn from a Zipf-like popularity distribution.

    A popularity draw is ``Generator.choice(n_items, p=pop)`` done by hand:
    one ``rng.random()`` looked up in the cumulative distribution, which is
    what ``choice`` does, so the random stream and the draws are the JAX
    package's, at a tenth of the cost.
    """
    rng = np.random.default_rng(seed)
    succ = rng.permutation(n_items)
    pop_logits = -1.1 * np.log(np.arange(1, n_items + 1))
    pop = np.exp(pop_logits - pop_logits.max())
    pop /= pop.sum()
    cdf = pop.cumsum()
    cdf /= cdf[-1]

    def draw() -> int:
        return int(cdf.searchsorted(rng.random(), side="right"))

    rows = []
    t = 0
    for u in range(n_users):
        length = int(rng.integers(min_len, max_len + 1))
        item = draw()
        seen = {item}
        rows.append((u, item, 1 + int(rng.integers(0, 5)), t))
        t += 1
        for _ in range(length - 1):
            if rng.random() < markov_strength:
                item = int(succ[item])
            else:
                item = draw()
            # avoid long repeats of the same item
            if item in seen and rng.random() < 0.5:
                item = draw()
            seen.add(item)
            rows.append((u, item, 1 + int(rng.integers(0, 5)), t))
            t += 1
    return np.asarray(rows, dtype=np.int64)


def catalog_interactions(
    n_users: int,
    n_items: int,
    min_len: int = 20,
    max_len: int = 100,
    markov_strength: float = 0.45,
    pop_exponent: float = 0.5,
    seed: int = 0,
) -> np.ndarray:
    """Rows ``(user, item, rating, time)`` for a large catalog, one numpy
    pass per time step over all users: with probability
    ``markov_strength`` the next item is the planted successor of the
    previous one, otherwise a draw from a popularity ``rank^-pop_exponent``
    (flatter than ``generate_interactions``' 1.1, so that most items stay
    above the rare-item filter). Not the JAX package's draws."""
    rng = np.random.default_rng(seed)
    succ = rng.permutation(n_items)
    cdf = np.cumsum(np.arange(1, n_items + 1, dtype=np.float64) ** -pop_exponent)
    cdf /= cdf[-1]
    lengths = rng.integers(min_len, max_len + 1, size=n_users)
    items = np.zeros((n_users, max_len), dtype=np.int64)
    items[:, 0] = cdf.searchsorted(rng.random(n_users), side="right")
    for t in range(1, max_len):
        follow = rng.random(n_users) < markov_strength
        drawn = cdf.searchsorted(rng.random(n_users), side="right")
        items[:, t] = np.where(follow, succ[items[:, t - 1]], drawn)
    valid = np.arange(max_len)[None, :] < lengths[:, None]
    users = np.broadcast_to(np.arange(n_users)[:, None], items.shape)[valid]
    n = int(valid.sum())
    return np.stack([users, items[valid], rng.integers(1, 6, size=n), np.arange(n)], axis=1)


def generate_interactions_lag2(
    n_users: int = 500,
    n_items: int = 2000,
    min_len: int = 10,
    max_len: int = 40,
    markov_strength: float = 0.6,
    seed: int = 0,
) -> np.ndarray:
    """Rows ``(user, item, rating, time)`` of the lag-2 successor regime,
    the same draws as ``seqrec_tpu.data.synthetic.generate_interactions_lag2``
    for the same arguments: with probability ``markov_strength`` the next
    item is ``succ[i_{t-2}]`` (a planted permutation of the second-to-last
    item), otherwise a uniform jump. Two interleaved successor chains leave
    a first-order model at the popularity floor, while a recurrent model
    has to carry the item one step through its state
    (``scripts/convergence_run.sh``'s dataset)."""
    rng = np.random.default_rng(seed)
    succ = rng.permutation(n_items)
    lengths = rng.integers(min_len, max_len + 1, size=n_users)
    L = int(lengths.max())
    items = np.zeros((n_users, L), dtype=np.int64)
    items[:, 0] = rng.integers(0, n_items, size=n_users)
    items[:, 1] = rng.integers(0, n_items, size=n_users)
    for t in range(2, L):
        follow = rng.random(n_users) < markov_strength
        jump = rng.integers(0, n_items, size=n_users)
        items[:, t] = np.where(follow, succ[items[:, t - 2]], jump)
    valid = np.arange(L)[None, :] < lengths[:, None]
    users = np.repeat(np.arange(n_users), lengths)
    flat_items = items[valid]
    ratings = rng.integers(1, 6, size=flat_items.size)
    return np.stack([users, flat_items, ratings, np.arange(flat_items.size)], axis=1)


def _remove_rare(rows: np.ndarray, min_user_activity: int, min_item_pop: int) -> np.ndarray:
    """Drop inactive users, then rare items, then inactive users again (the
    preprocess order; the item bound may end up loosely satisfied)."""

    def keep_frequent(col, least):
        _, inv, counts = np.unique(rows[:, col], return_inverse=True, return_counts=True)
        return counts[inv] >= least

    rows = rows[keep_frequent(0, min_user_activity)]
    rows = rows[keep_frequent(1, min_item_pop)]
    return rows[keep_frequent(0, min_user_activity)]


def _stats_row(name: str, rows: np.ndarray) -> str:
    users, counts = np.unique(rows[:, 0], return_counts=True)
    return "\t".join(
        map(str, [name, len(users), len(np.unique(rows[:, 1])), len(rows), counts.max()])
    )


def _write_sequences(filename: str, rows: np.ndarray) -> None:
    order = np.argsort(rows[:, 0], kind="stable")  # user-major, time order kept
    rows = rows[order]
    starts = np.flatnonzero(np.r_[True, rows[1:, 0] != rows[:-1, 0]])
    ends = np.r_[starts[1:], len(rows)]
    with open(filename, "w") as f:
        for lo, hi in zip(starts, ends):
            pairs = rows[lo:hi, 1:3].ravel()
            f.write(" ".join(map(str, [rows[lo, 0], *pairs.tolist()])) + "\n")


def make_dataset(
    dirname: str,
    n_users: int = 500,
    n_items: int = 200,
    min_len: int = 10,
    max_len: int = 40,
    markov_strength: float = 0.7,
    n_val_users: int = 50,
    n_test_users: int = 50,
    min_user_activity: int = 2,
    min_item_pop: int = 5,
    seed: int = 0,
) -> str:
    """Generate interactions (``generate_interactions``) and write the
    preprocessed layout into ``dirname`` (``write_dataset``); returns the
    directory with a trailing slash."""
    rows = generate_interactions(
        n_users=n_users,
        n_items=n_items,
        min_len=min_len,
        max_len=max_len,
        markov_strength=markov_strength,
        seed=seed,
    )
    return write_dataset(dirname, rows, n_val_users, n_test_users, min_user_activity, min_item_pop, seed)


def write_dataset(
    dirname: str,
    rows: np.ndarray,
    n_val_users: int = 50,
    n_test_users: int = 50,
    min_user_activity: int = 2,
    min_item_pop: int = 5,
    seed: int = 0,
) -> str:
    """Write interaction rows ``(user, item, rating, time)`` as a
    preprocessed dataset into ``dirname``; returns the directory with a
    trailing slash.

    Users and items are renumbered ``0..n-1`` in the order of their
    original ids after the rare-element filter; validation and test users
    are drawn without replacement from ``np.random.default_rng(seed)``."""
    rows = _remove_rare(rows, min_user_activity, min_item_pop)
    rows = rows[np.argsort(rows[:, 3], kind="stable")]
    rows[:, 0] = np.unique(rows[:, 0], return_inverse=True)[1]
    rows[:, 1] = np.unique(rows[:, 1], return_inverse=True)[1]

    users = np.unique(rows[:, 0])
    if len(users) <= n_val_users + n_test_users:
        raise ValueError("Not enough users for the validation and test splits")
    rng = np.random.default_rng(seed)
    test_users = rng.choice(users, n_test_users, replace=False)
    rest = np.setdiff1d(users, test_users)
    val_users = rng.choice(rest, n_val_users, replace=False)
    is_test = np.isin(rows[:, 0], test_users)
    is_val = np.isin(rows[:, 0], val_users)
    splits = {
        "train": rows[~(is_test | is_val)],
        "val": rows[is_val],
        "test": rows[is_test],
    }

    dirname = dirname if dirname.endswith("/") else dirname + "/"
    for sub in ("data", "models", "results"):
        os.makedirs(os.path.join(dirname, sub), exist_ok=True)
    data = os.path.join(dirname, "data")
    # DataHandler caches the item popularity of the training set here
    stale = os.path.join(data, "training_set_item_popularity.npy")
    if os.path.exists(stale):
        os.remove(stale)
    np.savetxt(os.path.join(data, "train_set_triplets"), splits["train"][:, :3], fmt="%d", delimiter="\t")
    for name, part in splits.items():
        _write_sequences(os.path.join(data, name + "_set_sequences"), part)
    with open(os.path.join(data, "stats"), "w") as f:
        f.write("set\tn_users\tn_items\tn_interactions\tlongest_sequence\n")
        for name, part in (("Full", rows), ("Train", splits["train"]), ("Val", splits["val"]), ("Test", splits["test"])):
            f.write(_stats_row(name, part) + "\n")
    return dirname


def write_side_features(dirname: str, n_items: int, n_users: int, seed: int = 0, n_genres: int = 18,
                        max_genres: int = 6) -> None:
    """Write ``data/movie_features`` and ``data/user_features`` (TSV,
    ``data/features.py``'s contract) for every item and user, drawn from
    ``seed`` at MovieLens-1M's widths: ``n_genres`` binary genre columns
    with 1 to ``max_genres`` genres an item (item 0 has ``max_genres``),
    release years 1919-2000, sex 0-1, age bucket 0-6, occupation 0-20."""
    rng = np.random.default_rng(seed)
    n_genre = rng.integers(1, max_genres + 1, size=n_items)
    n_genre[0] = max_genres
    genres = np.zeros((n_items, n_genres), dtype=np.int64)
    for i, n in enumerate(n_genre):
        genres[i, rng.choice(n_genres, size=n, replace=False)] = 1
    years = rng.integers(1919, 2001, size=n_items)
    movies = np.column_stack([np.arange(n_items), years, genres])
    users = np.column_stack([
        np.arange(n_users), rng.integers(0, 2, n_users), rng.integers(0, 7, n_users), rng.integers(0, 21, n_users),
    ])
    os.makedirs(os.path.join(dirname, "data"), exist_ok=True)
    np.savetxt(os.path.join(dirname, "data", "movie_features"), movies, fmt="%d", delimiter="\t")
    np.savetxt(os.path.join(dirname, "data", "user_features"), users, fmt="%d", delimiter="\t")
