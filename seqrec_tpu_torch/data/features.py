"""Item/user side-feature tables for the --mf/--uf input modes.

Counterpart of ``seqrec_tpu/data/features.py``, line for line: the
reference's featurization (rnn_base.py:546-613) one-hot-encodes
MovieLens-style side data into the RNN input: per item a release-decade
one-hot [8], a genre multi-hot [G], an average-rating one-hot [10] and a
log-popularity one-hot [10]; per user a sex [2] / age [7] / occupation
[21] one-hot triple. The tables hold packed FEATURE-ID rows, so the
featurization stays the sparse gather-sum of the input layer (no dense
one-hot is built).

On-disk contract (TSV, REMAPPED ids, under the dataset's ``data/`` dir):

- ``movie_features``: ``item_id year g1 ... gG`` with binary genre flags
  (column count fixes G). Items absent from the file get year 0 (decade
  bucket 0) and no genres.
- ``user_features``: ``user_id sex age occupation`` with sex in {0,1},
  age bucket in {0..6}, occupation in {0..20} (the reference indexes
  these 0-based, rnn_base.py:597-607).

The reference's ``other_features`` (average rating, log-scale popularity;
rnn_base.py:573-574) are DERIVED from the training set: avg-rating bucket
``clip(round(mean_rating * 2), 1, 10)`` and popularity bucket
``1 + floor(9 * ln(1+count) / ln(1+max_count))`` — both 1-based like the
reference's ``int2list(val, 10)``.

Feature ids are LOCAL to the movie/user block; the model adds the block
offset (after ``n_items`` and the enabled blocks before it). Pad slots
carry id -1, which the gather-sum drops.
"""

from __future__ import annotations

import os

import numpy as np


def year_to_decade_idx(years: np.ndarray) -> np.ndarray:
    """Vectorized decade bucket (rnn_base.py:554-565): <1950 -> 0, the
    50s..90s -> 1..5, the 2000s/2010s -> 6/7."""
    years = np.asarray(years, dtype=np.int64)
    idx = np.zeros(years.shape, dtype=np.int64)
    mid = (years >= 1950) & (years < 2000)
    idx[mid] = (years[mid] - 1900) // 10 - 4
    new = years >= 2000
    idx[new] = np.minimum((years[new] - 2000) // 10 + 6, 7)
    return idx


class FeatureTables:
    """Packed per-item / per-user feature-id tables.

    Attributes
    ----------
    n_movie_feats: width of the movie block (8 + G + 10 + 10), 0 if off.
    n_user_feats:  width of the user block (2 + 7 + 21 = 30), 0 if off.
    item_ids:  [n_items, 3 + Gmax] int32, ids local to the movie block,
               -1 pads (decade, avg-rating, popularity are always
               present; genres are a variable-size multi-hot).
    user_ids:  [n_users, 3] int32, ids local to the user block.
    """

    def __init__(self, item_ids, n_movie_feats, user_ids, n_user_feats):
        self.item_ids = item_ids
        self.n_movie_feats = n_movie_feats
        self.user_ids = user_ids
        self.n_user_feats = n_user_feats

    @property
    def item_slots(self) -> int:
        return 0 if self.item_ids is None else self.item_ids.shape[1]

    @property
    def user_slots(self) -> int:
        return 0 if self.user_ids is None else self.user_ids.shape[1]


def _derived_item_buckets(store, n_items):
    """(avg-rating bucket, popularity bucket) per item, both 1-based in
    1..10, from the packed training store."""
    counts = np.bincount(store.items, minlength=n_items).astype(np.float64)
    rating_sums = np.zeros(n_items, dtype=np.float64)
    np.add.at(rating_sums, store.items, store.ratings)
    avg = np.divide(rating_sums, counts, out=np.zeros_like(rating_sums),
                    where=counts > 0)
    avg_bucket = np.clip(np.round(avg * 2), 1, 10).astype(np.int64)
    cmax = max(1.0, counts.max())
    pop_bucket = 1 + np.floor(
        9.0 * np.log1p(counts) / np.log1p(cmax)
    ).astype(np.int64)
    pop_bucket = np.clip(pop_bucket, 1, 10)
    return avg_bucket, pop_bucket


def load_feature_tables(dataset, use_movies: bool, use_users: bool) -> FeatureTables:
    """Build the packed tables for a DataHandler. Raises FileNotFoundError
    with the contract description when a requested file is missing."""
    n_items, n_users = dataset.n_items, dataset.n_users
    item_ids = None
    n_movie_feats = 0
    if use_movies:
        path = os.path.join(dataset.dirname, "data", "movie_features")
        if not os.path.isfile(path):
            raise FileNotFoundError(
                f"--mf needs {path} (TSV: item_id year g1..gG with remapped "
                "item ids and binary genre flags; see seqrec_tpu/data/features.py)"
            )
        raw = np.loadtxt(path, dtype=np.int64, ndmin=2)
        G = raw.shape[1] - 2
        years = np.zeros(n_items, dtype=np.int64)
        genres = np.zeros((n_items, G), dtype=np.int64)
        rows = raw[:, 0]
        ok = (rows >= 0) & (rows < n_items)
        years[rows[ok]] = raw[ok, 1]
        genres[rows[ok]] = raw[ok, 2:]
        avg_bucket, pop_bucket = _derived_item_buckets(
            dataset.training_set.store, n_items
        )
        # block layout mirrors the reference concat (rnn_base.py:566-575):
        # decade [8] | genres [G] | avg rating [10] | popularity [10]
        n_movie_feats = 8 + G + 10 + 10
        Gmax = int(genres.sum(axis=1).max()) if G else 0
        item_ids = np.full((n_items, 3 + Gmax), -1, dtype=np.int32)
        item_ids[:, 0] = year_to_decade_idx(years)
        item_ids[:, 1] = 8 + G + (avg_bucket - 1)
        item_ids[:, 2] = 8 + G + 10 + (pop_bucket - 1)
        if Gmax:
            items_r, cols = np.nonzero(genres)
            # running slot index per item (nonzero returns row-major order)
            first = np.ones(len(items_r), dtype=bool)
            first[1:] = items_r[1:] != items_r[:-1]
            start = np.where(first)[0]
            slot = np.arange(len(items_r)) - np.repeat(start, np.diff(
                np.append(start, len(items_r))
            ))
            item_ids[items_r, 3 + slot] = 8 + cols

    user_ids = None
    n_user_feats = 0
    if use_users:
        path = os.path.join(dataset.dirname, "data", "user_features")
        if not os.path.isfile(path):
            raise FileNotFoundError(
                f"--uf needs {path} (TSV: user_id sex age occupation with "
                "remapped user ids; see seqrec_tpu/data/features.py)"
            )
        raw = np.loadtxt(path, dtype=np.int64, ndmin=2)
        # block layout mirrors rnn_base.py:597-607: sex [2] | age [7] | occ [21]
        n_user_feats = 2 + 7 + 21
        user_ids = np.zeros((n_users, 3), dtype=np.int32)
        rows = raw[:, 0]
        ok = (rows >= 0) & (rows < n_users)
        user_ids[rows[ok], 0] = np.clip(raw[ok, 1], 0, 1)
        user_ids[rows[ok], 1] = 2 + np.clip(raw[ok, 2], 0, 6)
        user_ids[rows[ok], 2] = 2 + 7 + np.clip(raw[ok, 3], 0, 20)
        user_ids[:, 1] = np.maximum(user_ids[:, 1], 2)
        user_ids[:, 2] = np.maximum(user_ids[:, 2], 9)

    return FeatureTables(item_ids, n_movie_feats, user_ids, n_user_feats)
