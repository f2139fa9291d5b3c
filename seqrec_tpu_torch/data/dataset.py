"""Dataset access: packed sequence store + reference-compatible handlers.

A copy of ``seqrec_tpu/data/dataset.py`` (the port imports nothing of the
JAX package). Sequence files are parsed by the port's own copy of the C++
parser (``data/native.py``), with the Python tokenizer where it is
unavailable, as in the JAX package.

Reads the on-disk dataset contract produced by the JAX package's
preprocess, by the port's (``seqrec_tpu_torch.data.preprocess``, the same
files) or by ``seqrec_tpu_torch.data.synthetic`` (same layout as the
reference's preprocess.py:147-214):

- ``data/train_set_triplets``          TSV ``user item rating``, chronological
- ``data/{train,val,test}_set_sequences``  line = ``user i1 r1 i2 r2 ...``
- ``data/train_set_sequences+``        extended training set
- ``data/stats``                       per-split user/item/interaction counts
- ``data/{user,item}_id_mapping``      original-id ↔ new-id TSVs

Unlike the reference's line-oriented ``SequenceGenerator``
(the reference's helpers/data_handling.py:104-174) which re-parses text per
epoch, sequences are parsed ONCE into packed integer arrays (flat ``items``
/ ``ratings`` + ``offsets``) so that batch assembly is numpy gathers and the
arrays can be shipped to the device wholesale. A generator facade keeps the
reference iteration semantics (fractional ``epochs`` counter, shuffling,
min-length filter, subsequence modes) for the training loops.
"""

from __future__ import annotations

import os

import numpy as np

# Default dataset-directory prefix (reference: data_handling.py:9). Can be
# pointed elsewhere with the SEQREC_DATA_DIR environment variable.
DEFAULT_DIR = os.environ.get("SEQREC_DATA_DIR", "../../data/")


class SequenceStore:
    """Packed in-memory store of an entire ``*_set_sequences`` file.

    Attributes
    ----------
    items : int32[total_interactions]
        All item ids, concatenated in sequence order.
    ratings : float32[total_interactions]
        Matching ratings.
    offsets : int64[n_sequences + 1]
        ``items[offsets[i]:offsets[i+1]]`` is user ``i``'s sequence.
    user_ids : int64[n_sequences]
    """

    def __init__(self, items, ratings, offsets, user_ids):
        self.items = np.asarray(items, dtype=np.int32)
        self.ratings = np.asarray(ratings, dtype=np.float32)
        self.offsets = np.asarray(offsets, dtype=np.int64)
        self.user_ids = np.asarray(user_ids, dtype=np.int64)

    @classmethod
    def from_file(cls, filename: str) -> "SequenceStore":
        # fast path: the native C++ parser (data/native.py); the Python
        # tokenizer where it is unavailable
        from seqrec_tpu_torch.data.native import load_sequences_native

        parsed = load_sequences_native(filename)
        if parsed is not None:
            items, ratings, offsets, users = parsed
            return cls(items, ratings, offsets, users)

        users, items, ratings, offsets = [], [], [], [0]
        with open(filename) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                users.append(int(float(parts[0])))
                seq = parts[1:]
                items.extend(int(float(tok)) for tok in seq[0::2])
                ratings.extend(float(tok) for tok in seq[1::2])
                offsets.append(len(items))
        return cls(items, ratings, offsets, users)

    def __len__(self) -> int:
        return len(self.user_ids)

    @property
    def lengths(self) -> np.ndarray:
        return np.diff(self.offsets)

    def sequence(self, i: int):
        """Return ``(items, ratings, user_id)`` arrays for sequence ``i``."""
        lo, hi = self.offsets[i], self.offsets[i + 1]
        return self.items[lo:hi], self.ratings[lo:hi], self.user_ids[i]

    def as_tuples(self, i: int):
        """Reference-format view: ``[[item, rating], ...]`` list."""
        its, rts, _ = self.sequence(i)
        return [[int(a), float(b)] for a, b in zip(its, rts)]


class SequenceGenerator:
    """Epoch-looping generator over a :class:`SequenceStore`.

    Iteration semantics mirror the reference generator
    (data_handling.py:126-174): yields ``(sequence, user_id)`` with
    ``sequence`` a list of ``[item, rating]`` pairs, maintains a fractional
    ``epochs`` attribute, optionally shuffles between epochs, filters by
    ``min_length`` and applies ``length_choice`` ∈ {max, random} and
    ``subsequence`` ∈ {contiguous, random, begining}.
    """

    def __init__(self, filename: str, shuffle: bool = False):
        self.filename = filename
        self.shuffle = shuffle
        self.epochs = 0.0
        self._store: SequenceStore | None = None
        # split stats, populated by DataHandler._load_stats
        self.n_users = None
        self.n_items = None
        self.n_interactions = None
        self.longest_sequence = None

    def load(self) -> None:
        if self._store is None:
            self._store = SequenceStore.from_file(self.filename)

    @property
    def store(self) -> SequenceStore:
        self.load()
        return self._store

    def __call__(
        self,
        min_length: int = 2,
        max_length: int | None = None,
        length_choice: str = "max",
        subsequence: str = "contiguous",
        epochs: float = np.inf,
        rng: np.random.Generator | None = None,
    ):
        store = self.store
        rng = rng or np.random.default_rng()
        order = np.arange(len(store))

        counter = 0
        self.epochs = 0.0
        n = len(store)
        while counter < epochs:
            counter += 1
            if self.shuffle:
                rng.shuffle(order)
            for j, idx in enumerate(order):
                self.epochs = counter - 1 + j / n
                items, ratings, user_id = store.sequence(idx)
                seq_len = len(items)
                if seq_len < min_length:
                    continue

                this_max = seq_len if max_length is None else max_length
                if length_choice == "random":
                    length = int(rng.integers(min_length, min(this_max, seq_len) + 1))
                elif length_choice == "max":
                    length = min(this_max, seq_len)
                else:
                    raise ValueError(
                        'Unrecognised length_choice option. Authorised values are "random" and "max"'
                    )

                if length < seq_len:
                    if subsequence == "random":
                        keep = np.sort(rng.choice(seq_len, size=length, replace=False))
                        items, ratings = items[keep], ratings[keep]
                    elif subsequence == "contiguous":
                        start = int(rng.integers(0, seq_len - length + 1))
                        items = items[start : start + length]
                        ratings = ratings[start : start + length]
                    elif subsequence == "begining":
                        items, ratings = items[:length], ratings[:length]
                    else:
                        raise ValueError(
                            'Unrecognised subsequence option. Authorised values are "random", "contiguous" and "begining".'
                        )

                yield [[int(a), float(b)] for a, b in zip(items, ratings)], user_id


class DataHandler:
    """Loads a preprocessed dataset directory.

    Constructor contract matches the reference (data_handling.py:18-51):
    ``dirname`` falls back to ``DEFAULT_DIR + dirname``; the directory must
    contain ``data/``, ``models/`` and ``results/`` subdirectories.
    """

    def __init__(
        self,
        dirname: str,
        extended_training_set: bool = False,
        shuffle_training: bool = False,
    ):
        self.dirname = self._get_path(dirname)
        self.extended_training_set = extended_training_set
        suffix = "train_set_sequences+" if extended_training_set else "train_set_sequences"
        self.training_set = SequenceGenerator(
            os.path.join(self.dirname, "data", suffix), shuffle=shuffle_training
        )
        self.validation_set = SequenceGenerator(
            os.path.join(self.dirname, "data", "val_set_sequences")
        )
        self.test_set = SequenceGenerator(
            os.path.join(self.dirname, "data", "test_set_sequences")
        )
        self._load_stats()

    # ------------------------------------------------------------------
    def training_set_triplets(self):
        with open(os.path.join(self.dirname, "data", "train_set_triplets")) as f:
            for line in f:
                parts = line.split()
                yield {
                    "user_id": int(parts[0]),
                    "item_id": int(parts[1]),
                    "rating": float(parts[2]),
                }

    @property
    def item_popularity(self) -> np.ndarray:
        """Number of occurrences of each item in the training set; cached to
        ``data/training_set_item_popularity.npy`` (data_handling.py:59-74)."""
        if getattr(self, "_item_pop", None) is None:
            cache = os.path.join(
                self.dirname, "data", "training_set_item_popularity.npy"
            )
            if os.path.isfile(cache):
                self._item_pop = np.load(cache)
            else:
                pop = np.zeros(self.n_items)
                with open(
                    os.path.join(self.dirname, "data", "train_set_triplets")
                ) as f:
                    for line in f:
                        pop[int(line.split()[1])] += 1
                np.save(cache, pop)
                self._item_pop = pop
        return self._item_pop

    # ------------------------------------------------------------------
    @staticmethod
    def _get_path(dirname: str) -> str:
        if os.path.isabs(dirname):
            if os.path.exists(dirname):
                return dirname if dirname.endswith("/") else dirname + "/"
            raise ValueError("Dataset not found")
        prefixed = os.path.join(DEFAULT_DIR, dirname) + "/"
        if os.path.exists(dirname) and not os.path.exists(prefixed):
            return dirname if dirname.endswith("/") else dirname + "/"
        if not os.path.exists(dirname) and os.path.exists(prefixed):
            return prefixed
        if os.path.exists(dirname) and os.path.exists(prefixed):
            print(
                'WARNING: ambiguous directory name, both "%s" and "%s" exist. "%s" is used.'
                % (dirname, prefixed, dirname)
            )
            return dirname if dirname.endswith("/") else dirname + "/"
        raise ValueError("Dataset not found")

    def _load_stats(self) -> None:
        """Parse ``data/stats`` (written by preprocess; data_handling.py:89-102)."""
        with open(os.path.join(self.dirname, "data", "stats")) as f:
            f.readline()  # header
            rows = [list(map(int, f.readline().split()[1:])) for _ in range(4)]
        (
            (self.n_users, self.n_items, self.n_interactions, self.longest_sequence),
            train_row,
            val_row,
            test_row,
        ) = rows
        for gen, row in (
            (self.training_set, train_row),
            (self.validation_set, val_row),
            (self.test_set, test_row),
        ):
            gen.n_users, gen.n_items, gen.n_interactions, gen.longest_sequence = row

        if self.extended_training_set:
            # Approximate, as in the reference (data_handling.py:99-102).
            self.training_set.n_users = self.n_users
            self.training_set.n_items = self.n_items
            self.training_set.n_interactions += (
                self.validation_set.n_interactions + self.test_set.n_interactions
            ) // 2
