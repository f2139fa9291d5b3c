"""Non-learned baseline predictors: POP, first-order Markov, user-KNN.

A copy of ``seqrec_tpu/models/lazy.py`` (the port imports nothing of the
JAX package). These are the evaluation floors: numpy and scipy on the
host, with no device work, in the port as in the JAX package. Their test
CLI still resolves ``--device``, as every entry point of the port does.
The reference's quirks are kept:

- MarkovModel stores one transition per distinct source item per user
  sequence (later occurrences overwrite) and ranks by a k-step ranking
  vector, so with fewer than k counted successors the remaining slots are
  arbitrary unseen items;
- UserKNN similarity is overlap / sqrt(items-per-user), an asymmetric
  cosine.
"""

from __future__ import annotations

import collections
import os.path
from copy import deepcopy

import numpy as np
import scipy.sparse as ssp


def top_k(values, k, exclude=()):
    values[list(exclude)] = -np.inf
    return list(np.argpartition(-values, range(k))[:k])


def get_sparse_vector(ids, length, values=None):
    n = len(ids)
    if values is None:
        values = np.ones(n)
    return ssp.coo_matrix((values, (ids, np.zeros(n))), (length, 1)).tocsc()


class Lazy:
    """Base for non-learned predictors."""

    def __init__(self):
        self.name = "Lazy base"
        self.metrics = {
            "recall": {"direction": 1},
            "sps": {"direction": 1},
            "user_coverage": {"direction": 1},
            "item_coverage": {"direction": 1},
            "ndcg": {"direction": 1},
            "blockbuster_share": {"direction": -1},
        }

    def prepare_model(self, dataset):  # pragma: no cover
        raise NotImplementedError

    def load(self, *args, **kwargs):
        return None

    def top_k_recommendations(self, sequence, k=10, **kwargs):  # pragma: no cover
        raise NotImplementedError


class Pop(Lazy):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.name = "Pop"

    def _get_model_filename(self, *args):
        return "pop"

    def prepare_model(self, dataset):
        self._items_pop = np.zeros(dataset.n_items)
        for triplet in dataset.training_set_triplets():
            self._items_pop[triplet["item_id"]] += 1

    def top_k_recommendations(self, sequence, k=10, exclude=None, **kwargs):
        if exclude is None:
            exclude = []
        items_pop = self._items_pop.copy()
        items_pop[list(exclude)] = -np.inf
        items_pop[[i[0] for i in sequence]] = -np.inf
        return list(np.argpartition(-items_pop, range(k))[:k])


class MarkovModel(Lazy):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.previous_recommendations = {}
        self.name = "MarkovModel"

    def _get_model_filename(self, *args):
        return "MM"

    def prepare_model(self, dataset):
        self.n_items = dataset.n_items
        self.sequences = []
        store = dataset.training_set.store
        for idx in range(len(store)):
            items, _, _ = store.sequence(idx)
            s = {}
            for i in range(len(items) - 1):
                s[int(items[i])] = int(items[i + 1])
            self.sequences.append(s)

    def get_all_recommendations(self, item):
        all_recommendations = collections.Counter(
            s[item] for s in self.sequences if item in s
        )
        del all_recommendations[None]
        self.previous_recommendations[item] = all_recommendations

    def top_k_recommendations(self, sequence, k=10, exclude=None, **kwargs):
        if exclude is None:
            exclude = []
        last_item = int(sequence[-1][0])
        if last_item not in self.previous_recommendations:
            self.get_all_recommendations(last_item)

        all_recommendations = deepcopy(self.previous_recommendations[last_item])
        for s in sequence:
            all_recommendations[int(s[0])] = 0
        for i in exclude:
            all_recommendations[i] = 0

        ranking = np.zeros(self.n_items)
        for i, x in enumerate(all_recommendations.most_common(k)):
            ranking[x[0]] = k - i
        return list(np.argpartition(-ranking, range(k))[:k])


class UserKNN(Lazy):
    def __init__(self, similarity_measure="cosine", neighborhood_size=80, **kwargs):
        super().__init__(**kwargs)
        self.similarity_measure = similarity_measure
        self.neighborhood_size = neighborhood_size
        self.name = "UserKNN"

    def _get_model_filename(self, *args):
        return "UKNN_ns" + str(self.neighborhood_size) + "_" + self.similarity_measure

    def prepare_model(self, dataset):
        filename = os.path.join(dataset.dirname, "data", "train_set_triplets")
        if os.path.isfile(filename + ".npy"):
            file_content = np.load(filename + ".npy")
        else:
            file_content = np.loadtxt(filename)
            np.save(filename, file_content)
        self.binary_user_item = ssp.coo_matrix(
            (
                np.ones(file_content.shape[0]),
                (file_content[:, 0].astype(int), file_content[:, 1].astype(int)),
            )
        ).tocsr()
        self.n_users, self.n_items = self.binary_user_item.shape

    def _items_count_per_user(self):
        if not hasattr(self, "_items_count"):
            self._items_count = np.asarray(
                self.binary_user_item.sum(axis=1)
            ).ravel()
        return self._items_count

    def similarity_with_users(self, sequence):
        sparse_sequence = get_sparse_vector([i[0] for i in sequence], self.n_items)
        overlap = self.binary_user_item.dot(sparse_sequence).toarray().ravel()
        nz = overlap != 0
        overlap[nz] /= np.sqrt(self._items_count_per_user()[nz])
        return overlap

    def top_k_recommendations(self, sequence, k=10, exclude=None, **kwargs):
        if exclude is None:
            exclude = []
        sim_with_users = self.similarity_with_users(sequence)
        nearest_neighbors = top_k(sim_with_users, self.neighborhood_size)
        sim_with_users = get_sparse_vector(
            nearest_neighbors, self.n_users, values=sim_with_users[nearest_neighbors]
        )
        sim_with_items = (
            self.binary_user_item.T.dot(sim_with_users).toarray().ravel()
        )
        sim_with_items[list(exclude)] = -np.inf
        sim_with_items[[i[0] for i in sequence]] = -np.inf
        return list(np.argpartition(-sim_with_items, range(k))[:k])
