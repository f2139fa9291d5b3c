"""Top-N recommendation metrics.

Metric semantics follow the reference evaluator exactly
(the reference's helpers/evaluation.py:16-216), including its quirks:

- ``item_coverage`` is a *count* of distinct correctly-predicted items,
  not a ratio (evaluation.py:187-188).
- ``blockbuster_share`` is computed over the multiset of correct
  predictions (each instance contributes the set of its own correct
  items) against the top-1% most popular items (evaluation.py:81-91).
- ``sps`` only looks at ``goal[0]`` (evaluation.py:143-150).
- ``ndcg`` caps the ideal DCG at ``len(goal)`` terms (evaluation.py:126-141).
- every metric divides by the total number of instances even when an
  instance was skipped by a guard (e.g. empty goal in recall).

The accumulation API (``add_instance(goal, predictions)``) is kept so the
test/validation CLIs stay model-agnostic, but the metric math is
vectorized where it matters (blockbuster top-1% set, popularity loads).
"""

from __future__ import annotations

import os.path

import numpy as np
import scipy.sparse as ssp


class Evaluator:
    """Accumulates (goal, predictions) instances and computes metrics @k.

    Parameters
    ----------
    dataset:
        An object exposing ``n_items``, ``item_popularity`` and
        ``dirname`` (the latter only needed for the intra-list
        similarity / novelty extras). ``seqrec_tpu_torch.data.DataHandler``
        satisfies this; tests use small stand-ins.
    k:
        Cut-off for all @k metrics.
    """

    def __init__(self, dataset, k: int = 10):
        self.instances: list[list] = []
        self.dataset = dataset
        self.k = int(k)
        self.metrics = {
            "sps": self.sps,
            "recall": self.average_recall,
            "precision": self.average_precision,
            "ndcg": self.average_ndcg,
            "item_coverage": self.item_coverage,
            "user_coverage": self.user_coverage,
            "assr": self.assr,
            "blockbuster_share": self.blockbuster_share,
        }

    # ------------------------------------------------------------------
    # accumulation
    # ------------------------------------------------------------------
    def add_instance(self, goal, predictions) -> None:
        self.instances.append([list(goal), list(predictions)])

    def _topk(self, prediction):
        return prediction[: min(len(prediction), self.k)]

    # ------------------------------------------------------------------
    # core metrics (reference parity)
    # ------------------------------------------------------------------
    def short_term_prediction_success(self) -> float:
        score = 0
        for goal, prediction in self.instances:
            score += int(goal[0] in self._topk(prediction))
        return score / len(self.instances)

    def sps(self) -> float:
        return self.short_term_prediction_success()

    def average_recall(self) -> float:
        recall = 0.0
        for goal, prediction in self.instances:
            if len(goal) > 0:
                recall += len(set(goal) & set(self._topk(prediction))) / len(goal)
        return recall / len(self.instances)

    def average_precision(self) -> float:
        precision = 0.0
        for goal, prediction in self.instances:
            if len(prediction) > 0:
                cut = min(len(prediction), self.k)
                precision += len(set(goal) & set(prediction[:cut])) / cut
        return precision / len(self.instances)

    def average_ndcg(self) -> float:
        ndcg = 0.0
        for goal, prediction in self.instances:
            if len(prediction) > 0:
                goal_set = set(goal)
                dcg = 0.0
                max_dcg = 0.0
                for i, p in enumerate(self._topk(prediction)):
                    if i < len(goal):
                        max_dcg += 1.0 / np.log2(2 + i)
                    if p in goal_set:
                        dcg += 1.0 / np.log2(2 + i)
                ndcg += dcg / max_dcg
        return ndcg / len(self.instances)

    def user_coverage(self) -> float:
        score = 0
        for goal, prediction in self.instances:
            score += int(len(set(goal) & set(self._topk(prediction))) > 0)
        return score / len(self.instances)

    def item_coverage(self) -> int:
        return len(set(self.get_correct_predictions()))

    def blockbuster_share(self) -> float:
        correct_predictions = self.get_correct_predictions()
        nb_pop_items = self.dataset.n_items // 100
        pop = np.asarray(self.dataset.item_popularity)
        pop_items = set(np.argpartition(-pop, nb_pop_items)[:nb_pop_items].tolist())
        if len(correct_predictions) == 0:
            return 0
        return len([i for i in correct_predictions if i in pop_items]) / len(
            correct_predictions
        )

    def assr(self) -> float:
        """Average search-space reduction: n_items / mean dot products.

        ``nb_of_dp`` is set by the cluster-model test CLI; without it,
        clustering is not in use and the default reduction is 1
        (evaluation.py:208-216).
        """
        if getattr(self, "nb_of_dp", 0) > 0:
            return self.dataset.n_items / self.nb_of_dp
        return 1

    # ------------------------------------------------------------------
    # helper collections (reference parity)
    # ------------------------------------------------------------------
    def get_all_goals(self):
        return [g for goal, _ in self.instances for g in goal]

    def get_strict_goals(self):
        return [goal[0] for goal, _ in self.instances]

    def get_all_predictions(self):
        return [p for _, prediction in self.instances for p in self._topk(prediction)]

    def get_correct_predictions(self):
        correct = []
        for goal, prediction in self.instances:
            correct.extend(set(goal) & set(self._topk(prediction)))
        return correct

    def get_correct_strict_predictions(self):
        correct = []
        for goal, prediction in self.instances:
            correct.extend({goal[0]} & set(self._topk(prediction)))
        return correct

    def get_rank_comparison(self):
        """(position in goals, position in recommendations) tuples.

        Mirrors evaluation.py:198-206; requires full-length prediction
        lists (``--save_rank`` path).
        """
        all_positions = []
        for goal, prediction in self.instances:
            position_in_predictions = np.argsort(prediction)[goal]
            all_positions.extend(list(enumerate(position_in_predictions)))
        return all_positions

    # ------------------------------------------------------------------
    # Auralist extras (evaluation.py:54-104)
    # ------------------------------------------------------------------
    def _load_interaction_matrix(self) -> None:
        filename = os.path.join(self.dataset.dirname, "data", "train_set_triplets")
        if os.path.isfile(filename + ".npy"):
            file_content = np.load(filename + ".npy")
        else:
            file_content = np.loadtxt(filename)
            np.save(filename, file_content)
        self._interactions = ssp.coo_matrix(
            (
                np.ones(file_content.shape[0]),
                (file_content[:, 1].astype(int), file_content[:, 0].astype(int)),
            )
        ).tocsr()

    def _intra_list_similarity(self, items) -> float:
        if not hasattr(self, "_interactions"):
            self._load_interaction_matrix()
        norm = np.sqrt(np.asarray(self._interactions[items, :].sum(axis=1)).ravel())
        sims = (
            self._interactions[items, :].dot(self._interactions[items, :].T).toarray()
        )
        total = 0.0
        for i in range(len(items)):
            for j in range(i):
                total += sims[i, j] / norm[i] / norm[j]
        return total

    def average_intra_list_similarity(self) -> float:
        ils = 0.0
        for _, prediction in self.instances:
            if len(prediction) > 0:
                ils += self._intra_list_similarity(self._topk(prediction))
        return ils / len(self.instances)

    def average_novelty(self) -> float:
        pop = np.asarray(self.dataset.item_popularity, dtype=np.float64)
        nb_of_ratings = pop.sum()
        novelty = 0.0
        for _, prediction in self.instances:
            if len(prediction) > 0:
                topk = np.asarray(self._topk(prediction))
                novelty += np.sum(np.log2(pop[topk] / nb_of_ratings)) / len(topk)
        return -novelty / len(self.instances)


class DistributionCharacteristics:
    """Popularity-distribution characteristics of a list of item ids.

    Functional rebuild of the reference's vestigial helper
    (the reference's helpers/evaluation.py:218-248), whose plotting calls
    are commented out and whose popularity-category path depends on the
    MovieLens-specific ``OTHER_FEATURES`` table (``None`` in the
    reference). Here the same quantities are *returned* instead of
    plotted; the category breakdown takes popularity counts directly.
    """

    def __init__(self, items):
        import collections

        self.items = collections.Counter(int(i) for i in items)

    def frequency_distribution(self) -> dict:
        """Map frequency -> number of distinct items with that frequency
        (the log-log scatter the reference meant to plot)."""
        import collections

        return dict(collections.Counter(self.items.values()))

    def popularity_distribution(self, item_popularity, n_bins: int = 10):
        """Occurrence counts bucketed into ``n_bins`` popularity deciles
        of ``item_popularity`` (the reference's bar plot, with popularity
        categories derived from counts instead of the absent
        ``OTHER_FEATURES[:, 3]`` table)."""
        pop = np.asarray(item_popularity, dtype=np.float64)
        order = np.argsort(np.argsort(pop))  # rank of each item
        bins = np.minimum((order * n_bins) // max(len(pop), 1), n_bins - 1)
        bars = np.zeros(n_bins)
        for item, count in self.items.items():
            bars[int(bins[item])] += count
        return bars

    def number_of_items(self) -> int:
        return len(self.items)
