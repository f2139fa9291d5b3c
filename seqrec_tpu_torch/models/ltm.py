"""Latent Trajectory Modeling over item-sequence word2vec embeddings.

Counterpart of ``seqrec_tpu/models/ltm.py`` (``LTM``):

- CBOW with negative sampling (gensim's defaults: the context mean,
  5 negatives, reduced windows, unigram^0.75 noise, linear lr decay), one
  ``train()`` iteration being one epoch over the training sequences;
- the user's trajectory: the EWMA of consecutive item-embedding deltas
  with damping ``alpha``; the prediction is the cosine-nearest items to
  it, or to the mean of the last ``window // 2`` embeddings with
  ``use_trajectory=False``.

Every draw is the model's ``np.random.default_rng(seed)``, in the JAX
package's order: the initial ``syn0``; per epoch a permutation and the
reduced windows, then one array of noise draws per step. So one seed
gives the JAX package's initial tables, contexts and negatives bit for
bit. Padded context slots carry id -1 (the JAX package's carry 0; the
mask is 0 either way), so the gather-sum kernels skip them.

A CBOW step runs on ``self.device``: the context mean is the gather-sum
forward (G1, ``ops/gather_sum.py``), the targets' rows an
``index_select``, and both table updates are G1's table gradient
(``gather_sum_table_grad``: at F = 1 over the targets for ``syn1neg``, over
the contexts for ``syn0``), fixed-order sums without atomics; on the CPU
the same functions run their plain versions. Both updates come from the
old tables, as the JAX package's ``.at[].add`` does; the step losses stay
on the device until the epoch ends. The query features are computed on
the host as in the JAX package; the scores, the seen-item mask and the
top k are one call of K4 (``ops/score_topk.py:fused_score_topk``) against
the row-normalized ``syn0`` (``--save_rank``'s whole-catalog ranking, past
K4's k <= 64: one product and a masked sort). Checkpoints are the JAX package's ``.npz``
(``syn0``, ``syn1neg``) under the same file names.
"""

from __future__ import annotations

import os
from time import time

import numpy as np
import torch

from seqrec_tpu_torch import resolve_device
from seqrec_tpu_torch.models.base import RNNBase
from seqrec_tpu_torch.ops.gather_sum import gather_sum, gather_sum_table_grad
from seqrec_tpu_torch.ops.core import masked_top_k
from seqrec_tpu_torch.ops.score_topk import MAX_K, fused_score_topk
from seqrec_tpu_torch.utils import evaluation


class LTM:
    def __init__(
        self,
        use_trajectory: bool = True,
        alpha: float = 0.8,
        k: int = 32,
        window: int = 5,
        learning_rate: float = 0.025,
        negative: int = 5,
        min_alpha: float = 0.0001,
        seed: int = 42,
        batch_positions: int = 2048,
        device="cuda",
    ):
        self.use_trajectory = use_trajectory
        self.alpha = alpha
        self.k = k
        self.window = window
        self.learning_rate = learning_rate
        self.negative = negative
        self.min_alpha = min_alpha
        self.rng = np.random.default_rng(seed)
        self.batch_positions = batch_positions
        self.device = resolve_device(device)

        self.name = "Latent Trajectory Modeling"
        self.metrics = {
            "recall": {"direction": 1},
            "sps": {"direction": 1},
            "user_coverage": {"direction": 1},
            "item_coverage": {"direction": 1},
            "ndcg": {"direction": 1},
            "blockbuster_share": {"direction": -1},
        }

    def _get_model_filename(self, epochs) -> str:
        filename = (
            "ltm_ne" + str(epochs) + "_lr" + str(self.learning_rate)
            + "_k" + str(self.k) + "_w" + str(self.window)
        )
        if self.use_trajectory:
            filename += "_ut" + str(self.alpha)
        return filename + ".npz"

    def prepare_model(self, dataset) -> None:
        self.dataset = dataset
        self.n_items = dataset.n_items

    def set_dataset(self, dataset) -> None:
        self.dataset = dataset

    def _tensor(self, arr) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    # ------------------------------------------------------------------
    # CBOW training
    # ------------------------------------------------------------------
    def _init_w2v(self) -> None:
        n, k = self.n_items, self.k
        # gensim's init U(-0.5/k, 0.5/k), drawn in f64 and rounded to f32
        self.syn0 = self._tensor(((self.rng.random((n, k)) - 0.5) / k).astype(np.float32))
        self.syn1neg = torch.zeros((n, k), dtype=torch.float32, device=self.device)

    def _init_training_aux(self) -> None:
        pop = np.maximum(1, np.asarray(self.dataset.item_popularity))
        noise = np.power(pop, 0.75)
        self._noise_cdf = np.cumsum(noise / noise.sum())

    @torch.no_grad()
    def _cbow_step(self, ctx, ctx_mask, center, negs, row_mask, lr: float) -> torch.Tensor:
        """One CBOW / negative-sampling step (gensim-equivalent) on the
        tables in place; returns the step's loss as a device scalar.

        ctx: [N, C] context ids (-1: a pad slot, mask 0), center: [N],
        negs: [N, S] noise ids, row_mask: [N] (0 = a padding row of the
        last slice; its updates and loss are zeroed)."""
        n, k = self.syn0.shape
        counts = ctx_mask.sum(-1, keepdim=True).clamp_min(1.0)
        h = gather_sum(self.syn0, ctx, ctx_mask) / counts  # cbow_mean=1

        # positive + negatives share the update form: g = (label - σ(h·v)) * lr
        targets = torch.cat([center[:, None], negs], dim=1)  # [N, 1+S]
        labels = torch.zeros(targets.shape, dtype=torch.float32, device=self.device)
        labels[:, 0] = 1.0
        v = self.syn1neg.index_select(0, targets.reshape(-1)).view(*targets.shape, k)  # [N, 1+S, k]
        f = torch.sigmoid(torch.bmm(v, h.unsqueeze(-1)).squeeze(-1))
        g = (labels - f) * lr * row_mask[:, None]  # [N, 1+S]

        # hidden-layer error propagated back to all context words
        neu1e = torch.bmm(g.unsqueeze(1), v).squeeze(1)  # [N, k]
        self.syn1neg += gather_sum_table_grad((g.unsqueeze(-1) * h.unsqueeze(1)).reshape(-1, k),
                                              targets.reshape(-1, 1), None, n)
        self.syn0 += gather_sum_table_grad(neu1e / counts, ctx, ctx_mask, n)
        nll = -torch.log(torch.where(labels > 0, f, 1 - f).clamp(1e-7, 1.0))
        denom = (row_mask.sum() * nll.shape[1]).clamp_min(1.0)
        return (nll * row_mask[:, None]).sum() / denom

    def _epoch_positions(self):
        """All (context, center) positions of one epoch in ONE numpy pass:
        the JAX package's draws (a permutation of the sequences, then one
        ``rng.integers`` array of reduced windows b ~ U{1..window}) and its
        arrays, with -1 in the pad slots of ``ctx``.

        Yields fixed-size [batch_positions] slices; the final slice is
        padded with ``row_mask`` marking real rows."""
        store = self.dataset.training_set.store
        order = self.rng.permutation(len(store))
        lens = store.lengths[order].astype(np.int64)
        offs = store.offsets[order].astype(np.int64)
        total = int(lens.sum())
        pos_off = np.repeat(offs, lens)  # flat-store offset of each position's sequence
        pos_len = np.repeat(lens, lens)
        starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
        t = np.arange(total, dtype=np.int64) - np.repeat(starts, lens)

        b = self.rng.integers(1, self.window + 1, size=total)
        lo = np.maximum(0, t - b)
        hi = np.minimum(pos_len, t + b + 1)
        C = 2 * self.window
        j = np.arange(C, dtype=np.int64)[None, :]
        p = lo[:, None] + j
        p = p + (p >= t[:, None])  # skip the center position
        valid = p < hi[:, None]
        ctx = np.where(
            valid, store.items[np.where(valid, pos_off[:, None] + p, 0)], -1
        ).astype(np.int32)
        mask = valid.astype(np.float32)
        center = store.items[pos_off + t].astype(np.int32)
        keep = valid.any(axis=1)  # drop empty-context positions (length-1 seqs)
        ctx, mask, center = ctx[keep], mask[keep], center[keep]

        N = self.batch_positions
        n_total = len(center)
        for c0 in range(0, n_total, N):
            m = min(N, n_total - c0)
            if m < N:
                pad = N - m
                yield (
                    np.concatenate([ctx[c0:], np.full((pad, C), -1, np.int32)]),
                    np.concatenate([mask[c0:], np.zeros((pad, C), np.float32)]),
                    np.concatenate([center[c0:], np.zeros(pad, np.int32)]),
                    np.concatenate(
                        [np.ones(m, np.float32), np.zeros(pad, np.float32)]
                    ),
                )
            else:
                yield (
                    ctx[c0 : c0 + N],
                    mask[c0 : c0 + N],
                    center[c0 : c0 + N],
                    np.ones(N, np.float32),
                )

    def _train_one_epoch(self, lr: float) -> float:
        """One epoch of CBOW steps; the mean of the step losses, read from
        the device once, at the end."""
        lr = float(np.float32(lr))
        losses = []
        for ctx, ctx_mask, center, row_mask in self._epoch_positions():
            u = self.rng.random((len(center), self.negative))
            negs = np.searchsorted(self._noise_cdf, u, side="right").astype(np.int32)
            losses.append(self._cbow_step(*map(self._tensor, (ctx, ctx_mask, center, negs, row_mask)), lr))
        if not losses:
            return 0.0
        return float(np.mean(torch.stack(losses).cpu().numpy().astype(np.float64)))

    # ------------------------------------------------------------------
    # prediction
    # ------------------------------------------------------------------
    def _query_features(self, sequence, syn0) -> np.ndarray:
        if self.use_trajectory:
            ids = np.fromiter((int(i[0]) for i in sequence), dtype=np.int64)
            if len(ids) < 2:
                return np.zeros(self.k, dtype=syn0.dtype)
            # EWMA of consecutive deltas, closed form: (1-α)·Σ α^(n-1-i)·d_i
            d = syn0[ids[1:]] - syn0[ids[:-1]]
            wts = (1 - self.alpha) * np.power(
                self.alpha, np.arange(len(d) - 1, -1, -1, dtype=np.float64)
            ).astype(syn0.dtype)
            return wts @ d
        return np.mean(
            [syn0[int(sequence[-i - 1][0])] for i in range(self.window // 2)],
            axis=0,
        )

    def _top_k(self, sequences, k, excluded) -> np.ndarray:
        """[B, k] item ids: K4 over the query features and the row-normalized
        table (zero norms become 1), each row's ``excluded`` ids masked. A
        list longer than K4's ``MAX_K`` (``--save_rank`` ranks the whole
        catalog) sorts the masked scores of one product instead."""
        syn0 = self.syn0.cpu().numpy()
        feats = np.stack([self._query_features(s, syn0) for s in sequences])
        norms = np.linalg.norm(syn0, axis=1)
        norms[norms == 0] = 1.0
        w = (syn0 / norms[:, None]).T
        S = max(1, max(len(ids) for ids in excluded))
        seen_ids = np.zeros((len(excluded), S), np.int32)
        seen_mask = np.zeros((len(excluded), S), np.float32)
        for row, ids in enumerate(excluded):
            seen_ids[row, : len(ids)] = ids
            seen_mask[row, : len(ids)] = 1.0
        if k > MAX_K:
            with torch.inference_mode():
                scores = self._tensor(feats) @ self._tensor(w)
                top = masked_top_k(scores, k, self._tensor(seen_ids), self._tensor(seen_mask))
            return top.cpu().numpy().astype(np.int64)
        bias = torch.zeros(self.n_items, dtype=torch.float32, device=self.device)
        _, top = fused_score_topk(
            self._tensor(feats), self._tensor(w), bias, self._tensor(seen_ids), self._tensor(seen_mask), k
        )
        return top.cpu().numpy().astype(np.int64)

    def top_k_recommendations(self, sequence, user_id=None, k=10, exclude=None):
        excluded = [int(i[0]) for i in sequence] + [int(i) for i in (exclude or [])]
        return self._top_k([sequence], k, [excluded])[0].tolist()

    def top_k_batch(self, instances, k=10):
        """Batched prediction: one K4 call for ALL queried users."""
        if not instances:
            return []
        seqs = [s for s, _ in instances]
        return self._top_k(seqs, k, [[int(i[0]) for i in s] for s in seqs])

    # ------------------------------------------------------------------
    # training loop: one iteration = one epoch
    # ------------------------------------------------------------------
    get_pareto_front = RNNBase.get_pareto_front
    load_last = RNNBase.load_last
    _print_progress = RNNBase._print_progress

    def _compute_validation_metrics(self, metrics):
        ev = evaluation.Evaluator(self.dataset, k=10)
        instances, goals = [], []
        for sequence, user_id in self.dataset.validation_set(epochs=1):
            half = len(sequence) // 2
            instances.append((sequence[:half], user_id))
            goals.append([i[0] for i in sequence[half:]])
        for top_k, goal in zip(self.top_k_batch(instances), goals):
            ev.add_instance(goal, list(top_k))
        for m, fn in (
            ("recall", ev.average_recall),
            ("sps", ev.sps),
            ("ndcg", ev.average_ndcg),
            ("user_coverage", ev.user_coverage),
            ("item_coverage", ev.item_coverage),
            ("blockbuster_share", ev.blockbuster_share),
        ):
            metrics[m].append(fn())
        return metrics

    def train(
        self,
        dataset,
        max_time=np.inf,
        progress=2.0,
        time_based_progress=False,
        autosave="All",
        save_dir="",
        min_iterations=0,
        max_iter=np.inf,
        max_progress_interval=np.inf,
        load_last_model=False,
        early_stopping=None,
        validation_metrics=("sps",),
    ):
        validation_metrics = list(validation_metrics)
        self.set_dataset(dataset)
        if len(set(validation_metrics) & set(self.metrics.keys())) < len(
            validation_metrics
        ):
            raise ValueError(
                "Incorrect validation metrics. Metrics must be chosen among: "
                + ", ".join(self.metrics.keys())
            )

        iterations = 0
        epochs_offset = 0
        if load_last_model:
            epochs_offset = self.load_last(save_dir)
        if not hasattr(self, "syn0"):
            self._init_w2v()
        if not hasattr(self, "_noise_cdf"):
            self._init_training_aux()

        start_time = time()
        next_save = int(progress)
        epochs = []
        train_costs = []
        metrics = {name: [] for name in self.metrics.keys()}
        filename = {}

        while time() - start_time < max_time and iterations < max_iter:
            # linear lr decay across the run (gensim-style, bounded below)
            frac = iterations / max(max_iter, 1) if np.isfinite(max_iter) else 0.0
            lr = max(self.min_alpha, self.learning_rate * (1 - frac))
            cost = self._train_one_epoch(lr)
            train_costs.append(cost)
            iterations += 1

            if time_based_progress:
                progress_indicator = int(time() - start_time)
            else:
                progress_indicator = iterations

            if progress_indicator >= next_save:
                if progress_indicator >= min_iterations:
                    epochs.append(epochs_offset + iterations)
                    metrics = self._compute_validation_metrics(metrics)
                    self._print_progress(
                        iterations, epochs[-1], start_time, train_costs,
                        metrics, validation_metrics,
                    )

                    run_nb = len(metrics[list(self.metrics.keys())[0]]) - 1
                    if autosave == "All":
                        filename[run_nb] = save_dir + self._get_model_filename(
                            round(epochs[-1], 3)
                        )
                        self.save(filename[run_nb])
                    elif autosave == "Best":
                        pareto_runs = self.get_pareto_front(metrics, validation_metrics)
                        if run_nb in pareto_runs:
                            filename[run_nb] = save_dir + self._get_model_filename(
                                round(epochs[-1], 3)
                            )
                            self.save(filename[run_nb])
                            to_delete = [r for r in filename if r not in pareto_runs]
                            for run in to_delete:
                                try:
                                    os.remove(filename[run])
                                except OSError:
                                    print("Warning : Previous model could not be deleted")
                                del filename[run]

                    if early_stopping is not None:
                        if all(
                            early_stopping(epochs, metrics[m])
                            for m in validation_metrics
                        ):
                            break

                if isinstance(progress, int):
                    next_save += min(progress, max_progress_interval)
                else:
                    next_save += min(max_progress_interval, next_save * (progress - 1))

        if not metrics[validation_metrics[0]]:
            return ({m: None for m in self.metrics}, time() - start_time, None)
        best_run = np.argmax(
            np.array(metrics[validation_metrics[0]])
            * self.metrics[validation_metrics[0]]["direction"]
        )
        return (
            {m: metrics[m][best_run] for m in self.metrics.keys()},
            time() - start_time,
            filename.get(best_run),
        )

    # ------------------------------------------------------------------
    def save(self, filename: str) -> None:
        print("Save model in " + filename)
        if os.path.dirname(filename) and not os.path.exists(os.path.dirname(filename)):
            os.makedirs(os.path.dirname(filename))
        with open(filename, "wb") as f:
            np.savez(f, syn0=self.syn0.cpu().numpy(), syn1neg=self.syn1neg.cpu().numpy())

    def load(self, filename: str) -> None:
        with np.load(filename) as f:
            self.syn0 = self._tensor(f["syn0"])
            self.syn1neg = self._tensor(f["syn1neg"])
