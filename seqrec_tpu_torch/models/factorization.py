"""Factorization family: BPR-MF, FPMC, FISM, Fossil.

Counterpart of ``seqrec_tpu/models/factorization.py``. Each SGD chunk
updates a vector of ``samples_per_step`` independent samples at once: it
gathers the touched factor rows, computes the closed-form update from
them, and adds the updates back into the tables (colliding ids within a
chunk accumulate rather than chain, as in the JAX package).

- The tables are tensors on ``self.device``, updated in place under
  ``torch.no_grad()``. Every row scatter (``X.at[ids].add(rows)`` in the
  JAX package) is the gather-sum kernel pair's fixed-order table gradient
  (G1, ``ops/gather_sum.py:gather_sum_table_grad``; ``index_add_`` on the
  CPU), pad slots carrying id -1. The 1-D bias scatters are
  ``index_add_``; the j-update reads the bias after the i-update, as the
  JAX package's sequential ``.at[].add`` does.
- The basket models (FISM, Fossil) run each chunk as 16 sequential
  sub-chunks, each reading the tables the previous one updated.
- Sampling draws on the device by default, ``chunks_per_dispatch`` chunks
  a ``training_step``: uniform negatives by rejection against the user's
  history, Rendle'14's adaptive negatives (exponential rank, factor,
  signed rank-table lookup) with the rank tables refreshed on the device.
  The draws come from a ``torch.Generator`` on the model's device, seeded
  per dispatch from the model's seed: the JAX package's distribution from
  other bits. The host samplers (``device_sampling = False``,
  ``device_adaptive = False``) draw from ``self.rng`` exactly as the JAX
  package does, so one seed gives its samples bit for bit; they are the
  distribution oracles and the step-for-step parity path.
- Costs stay on the device; the training loop reads them once a
  checkpoint.
- Validation and test scoring run on the host in numpy below
  ``DEVICE_TOPK_MIN_ITEMS`` items (one matmul and one ``argpartition``,
  as in the JAX package) and at or above it through K4
  (``ops/score_topk.py:fused_score_topk``): the user representations
  against the output table, the seen items masked, the top k.
- Checkpoints are the JAX package's ``.npz`` files (same keys, same file
  names). ``params_from_numpy`` takes the JAX package's parameters.
- ``set_mesh`` takes a ("data", "model") mesh for evaluation only, as in
  the JAX package (training stays on each rank's own device, the ranks
  drawing the same samples from the same seed): scoring always runs on
  the device, and where the catalog divides the model axis each rank
  scores its rows of a chunk against its columns of the output table
  (``parallel/topk.py:sharded_score_topk``, K4 per shard), and the rows'
  lists are gathered over "data". Only the rank with ``LOCAL_RANK`` 0
  writes checkpoints.
"""

from __future__ import annotations

import os
from time import time

import numpy as np
import torch

from seqrec_tpu_torch import resolve_device
from seqrec_tpu_torch.models.base import RNNBase
from seqrec_tpu_torch.ops.core import masked_top_k
from seqrec_tpu_torch.ops.core import pad_bucket as _bucket
from seqrec_tpu_torch.ops.gather_sum import gather_sum_table_grad
from seqrec_tpu_torch.ops.score_topk import MAX_K, fused_score_topk
from seqrec_tpu_torch.parallel.collectives import all_gather
from seqrec_tpu_torch.parallel.distributed import writes_files
from seqrec_tpu_torch.parallel.mesh import shard_offset
from seqrec_tpu_torch.parallel.topk import sharded_score_topk
from seqrec_tpu_torch.utils import evaluation


def _delta(x_true, x_false):
    """σ(clip(x_false − x_true, ±10)): the BPR step's weight [n, 1]."""
    return torch.sigmoid(torch.clamp(x_false - x_true, -10.0, 10.0))[:, None]


def _scatter_rows(table, ids, rows) -> None:
    """table[ids] += rows in place, duplicates summed: ids [n] (-1: a pad
    slot that adds nothing), rows [n, D]. G1's fixed-order table gradient
    on the card, ``index_add_`` on the CPU."""
    table += gather_sum_table_grad(rows.contiguous(), ids.reshape(-1, 1).contiguous(), None, table.shape[0])


def _bias_updates(bias, i, j, d, reg, lr) -> None:
    """The JAX package's two sequential bias adds: the i-update from the
    bias before the chunk, the j-update from the bias after it."""
    bias.index_add_(0, i, lr * (d - reg * bias[i]))
    bias.index_add_(0, j, lr * (-d - reg * bias[j]))


def _sub_chunked(chunk, params, data, lr, n_sub):
    """``chunk(*params, *data_slice, lr)`` over ``n_sub`` sequential slices of
    the samples (each reading the tables the previous one updated); the
    mean of their costs. The JAX package's ``_scan_subchunks``."""
    n = data[0].shape[0] // n_sub
    costs = [chunk(*params, *(d[s * n : (s + 1) * n] for d in data), lr) for s in range(n_sub)]
    return torch.stack(costs).mean()


class MFBase:
    """Shared train loop, sampling, evaluation and checkpoints of the
    factorization family."""

    samples_per_step = 512
    chunks_per_dispatch = 16
    _NEG_REJECTION_ROUNDS = 8
    # adaptive draws concentrate on high-rank items, which can overlap a
    # user's history far more than the uniform density: more rounds
    _ADAPTIVE_REJECTION_ROUNDS = 16
    # the host paths (False) draw as the JAX package's, bit for bit
    device_sampling = True
    device_adaptive = True
    # at or above this many items, eval scoring and top-k run through K4
    DEVICE_TOPK_MIN_ITEMS = 16384
    # eval rows scored per K4 call: bounds the [chunk, n_items] work
    _DEVICE_TOPK_ROW_CHUNK = 1024
    # the tables, in checkpoint order (the JAX package's .npz keys)
    _PARAMS: tuple = ()

    def __init__(self, reg=0.0025, learning_rate=0.05, annealing=1.0, init_sigma=1, seed=42, device="cuda"):
        self.name = "Base for matrix factorization"
        self.reg = reg
        self.learning_rate = learning_rate
        self.init_learning_rate = learning_rate
        self.annealing_rate = annealing
        self.init_sigma = init_sigma
        self.max_length = np.inf  # the RNN models' attribute, kept as in the JAX package
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.device = resolve_device(device)
        self._dispatches = 0
        self.mesh = None  # eval-only (set_mesh)
        self.metrics = {
            "recall": {"direction": 1},
            "sps": {"direction": 1},
            "user_coverage": {"direction": 1},
            "item_coverage": {"direction": 1},
            "ndcg": {"direction": 1},
            "blockbuster_share": {"direction": -1},
        }

    # ------------------------------------------------------------------
    def prepare_model(self, dataset) -> None:
        self.dataset = dataset
        self.n_items = dataset.n_items
        self.n_users = dataset.n_users

    def change_data_format(self, dataset) -> None:
        """Per-user (offset, length) index, flat item array, the users with
        at least 2 interactions and the user x item CSR, from the training
        store (rows in the store's order, not by user id)."""
        import scipy.sparse as ssp

        store = dataset.training_set.store
        self.users = np.zeros((self.n_users, 2), dtype=np.int64)
        for row in range(len(store)):
            uid = int(store.user_ids[row])
            self.users[uid] = [store.offsets[row], store.offsets[row + 1] - store.offsets[row]]
        self.items = store.items.astype(np.int64)
        self._eligible_users = np.where(self.users[:, 1] >= 2)[0]
        seg_rows = np.repeat(store.user_ids.astype(np.int64), np.diff(store.offsets))
        self._user_item = ssp.coo_matrix(
            (np.ones(len(self.items), dtype=np.int8), (seg_rows, self.items)),
            shape=(self.n_users, self.n_items),
        ).tocsr()

    def _is_member(self, users, items) -> np.ndarray:
        """Vectorized ``item in user's history`` test."""
        return np.asarray(self._user_item[users, items]).ravel() > 0

    def _tensor(self, arr) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _np(self, name: str) -> np.ndarray:
        """Host copy of a table, cached until the table changes. The tables
        are updated in place, so the key is the tensor and its ``_version``
        (bumped by every in-place update), not the tensor alone."""
        cache = self.__dict__.setdefault("_np_cache", {})
        t = getattr(self, name)
        hit = cache.get(name)
        if hit is not None and hit[0] is t and hit[1] == t._version:
            return hit[2]
        val = t.detach().to("cpu", copy=True).numpy()
        cache[name] = (t, t._version, val)
        return val

    def params_from_numpy(self, params) -> None:
        """Set the tables from numpy arrays keyed as the JAX package's
        checkpoints (its parameters, or an ``np.load`` of its ``.npz``).
        The tables are copies: training updates them in place, and must not
        write into the caller's arrays."""
        for name in self._PARAMS:
            setattr(self, name, self._tensor(np.array(params[name], dtype=np.float32, copy=True)))

    def params_to_numpy(self) -> dict:
        return {name: self._np(name).copy() for name in self._PARAMS}

    def _init_tables(self, shapes) -> None:
        """init_sigma * N(0, 1) draws from ``self.rng`` in the JAX package's
        order, rounded to f32, for tuple shapes; an int shape is a zero
        vector (no draw)."""
        for name, shape in shapes:
            if isinstance(shape, tuple):
                arr = (self.init_sigma * self.rng.standard_normal(shape)).astype(np.float32)
            else:
                arr = np.zeros(shape, np.float32)
            setattr(self, name, self._tensor(arr))

    # subclass hooks -----------------------------------------------------
    def init_model(self):  # pragma: no cover
        raise NotImplementedError

    def training_step(self, iterations):  # pragma: no cover
        """One dispatch; returns (mean cost as a device scalar, samples consumed)."""
        raise NotImplementedError

    def top_k_recommendations(self, sequence, user_id=None, k=10, exclude=None):  # pragma: no cover
        raise NotImplementedError

    get_pareto_front = RNNBase.get_pareto_front
    _print_progress = RNNBase._print_progress
    load_last = RNNBase.load_last

    # batched prediction ------------------------------------------------
    @staticmethod
    def _bag_sums(V, seqs):
        """Per-user sums of V rows over each sequence's items, via one flat
        gather + scatter-add. Returns (sums [B,k], lens [B], flat item ids,
        ends [B] exclusive offsets into flat)."""
        lens = np.array([len(s) for s in seqs], dtype=np.int64)
        total = int(lens.sum())
        flat = np.fromiter((int(i[0]) for s in seqs for i in s), dtype=np.int64, count=total)
        rows = np.repeat(np.arange(len(seqs)), lens)
        sums = np.zeros((len(seqs), V.shape[1]), dtype=V.dtype)
        np.add.at(sums, rows, V[flat])
        return sums, lens, flat, np.cumsum(lens)

    def _rep_rows(self, user_ids, seqs):  # pragma: no cover
        """[B, F] user representations (numpy): scores = rep @ W + b with
        (W, b) = ``_device_out_table()``."""
        raise NotImplementedError

    def _device_out_table(self):  # pragma: no cover
        """(W [F, n_items] contiguous, b [n_items]) on the device."""
        raise NotImplementedError

    def _batch_scores(self, user_ids, seqs):  # pragma: no cover
        """[B, n_items] host scores of a batch of (user, input-sequence)."""
        raise NotImplementedError

    def set_mesh(self, mesh) -> None:
        """Accept a ("data", "model") mesh for evaluation
        (``factorization.py:set_mesh``): the output table's columns split
        over "model" and the eval rows over "data"; training stays on the
        rank's device."""
        if mesh is not None and mesh.device != self.device:
            raise ValueError(f"the mesh's device {mesh.device} is not the model's {self.device}")
        self.mesh = mesh

    def _use_device_topk(self) -> bool:
        return self.mesh is not None or self.n_items >= self.DEVICE_TOPK_MIN_ITEMS

    def _device_topk_batch(self, user_ids, seqs, k) -> np.ndarray:
        """K4 over row chunks of ``_DEVICE_TOPK_ROW_CHUNK`` users: the output
        table built once for the pass, each chunk's representations and
        seen ids (S rounded up to a multiple of 16) uploaded. K4 keeps at
        most ``MAX_K`` a row: a longer list (``--save_rank`` ranks the
        whole catalog) sorts the chunk's masked device scores, as the JAX
        package ranks this route with ``masked_top_k`` at any k.

        Under a mesh whose model axis the catalog divides
        (``factorization.py:247-267``), each chunk is padded to a multiple
        of the data axis, this rank scores its rows against its columns of
        the table (``parallel/topk.py:sharded_score_topk``) and the rows'
        lists are gathered over "data": every rank returns the whole list."""
        W, b = self._device_out_table()
        mesh = self.mesh
        if mesh is not None and self.n_items % mesh.shape["model"]:
            mesh = None  # the table stays whole: every rank scores every row
        if mesh is not None:
            col0, n_cols = shard_offset(W.shape[1], mesh)
            W, b = W[:, col0 : col0 + n_cols].contiguous(), b[col0 : col0 + n_cols].contiguous()
        C = self._DEVICE_TOPK_ROW_CHUNK
        out = []
        for c0 in range(0, len(seqs), C):
            chunk = seqs[c0 : c0 + C]
            rep = self._rep_rows(user_ids[c0 : c0 + C], chunk).astype(np.float32)
            B = len(chunk)
            rows = B if mesh is None else -(-B // mesh.shape["data"]) * mesh.shape["data"]
            rep = np.concatenate([rep, np.zeros((rows - B, rep.shape[1]), np.float32)])
            S = max(1, max((len(s) for s in chunk), default=1))
            S = -(-S // 16) * 16
            seen = np.zeros((rows, S), np.int32)
            sm = np.zeros((rows, S), np.float32)
            for r, s in enumerate(chunk):
                seen[r, : len(s)] = [int(i[0]) for i in s]
                sm[r, : len(s)] = 1.0
            with torch.inference_mode():
                if mesh is not None:
                    r0, n = shard_offset(rows, mesh, "data")
                    mine = slice(r0, r0 + n)
                    _, ids = sharded_score_topk(mesh, self._tensor(rep[mine]), W, b, self._tensor(seen[mine]),
                                                self._tensor(sm[mine]), k)
                    ids = all_gather(ids, mesh, "data")
                elif k > MAX_K:
                    ids = masked_top_k(self._tensor(rep) @ W + b, k, self._tensor(seen), self._tensor(sm))
                else:
                    _, ids = fused_score_topk(self._tensor(rep), W, b, self._tensor(seen), self._tensor(sm), k)
            out.append(ids[:B].cpu().numpy().astype(np.int64))
        return np.concatenate(out)

    def top_k_batch(self, instances, k=10):
        """Top-k for ``[(sequence, user_id), ...]``: one whole-matrix scoring
        pass and one argpartition on the host, or K4 at large catalogs (an
        error there raises)."""
        if not instances:
            return []
        user_ids = np.array([int(u) for _, u in instances], dtype=np.int64)
        seqs = [s for s, _ in instances]
        if self._use_device_topk():
            return self._device_topk_batch(user_ids, seqs, k)
        scores = self._batch_scores(user_ids, seqs)
        for row, seq in zip(scores, seqs):
            row[[int(i[0]) for i in seq]] = -np.inf
        return np.argpartition(-scores, range(k), axis=1)[:, :k]

    def _compute_validation_metrics(self, metrics):
        ev = evaluation.Evaluator(self.dataset, k=10)
        instances, goals = [], []
        for sequence, user_id in self.dataset.validation_set(epochs=1):
            half = len(sequence) // 2
            instances.append((sequence[:half], user_id))
            goals.append([i[0] for i in sequence[half:]])
        for top_k, goal in zip(self.top_k_batch(instances), goals):
            ev.add_instance(goal, list(top_k))
        metrics["recall"].append(ev.average_recall())
        metrics["sps"].append(ev.sps())
        metrics["ndcg"].append(ev.average_ndcg())
        metrics["user_coverage"].append(ev.user_coverage())
        metrics["item_coverage"].append(ev.item_coverage())
        metrics["blockbuster_share"].append(ev.blockbuster_share())
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
        self.change_data_format(dataset)
        if len(set(validation_metrics) & set(self.metrics.keys())) < len(validation_metrics):
            raise ValueError(
                "Incorrect validation metrics. Metrics must be chosen among: " + ", ".join(self.metrics.keys())
            )

        iterations = 0
        epochs_offset = 0
        if load_last_model:
            epochs_offset = self.load_last(save_dir)
        if epochs_offset == 0:
            self.init_model()

        start_time = time()
        next_save = int(progress)
        train_costs = []
        cost_sum = None  # a device scalar: one host read per checkpoint
        cost_count = 0
        epochs = []
        metrics = {name: [] for name in self.metrics.keys()}
        filename = {}
        n_interactions = dataset.training_set.n_interactions
        next_anneal = n_interactions

        while time() - start_time < max_time and iterations < max_iter:
            cost, consumed = self.training_step(iterations)
            cost_sum = cost if cost_sum is None else cost_sum + cost
            cost_count += 1
            iterations += consumed

            # lr annealing once per epoch-worth of samples
            while iterations >= next_anneal:
                self.learning_rate *= self.annealing_rate
                next_anneal += n_interactions

            progress_indicator = int(time() - start_time) if time_based_progress else iterations

            if progress_indicator >= next_save:
                if progress_indicator >= min_iterations:
                    epochs.append(epochs_offset + iterations / n_interactions)
                    train_costs.append(float(cost_sum) / max(cost_count, 1))
                    if np.isnan(train_costs[-1]):
                        raise ValueError("Cost is NaN")
                    cost_sum, cost_count = None, 0
                    metrics = self._compute_validation_metrics(metrics)
                    self._print_progress(iterations, epochs[-1], start_time, train_costs, metrics, validation_metrics)

                    run_nb = len(metrics[list(self.metrics.keys())[0]]) - 1
                    if autosave == "All":
                        filename[run_nb] = save_dir + self._get_model_filename(round(epochs[-1], 3))
                        self.save(filename[run_nb])
                    elif autosave == "Best":
                        pareto_runs = self.get_pareto_front(metrics, validation_metrics)
                        if run_nb in pareto_runs:
                            filename[run_nb] = save_dir + self._get_model_filename(round(epochs[-1], 3))
                            self.save(filename[run_nb])
                            for run in [r for r in filename if r not in pareto_runs]:
                                if writes_files():
                                    try:
                                        os.remove(filename[run])
                                    except OSError:
                                        print("Warning : Previous model could not be deleted")
                                del filename[run]

                    if early_stopping is not None and all(
                        early_stopping(epochs, metrics[m]) for m in validation_metrics
                    ):
                        break

                while next_save <= progress_indicator:
                    if isinstance(progress, int):
                        next_save += min(progress, max_progress_interval)
                    else:
                        next_save += min(max_progress_interval, next_save * (progress - 1))

        if not metrics[validation_metrics[0]]:
            return ({m: None for m in self.metrics}, time() - start_time, None)
        best_run = np.argmax(
            np.array(metrics[validation_metrics[0]]) * self.metrics[validation_metrics[0]]["direction"]
        )
        return (
            {m: metrics[m][best_run] for m in self.metrics.keys()},
            time() - start_time,
            filename.get(best_run),
        )

    # checkpoints -------------------------------------------------------
    def save(self, filename: str) -> None:
        print("Save model in " + filename)
        if not writes_files():
            return
        if os.path.dirname(filename) and not os.path.exists(os.path.dirname(filename)):
            os.makedirs(os.path.dirname(filename))
        with open(filename, "wb") as f:
            np.savez(f, **{name: self._np(name) for name in self._PARAMS})

    def load(self, filename: str) -> None:
        with np.load(filename) as f:
            self.params_from_numpy(f)

    # host sampling -----------------------------------------------------
    def _sample_users(self, n: int) -> np.ndarray:
        return self.rng.choice(self._eligible_users, size=n)

    def _uniform_negatives_for_users(self, users: np.ndarray) -> np.ndarray:
        """Uniform negatives not in each user's full history (CSR-backed
        vectorized rejection)."""
        n = len(users)
        out = self.rng.integers(0, self.n_items, size=n)
        for _ in range(30):
            bad = self._is_member(users, out)
            if not bad.any():
                break
            out[bad] = self.rng.integers(0, self.n_items, size=int(bad.sum()))
        return out

    def _adaptive_negatives_vec(self, weights, signs, reject_fn) -> np.ndarray:
        """Rendle'14 adaptive negatives on the host, whole-array: per sample
        a rank ~ Exp(sampling_bias) (redrawn while >= n_items), a factor f ∝
        ``weights`` row, the item at the signed rank of the factor-sorted
        ranking (a negative sign indexes from the other end); rejected
        samples draw again. ``reject_fn(todo_indices, candidates)``."""
        n, F = weights.shape
        cum = np.cumsum(weights, axis=1)
        out = np.empty(n, dtype=np.int64)
        todo = np.arange(n)
        rounds = 0
        while len(todo):
            rounds += 1
            if rounds > 1000:
                raise RuntimeError(f"adaptive sampling rejected 1000 consecutive draws for {len(todo)} samples")
            m = len(todo)
            rank = self.rng.exponential(scale=self.sampling_bias, size=m)
            while True:
                bad = rank >= self.n_items
                nb = int(bad.sum())
                if not nb:
                    break
                rank[bad] = self.rng.exponential(scale=self.sampling_bias, size=nb)
            c = cum[todo]
            rnd = self.rng.random(m) * c[:, -1]
            f = np.minimum((c < rnd[:, None]).sum(axis=1), F - 1)
            idx = rank.astype(np.int64) * signs[todo, f].astype(np.int64)
            cand = self.ranks[idx, f]
            rejected = np.asarray(reject_fn(todo, cand), dtype=bool)
            keep = ~rejected
            out[todo[keep]] = cand[keep]
            todo = todo[rejected]
        return out

    # device sampling ---------------------------------------------------
    def _upload_sample_store(self) -> None:
        """The index tables on the device: eligible users, per-user offsets
        and lengths, the flat items, and every (user, item) of the history
        as one sorted key user * n_items + item (membership tests)."""
        seg_users = np.repeat(np.arange(self.n_users, dtype=np.int64), self.users[:, 1])
        seg_items = np.concatenate(
            [self.items[off : off + ln] for off, ln in self.users if ln > 0] or [np.zeros(0, np.int64)]
        )
        self._dev_store = {
            "eligible": self._tensor(self._eligible_users.astype(np.int64)),
            "offs": self._tensor(self.users[:, 0]),
            "lens": self._tensor(self.users[:, 1]),
            "items": self._tensor(self.items),
            "keys": self._tensor(np.sort(seg_users * self.n_items + seg_items)),
        }
        self._gen = torch.Generator(device=self.device)

    def _dispatch_generator(self) -> torch.Generator:
        """The device generator, seeded for this dispatch from the model's seed."""
        if not hasattr(self, "_dev_store"):
            self._upload_sample_store()
        self._gen.manual_seed((self.seed << 32) + self._dispatches)
        self._dispatches += 1
        return self._gen

    def _rand_below(self, gen, hi) -> torch.Tensor:
        """Uniform integers in [0, hi) per entry of the int64 tensor ``hi``
        (>= 1): floor(u * hi), clamped to hi - 1."""
        u = torch.rand(hi.shape, generator=gen, device=self.device)
        return torch.minimum((u * hi).long(), hi - 1)

    def _device_users(self, gen, n, pool=None) -> torch.Tensor:
        pool = self._dev_store["eligible"] if pool is None else pool
        return pool[torch.randint(0, pool.numel(), (n,), generator=gen, device=self.device)]

    def _device_member(self, cand, u) -> torch.Tensor:
        """``cand in user u's history`` on the device: a lower-bound binary
        search inside user u's sorted segment. The segment is the run of
        keys u * n_items + item in the sorted key array, so the search is
        one ``torch.searchsorted`` over it; the answer is the JAX package's
        ``_device_member``'s."""
        keys = self._dev_store["keys"]
        q = u * self.n_items + cand
        pos = torch.searchsorted(keys, q).clamp_max(keys.numel() - 1)
        return keys[pos] == q

    def _device_negatives(self, gen, u) -> torch.Tensor:
        """Uniform negatives outside each user's history: the first
        non-member of R candidates per sample, or, where all R are members,
        the first non-member of 4 more (the JAX package's redraw). All R + 4
        rounds are drawn and tested at once, so no host sync decides the
        redraw."""
        R, n = self._NEG_REJECTION_ROUNDS, u.numel()
        cands = torch.randint(0, self.n_items, (R + 4, n), generator=gen, device=self.device)
        bad = self._device_member(cands.reshape(-1), u.repeat(R + 4)).reshape(R + 4, n)
        rows = torch.arange(n, device=self.device)
        chosen = cands[bad[:R].to(torch.uint8).argmin(0), rows]
        redraw = cands[R + bad[R:].to(torch.uint8).argmin(0), rows]
        return torch.where(bad[:R].all(0), redraw, chosen)

    def _device_adaptive_draw(self, gen, weights, signs, ranks, reject_fn) -> torch.Tensor:
        """One Rendle'14 negative per row of ``weights`` on the device.

        weights/signs: [n, F] per-sample factor tables (|factors|·var and
        their signs); ranks: [N, F] rank table; reject_fn(cand [R, n]) ->
        bool mask. R rounds drawn at once, the first accepted candidate
        kept; where all R are rejected, the first accepted of 4 uniform
        candidates (the JAX package's fallback, here always computed and
        selected with ``where``). The rank is Exp(sampling_bias)
        conditioned on rank < N by inverse CDF (the host's redraw loop's
        law)."""
        R = self._ADAPTIVE_REJECTION_ROUNDS
        n, F = weights.shape
        N = self.n_items
        lam = float(self.sampling_bias)
        dev = self.device
        if lam <= 0.0:
            rank = torch.zeros((R, n), dtype=torch.int64, device=dev)
        else:
            v = torch.rand((R, n), generator=gen, device=dev)
            fmax = 1.0 - np.exp(-N / lam)
            rank = torch.floor(-lam * torch.log1p(-v * fmax)).long().clamp_max(N - 1)
        cum = torch.cumsum(weights, dim=1)
        rnd = torch.rand((R, n), generator=gen, device=dev) * cum[:, -1]
        f = (cum[None] < rnd[..., None]).sum(-1).clamp_max(F - 1)  # [R, n]
        sgn = torch.gather(signs, 1, f.t()).t()
        idx = torch.where(sgn < 0, (N - rank) % N, rank)
        cand = ranks[idx, f]
        bad = reject_fn(cand)
        rows = torch.arange(n, device=dev)
        chosen = cand[bad.to(torch.uint8).argmin(0), rows]
        ucand = torch.randint(0, N, (4, n), generator=gen, device=dev)
        fallback = ucand[reject_fn(ucand).to(torch.uint8).argmin(0), rows]
        return torch.where(bad.all(0), fallback, chosen)

    def _member_reject(self, u):
        """reject_fn of a history-membership test for users ``u`` [n]."""
        return lambda cand: self._device_member(cand.reshape(-1), u.repeat(cand.shape[0])).reshape(cand.shape)

    def _refresh_schedule(self, iterations) -> bool:
        """Whether the device rank tables are due (every n·ln(n) samples)."""
        if iterations >= getattr(self, "_next_rank_refresh", -1):
            self._next_rank_refresh = iterations + int(self.n_items * np.log(self.n_items))
            return True
        return False

    def _dispatch(self, chunk, per_chunk: int = 1):
        """``chunks_per_dispatch * per_chunk`` sequential calls ``chunk(gen)``
        on one seeded generator; (the mean of their costs as a device
        scalar, the samples of ``chunks_per_dispatch`` chunks)."""
        gen = self._dispatch_generator()
        costs = [chunk(gen) for _ in range(self.chunks_per_dispatch * per_chunk)]
        return torch.stack(costs).mean(), self.samples_per_step * self.chunks_per_dispatch

    # bucketed device sampling for the basket models --------------------
    def _upload_bucket_store(self) -> None:
        """Eligible users grouped by the power-of-two bucket of their history
        length, on the device; a dispatch draws its bucket with probability
        proportional to its population (from ``self.rng``, as the JAX
        package does) and users uniformly within it."""
        if not hasattr(self, "_dev_store"):
            self._upload_sample_store()
        lens = self.users[self._eligible_users, 1].astype(int)
        pads = np.array([_bucket(int(ln)) for ln in lens])
        self._bucket_users = {}
        self._bucket_probs = {}
        total = len(self._eligible_users)
        for P in np.unique(pads):
            sel = self._eligible_users[pads == P].astype(np.int64)
            self._bucket_users[int(P)] = self._tensor(sel)
            self._bucket_probs[int(P)] = len(sel) / total

    def _draw_bucket(self) -> int:
        keys = sorted(self._bucket_probs)
        probs = np.array([self._bucket_probs[k] for k in keys])
        return int(self.rng.choice(keys, p=probs))

    def _dispatch_bucket(self) -> int:
        """A dispatch's bucket (the stores uploaded at the first)."""
        if not hasattr(self, "_bucket_users"):
            self._upload_bucket_store()
        return self._draw_bucket()

    def _device_baskets(self, gen, users_b, n, P):
        """n users of one bucket and their whole histories as [n, P]
        baskets: (u, offs, lens, items at slots j < len, valid)."""
        st = self._dev_store
        u = self._device_users(gen, n, users_b)
        offs, lens = st["offs"][u], st["lens"][u]
        j = torch.arange(P, device=self.device)[None, :]
        valid = j < lens[:, None]
        basket = st["items"][torch.where(valid, offs[:, None] + j, 0)]
        return u, offs, lens, basket, valid


# ======================================================================
class BPRMF(MFBase):
    """BPR-MF (Rendle'09) with optional adaptive sampling (Rendle'14)."""

    _PARAMS = ("V", "H", "bias")

    def __init__(self, k=32, adaptive_sampling=True, sampling_bias=500, **kwargs):
        super().__init__(**kwargs)
        self.name = "BPRMF"
        self.k = k
        self.adaptive_sampling = adaptive_sampling
        self.sampling_bias = sampling_bias

    def _get_model_filename(self, epochs):
        filename = (
            "bprmf_ne" + str(epochs) + "_lr" + str(self.init_learning_rate)
            + "_an" + str(self.annealing_rate) + "_k" + str(self.k)
            + "_reg" + str(self.reg) + "_ini" + str(self.init_sigma)
        )
        if self.adaptive_sampling:
            filename += "_as" + str(self.sampling_bias)
        return filename + ".npz"

    def init_model(self):
        self._init_tables((("V", (self.n_users, self.k)), ("H", (self.n_items, self.k)), ("bias", self.n_items)))

    @staticmethod
    @torch.no_grad()
    def _sgd_chunk(reg, V, H, bias, u, i, j, lr):
        """One chunk on V, H, bias in place; returns the mean delta."""
        Vu, Hi, Hj = V[u], H[i], H[j]
        x_true = bias[i] + (Vu * Hi).sum(-1)
        x_false = bias[j] + (Vu * Hj).sum(-1)
        delta = _delta(x_true, x_false)
        _scatter_rows(V, u, lr * (delta * (Hi - Hj) - reg * Vu))
        _scatter_rows(
            H, torch.cat([i, j]), torch.cat([lr * (delta * Vu - reg * Hi), lr * (-delta * Vu - reg / 10 * Hj)])
        )
        d = delta[:, 0]
        _bias_updates(bias, i, j, d, reg, lr)
        return d.mean()

    def compute_factor_rankings(self):
        H = self._np("H")
        self.ranks = np.argsort(H, axis=0)
        self.var = np.var(H, axis=0)

    def _adaptive_negatives(self, users):
        Vu = self._np("V")[users]
        return self._adaptive_negatives_vec(
            np.abs(Vu) * self.var, np.sign(Vu), lambda todo, cand: self._is_member(users[todo], cand)
        )

    def _sample_chunk(self, n):
        users = self._sample_users(n)
        offs, lens = self.users[users, 0], self.users[users, 1]
        true_items = self.items[offs + self.rng.integers(0, lens)]
        if self.adaptive_sampling:
            false_items = self._adaptive_negatives(users)
        else:
            false_items = self._uniform_negatives_for_users(users)
        return users, true_items, false_items

    def _device_sample(self, gen):
        st = self._dev_store
        u = self._device_users(gen, self.samples_per_step)
        i = st["items"][st["offs"][u] + self._rand_below(gen, st["lens"][u])]
        return u, i

    def _device_rank_refresh(self):
        """Rank tables on the device: a stable argsort and the population
        variance of each column of the live H."""
        self._dev_ranks = torch.argsort(self.H, dim=0, stable=True)
        self._dev_var = torch.var(self.H, dim=0, correction=0)

    def training_step(self, iterations):
        n = self.samples_per_step
        lr = float(np.float32(self.learning_rate))
        if self.adaptive_sampling and self.device_adaptive:
            if self._refresh_schedule(iterations):
                self._device_rank_refresh()

            def chunk(gen):
                u, i = self._device_sample(gen)
                Vu = self.V[u]  # live user factors; only the rank table is stale between refreshes
                j = self._device_adaptive_draw(
                    gen, Vu.abs() * self._dev_var, torch.sign(Vu), self._dev_ranks, self._member_reject(u)
                )
                return self._sgd_chunk(self.reg, self.V, self.H, self.bias, u, i, j, lr)

            return self._dispatch(chunk)
        if not self.adaptive_sampling and self.device_sampling:

            def chunk(gen):
                u, i = self._device_sample(gen)
                return self._sgd_chunk(self.reg, self.V, self.H, self.bias, u, i, self._device_negatives(gen, u), lr)

            return self._dispatch(chunk)
        if self.adaptive_sampling and (
            iterations % int(self.n_items * np.log(self.n_items)) < n or not hasattr(self, "ranks")
        ):
            self.compute_factor_rankings()
        u, i, j = map(self._tensor, self._sample_chunk(n))
        return self._sgd_chunk(self.reg, self.V, self.H, self.bias, u, i, j, lr), n

    # ------------------------------------------------------------------
    def _rep_rows(self, user_ids, seqs):
        return self._np("V")[user_ids]

    def _device_out_table(self):
        return self.H.t().contiguous(), self.bias

    def _batch_scores(self, user_ids, seqs):
        return self._np("bias") + self._rep_rows(user_ids, seqs) @ self._np("H").T

    def top_k_recommendations(self, sequence, user_id=None, k=10, exclude=None):
        if exclude is None:
            exclude = []
        V, H, bias = self._np("V"), self._np("H"), self._np("bias")
        output = bias + V[user_id] @ H.T
        output[[i[0] for i in sequence]] = -np.inf
        output[list(exclude)] = -np.inf
        return list(np.argpartition(-output, range(k))[:k])


# ======================================================================
class FPMC(MFBase):
    """Factorized Personalized Markov Chains (Rendle'10)."""

    _PARAMS = ("V_user_item", "V_item_user", "V_prev_next", "V_next_prev")

    def __init__(self, k_cf=32, k_mc=32, adaptive_sampling=True, sampling_bias=500, **kwargs):
        super().__init__(**kwargs)
        self.name = "FPMC"
        self.k_cf = k_cf
        self.k_mc = k_mc
        self.adaptive_sampling = adaptive_sampling
        self.sampling_bias = sampling_bias

    def _get_model_filename(self, epochs):
        filename = (
            "fpmc_ne" + str(epochs) + "_lr" + str(self.init_learning_rate)
            + "_an" + str(self.annealing_rate) + "_kcf" + str(self.k_cf)
            + "_kmc" + str(self.k_mc) + "_reg" + str(self.reg)
            + "_ini" + str(self.init_sigma)
        )
        if self.adaptive_sampling:
            filename += "_as" + str(self.sampling_bias)
        return filename + ".npz"

    def init_model(self):
        self._init_tables((
            ("V_user_item", (self.n_users, self.k_cf)),
            ("V_item_user", (self.n_items, self.k_cf)),
            ("V_prev_next", (self.n_items, self.k_mc)),
            ("V_next_prev", (self.n_items, self.k_mc)),
        ))

    @staticmethod
    @torch.no_grad()
    def _sgd_chunk(reg, VUI, VIU, VPN, VNP, u, p, i, j, lr):
        VUIu, VIUi, VIUj = VUI[u], VIU[i], VIU[j]
        VPNp, VNPi, VNPj = VPN[p], VNP[i], VNP[j]
        x_true = (VUIu * VIUi).sum(-1) + (VPNp * VNPi).sum(-1)
        x_false = (VUIu * VIUj).sum(-1) + (VPNp * VNPj).sum(-1)
        delta = _delta(x_true, x_false)
        _scatter_rows(VUI, u, lr * (delta * (VIUi - VIUj) - reg * VUIu))
        _scatter_rows(VPN, p, lr * (delta * (VNPi - VNPj) - reg * VPNp))
        # VIU and VNP share their ids [i; j]: one scatter of the joined rows
        ij_rows = torch.cat([
            torch.cat([lr * (delta * VUIu - reg * VIUi), lr * (delta * VPNp - reg * VNPi)], 1),
            torch.cat([lr * (-delta * VUIu - reg * VIUj), lr * (-delta * VPNp - reg * VNPj)], 1),
        ])
        grad = gather_sum_table_grad(ij_rows, torch.cat([i, j])[:, None], None, VIU.shape[0])
        VIU += grad[:, : VIU.shape[1]]
        VNP += grad[:, VIU.shape[1] :]
        return delta[:, 0].mean()

    def compute_factor_rankings(self):
        VIU, VNP = self._np("V_item_user"), self._np("V_next_prev")
        self.ranks = np.concatenate((np.argsort(VIU, axis=0), np.argsort(VNP, axis=0)), axis=1)
        self.var = np.concatenate((np.var(VIU, axis=0), np.var(VNP, axis=0)))

    def _sample_chunk(self, n):
        users = self._sample_users(n)
        offs, lens = self.users[users, 0], self.users[users, 1]
        r = self.rng.integers(0, lens - 1)
        prevs = self.items[offs + r]
        trues = self.items[offs + r + 1]
        if self.adaptive_sampling:
            concat = np.concatenate((self._np("V_user_item")[users], self._np("V_prev_next")[prevs]), axis=1)
            falses = self._adaptive_negatives_vec(
                np.abs(concat) * self.var, np.sign(concat), lambda todo, cand: cand == trues[todo]
            )
        else:
            falses = self.rng.integers(0, self.n_items - 1, size=n)
            falses[falses >= trues] += 1  # false != true
        return users, prevs, trues, falses

    def _device_sample(self, gen):
        st = self._dev_store
        u = self._device_users(gen, self.samples_per_step)
        offs, lens = st["offs"][u], st["lens"][u]
        r = self._rand_below(gen, lens - 1)
        return u, st["items"][offs + r], st["items"][offs + r + 1]

    def _device_rank_refresh(self):
        """Stable argsorts and population variances of VIU's and VNP's
        columns, joined as the host's ``compute_factor_rankings``."""
        A, B = self.V_item_user, self.V_next_prev
        self._dev_ranks = torch.cat([torch.argsort(A, dim=0, stable=True), torch.argsort(B, dim=0, stable=True)], 1)
        self._dev_var = torch.cat([torch.var(A, dim=0, correction=0), torch.var(B, dim=0, correction=0)])

    def _tables(self):
        return self.V_user_item, self.V_item_user, self.V_prev_next, self.V_next_prev

    def training_step(self, iterations):
        n = self.samples_per_step
        lr = float(np.float32(self.learning_rate))
        if self.adaptive_sampling and self.device_adaptive:
            if self._refresh_schedule(iterations):
                self._device_rank_refresh()

            def chunk(gen):
                u, p, i = self._device_sample(gen)
                concat = torch.cat([self.V_user_item[u], self.V_prev_next[p]], 1)
                j = self._device_adaptive_draw(
                    gen, concat.abs() * self._dev_var, torch.sign(concat), self._dev_ranks,
                    lambda cand: cand == i[None, :],
                )
                return self._sgd_chunk(self.reg, *self._tables(), u, p, i, j, lr)

            return self._dispatch(chunk)
        if not self.adaptive_sampling and self.device_sampling:

            def chunk(gen):
                u, p, i = self._device_sample(gen)
                j = torch.randint(0, self.n_items - 1, (n,), generator=gen, device=self.device)
                j = torch.where(j >= i, j + 1, j)
                return self._sgd_chunk(self.reg, *self._tables(), u, p, i, j, lr)

            return self._dispatch(chunk)
        if self.adaptive_sampling and (
            iterations % int(self.n_items * np.log(self.n_items)) < n or not hasattr(self, "ranks")
        ):
            self.compute_factor_rankings()
        u, p, i, j = map(self._tensor, self._sample_chunk(n))
        return self._sgd_chunk(self.reg, *self._tables(), u, p, i, j, lr), n

    def _rep_rows(self, user_ids, seqs):
        lasts = np.array([int(s[-1][0]) for s in seqs], dtype=np.int64)
        return np.concatenate((self._np("V_user_item")[user_ids], self._np("V_prev_next")[lasts]), axis=1)

    def _device_out_table(self):
        # [VIU ‖ VNP]^T: scores = [VUI[u] ‖ VPN[last]] @ it; FPMC has no bias
        W = torch.cat([self.V_item_user, self.V_next_prev], 1).t().contiguous()
        return W, torch.zeros(self.n_items, dtype=torch.float32, device=self.device)

    def _batch_scores(self, user_ids, seqs):
        lasts = np.array([int(s[-1][0]) for s in seqs], dtype=np.int64)
        return (
            self._np("V_user_item")[user_ids] @ self._np("V_item_user").T
            + self._np("V_prev_next")[lasts] @ self._np("V_next_prev").T
        )

    def top_k_recommendations(self, sequence, user_id=None, k=10, exclude=None):
        if exclude is None:
            exclude = []
        last_item = sequence[-1][0]
        VUI, VIU = self._np("V_user_item"), self._np("V_item_user")
        VPN, VNP = self._np("V_prev_next"), self._np("V_next_prev")
        output = VUI[user_id] @ VIU.T + VPN[last_item] @ VNP.T
        output[[i[0] for i in sequence]] = -np.inf
        output[list(exclude)] = -np.inf
        return list(np.argpartition(-output, range(k))[:k])


# ======================================================================
class FISM(MFBase):
    """Factored Item Similarity Model (Kabbur'13).

    Baskets are padded per chunk to a power-of-two bucket; pad slots carry
    id -1 and mask 0 (the JAX package's carry id n_items, which its scatter
    drops as out of bounds)."""

    _PARAMS = ("V", "H", "bias")
    # basket scatters collide heavily: each chunk runs as this many
    # sequential sub-chunks
    sub_chunks = 16

    def __init__(self, k=100, alpha=0.5, loss="auc", **kwargs):
        super().__init__(**kwargs)
        self.name = "FISM"
        self.k = k
        self.loss = loss
        if loss not in ("RMSE", "BPR"):
            raise ValueError("Unknown loss for FISM: " + str(loss))
        self.alpha = alpha

    def _get_model_filename(self, epochs):
        return (
            "fism_" + self.loss + "_ne" + str(epochs)
            + "_lr" + str(self.init_learning_rate) + "_an" + str(self.annealing_rate)
            + "_k" + str(self.k) + "_reg" + str(self.reg)
            + "_ini" + str(self.init_sigma) + ".npz"
        )

    def init_model(self):
        self._init_tables((("V", (self.n_items, self.k)), ("H", (self.n_items, self.k)), ("bias", self.n_items)))

    @staticmethod
    def _bag(V, basket, bmask, alpha):
        """(scale [n, 1], masked basket rows [n, P, k], their sum [n, k])."""
        scale = bmask.sum(-1).clamp_min(1.0).pow(-alpha)[:, None]
        Vrows = V[basket.clamp_min(0)] * bmask[..., None]
        return scale, Vrows, Vrows.sum(1)

    @staticmethod
    @torch.no_grad()
    def _auc_chunk(reg, alpha, V, H, bias, basket, bmask, i, j, lr):
        """basket excludes the true item (leave-one-out)."""
        scale, Vrows, Vsum = FISM._bag(V, basket, bmask, alpha)
        Hi, Hj = H[i], H[j]
        x_true = bias[i] + (scale * Vsum * Hi).sum(-1)
        x_false = bias[j] + (scale * Vsum * Hj).sum(-1)
        delta = _delta(x_true, x_false)
        V_up = lr * ((delta * scale)[:, None, :] * (Hi - Hj)[:, None, :] - reg * Vrows) * bmask[..., None]
        _scatter_rows(V, basket.reshape(-1), V_up.reshape(-1, V_up.shape[-1]))
        _scatter_rows(
            H, torch.cat([i, j]),
            torch.cat([lr * (delta * scale * Vsum - reg * Hi), lr * (-delta * scale * Vsum - reg * Hj)]),
        )
        d = delta[:, 0]
        _bias_updates(bias, i, j, d, reg, lr)
        return d.mean()

    @staticmethod
    @torch.no_grad()
    def _rmse_chunk(reg, alpha, V, H, bias, basket, bmask, item, rating, lr):
        scale, Vrows, Vsum = FISM._bag(V, basket, bmask, alpha)
        Hi = H[item]
        pred = bias[item] + (scale * Vsum * Hi).sum(-1)
        delta = (rating - pred)[:, None]
        V_up = lr * ((delta * scale)[:, None, :] * Hi[:, None, :] - reg * Vrows) * bmask[..., None]
        _scatter_rows(V, basket.reshape(-1), V_up.reshape(-1, V_up.shape[-1]))
        _scatter_rows(H, item, lr * (delta * scale * Vsum - reg * Hi))
        bias.index_add_(0, item, lr * (delta[:, 0] - reg * bias[item]))
        return delta[:, 0].abs().mean()

    def _chunk(self):
        return self._auc_chunk if self.loss == "BPR" else self._rmse_chunk

    # ------------------------------------------------------------------
    def _sample_baskets(self, n):
        """Host baskets (the JAX package's draws, pad slots -1)."""
        users = self._sample_users(n)
        offs, lens = self.users[users, 0], self.users[users, 1]
        trues = self.items[offs + self.rng.integers(0, lens)]
        pad = _bucket(int(lens.max()))
        j = np.arange(pad, dtype=np.int64)[None, :]
        valid = j < lens[:, None]
        basket = self.items[np.where(valid, offs[:, None] + j, 0)]
        # leave-one-out by value
        bmask = (valid & (basket != trues[:, None])).astype(np.float32)
        basket = np.where(bmask > 0, basket, -1)
        falses = self._uniform_negatives_for_users(users)
        return basket, bmask, trues, falses

    def _device_sub_chunk(self, gen, lr, P):
        """One (sample + SGD) sub-chunk of ``samples_per_step // sub_chunks``
        users of the length bucket P."""
        n = max(1, self.samples_per_step // self.sub_chunks)
        u, offs, lens, basket, valid = self._device_baskets(gen, self._bucket_users[P], n, P)
        trues = self._dev_store["items"][offs + self._rand_below(gen, lens)]
        bmask = (valid & (basket != trues[:, None])).float()
        basket = torch.where(bmask > 0, basket, -1)
        falses = self._device_negatives(gen, u)
        if self.loss == "BPR":
            data = (trues, falses)
        else:
            pos = torch.rand(n, generator=gen, device=self.device) < 0.25
            data = (torch.where(pos, trues, falses), pos.float())
        return self._chunk()(self.reg, self.alpha, self.V, self.H, self.bias, basket, bmask, *data, lr)

    def training_step(self, iterations):
        lr = float(np.float32(self.learning_rate))
        if self.device_sampling:
            P = self._dispatch_bucket()
            return self._dispatch(lambda gen: self._device_sub_chunk(gen, lr, P), self.sub_chunks)
        n = self.samples_per_step
        basket, bmask, trues, falses = self._sample_baskets(n)
        if self.loss == "BPR":
            data = (basket, bmask, trues, falses)
        else:
            # 1:3 positive:negative mix
            pos = self.rng.random(n) < 0.25
            data = (basket, bmask, np.where(pos, trues, falses), pos.astype(np.float32))
        chunk = self._chunk()
        cost = _sub_chunked(
            lambda *a: chunk(self.reg, self.alpha, *a), (self.V, self.H, self.bias),
            tuple(map(self._tensor, data)), lr, self.sub_chunks,
        )
        return cost, n

    def item_score(self, user_items):
        V, H, bias = self._np("V"), self._np("H"), self._np("bias")
        if not user_items:  # empty bag: 0^-alpha guard, score = bias
            return bias.copy()
        return bias + np.power(len(user_items), -self.alpha) * (V[user_items].sum(axis=0) @ H.T)

    def _rep_rows(self, user_ids, seqs):
        V = self._np("V")
        sums, lens, _, _ = self._bag_sums(V, seqs)
        # empty bags score as plain bias: clamp 0^-alpha
        w = np.power(np.maximum(lens, 1).astype(np.float64), -self.alpha).astype(V.dtype)
        return sums * w[:, None]

    def _device_out_table(self):
        return self.H.t().contiguous(), self.bias

    def _batch_scores(self, user_ids, seqs):
        return self._np("bias") + self._rep_rows(user_ids, seqs) @ self._np("H").T

    def top_k_recommendations(self, sequence, user_id=None, k=10, exclude=None):
        if exclude is None:
            exclude = []
        user_items = [i[0] for i in sequence]
        output = self.item_score(user_items)
        output[user_items] = -np.inf
        output[list(exclude)] = -np.inf
        return list(np.argpartition(-output, range(k))[:k])


# ======================================================================
class Fossil(MFBase):
    """FISM + factorized higher-order Markov chains (He & McAuley'16)."""

    _PARAMS = ("V", "H", "bias", "eta", "eta_bias")
    sub_chunks = 16  # see FISM.sub_chunks

    def __init__(self, k=32, order=1, alpha=0.2, **kwargs):
        super().__init__(**kwargs)
        self.name = "Fossil"
        self.k = k
        self.order = order
        self.alpha = alpha

    def _get_model_filename(self, epochs):
        return (
            "fossil_ne" + str(epochs) + "_lr" + str(self.init_learning_rate)
            + "_an" + str(self.annealing_rate) + "_k" + str(self.k)
            + "_o" + str(self.order) + "_reg" + str(self.reg)
            + "_ini" + str(self.init_sigma) + ".npz"
        )

    def init_model(self):
        self._init_tables((
            ("V", (self.n_items, self.k)),
            ("H", (self.n_items, self.k)),
            ("eta", (self.n_users, self.order)),
            ("eta_bias", self.order),
            ("bias", self.n_items),
        ))

    @staticmethod
    @torch.no_grad()
    def _sgd_chunk(reg, alpha, order, V, H, bias, eta, eta_bias, basket, bmask, recent, rmask, u, i, j, lr):
        """basket: prefix items before the target; recent: the last
        ``order`` of them, most recent first (pad slots -1, mask 0)."""
        scale, Vrows, Vsum = FISM._bag(V, basket, bmask, alpha)
        long_term = scale * Vsum
        w = (eta_bias + eta[u]) * rmask  # [n, order]
        Vrecent = V[recent.clamp_min(0)] * rmask[..., None]
        short_term = (w[..., None] * Vrecent).sum(1)
        rep = long_term + short_term
        Hi, Hj = H[i], H[j]
        x_true = bias[i] + (rep * Hi).sum(-1)
        x_false = bias[j] + (rep * Hj).sum(-1)
        delta = _delta(x_true, x_false)
        dH = Hi - Hj

        V_up = lr * ((delta * scale)[:, None, :] * dH[:, None, :] - reg * Vrows) * bmask[..., None]
        V_up2 = lr * delta[:, None, :] * (w[..., None] * dH[:, None, :]) * rmask[..., None]
        k = V.shape[1]
        _scatter_rows(
            V, torch.cat([basket.reshape(-1), recent.reshape(-1)]), torch.cat([V_up.reshape(-1, k), V_up2.reshape(-1, k)])
        )
        _scatter_rows(H, torch.cat([i, j]), torch.cat([lr * (delta * rep - reg * Hi), lr * (-delta * rep - reg * Hj)]))
        d = delta[:, 0]
        _bias_updates(bias, i, j, d, reg, lr)

        grad_eta = (Vrecent * dH[:, None, :]).sum(-1)  # [n, order]
        # eta_bias is global: the per-position mean of the samples' steps
        n_eff = rmask.sum(0).clamp_min(1.0)
        eta_rows = lr * (delta * grad_eta - reg * eta[u] * rmask)
        eta_bias += lr * ((delta * grad_eta).sum(0) / n_eff - reg * eta_bias)
        _scatter_rows(eta, u, eta_rows)
        return d.mean()

    # ------------------------------------------------------------------
    def _sample_chunk(self, n):
        """Host prefixes and recent items (the JAX package's draws, pad
        slots -1); negatives reject against the user's full history."""
        users = self._sample_users(n)
        offs, lens = self.users[users, 0], self.users[users, 1]
        t = self.rng.integers(1, lens)  # prefix length; target = item t
        trues = self.items[offs + t]
        pad = _bucket(int(t.max()))
        j = np.arange(pad, dtype=np.int64)[None, :]
        valid = j < t[:, None]
        basket = np.where(valid, self.items[np.where(valid, offs[:, None] + j, 0)], -1)
        bmask = valid.astype(np.float32)
        k = np.arange(self.order, dtype=np.int64)[None, :]
        rvalid = k < t[:, None]
        ridx = np.where(rvalid, offs[:, None] + t[:, None] - 1 - k, 0)
        recent = np.where(rvalid, self.items[ridx], -1)
        rmask = rvalid.astype(np.float32)
        falses = self._uniform_negatives_for_users(users)
        return users, basket, bmask, recent, rmask, trues, falses

    def _tables(self):
        return self.V, self.H, self.bias, self.eta, self.eta_bias

    def _device_sub_chunk(self, gen, lr, P):
        """FISM's sub-chunk with prefix baskets (a random cut t in [1, len)),
        the last ``order`` prefix items most recent first, and negatives by
        rejection."""
        n = max(1, self.samples_per_step // self.sub_chunks)
        items = self._dev_store["items"]
        u, offs, lens, basket, _ = self._device_baskets(gen, self._bucket_users[P], n, P)
        t = 1 + self._rand_below(gen, lens - 1)
        trues = items[offs + t]
        valid = torch.arange(P, device=self.device)[None, :] < t[:, None]
        basket = torch.where(valid, basket, -1)
        kk = torch.arange(self.order, device=self.device)[None, :]
        rvalid = kk < t[:, None]
        recent = torch.where(rvalid, items[torch.where(rvalid, offs[:, None] + t[:, None] - 1 - kk, 0)], -1)
        falses = self._device_negatives(gen, u)
        return self._sgd_chunk(
            self.reg, self.alpha, self.order, *self._tables(),
            basket, valid.float(), recent, rvalid.float(), u, trues, falses, lr,
        )

    def training_step(self, iterations):
        lr = float(np.float32(self.learning_rate))
        if self.device_sampling:
            P = self._dispatch_bucket()
            return self._dispatch(lambda gen: self._device_sub_chunk(gen, lr, P), self.sub_chunks)
        n = self.samples_per_step
        users, basket, bmask, recent, rmask, trues, falses = self._sample_chunk(n)
        cost = _sub_chunked(
            lambda *a: self._sgd_chunk(self.reg, self.alpha, self.order, *a), self._tables(),
            tuple(map(self._tensor, (basket, bmask, recent, rmask, users, trues, falses))), lr, self.sub_chunks,
        )
        return cost, n

    def item_score(self, user_id, user_items):
        V, H, bias = self._np("V"), self._np("H"), self._np("bias")
        eta, eta_bias = self._np("eta"), self._np("eta_bias")
        # empty-bag guard: 0^-alpha = inf * zero-sum = NaN
        long_term = np.power(max(len(user_items), 1), -self.alpha) * V[user_items].sum(axis=0)
        effective_order = min(self.order, len(user_items))
        if user_id is None:
            w = (eta_bias + eta.mean(axis=0))[:effective_order]
        else:
            w = (eta_bias + eta[user_id])[:effective_order]
        short_term = w @ V[user_items[: -effective_order - 1 : -1]]
        return bias + (long_term + short_term) @ H.T

    def _rep_rows(self, user_ids, seqs):
        V = self._np("V")
        eta, eta_bias = self._np("eta"), self._np("eta_bias")
        sums, lens, flat, ends = self._bag_sums(V, seqs)
        long_term = sums * np.power(np.maximum(lens, 1).astype(np.float64), -self.alpha).astype(V.dtype)[:, None]
        # the last min(order, len) items, most recent first, weighted by the
        # per-user short-term decay
        j = np.arange(self.order, dtype=np.int64)[None, :]
        rvalid = j < np.minimum(self.order, lens)[:, None]
        recent = flat[np.where(rvalid, ends[:, None] - 1 - j, 0)]
        w = (eta_bias[None, :] + eta[user_ids]) * rvalid
        short = np.einsum("bj,bjk->bk", w, V[recent])
        return long_term + short

    def _device_out_table(self):
        return self.H.t().contiguous(), self.bias

    def _batch_scores(self, user_ids, seqs):
        return self._np("bias") + self._rep_rows(user_ids, seqs) @ self._np("H").T

    def top_k_recommendations(self, sequence, user_id=None, k=10, exclude=None):
        if exclude is None:
            exclude = []
        user_items = [i[0] for i in sequence]
        output = self.item_score(user_id, user_items)
        output[user_items] = -np.inf
        output[list(exclude)] = -np.inf
        return list(np.argpartition(-output, range(k))[:k])
