"""Clustered-softmax models: RNNCluster and FISMCluster.

Counterpart of ``seqrec_tpu/models/cluster.py``. Two objectives share one
optimizer step:

1. item scoring: sampled (Blackout-style) scores over the batch's targets
   and the shared negative samples, ``h W_out[:, cols] + b_out[cols]``
   with the columns gathered by ``index_select``;
2. cluster assignment: a user-side selection head (a scaled softmax over
   ``h W_cs``, with optional gaussian exploration noise) against the
   item-side ``cluster_repartition``, whose membership nonlinearity
   depends on ``cluster_type`` (softmax, sigmoid, or mix: softmax +
   sigmoid).

The gradient partition is the reference's two-optimizer scheme: the
cluster objective sees ``h.detach()``, so the recommendation loss alone
moves the tower, ``W_out`` and ``b_out``, and the cluster loss alone moves
``W_cs`` and ``cluster_repartition``. The temperature ``scale`` grows
geometrically at every epoch boundary up to ``max_scale`` and is batch
data, as in the JAX package.

Every numpy draw (the samples, the cluster samples) comes from the model's
generator at the same points and in the same order as the JAX package, so
one seed gives the same batches. The selection noise (``--csn``) is drawn
on the model's device from a ``torch.Generator`` seeded with the batch's
``noise_seed``: the JAX package's distribution and seeding schedule, drawn
from other bits.

The RNN tower trains through the port's kernels (K1 or K5 and the
gather-sum pair) and validates through the eval scan (K3 or K6); the
validation ranks on the device with a stable sort (value descending, id
ascending, as ``lax.top_k``). At test time ``prepare_tests`` hardens the
memberships into per-cluster item lists, and prediction scores only the
argmax cluster's items on the host, returning ``(recommendations,
cluster_size)`` for the ASSR metric.

FISMCluster replaces the tower with FISM's user representation: the
mask-weighted bag of input item embeddings scaled by ``1/len^alpha``, a
plain gather (``index_select``) and einsum as in the JAX package, which
runs it through XLA (no kernel); L2 or L1 regularization on its network parameters, and the
whole history as input (``max_length`` infinite, targets shuffled).

Under a mesh (the JAX package's layout: ``W_out`` and ``b_out`` by
columns, ``cluster_repartition`` and ``item_embeddings`` by rows, ``W_cs``
replicated) each data rank scores its rows against the global batch's
targets (gathered over "data") and the samples: the item columns come
from their shards (``parallel/columns.py:gather_columns``), the
membership rows through G1 on each shard (``gather_rows``), FISM's bag
through the sharded gather-sum with ``mask / len^alpha`` as the slot
weights, and the regularization's sums over the sharded tables are
summed over "model". The selection noise is drawn in the global batch's
shape, each rank keeping its rows, so a mesh run draws the one-device
run's bits. The validation splits each chunk's rows over "data", takes
the softmax over the sharded columns with its max and sum over "model",
merges each shard's two top-10 lists (``parallel/topk.py``) and gathers
the rows back; the host reads of the sharded tables (the validation's
cluster sizes, ``prepare_tests``, the unclustered test scores) gather
them over "model" first, a collective every rank reaches in the same
order.
"""

from __future__ import annotations

import sys
from time import time

import numpy as np
import torch
from torch import nn

from seqrec_tpu_torch.models.base import RNNBase
from seqrec_tpu_torch.models.rnn_one_hot import OneHotNetwork
from seqrec_tpu_torch.ops import losses
from seqrec_tpu_torch.ops.core import pad_bucket, top_k_sorted
from seqrec_tpu_torch.ops.gather_sum import sharded_gather_sum
from seqrec_tpu_torch.parallel import mesh as mesh_lib
from seqrec_tpu_torch.parallel.collectives import all_gather, all_reduce, reduce_from_model
from seqrec_tpu_torch.parallel.columns import gather_rows
from seqrec_tpu_torch.parallel.topk import local_seen, sharded_top_k
from seqrec_tpu_torch.utils import evaluation


def _param(shape, device):
    return nn.Parameter(torch.empty(shape, device=device))


class RNNClusterNetwork(OneHotNetwork):
    """Recurrent tower, item head and cluster parameters; state-dict keys
    ``tower.*``, ``W_out``, ``b_out``, ``W_cs``, ``cluster_repartition``."""

    def __init__(self, tower, true_input_size: int, n_items: int, n_clusters: int, device):
        super().__init__(tower, true_input_size, n_items, device)
        self.W_cs = _param((tower.output_size, n_clusters), device)
        self.cluster_repartition = _param((n_items, n_clusters), device)

    def representation(self, ids, mask, id_mask=None, train=False):
        return self.tower(ids, mask, id_mask, train=train)


class FISMClusterNetwork(nn.Module):
    """FISM's item embeddings, the item head and the cluster parameters."""

    def __init__(self, n_items: int, n_hidden: int, n_clusters: int, alpha: float, device):
        super().__init__()
        self.n_items, self.alpha = n_items, alpha
        self.item_embeddings = _param((n_items, n_hidden), device)
        self.W_out = _param((n_hidden, n_items), device)
        self.b_out = _param((n_items,), device)
        self.W_cs = _param((n_hidden, n_clusters), device)
        self.cluster_repartition = _param((n_items, n_clusters), device)
        # (mesh, first row) when item_embeddings holds one shard of its rows
        self.input_shard = None

    def representation(self, ids, mask, id_mask=None, train=False):
        """Bag of items [B, H]: ids [B, P] under mask [B, P], weighted by
        1/len^alpha; ids are clamped into the table as in the JAX package.
        The rows are gathered by ``index_select``, whose backward is
        ``index_add_``: an indexing gather's backward
        (``indexing_backward_kernel``) serializes the pad slots, which all
        name item 0. With the table's rows sharded, the bag is the sharded
        gather-sum (G1 on the shard) of one [P]-slot row a user, the
        weights as its slot mask."""
        counts = mask.sum(-1, keepdim=True).clamp_min(1.0)
        weights = mask / torch.pow(counts, self.alpha)
        if self.input_shard is not None:
            ids = ids.clamp_max(self.n_items - 1)[:, None, :]
            return sharded_gather_sum(self.item_embeddings, ids, weights[:, None, :], *self.input_shard)[:, 0]
        flat = ids.long().clamp_max(self.n_items - 1).reshape(-1)
        rows = self.item_embeddings.index_select(0, flat).view(*ids.shape, -1)
        return torch.einsum("bl,blk->bk", weights, rows)


class RNNCluster(RNNBase):
    _DEVICE_ID_KEYS = RNNBase._DEVICE_ID_KEYS + ("cluster_samples",)
    _HOST_KEYS = ("noise_seed",)

    def __init__(
        self,
        n_clusters: int = 10,
        loss: str = "Blackout",
        cluster_type: str = "mix",
        sampling=100,
        cluster_sampling=-1,
        sampling_bias: float = 0.0,
        predict_with_clusters: bool = True,
        cluster_selection_noise: float = 0.0,
        init_scale: float = 1.0,
        scale_growing_rate: float = 1.0,
        max_scale: float = 50,
        **kwargs,
    ):
        super().__init__(**kwargs)
        self.n_clusters = n_clusters
        self.init_scale = float(init_scale)
        self.effective_scale = float(init_scale)
        self.scale_growing_rate = float(scale_growing_rate)
        self.max_scale = float(max_scale)
        self.cluster_type = cluster_type
        self.sampling_bias = sampling_bias
        self.loss = loss
        self.cluster_selection_noise = cluster_selection_noise
        self.predict_with_clusters = predict_with_clusters
        if loss not in losses.CLUSTER_LOSSES:
            raise ValueError("Unknown cluster loss")
        self.n_samples = int(sampling)
        self.n_cluster_samples = int(cluster_sampling)
        self._noise_seed = 0

        self.name = "RNN Cluster with categorical cross entropy"
        self.metrics = {
            "recall": {"direction": 1},
            "cluster_recall": {"direction": 1},
            "sps": {"direction": 1},
            "cluster_sps": {"direction": 1},
            "ignored_items": {"direction": -1},
            "assr": {"direction": 1},
            "cluster_use": {"direction": 1},
            "cluster_use_std": {"direction": -1},
            "cluster_size": {"direction": 1},
        }

    # ------------------------------------------------------------------
    def _filename_clusters(self) -> str:
        """The sample, cluster-type, noise part of the filename."""
        filename = ""
        if self.sampling_bias > 0.0:
            filename += "p" + str(self.sampling_bias)
        filename += "s" + str(self.n_samples)
        if self.n_cluster_samples > 0:
            filename += "_"
            if self.sampling_bias > 0.0:
                filename += "p" + str(self.sampling_bias)
            filename += "cs" + str(self.n_cluster_samples)
        if self.cluster_type == "softmax":
            filename += "_softmax"
        elif self.cluster_type == "mix":
            filename += "_mix"
        if self.cluster_selection_noise > 0.0:
            filename += "_n" + str(self.cluster_selection_noise)
        return filename

    def _filename_scale(self, prefix: str) -> str:
        filename = prefix + str(self.n_clusters) + "_sc" + str(self.init_scale)
        if self.scale_growing_rate != 1.0:
            filename += "-" + str(self.scale_growing_rate) + "-" + str(self.max_scale)
        return filename

    def _get_model_filename(self, epochs) -> str:
        filename = self._filename_scale("rnn_clusters") + "_" + self._filename_clusters()
        return filename + "_c" + self.loss + "_" + self._common_filename(epochs)

    # ------------------------------------------------------------------
    def _prepare_networks(self, n_items: int) -> None:
        self.n_items = n_items
        self.net = RNNClusterNetwork(self.recurrent_layer, self._input_size(), n_items, self.n_clusters, self.device)

    def _init_params(self) -> dict:
        rng = self.rng
        tower = self.recurrent_layer.init_params(rng, self._input_size())
        h_out = self.recurrent_layer.output_size
        limit = np.sqrt(6.0 / (h_out + self.n_items))
        limit_cs = np.sqrt(6.0 / (h_out + self.n_clusters))
        return {
            "tower": tower,
            "W_out": rng.uniform(-limit, limit, size=(h_out, self.n_items)).astype(np.float32),
            "b_out": np.zeros(self.n_items, dtype=np.float32),
            "W_cs": rng.uniform(-limit_cs, limit_cs, size=(h_out, self.n_clusters)).astype(np.float32),
            "cluster_repartition": (0.1 * rng.standard_normal((self.n_items, self.n_clusters))).astype(np.float32),
        }

    # ------------------------------------------------------------------
    def _membership(self, logits, scale):
        """Soft cluster membership by cluster_type."""
        if self.cluster_type == "softmax":
            return torch.softmax(scale * logits, dim=-1)
        if self.cluster_type == "mix":
            return torch.softmax(scale * logits, dim=-1) + torch.sigmoid(scale * logits)
        return torch.sigmoid(scale * logits)

    def _hard_clusters(self, repartition):
        """The memberships hardened at temperature 100."""
        if self.cluster_type == "softmax":
            return torch.softmax(100.0 * repartition, dim=-1)
        if self.cluster_type == "mix":
            return torch.clip(torch.softmax(100.0 * repartition, dim=-1) + torch.sigmoid(100.0 * repartition), 0, 1)
        return torch.sigmoid(100.0 * repartition)

    @staticmethod
    def _selection_noise(seed: int, like: torch.Tensor, rows: int | None = None, row0: int = 0) -> torch.Tensor:
        """Standard normal noise shaped as ``like``, from a generator on its
        device seeded with the step's ``noise_seed``: rows ``row0 ...`` of
        a draw of ``rows`` rows (the global batch's, under a mesh)."""
        gen = torch.Generator(device=like.device)
        gen.manual_seed(seed)
        shape = (like.shape[0] if rows is None else rows, *like.shape[1:])
        noise = torch.randn(shape, generator=gen, device=like.device, dtype=like.dtype)
        return noise[row0 : row0 + like.shape[0]]

    def _cluster_rows(self, ids):
        """``cluster_repartition[ids]`` of the full table: ``index_select``,
        or G1 on each shard of a row-sharded table."""
        row0 = self._shard_start("cluster_repartition")
        if row0 is None:
            return self.net.cluster_repartition.index_select(0, ids)
        return gather_rows(self.net.cluster_repartition, ids, self.mesh, row0)

    def _full_param(self, key: str) -> np.ndarray:
        """A parameter as a host array, gathered over "model" when it is
        sharded (a collective)."""
        t = self.net.get_parameter(key).detach()
        if self._shard_start(key) is not None:
            t = mesh_lib.gather_params({key: t}, self._param_specs, self.mesh)[key]
        return t.cpu().numpy()

    def _loss(self, batch):
        cost, cost_clusters = self._objectives(batch)
        return cost + cost_clusters

    def _objectives(self, batch):
        """(the recommendation cost with its regularization, the cluster
        cost) of a device batch."""
        net = self.net
        h = net.representation(batch["ids"], batch["mask"], batch.get("id_mask"), train=True)
        # the global batch's targets: each row scores against all B of them
        targets, offset = self._batch_targets(batch["targets"])
        B = targets.shape[0]
        loss_fn = losses.CLUSTER_LOSSES[self.loss]
        scale = batch["scale"]

        # objective 1: item scoring on targets + samples
        w_cols, b_cols = self._head_columns(torch.cat([targets, batch["samples"]]))
        cost = loss_fn(h @ w_cols + b_cols, B, offset).mean() + self._regularization()

        # objective 2: cluster assignment (the tower frozen by detach)
        sel_logits = h.detach() @ net.W_cs
        if self.cluster_selection_noise > 0.0:
            sel_logits = sel_logits + self.cluster_selection_noise * self._selection_noise(
                batch["noise_seed"], sel_logits, *self._global_rows(sel_logits.shape[0])
            )
        selection = torch.softmax(scale * sel_logits, dim=-1)
        membership = self._membership(self._cluster_rows(torch.cat([targets, batch["cluster_samples"]])), scale)
        return cost, loss_fn(selection @ membership.T, B, offset).mean()

    def _regularization(self):
        return 0.0

    def _scores(self, ids, id_mask, mask):
        h = self.net.representation(ids, mask, id_mask)
        return torch.softmax(h @ self.net.W_out + self.net.b_out, dim=-1)

    # ------------------------------------------------------------------
    # batching
    # ------------------------------------------------------------------
    def _popularity_samples(self, n):
        if not hasattr(self, "_cumsum"):
            self._cumsum = np.cumsum(np.power(self.dataset.item_popularity, self.sampling_bias))
        u = self.rng.uniform(0, self._cumsum[-1], size=n)
        return np.searchsorted(self._cumsum, u, side="right").astype(np.int32)

    def _draw_sample_sets(self):
        if self.sampling_bias > 0.0:
            samples = self._popularity_samples(self.n_samples)
            cluster_samples = (
                self._popularity_samples(self.n_cluster_samples) if self.n_cluster_samples > 0 else samples
            )
        else:
            samples = self.rng.choice(self.n_items, self.n_samples).astype(np.int32)
            cluster_samples = (
                self.rng.choice(self.n_items, self.n_cluster_samples).astype(np.int32)
                if self.n_cluster_samples > 0
                else samples
            )
        return samples, cluster_samples

    def _update_scale(self) -> None:
        """Geometric temperature schedule, grown once at every crossing of
        an integer epoch (floor of the epoch count), clamped at
        ``max_scale``: the JAX package's schedule."""
        epoch = int(self.dataset.training_set.epochs)
        if not hasattr(self, "_last_epoch"):
            self._last_epoch = epoch
        elif epoch > self._last_epoch and self.scale_growing_rate != 1.0:
            steps = epoch - self._last_epoch
            self.effective_scale = min(self.max_scale, self.effective_scale * self.scale_growing_rate**steps)
            self._last_epoch = epoch
            print("New scale: ", self.effective_scale)

    def _step_fields(self) -> dict:
        """The per-step fields: samples, cluster samples, scale, noise seed."""
        samples, cluster_samples = self._draw_sample_sets()
        self._update_scale()
        self._noise_seed += 1
        return {
            "samples": samples,
            "cluster_samples": cluster_samples,
            "scale": np.float32(self.effective_scale),
            "noise_seed": np.int32(self._noise_seed),
        }

    def _finalize_packed_batch(self, packed, target_ratings):
        packed.update(self._step_fields())
        return packed

    def _restack_wire(self, batch, n_stack):
        out = super()._restack_wire(batch, n_stack)
        # the sample sets and the noise seed are per step: drawn and
        # advanced anew for each of the K steps (the scale is the batch's)
        samples, cluster_samples = [np.asarray(batch["samples"])], [np.asarray(batch["cluster_samples"])]
        seeds = [np.int32(batch["noise_seed"])]
        for _ in range(n_stack - 1):
            s, cs = self._draw_sample_sets()
            self._noise_seed += 1
            samples.append(s)
            cluster_samples.append(cs)
            seeds.append(np.int32(self._noise_seed))
        out["samples"] = np.stack(samples)
        out["cluster_samples"] = np.stack(cluster_samples)
        out["noise_seed"] = np.asarray(seeds, dtype=np.int32)
        return out

    # index wire: the sample sets, noise seeds and the scale are drawn on the
    # host in the packed path's order and ship beside (rows, cuts); the
    # sequence fields assemble on the device. FISMCluster stays off it
    # (its max_length is infinite, so the packed batcher does not apply).
    index_wire_ok = True

    def _index_payload_extras(self, k):
        samples, cluster_samples, seeds = [], [], []
        for _ in range(k):
            s, cs = self._draw_sample_sets()
            self._noise_seed += 1
            samples.append(s)
            cluster_samples.append(cs)
            seeds.append(np.int32(self._noise_seed))
        # the scale schedule advances once a payload, after its draws
        self._update_scale()
        return {
            "samples": np.stack(samples),
            "cluster_samples": np.stack(cluster_samples),
            "scale": np.full(k, self.effective_scale, dtype=np.float32),
            "noise_seed": np.asarray(seeds, dtype=np.int32),
        }

    def _prepare_input(self, sequences):
        ids, id_mask, mask = self._encode_sequences([s[1] for s in sequences], user_ids=[s[0] for s in sequences])
        targets = np.array([s[2][0][0] for s in sequences], dtype=np.int32)
        batch = {"ids": ids, "mask": mask, "targets": targets, **self._step_fields()}
        if id_mask is not None:
            batch["id_mask"] = id_mask
        return batch

    # ------------------------------------------------------------------
    # validation: the cluster metric set, in device chunks
    # ------------------------------------------------------------------
    @torch.inference_mode()
    def _cluster_eval_topk(self, ids, id_mask, mask, seen, seen_mask):
        """One chunk's unrestricted and cluster-restricted top-10 ids, its
        argmax clusters and used-item counts, on the device. Seen items are
        zeroed in the (nonnegative) probabilities; items outside the
        user's cluster score 0 in the restricted list, whose ties at 0 then
        go by id, ascending.

        With ``W_out`` and ``b_out`` sharded by columns and
        ``cluster_repartition`` by rows, each rank works on its columns: the
        softmax's max and sum over "model", the seen items zeroed in its
        columns, its rows of the hard memberships as the user's used
        columns (their count summed over "model"), both top-10 lists
        merged from the shards in the same order. The same on every model
        rank."""
        net, mesh = self.net, self.mesh
        col0 = self._shard_start("W_out")
        h = net.representation(ids, mask, id_mask)
        logits = h @ net.W_out + net.b_out  # [B, N], or the rank's [B, N/M]
        if col0 is None:
            probs = torch.softmax(logits, dim=-1)
        else:
            e = torch.exp(logits - all_reduce(logits.max(dim=1).values, mesh, "model", op="max")[:, None])
            probs = e / all_reduce(e.sum(dim=1), mesh, "model")[:, None]
        c_sel = torch.argmax(h @ net.W_cs, dim=-1)
        B, n = probs.shape
        if self.interactions_are_unique:
            local, seen_mask = local_seen(seen, seen_mask, col0 or 0, n)
            safe = torch.where(seen_mask > 0, local, n).long()  # id n: a pad column, dropped
            probs = torch.cat([probs, probs.new_zeros((B, 1))], dim=1).scatter_(1, safe, 0.0)[:, :n]
        used_rows = self._hard_clusters(net.cluster_repartition).T.index_select(0, c_sel)  # [B, n]
        if col0 is None:
            top1, top2 = (top_k_sorted(p, 10)[1] for p in (probs, probs * used_rows))
            return top1, top2, c_sel, used_rows.sum(dim=1)
        top1, top2 = (sharded_top_k(mesh, p, col0, 10)[1] for p in (probs, probs * used_rows))
        return top1, top2, c_sel, all_reduce(used_rows.sum(dim=1), mesh, "model")

    def _compute_validation_metrics(self, metrics):
        clusters = np.zeros(self.n_clusters, dtype="int")
        used_items = []
        ev = evaluation.Evaluator(self.dataset, k=10)
        ev_clusters = evaluation.Evaluator(self.dataset, k=10)

        instances = list(self._iter_test_instances(self.dataset.validation_set(epochs=1)))
        if not instances:
            for m in self.metrics:
                metrics[m].append(0)
            return metrics
        chunk = self.eval_batch_size
        for c0 in range(0, len(instances), chunk):
            part = instances[c0 : c0 + chunk]
            seqs = [seq for seq, _, _ in part]
            users = [u for _, _, u in part]
            pad = chunk - len(part)
            ids, id_mask, mask = self._encode_sequences(seqs + [seqs[-1]] * pad, user_ids=users + [users[-1]] * pad)
            # the seen items are every item of the input sequence, not only
            # the encoded (max_length) window
            S = max(1, max(len(s) for s in seqs))
            seen = np.zeros((chunk, S), dtype=np.int32)
            seen_mask = np.zeros((chunk, S), dtype=np.float32)
            for row, seq in enumerate(seqs):
                items = [int(i[0]) for i in seq]
                seen[row, : len(items)] = items
                seen_mask[row, : len(items)] = 1.0
            arrays = {"ids": ids, "id_mask": id_mask, "mask": mask, "seen": seen, "seen_mask": seen_mask}
            if self.mesh is not None:  # this rank's rows of the chunk
                arrays = mesh_lib.batch_rows({k: v for k, v in arrays.items() if v is not None}, self.mesh)
            out = self._cluster_eval_topk(*(self._tensor(arrays.get(k)) for k in
                                            ("ids", "id_mask", "mask", "seen", "seen_mask")))
            if self.mesh is not None:  # every data rank's rows, on every rank
                out = [all_gather(t, self.mesh, "data") for t in out]
            top1, top2, c_sel, used_count = (t.cpu().numpy() for t in out)
            for row, (seq, goal, _) in enumerate(part):
                ev.add_instance(goal, top1[row].tolist())
                ev_clusters.add_instance(goal, top2[row].tolist())
                clusters[c_sel[row]] += 1
                used_items.append(used_count[row])

        repartition = self._full_param("cluster_repartition")
        if self.cluster_type == "softmax":
            ignored_items = 0
            cluster_size = np.histogram(repartition.argmax(axis=1), bins=range(self.n_clusters + 1))[0].tolist()
        elif self.cluster_type == "mix":
            ignored_items = 0
            sig_clusters = repartition > 0.0
            sig_clusters[np.arange(self.n_items), repartition.argmax(axis=1)] = True
            cluster_size = sig_clusters.sum(axis=0)
        else:
            ignored_items = (repartition.max(axis=1) < 0.0).sum()
            cluster_size = (repartition > 0.0).sum(axis=0)

        metrics["recall"].append(ev.average_recall())
        metrics["cluster_recall"].append(ev_clusters.average_recall())
        metrics["sps"].append(ev.sps())
        metrics["cluster_sps"].append(ev_clusters.sps())
        metrics["assr"].append(self.n_items / np.mean(used_items))
        metrics["ignored_items"].append(ignored_items)
        metrics["cluster_use"].append(clusters)
        metrics["cluster_use_std"].append(np.std(clusters))
        metrics["cluster_size"].append(cluster_size)
        return metrics

    # ------------------------------------------------------------------
    # test time: hard clusters, scoring on the host
    # ------------------------------------------------------------------
    def prepare_tests(self) -> None:
        """Each item joins every cluster where its repartition is positive,
        or else the one of its largest value."""
        cluster_membership = self._full_param("cluster_repartition")
        item_embeddings = self._full_param("W_out")
        item_bias = self._full_param("b_out")
        self.clusters = [[] for _ in range(self.n_clusters)]
        for i in range(cluster_membership.shape[0]):
            no_cluster = True
            best_cluster = 0
            best_val = cluster_membership[i, 0]
            for j in range(self.n_clusters):
                if cluster_membership[i, j] > 0:
                    self.clusters[j].append(i)
                    no_cluster = False
                elif cluster_membership[i, j] > best_val:
                    best_val = cluster_membership[i, j]
                    best_cluster = j
            if no_cluster:
                self.clusters[best_cluster].append(i)
        self.clusters = [np.array(c, dtype=np.int64) for c in self.clusters]
        self.clusters_reverse_index = [{int(c[j]): j for j in range(len(c))} for c in self.clusters]
        self.clusters_embeddings = [item_embeddings[:, c] for c in self.clusters]
        self.clusters_bias = [item_bias[c] for c in self.clusters]

    @torch.inference_mode()
    def _rep_and_cluster(self, ids, id_mask, mask):
        """(h [B, H], argmax cluster [B]) as numpy."""
        h = self.net.representation(*map(self._tensor, (ids, mask, id_mask)))
        c = torch.argmax(h @ self.net.W_cs, dim=-1)
        return h.cpu().numpy(), c.cpu().numpy()

    def _predict_representation(self, sequence, user_id=None):
        seq = sequence[-min(self.max_length, len(sequence)) :] if np.isfinite(self.max_length) else sequence
        ids, id_mask, mask = self._encode_sequences([seq], user_ids=None if user_id is None else [user_id])
        h, c = self._rep_and_cluster(ids, id_mask, mask)
        return h[0], int(c[0])

    def _batch_representations(self, seqs, user_ids=None):
        """(h [B, H], argmax cluster [B]) for a list of input sequences, in
        chunks of ``eval_batch_size`` (the last padded with its last row)."""
        chunk = self.eval_batch_size
        hs, cs = [], []
        for c0 in range(0, len(seqs), chunk):
            part = seqs[c0 : c0 + chunk]
            enc = part + [part[-1]] * (chunk - len(part))
            users_p = None
            if user_ids is not None:
                users = list(user_ids[c0 : c0 + chunk])
                users_p = users + [users[-1]] * (chunk - len(part))
            if np.isfinite(self.max_length):
                L = int(self.max_length)
                enc = [s[-min(L, len(s)) :] for s in enc]
            h, c = self._rep_and_cluster(*self._encode_sequences(enc, user_ids=users_p))
            hs.append(h[: len(part)])
            cs.append(c[: len(part)])
        return np.concatenate(hs), np.concatenate(cs)

    def top_k_batch_clustered(self, seqs, k=10, user_ids=None):
        """Batched test-time prediction: every user's representation and
        argmax cluster from chunked device passes, then the users grouped by
        cluster and each group scored with one product against its
        cluster's columns. Returns (recommendation lists, items-in-cluster
        counts: the ASSR datapoints)."""
        if not seqs:
            return [], []
        h, c = self._batch_representations(seqs, user_ids=user_ids)
        B = len(seqs)
        if not self.predict_with_clusters:
            scores = h @ self._full_param("W_out") + self._full_param("b_out")
            for row, seq in enumerate(seqs):
                if self.interactions_are_unique:
                    scores[row, [int(i[0]) for i in seq]] = -np.inf
            kk = min(k, scores.shape[1])
            top = np.argpartition(-scores, range(kk), axis=1)[:, :kk]
            return [list(map(int, t)) for t in top], [self.n_items] * B
        if not hasattr(self, "clusters"):
            self.prepare_tests()
        recs: list = [None] * B
        ns = [0] * B
        for cl in range(self.n_clusters):
            rows = np.where(c == cl)[0]
            if len(rows) == 0:
                continue
            members = self.clusters[cl]
            rev = self.clusters_reverse_index[cl]
            scores = h[rows] @ self.clusters_embeddings[cl] + self.clusters_bias[cl]
            eff_k = min(k, len(members))
            for rr, row in enumerate(rows):
                if self.interactions_are_unique:
                    ex = [rev[int(i[0])] for i in seqs[row] if int(i[0]) in rev]
                    scores[rr, ex] = -np.inf
                top = np.argpartition(-scores[rr], range(eff_k))[:eff_k]
                recs[row] = [int(members[t]) for t in top]
                ns[row] = len(members)
        return recs, ns

    def top_k_recommendations(self, sequence, user_id=None, k=10, exclude=None):
        """(k item ids, the number of items scored) for one sequence."""
        if exclude is None:
            exclude = []
        should_exclude = [int(i[0]) for i in sequence] if self.interactions_are_unique else []
        should_exclude.extend(exclude)

        u, c = self._predict_representation(sequence, user_id=user_id)
        if self.predict_with_clusters:
            if not hasattr(self, "clusters"):
                self.prepare_tests()
            scores = u @ self.clusters_embeddings[c] + self.clusters_bias[c]
            rev = self.clusters_reverse_index[c]
            scores[[rev[i] for i in should_exclude if i in rev]] = -np.inf
            effective_k = min(k, len(self.clusters[c]))
            top = np.argpartition(-scores, range(effective_k))[:effective_k]
            return list(self.clusters[c][top]), len(self.clusters[c])
        scores = u @ self._full_param("W_out") + self._full_param("b_out")
        scores[should_exclude] = -np.inf
        return list(np.argpartition(-scores, range(k))[:k]), self.n_items

    def load(self, filename: str) -> None:
        super().load(filename)
        self.prepare_tests()

    def _print_progress(self, iterations, epochs, start_time, train_costs, metrics, validation_metrics):
        print(self.name, iterations, "batchs, ", epochs, " epochs in", time() - start_time, "s")
        print("Last train cost : ", train_costs[-1])
        for m in self.metrics.keys():
            print(m, ": ", metrics[m][-1])
        print("-----------------")
        print(
            iterations, epochs, time() - start_time, train_costs[-1],
            metrics["sps"][-1], metrics["cluster_sps"][-1], metrics["recall"][-1],
            metrics["cluster_recall"][-1], metrics["assr"][-1],
            metrics["ignored_items"][-1], metrics["cluster_use_std"][-1],
            file=sys.stderr,
        )


# ======================================================================
class FISMCluster(RNNCluster):
    """FISM user representation + the cluster machinery."""

    lazy_table_ok = False  # no recurrent tower (bag representation)

    def __init__(self, h=100, alpha=0.5, reg=0.00025, max_length=np.inf, **kwargs):
        # FISM consumes the whole history, whatever the CLI's max_length
        super().__init__(max_length=np.inf, **kwargs)
        self.n_hidden = h
        self.alpha = alpha
        self.reg = reg
        self.target_selection.shuffle = True
        self.name = "FISM Cluster with categorical cross entropy"
        self.recurrent_layer.name = ""

    def _get_model_filename(self, epochs) -> str:
        filename = self._filename_scale("fism_clusters") + "_h" + str(self.n_hidden) + "_a" + str(self.alpha) + "_"
        filename += self._filename_clusters()
        if self.reg != 0.0:
            filename += "_r" + str(self.reg)
        return filename + "_c" + self.loss + "_" + self._common_filename(epochs)

    # ------------------------------------------------------------------
    def _prepare_networks(self, n_items: int) -> None:
        self.n_items = n_items
        self.net = FISMClusterNetwork(n_items, self.n_hidden, self.n_clusters, self.alpha, self.device)

    def _init_params(self) -> dict:
        rng = self.rng
        limit_emb = np.sqrt(6.0 / (self.n_items + self.n_hidden))
        limit = np.sqrt(6.0 / (self.n_hidden + self.n_items))
        limit_cs = np.sqrt(6.0 / (self.n_hidden + self.n_clusters))
        return {
            "item_embeddings": rng.uniform(-limit_emb, limit_emb, size=(self.n_items, self.n_hidden)).astype(np.float32),
            "W_out": rng.uniform(-limit, limit, size=(self.n_hidden, self.n_items)).astype(np.float32),
            "b_out": np.zeros(self.n_items, dtype=np.float32),
            "W_cs": rng.uniform(-limit_cs, limit_cs, size=(self.n_hidden, self.n_clusters)).astype(np.float32),
            "cluster_repartition": (0.1 * rng.standard_normal((self.n_items, self.n_clusters))).astype(np.float32),
        }

    def _regularization(self):
        """L2 for reg > 0, L1 for reg < 0, on the network's parameters; the
        sum over a sharded table is summed over "model"."""
        if self.reg == 0.0:
            return 0.0
        penalty = (lambda p: torch.sum(torch.square(p))) if self.reg > 0.0 else losses.l1_penalty
        terms = []
        for key in ("item_embeddings", "W_out", "b_out"):
            term = penalty(self.net.get_parameter(key))
            terms.append(term if self._shard_start(key) is None else reduce_from_model(term, self.mesh))
        return abs(self.reg) * sum(terms)

    def params_from_numpy(self, tree: dict, device=None):
        net = super().params_from_numpy(tree, device)
        start = self._shard_start("item_embeddings")
        net.input_shard = None if start is None else (self.mesh, start)
        return net

    # FISM's input is the bag, not a timestep tensor ------------------
    def _encode_sequences(self, seqs, user_ids=None):
        pad = pad_bucket(max(1, max(len(s) for s in seqs)), floor=16)
        B = len(seqs)
        ids = np.zeros((B, pad), dtype=np.int32)
        mask = np.zeros((B, pad), dtype=np.float32)
        for i, seq in enumerate(seqs):
            items = [int(x[0]) for x in seq[:pad]]
            ids[i, : len(items)] = items
            mask[i, : len(items)] = 1.0
        return ids, None, mask
