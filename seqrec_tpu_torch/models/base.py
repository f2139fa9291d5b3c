"""RNN-family base predictor: encoding, batching, the training loop,
checkpoints and batched masked top-k.

Counterpart of ``seqrec_tpu/models/base.py:RNNBase``. The predictor
protocol the CLIs rely on is kept — ``prepare_model(dataset)``, ``train``,
``load``, ``load_last``, ``save``, ``set_dataset``,
``_iter_test_instances``, ``_stage_eval_inputs``/``_topk_from_staged``,
``top_k_recommendations``, ``metrics`` — and so are the filename scheme
and the ``.npz`` checkpoint format (path-encoded keys), so a checkpoint of
either package loads in the other. The network is an ``nn.Module``
(``self.net``) whose state-dict keys are the JAX parameter paths with
``/`` replaced by ``.``.

Training draws the JAX package's batches: the packed batcher with
``np.random.default_rng(seed + 77)`` on the default plugin settings, the
per-sequence batcher with the model's own generator otherwise, so one seed
gives the same batches and the loss trajectories compare step by step.
As in the JAX package, the packed batches are assembled on a prefetch
thread (``_prefetch``), each tagged with the epoch count of its assembly
(``_with_epochs``) so that checkpoint names do not depend on how far the
thread ran ahead; every host draw of a training run (the cuts, negative
samples, cluster sample sets and noise seeds) happens on that thread, in
the JAX package's order. Each ``train_function`` call is one optimizer
step (autograd, then the updater's in-place step) on a batch uploaded from
pinned memory without blocking the host.

``--spd K`` (``steps_per_dispatch``) runs K optimizer steps a dispatch on
[K, ...] payloads, the JAX package's ``lax.scan`` over K steps: an
assembly thread builds a [K*B] super-batch at a time (so a sequence's cuts
may span adjacent steps, as there), a transfer thread copies the payload
to the device on a stream of its own, and ``train_function_stacked``
enqueues the K steps back to back on its slices with no host sync between
them, summing the costs on the device. Models whose whole batch derives
from the training store (``index_wire_ok``: the CCE, sampled, margin and
RNNCluster heads) ship only the sampled (rows, cuts) and their per-step
host draws: the store is uploaded once, and ``_expand_index_wire``
assembles each step's batch with device gathers. Validation runs the eval
kernels.
``--lazy_updates`` (Adam only) moves the catalog-indexed tables onto a
slice-sparse Adam, TF LazyAdam's semantics: the input table's rows for
``RNNOneHot`` and ``RNNMargin``, the output columns and bias entries of
the sampled head for ``RNNSampling``; models without a recurrent tower
(``FISMCluster``, the autoencoder) refuse it. ``save`` writes the
optimizer state too when ``save_optimizer_state`` is set, as the JAX
package's ``opt/{i}`` leaves in optax's leaf order, and ``load`` reads
them back; the training loop's autosaves go through an async queue (a
device snapshot written by a worker thread), drained before ``train``
returns. With ``--mf``/``--uf`` the item and user side-feature ids of
``data/features.py`` follow each step's item id.

``set_mesh`` routes training and evaluation through a ("data", "model")
mesh of ``torch.distributed`` ranks (``parallel/``), one process a rank:
the catalog tables hold only the rank's shard (``params_from_numpy``
shards a loaded tree, ``params_to_numpy`` gathers it back: a collective),
each rank keeps its rows of the identical global batch (a mesh run always
takes the stacked pipeline, even at K = 1, as in the JAX package), the
gradients are averaged over "data" after each backward, and the eval
chunks split over "data" and their top-k rows are gathered back, so every
rank computes the same metrics and takes the same early-stopping and
``--save Best`` decisions. Saves gather the full tree on every rank and
are synchronous on more than one rank; only the rank with ``LOCAL_RANK``
0 writes files. Every model of the family takes a mesh (the CCE, sampled,
margin and cluster heads, FISMCluster and the autoencoder), with
``--bf16`` (the sharded ops take the compute dtype) and
``--lazy_updates``: the lazy Adam updates the slices that the global
batch touches (its ids gathered over "data") on the rank's shard, and its
moments live on the shard like their parameter.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import os
import queue
import re
import sys
import threading
from time import time

import numpy as np
import torch

from seqrec_tpu_torch import resolve_device
from seqrec_tpu_torch.data.noise import SequenceNoise
from seqrec_tpu_torch.data.targets import SelectTargets
from seqrec_tpu_torch.models.recurrent import RecurrentLayers
from seqrec_tpu_torch.models.updates import Adagrad, Adam
from seqrec_tpu_torch.ops.core import masked_top_k, matmul_bf16
from seqrec_tpu_torch.ops.score_topk import MAX_K, fused_score_topk
from seqrec_tpu_torch.parallel import mesh as mesh_lib
from seqrec_tpu_torch.parallel.collectives import all_gather, mean_over_data
from seqrec_tpu_torch.parallel.columns import gather_columns
from seqrec_tpu_torch.parallel.distributed import writes_files
from seqrec_tpu_torch.utils import evaluation

# Defaults (reference rnn_base.py:24,32)
MAX_LENGTH = 200
BATCH_SIZE = 10

# npz cannot hold extension dtypes (bfloat16, the float8s): the JAX package
# stores such a leaf as a same-width unsigned-int view with the dtype name
# after this marker in its key (and an older archive "#bf16" at the end).
_DTYPE_MARK = "#dtype="
_UINT_BY_SIZE = {1: np.uint8, 2: np.uint16, 4: np.uint32}


def _npz_leaf(key: str, node):
    """(npz key, array) of one leaf: a torch bf16 tensor (a bf16 Adam
    moment) as its uint16 view under the marker; any other tensor as its
    host array; an extension-dtype numpy array as its unsigned view."""
    if isinstance(node, torch.Tensor):
        node = node.detach().cpu()
        if node.dtype == torch.bfloat16:
            return key + _DTYPE_MARK + "bfloat16", node.view(torch.int16).numpy().view(np.uint16)
        return key, node.numpy()
    arr = np.asarray(node)
    if arr.dtype.kind == "V" and arr.dtype.names is None:  # ml_dtypes registers its dtypes as kind V
        return key + _DTYPE_MARK + arr.dtype.name, arr.view(_UINT_BY_SIZE[arr.dtype.itemsize])
    return key, arr


def pytree_save(filename: str, params) -> None:
    """Save a nested dict of arrays (numpy arrays or tensors) to an npz
    with path-encoded keys, in the JAX package's format."""
    flat = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(prefix + (k,), v)
        else:
            key, arr = _npz_leaf("/".join(prefix), node)
            flat[key] = arr

    walk((), params)
    if os.path.dirname(filename):
        os.makedirs(os.path.dirname(filename), exist_ok=True)
    with open(filename, "wb") as f:
        np.savez(f, **flat)


def pytree_load(filename: str) -> dict:
    """Inverse of the JAX package's ``pytree_save``. A bfloat16 leaf (the
    marker ``#dtype=bfloat16``, or an older archive's ``#bf16``) becomes a
    torch bf16 tensor, decoded without ``ml_dtypes``; any other extension
    dtype needs ``ml_dtypes``, imported only then."""
    out: dict = {}
    with np.load(filename) as data:
        for key in data.files:
            arr = data[key]
            name = None
            if _DTYPE_MARK in key:
                key, _, name = key.partition(_DTYPE_MARK)
            elif key.endswith("#bf16"):
                key, name = key[: -len("#bf16")], "bfloat16"
            if name in ("bfloat16", "bf16"):
                arr = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
            elif name is not None:
                import ml_dtypes

                arr = arr.view(np.dtype(getattr(ml_dtypes, name)))
            node = out
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = arr
    return out


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield ".".join(prefix + (k,)), v


def _unflatten(state) -> dict:
    """``{"a.b.c": tensor}`` -> nested ``{"a": {"b": {"c": ndarray}}}``."""
    tree: dict = {}
    for key, t in state.items():
        node = tree
        *parents, leaf = key.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = t.detach().cpu().numpy()
    return tree


class RNNBase:
    """Base for sequence predictors trained with the generic loop."""

    def __init__(
        self,
        sequence_noise: SequenceNoise | None = None,
        recurrent_layer: RecurrentLayers | None = None,
        updater=None,
        target_selection: SelectTargets | None = None,
        interactions_are_unique: bool = True,
        use_ratings_features: bool = False,
        use_movies_features: bool = False,
        use_users_features: bool = False,
        max_length: int = MAX_LENGTH,
        batch_size: int = BATCH_SIZE,
        seed: int = 42,
        compute_dtype: str = "float32",
        lazy_updates: bool = False,
        device="cuda",
    ):
        self.sequence_noise = sequence_noise or SequenceNoise()
        self.recurrent_layer = recurrent_layer or RecurrentLayers()
        self.updater = updater or Adagrad()
        self.target_selection = target_selection or SelectTargets()
        self.interactions_are_unique = interactions_are_unique
        self.use_ratings_features = use_ratings_features
        # --mf/--uf: item and user side-feature ids from the dataset's
        # data/{movie,user}_features (contract in data/features.py)
        self.use_movies_features = use_movies_features
        self.use_users_features = use_users_features
        self._feature_tables = None
        self.max_length = max_length
        self.batch_size = batch_size
        self.seed = seed
        if compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype must be float32 or bfloat16, got {compute_dtype!r}")
        # --bf16: the catalog-sized output products take bf16 inputs and
        # accumulate in f32 (_out_matmul); parameters stay f32
        self.compute_dtype = compute_dtype
        self.lazy_updates = lazy_updates
        self.device = resolve_device(device)
        self.rng = np.random.default_rng(seed)
        # plugin RNG streams derive from the model seed unless the caller
        # gave explicit generators (as in the JAX package)
        if not getattr(self.sequence_noise, "rng_explicit", True):
            self.sequence_noise.rng = np.random.default_rng(seed + 13)
        if not getattr(self.target_selection, "rng_explicit", True):
            self.target_selection.rng = np.random.default_rng(seed + 29)

        self.name = "RNN base"
        self.metrics = {
            "recall": {"direction": 1},
            "sps": {"direction": 1},
            "user_coverage": {"direction": 1},
            "item_coverage": {"direction": 1},
            "ndcg": {"direction": 1},
            "blockbuster_share": {"direction": -1},
        }
        self.net: torch.nn.Module | None = None
        self._has_params = False
        self.opt_state = None
        self.eval_batch_size = max(batch_size, 64)
        # optimizer steps a dispatch (--spd); > 1 takes the K-step payloads
        self.steps_per_dispatch = 1
        # the ("data", "model") mesh (set_mesh), the spec of every parameter
        # under it and {state-dict key: first index} of this rank's shards
        self.mesh = None
        self._param_specs: dict = {}
        self._shards: dict = {}

    # ------------------------------------------------------------------
    # featurization: packed sparse ids per timestep
    # ------------------------------------------------------------------
    @property
    def n_feature_slots(self) -> int:
        """Static number of feature ids per timestep (F). Pad slots (the
        variable-size genre multi-hot) carry id -1, which the gather-sum
        drops."""
        F = 1 + (1 if self.use_ratings_features else 0)
        ft = self._feature_tables
        if ft is not None:
            F += ft.item_slots + ft.user_slots
        return F

    def _n_optional_features(self) -> int:
        # the rating one-hot occupies 10 id slots (rnn_base.py:578-593); the
        # movie and user blocks' widths come from the loaded tables
        n = 10 if self.use_ratings_features else 0
        ft = self._feature_tables
        if ft is not None:
            n += ft.n_movie_feats + ft.n_user_feats
        return n

    def _feature_offsets(self):
        """(movie block offset, user block offset) in the id space: the
        enabled blocks in the order ratings | movies | users."""
        off = self.n_items + (10 if self.use_ratings_features else 0)
        ft = self._feature_tables
        return off, off + (ft.n_movie_feats if ft is not None else 0)

    def _input_size(self) -> int:
        return self.n_items + self._n_optional_features()

    def _feature_ids(self, item_id: int, rating: float):
        ids = [item_id]
        if self.use_ratings_features:
            bucket = int(round(rating * 2)) - 1
            ids.append(self.n_items + max(0, min(9, bucket)))
        return ids

    def _side_feature_ids(self, ids, col: int, valid, users) -> None:
        """Fill the --mf/--uf slots of ``ids`` [B, L, F] from column
        ``col`` on: the item block from each step's item (slot 0), the
        user block from ``users`` [B]; every slot past the item's is -1 at
        the invalid steps (``valid`` [B, L] bool)."""
        ft = self._feature_tables
        if ft is None or not (ft.item_slots or ft.user_slots):
            return
        mf_off, uf_off = self._feature_offsets()
        if ft.item_slots:
            tab = ft.item_ids[ids[:, :, 0]]  # [B, L, slots], -1 pads
            ids[:, :, col : col + ft.item_slots] = np.where(tab >= 0, mf_off + tab, -1)
            col += ft.item_slots
        if ft.user_slots:
            if users is None:
                raise ValueError("--uf encoding needs per-sequence user ids")
            u = np.asarray(users, dtype=np.int64)
            ids[:, :, col:] = (uf_off + ft.user_ids[u])[:, None, :]
        ids[:, :, 1:][~valid] = -1

    def _encode_sequences(self, seqs, user_ids=None):
        """Pack a list of [(item, rating), ...] into arrays: (ids [B,L,F]
        int32, id_mask [B,L,F] f32 or None, mask [B,L] f32). With --mf/--uf
        the item and user feature slots follow (``user_ids`` needed for
        --uf)."""
        B, L, F = len(seqs), self.max_length, self.n_feature_slots
        ids = np.zeros((B, L, F), dtype=np.int32)
        mask = np.zeros((B, L), dtype=np.float32)
        col = 1 + (1 if self.use_ratings_features else 0)
        for i, seq in enumerate(seqs):
            for t, (item, rating) in enumerate(seq[:L]):
                ids[i, t, :col] = self._feature_ids(int(item), float(rating))
            mask[i, : min(len(seq), L)] = 1.0
        self._side_feature_ids(ids, col, mask > 0, user_ids)
        id_mask = None
        if F > 1:
            id_mask = np.broadcast_to(mask[:, :, None], ids.shape).astype(np.float32)
        return ids, id_mask, mask

    # ------------------------------------------------------------------
    # model lifecycle
    # ------------------------------------------------------------------
    def prepare_model(self, dataset) -> None:
        """Must be called before load, params_from_numpy or prediction;
        loads the --mf/--uf tables from the dataset."""
        if (self.use_movies_features or self.use_users_features) and self._feature_tables is None:
            from seqrec_tpu_torch.data.features import load_feature_tables

            self._feature_tables = load_feature_tables(dataset, self.use_movies_features, self.use_users_features)
        self._prepare_networks(dataset.n_items)

    def _prepare_networks(self, n_items: int) -> None:  # pragma: no cover
        raise NotImplementedError

    def set_dataset(self, dataset) -> None:
        self.dataset = dataset
        self.target_selection.set_dataset(dataset)
        self._val_cache = None

    # ------------------------------------------------------------------
    # the ("data", "model") mesh (parallel/; base.py:set_mesh)
    # ------------------------------------------------------------------
    def set_mesh(self, mesh) -> None:
        """Route training and eval through ``mesh`` (``parallel.Mesh``; None:
        one device). ``batch_size`` must divide the data axis;
        ``eval_batch_size`` is rounded up to it. Parameters (and an
        optimizer state) already present are sharded now; later ones as
        they are loaded."""
        if mesh is not None:
            if mesh.device != self.device:
                raise ValueError(f"the mesh's device {mesh.device} is not the model's {self.device}")
            n_data = mesh.shape["data"]
            if self.batch_size % n_data:
                raise ValueError(f"batch_size {self.batch_size} is not divisible by the mesh data axis ({n_data})")
            if self.eval_batch_size % n_data:
                self.eval_batch_size += n_data - self.eval_batch_size % n_data
        full = opt = None
        if self._has_params:
            full = self.params_to_numpy()
            opt = self._opt_leaves() if self.opt_state is not None else None
        self.mesh = mesh
        self._val_cache = None
        if full is not None:
            self.params_from_numpy(full)
            if opt is not None:
                self.opt_state = self._opt_state_from_leaves(opt)

    def _shard_start(self, key: str):
        """First index of this rank's shard of parameter ``key``, or None
        when the parameter is whole here (no mesh, or replicated)."""
        return self._shards.get(key)

    def _shard_layout(self, key: str, shape):
        """(full shape, sharded dimension, first index) of this rank's
        shard of parameter ``key`` (whose local shape is ``shape``), or
        None when it is whole here."""
        start = self._shard_start(key)
        if start is None:
            return None
        dim = mesh_lib.sharded_axis(self._param_specs[key])
        full = list(shape)
        full[dim] *= self.mesh.shape["model"]
        return tuple(full), dim, start

    def _data_ids(self, ids):
        """The global batch's ids of a lazy spec from this rank's rows:
        gathered over "data" under a mesh (as int32: gloo has no int16),
        else as they are."""
        if self.mesh is None:
            return ids
        return all_gather(ids.int(), self.mesh, "data")

    def _global_rows(self, n_local: int) -> tuple[int, int]:
        """(the global batch's rows, the first of this rank's) for a device
        batch of ``n_local`` rows: each data rank holds an equal share."""
        if self.mesh is None:
            return n_local, 0
        return n_local * self.mesh.shape["data"], n_local * self.mesh.coords["data"]

    def _batch_targets(self, targets):
        """(the global batch's targets [B], the column of this rank's row 0
        among them): the sampled and cluster heads score each row against
        every target of the batch, so a data rank gathers the others'
        (ints, no gradient)."""
        if self.mesh is None:
            return targets, 0
        return all_gather(targets, self.mesh, "data"), self._global_rows(targets.shape[0])[1]

    def _head_columns(self, cols):
        """(``W_out[:, cols]``, ``b_out[cols]``) of the full output layer for
        global column ids ``cols``: ``index_select``, or under a mesh that
        shards ``W_out`` the columns gathered from their shards
        (``parallel/columns.py``)."""
        net = self.net
        col0 = self._shard_start("W_out")
        if col0 is None:
            return net.W_out.index_select(1, cols), net.b_out.index_select(0, cols)
        return gather_columns(net.W_out, net.b_out, cols, self.mesh, col0)

    def _shard_tree(self, state: dict) -> dict:
        """This rank's slices of a full ``{state-dict key: array}`` tree,
        recording each parameter's spec and shard, and the input tables'
        shards on the tower."""
        mesh = self.mesh
        self._param_specs = mesh_lib.param_sharding({k: np.shape(v) for k, v in state.items()}, mesh)
        self._shards = {}
        for key, spec in self._param_specs.items():
            axis = mesh_lib.sharded_axis(spec)
            if axis is not None:
                self._shards[key] = mesh_lib.shard_offset(np.shape(state[key])[axis], mesh)[0]
        self.recurrent_layer.input_shards = {
            key.split(".")[1]: (mesh, start)
            for key, start in self._shards.items()
            if key in ("tower.embedding", "tower.layer0_fwd.W_in", "tower.layer0_bwd.W_in")
        }
        return mesh_lib.shard_params(state, self._param_specs, mesh)

    def _init_params(self) -> dict:  # pragma: no cover
        """Freshly initialised numpy parameter tree (the JAX package's)."""
        raise NotImplementedError

    def params_from_numpy(self, tree: dict, device=None) -> torch.nn.Module:
        """Load a JAX-layout params tree of numpy arrays (``pytree_load``'s
        ``"params"``, or ``tree_map(np.asarray, model.params)``) into
        ``self.net``: the path ``a/b/c`` becomes the state-dict key
        ``a.b.c``. ``device`` moves the network first."""
        if device is not None:
            self.device = resolve_device(device)
            self.net.to(self.device)
        state = dict(_flatten(tree))
        resize = self.mesh is not None or bool(self._shards)  # to or from shards
        if self.mesh is not None:
            state = self._shard_tree(state)
        elif self._shards:
            self._param_specs, self._shards, self.recurrent_layer.input_shards = {}, {}, {}
        # np.require copies only leaves that are read-only or not C-contiguous
        state = {key: torch.from_numpy(np.require(arr, requirements="CW")) for key, arr in state.items()}
        if not resize:
            self.net.load_state_dict(state, strict=True)
        else:
            # a shard has its own shape: the parameters take the new tensors
            params = dict(self.net.named_parameters())
            if params.keys() != state.keys():
                raise ValueError(f"parameter keys differ: {sorted(params.keys() ^ state.keys())}")
            with torch.no_grad():
                for key, p in params.items():
                    p.data = state[key].to(self.device)
        self._has_params = True
        return self.net

    def params_to_numpy(self) -> dict:
        """The JAX-layout params tree of numpy arrays (inverse of
        ``params_from_numpy``); under a mesh the shards are gathered (a
        collective)."""
        state = self.net.state_dict()
        if self.mesh is not None:
            state = mesh_lib.gather_params(state, self._param_specs, self.mesh)
        return _unflatten(state)

    def load(self, filename: str) -> None:
        """Load a checkpoint of either package: the params, and the
        optimizer state where the archive has ``opt`` leaves (written with
        ``save_optimizer_state``); else the optimizer restarts from zero."""
        tree = pytree_load(filename)
        if "params" not in tree:  # archives from before the opt-state split
            tree = {"params": tree}
        self.params_from_numpy(tree["params"])
        self.opt_state = None
        if "opt" in tree:
            self.opt_state = self._opt_state_from_leaves([tree["opt"][str(i)] for i in range(len(tree["opt"]))])

    # ------------------------------------------------------------------
    # prediction
    # ------------------------------------------------------------------
    def _tensor(self, arr):
        return None if arr is None else torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _tensor_async(self, arr):
        """``_tensor`` without blocking the host: on the card the array is
        copied into pinned memory and uploaded with ``non_blocking``, on the
        current stream, so the kernels queued after it see it (the caching
        host allocator keeps the pinned block until its copy is done)."""
        if arr is None:
            return None
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _input_window(self, sequence):
        """Input truncation for prediction: last ``max_length`` items
        (rnn_base.py:144)."""
        return sequence[-min(self.max_length, len(sequence)) :]

    @torch.inference_mode()
    def top_k_recommendations(self, sequence, user_id=None, k=10, exclude=None):
        """Receives a sequence of (id, rating); returns k item ids, seen and
        excluded items masked to -inf first (rnn_base.py:132-159)."""
        if exclude is None:
            exclude = []
        seq = self._input_window(sequence)
        ids, id_mask, mask = self._encode_sequences([seq], user_ids=None if user_id is None else [user_id])
        scores = self._scores(self._tensor(ids), self._tensor(id_mask), self._tensor(mask))
        scores = scores[0].cpu().numpy()
        if self.interactions_are_unique:
            scores[[int(i[0]) for i in sequence]] = -np.inf
        scores[list(exclude)] = -np.inf
        return list(np.argpartition(-scores, range(k))[:k])

    def _out_matmul(self, h, w_out, b_out):
        """Catalog-sized output product h W_out + b: f32, or with --bf16
        bf16 operands and an f32 result (``base.py:_out_matmul``); under a
        mesh, of this rank's rows, the bf16 W_out cotangent rounded after
        its mean over "data" (``ops.core.matmul_bf16``)."""
        if self.compute_dtype == "bfloat16":
            return matmul_bf16(h, w_out, self.mesh) + b_out
        return h @ w_out + b_out

    def _logits(self, ids, id_mask, mask):
        """Output logits [B, n_items] of the tower's final state (under a
        mesh with ``W_out`` sharded, the shards' columns gathered)."""
        net = self.net
        logits = self._out_matmul(net.tower(ids, mask, id_mask), net.W_out, net.b_out)
        if self._shard_start("W_out") is not None:
            logits = all_gather(logits, self.mesh, "model", dim=1)
        return logits

    # softmax/identity heads over h·W_out+b set this: ranking raw logits
    # then matches ranking the scores, and the fused top-k kernel applies
    fused_eval_head = False

    def _scores(self, ids, id_mask, mask):  # pragma: no cover
        """Deterministic full-catalog scores [B, n_items]."""
        raise NotImplementedError

    def _rank_scores(self, ids, id_mask, mask):
        """Scores used only for top-k ranking (see fused_eval_head)."""
        return self._scores(ids, id_mask, mask)

    def _topk(self, ids, id_mask, mask, seen_ids, seen_mask, k):
        # K4 keeps at most MAX_K per row: a longer list (--save_rank ranks
        # the whole catalog) sorts the masked scores (under a mesh the
        # shards' logits gathered, in the compute dtype), as the JAX package
        # leaves its fused kernel above k = 64
        if self.fused_eval_head and self._shard_start("W_out") is not None and k <= MAX_K:
            from seqrec_tpu_torch.parallel.topk import sharded_score_topk

            h = self.net.tower(ids, mask, id_mask)
            return sharded_score_topk(self.mesh, h, self.net.W_out, self.net.b_out, seen_ids, seen_mask, k)[1]
        if not self.fused_eval_head or k > MAX_K:
            return masked_top_k(self._rank_scores(ids, id_mask, mask), k, seen_ids, seen_mask)
        h = self.net.tower(ids, mask, id_mask)
        return fused_score_topk(h, self.net.W_out, self.net.b_out, seen_ids, seen_mask, k=k)[1]

    def _topk_wire(self, ids, lengths, k):
        """Top-k of one staged chunk: the mask comes from the prefix
        lengths, the seen ids are ``ids[:, :, 0]`` under that mask."""
        ids = ids.int()
        L = ids.shape[-2]
        mask = (torch.arange(L, device=ids.device) < lengths[:, None]).float()
        id_mask = None
        if self.n_feature_slots > 1:
            id_mask = mask[..., None].expand(ids.shape).contiguous()
        seen_ids, seen_mask = None, None
        if self.interactions_are_unique:
            seen_ids, seen_mask = ids[:, :, 0].contiguous(), mask
        return self._topk(ids, id_mask, mask, seen_ids, seen_mask, k)

    def _iter_test_instances(self, sequence_generator):
        """Yield (input_sequence, goal_ids, user_id) per test/val user."""
        for sequence, user_id in sequence_generator:
            l = int(len(sequence) / 2)
            target = self.target_selection(sequence[l:], test=True)
            if len(target) == 0:
                continue
            start = max(0, l - self.max_length)
            goal = [i[0] for i in sequence[l:]]
            yield sequence[start:l], goal, user_id

    def _batched_recommendations(self, inputs, k: int = 10, user_ids=None):
        """Top-k for a list of input sequences, in device chunks."""
        return self._topk_from_staged(self._stage_eval_inputs(inputs, user_ids=user_ids), k)

    def _stage_eval_inputs(self, inputs, user_ids=None) -> list:
        """Encode the inputs in chunks of ``eval_batch_size`` rows (the last
        one padded with its last row) and start their upload as the compact
        wire format; returns [(n_real_rows, (ids, lengths)), ...]. Under a
        mesh each rank uploads its rows of each chunk."""
        chunk = self.eval_batch_size
        staged = []
        for c0 in range(0, len(inputs), chunk):
            batch = inputs[c0 : c0 + chunk]
            pad = chunk - len(batch)
            users_p = None
            if user_ids is not None:
                users = list(user_ids[c0 : c0 + chunk])
                users_p = users + [users[-1]] * pad
            ids, _, mask = self._encode_sequences(batch + [batch[-1]] * pad, user_ids=users_p)
            lengths = mask.sum(axis=1).astype(np.int32)
            if self._input_size() + 1 < np.iinfo(np.int16).max:
                ids = ids.astype(np.int16)
            if self.mesh is not None:
                rows = mesh_lib.batch_rows({"ids": ids, "lengths": lengths}, self.mesh)
                ids, lengths = rows["ids"], rows["lengths"]
            # uploads start here and do not block: all chunks are staged
            # before the first is scored (the JAX package's device_put)
            staged.append((len(batch), (self._tensor_async(ids), self._tensor_async(lengths))))
        return staged

    @torch.inference_mode()
    def _topk_from_staged(self, staged, k: int) -> np.ndarray:
        pending = [(n, self._topk_wire(ids, lengths, k)) for n, (ids, lengths) in staged]
        if self.mesh is not None:
            # the data ranks' rows of each chunk, gathered on every rank
            pending = [(n, all_gather(top, self.mesh, "data")) for n, top in pending]
        return np.concatenate([top[:n].cpu().numpy() for n, top in pending], axis=0)

    # ------------------------------------------------------------------
    # mini-batches: the JAX package's samplers, step for step
    # ------------------------------------------------------------------
    def _fast_batching_ok(self) -> bool:
        """The vectorized batcher reproduces the per-sequence sampler only
        for the default plugin settings (no sequence noise; deterministic
        next-item target)."""
        ts = self.target_selection
        return (
            self.sequence_noise.is_identity
            and ts.n_targets == 1
            and not ts.shuffle
            and ts.bias < 0
            and np.isfinite(self.max_length)
        )

    def _gen_cut_indices(self, training_set, rng, B: int):
        """Multiple random cuts per drawn sequence, the batch filled in
        draw order (``base.py:_gen_cut_indices``). Yields ``(sel_rows,
        sel_cuts)`` int64[B] buffers, reused across yields."""
        lengths = training_set.store.lengths
        eligible = np.where(lengths >= 3)[0]
        if len(eligible) == 0:
            raise ValueError("no trainable sequences (all shorter than 3)")
        order = eligible.copy()
        pos = len(order)
        epoch = -1
        sel_rows = np.empty(B, dtype=np.int64)
        sel_cuts = np.empty(B, dtype=np.int64)
        while True:
            j = 0
            while j < B:
                if pos >= len(order):
                    if training_set.shuffle:
                        rng.shuffle(order)
                    pos = 0
                    epoch += 1
                r = order[pos]
                pos += 1
                training_set.epochs = epoch + pos / len(order)
                n = int(min(B - j, lengths[r] - 2))
                if n == lengths[r] - 2:
                    # every cut: a sorted full sample is the range
                    sel_cuts[j : j + n] = np.arange(2, lengths[r])
                else:
                    sel_cuts[j : j + n] = np.sort(
                        rng.choice(np.arange(2, lengths[r]), size=n, replace=False)
                    )
                sel_rows[j : j + n] = r
                j += n
            yield sel_rows, sel_cuts

    def _gen_packed_mini_batch(self, training_set, rng=None, n_stack=0):
        """Vectorized batches from the packed SequenceStore
        (``base.py:_gen_packed_mini_batch``), in the compact wire format:
        int16 ids when they fit, [B] prefix lengths instead of masks.

        With ``n_stack=K`` one numpy pass assembles a [K*B] super-batch and
        yields it as a dict of [K, B, ...] arrays (``_restack_wire``) for the
        K-step dispatch: a sequence's cuts may then span adjacent steps, as
        in the JAX package."""
        store = training_set.store
        offsets = store.offsets
        B, L, F = self.batch_size * max(1, n_stack), self.max_length, self.n_feature_slots
        rng = rng if rng is not None else self.rng
        for sel_rows, sel_cuts in self._gen_cut_indices(training_set, rng, B):
            offs = offsets[sel_rows]
            starts = np.maximum(0, sel_cuts - L)
            m = (sel_cuts - starts).astype(np.int64)  # [B] prefix lengths
            t_idx = np.arange(L, dtype=np.int64)[None, :]
            valid = t_idx < m[:, None]
            flat = np.where(valid, offs[:, None] + starts[:, None] + t_idx, 0)
            ids = np.zeros((B, L, F), dtype=np.int32)
            ids[:, :, 0] = np.where(valid, store.items[flat], 0)
            col = 1
            if self.use_ratings_features:
                buckets = np.clip(np.round(store.ratings[flat] * 2) - 1, 0, 9).astype(np.int32)
                ids[:, :, 1] = np.where(valid, self.n_items + buckets, 0)
                col += 1
            self._side_feature_ids(ids, col, valid, store.user_ids[sel_rows])
            mask = valid.astype(np.float32)
            targets = store.items[offs + sel_cuts].astype(np.int32)
            target_ratings = store.ratings[offs + sel_cuts]
            packed = {"ids": ids, "mask": mask, "targets": targets}
            if F > 1:
                packed["id_mask"] = np.broadcast_to(mask[:, :, None], ids.shape).astype(np.float32)
            batch = self._compact_wire(self._finalize_packed_batch(packed, target_ratings), m)
            if n_stack:
                batch = self._restack_wire(batch, n_stack)
            yield batch

    def _restack_wire(self, batch: dict, n_stack: int) -> dict:
        """A [K*B]-row super-batch as [K, B, ...] arrays; per-model constants
        repeat along K. Heads whose batches carry per-step draws (negative
        samples, cluster sample sets, noise seeds) override this to draw
        them anew for each of the K steps."""
        B_super = self.batch_size * n_stack
        out = {}
        for key, v in batch.items():
            v = np.asarray(v)
            if v.ndim and v.shape[0] == B_super:
                out[key] = v.reshape(n_stack, self.batch_size, *v.shape[1:])
            else:
                out[key] = np.broadcast_to(v, (n_stack,) + v.shape)
        return out

    # ------------------------------------------------------------------
    # the index wire: the training store on the device, (rows, cuts) a step
    # ------------------------------------------------------------------
    # Models whose whole batch derives from (store, rows, cuts) and the
    # per-step host draws set this (``base.py:index_wire_ok``)
    index_wire_ok = False

    def _index_batching_ok(self) -> bool:
        return self.index_wire_ok and self._fast_batching_ok()

    def _make_pop_db(self) -> np.ndarray:
        """popularity^diversity_bias per item (ones without the bias)."""
        db = getattr(self, "diversity_bias", 0.0)
        return np.asarray(self.dataset.item_popularity[: self.n_items], dtype=np.float32) ** db

    def _index_payload_extras(self, k: int) -> dict:
        """Model hook: the per-step host draws shipped beside (rows, cuts),
        always on a leading k axis (the unstacked wire drops it)."""
        return {}

    def _build_index_store(self, training_set) -> dict:
        """Host arrays of the device-resident store (the JAX package's)."""
        store = training_set.store
        if store.offsets[-1] >= np.iinfo(np.int32).max:
            raise ValueError("dataset too large for int32 index wire")
        host = {
            "items": store.items.astype(np.int32),
            "offsets": store.offsets.astype(np.int32),
            "pop_db": np.asarray(self._make_pop_db(), dtype=np.float32),
        }
        if self.use_ratings_features:
            host["rating_buckets"] = np.clip(np.round(store.ratings * 2) - 1, 0, 9).astype(np.int32)
        ft = self._feature_tables
        if ft is not None and ft.item_slots:
            mf_off, _ = self._feature_offsets()
            host["mf_table"] = np.where(ft.item_ids >= 0, mf_off + ft.item_ids, -1).astype(np.int32)
        if ft is not None and ft.user_slots:
            _, uf_off = self._feature_offsets()
            host["uf_table"] = (uf_off + ft.user_ids).astype(np.int32)
            host["row_user"] = store.user_ids.astype(np.int32)
        return host

    def _upload_index_store(self, training_set) -> dict:
        """The store on the device, uploaded once a training run. Every
        target of the wire is a store item: the catalog range that the
        streaming CCE checks a step (one host sync) is checked here once,
        and each expanded batch carries ``targets_in_catalog``."""
        host = self._build_index_store(training_set)
        items = host["items"]
        if len(items) and (items.min() < 0 or items.max() >= self.n_items):
            raise ValueError(f"index wire: a store item is outside the catalog [0, {self.n_items})")
        # the arrays that only index other arrays go up as int64
        return {
            key: torch.from_numpy(arr.astype(np.int64) if key in ("offsets", "row_user") else arr).to(self.device)
            for key, arr in host.items()
        }

    def _gen_index_mini_batch(self, training_set, rng=None, n_stack=0):
        """Index-only twin of ``_gen_packed_mini_batch``: the same cut
        sampler, yielding int32 ``rows`` and ``cuts`` ([K, B] with
        ``n_stack``) and the model's per-step extras. The sampler reuses
        its buffers, so they are copied before the yield."""
        B = self.batch_size * max(1, n_stack)
        rng = rng if rng is not None else self.rng
        for sel_rows, sel_cuts in self._gen_cut_indices(training_set, rng, B):
            rows = sel_rows.astype(np.int32)  # astype copies the buffer
            cuts = sel_cuts.astype(np.int32)
            extras = self._index_payload_extras(max(1, n_stack))
            if n_stack:
                rows = rows.reshape(n_stack, self.batch_size)
                cuts = cuts.reshape(n_stack, self.batch_size)
            else:
                extras = {key: np.asarray(v)[0] for key, v in extras.items()}
            yield {"rows": rows, "cuts": cuts, **extras}

    def _expand_index_wire(self, batch: dict, store: dict) -> dict:
        """One step's batch assembled on the device from its (rows, cuts)
        and the store: the twin of the numpy assembly in
        ``_gen_packed_mini_batch`` and ``_finalize_packed_batch``, by torch
        gathers (XLA gathers in the JAX package). Ids stay int32; the
        masks are full [B, L] (and [B, L, F]) tensors."""
        rows, cuts = batch["rows"].long(), batch["cuts"].long()
        L = int(self.max_length)
        offs = store["offsets"][rows]
        starts = torch.clamp(cuts - L, min=0)
        m = cuts - starts
        t = torch.arange(L, device=rows.device)
        valid = t[None, :] < m[:, None]
        flat = torch.where(valid, offs[:, None] + starts[:, None] + t[None, :], 0)
        item_ids = torch.where(valid, store["items"][flat], 0)
        cols = [item_ids[..., None]]
        if self.use_ratings_features:
            cols.append(torch.where(valid, self.n_items + store["rating_buckets"][flat], 0)[..., None])
        if "mf_table" in store:
            cols.append(torch.where(valid[..., None], store["mf_table"][item_ids.long()], -1))
        if "uf_table" in store:
            u_feats = store["uf_table"][store["row_user"][rows]]  # [B, user slots]
            cols.append(torch.where(valid[..., None], u_feats[:, None, :], -1))
        ids = torch.cat(cols, dim=-1) if len(cols) > 1 else cols[0]
        mask = valid.float()
        targets = store["items"][offs + cuts]
        out = {"ids": ids, "mask": mask, "targets": targets, "target_pop": store["pop_db"][targets.long()],
               "targets_in_catalog": True}
        if self.n_feature_slots > 1:
            out["id_mask"] = mask[..., None].expand(ids.shape).contiguous()
        for key, v in batch.items():
            if key not in ("rows", "cuts"):
                out[key] = v  # the per-step extras pass through
        return out

    def _finalize_packed_batch(self, packed: dict, target_ratings) -> dict:
        """Model hook: loss-specific fields of a packed batch."""
        packed["target_pop"] = np.ones(len(packed["targets"]), dtype=np.float32)
        return packed

    _WIRE_ID_KEYS = ("ids", "targets", "seen_ids", "target_ids")

    def _compact_wire(self, packed: dict, prefix_lengths) -> dict:
        packed.pop("mask", None)
        packed.pop("id_mask", None)
        packed["lengths"] = prefix_lengths.astype(np.int32)
        if self._input_size() + 1 < np.iinfo(np.int16).max:
            for key in self._WIRE_ID_KEYS:
                if key in packed and packed[key].dtype == np.int32:
                    packed[key] = packed[key].astype(np.int16)
        return packed

    def _gen_mini_batch(self, sequence_generator, test=False, max_reuse_sequence=np.inf):
        """Per-sequence batches (``base.py:_gen_mini_batch``), the path the
        noise and target flags take; draws from the model's generator."""
        while True:
            j = 0
            sequences = []
            batch_size = 1 if test else self.batch_size
            while j < batch_size:
                sequence, user_id = next(sequence_generator)
                if not test:
                    n_cuts = int(min(batch_size - j, len(sequence) - 2, max_reuse_sequence))
                    if n_cuts <= 0:
                        continue
                    seq_lengths = sorted(
                        self.rng.choice(np.arange(2, len(sequence)), size=n_cuts, replace=False).tolist()
                    )
                else:
                    seq_lengths = [int(len(sequence) / 2)]
                skipped_seq = 0
                for l in seq_lengths:
                    target = self.target_selection(sequence[l:], test=test)
                    if len(target) == 0:
                        skipped_seq += 1
                        continue
                    start = max(0, l - self.max_length)
                    sequences.append([user_id, sequence[start:l], target])
                j += len(seq_lengths) - skipped_seq
            if test:
                yield self._prepare_input(sequences), [i[0] for i in sequence[seq_lengths[0] :]]
            else:
                yield self._prepare_input(sequences)

    def _prepare_input(self, sequences) -> dict:  # pragma: no cover
        """sequences: list of [user_id, input_sequence, targets] -> batch."""
        raise NotImplementedError

    def _device_batch(self, batch: dict) -> dict:
        """Upload a host batch (``_tensor_async``) and finish it on the
        device (``_finish_device_batch``)."""
        out = {key: int(val) if key in self._HOST_KEYS else self._tensor_async(val) for key, val in batch.items()}
        return self._finish_device_batch(out)

    def _finish_device_batch(self, out: dict) -> dict:
        """The compact wire's prefix lengths become the [B, L] mask (and its
        [B, L, F] broadcast); the id fields become int64."""
        if "lengths" in out:
            lengths = out.pop("lengths")
            ids = out["ids"]
            mask = (torch.arange(ids.shape[-2], device=ids.device) < lengths[:, None]).float()
            out["mask"] = mask
            if self.n_feature_slots > 1:
                out["id_mask"] = mask[..., None].expand(ids.shape).contiguous()
        for key in self._DEVICE_ID_KEYS:
            if key in out:
                out[key] = out[key].long()
        return out

    # id fields a model's batches may carry (CCE: targets; the sampled head:
    # targets and samples; the margin head: target_ids and seen_ids)
    _DEVICE_ID_KEYS = ("targets", "samples", "target_ids", "seen_ids")
    # per-step seeds of device-side draws, kept as Python ints (a seed is
    # read on the host, so it is never uploaded)
    _HOST_KEYS: tuple = ()

    # ------------------------------------------------------------------
    # the prefetch threads and the K-step payloads
    # ------------------------------------------------------------------
    @staticmethod
    def _prefetch(generator, depth: int = 4):
        """Run ``generator`` on a background thread, ``depth`` items ahead
        (``base.py:_prefetch``). An error of the producer reaches the
        consumer (it must not look like the end of the data); closing the
        returned generator sets a stop flag that the producer checks
        between bounded puts, and the producer closes its upstream
        generator when it ends, so nested stages (assembly, then transfer)
        release their threads one after another."""
        q: queue.Queue = queue.Queue(maxsize=depth)
        sentinel = object()
        stop = threading.Event()
        error: list = []

        def producer():
            try:
                for item in generator:
                    while not stop.is_set():
                        try:
                            q.put(item, timeout=0.2)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
            except Exception as exc:
                error.append(exc)
            finally:
                # this thread iterates the upstream generator, so it is
                # suspended here and close() is safe
                try:
                    generator.close()
                except Exception:
                    pass
                while not stop.is_set():
                    try:
                        q.put(sentinel, timeout=0.2)
                        break
                    except queue.Full:
                        continue

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    if error:
                        raise error[0]
                    return
                yield item
        finally:
            stop.set()

    @staticmethod
    def _with_epochs(gen, training_set):
        """Tag each batch with the training set's epoch count as of its
        assembly: the prefetch thread runs ahead of the steps, so the
        count at checkpoint time would depend on how far it got. The
        consumers keep the last tag in ``_pipeline_epochs``."""
        for b in gen:
            b["_epochs"] = float(training_set.epochs)
            yield b

    def _transfer(self, payload: dict, copies=None) -> dict:
        """Start the upload of a [K, ...] payload: ``{"dev": tensors,
        "host": arrays of _HOST_KEYS}``. On the card each array is copied
        into pinned memory and uploaded ``non_blocking`` on the stream
        ``copies`` (the current stream if None); ``"ready"`` is an event
        after the copies and ``"pinned"`` the host buffers, which must live
        until that event has passed (the payload pipeline holds them so;
        the caching host allocator, which records the copies, guards them
        too)."""
        host = {key: np.asarray(payload.pop(key)) for key in self._HOST_KEYS if key in payload}
        if self.device.type != "cuda":
            dev = {key: torch.from_numpy(np.ascontiguousarray(v)) for key, v in payload.items()}
            return {"dev": dev, "host": host, "ready": None, "pinned": []}
        pinned = [torch.from_numpy(np.ascontiguousarray(v)).pin_memory() for v in payload.values()]
        with torch.cuda.stream(copies) if copies is not None else contextlib.nullcontext():
            dev = {key: p.to(self.device, non_blocking=True) for key, p in zip(payload, pinned)}
            ready = torch.cuda.Event()
            ready.record()
        return {"dev": dev, "host": host, "ready": ready, "pinned": pinned}

    def _gen_dispatch_payloads(self, batch_gen, K: int):
        """Stack K wire batches at a time and start their upload
        (``base.py:_gen_dispatch_payloads``)."""
        while True:
            batches = []
            for _ in range(K):
                try:
                    batches.append(next(batch_gen))
                except StopIteration:
                    return
            yield self._transfer({key: np.stack([b[key] for b in batches]) for key in batches[0]})

    def _payload_pipeline(self, training_set, rng, K: int, depth: int = 2):
        """The K-step payloads in two overlapped stages
        (``base.py:_payload_pipeline``): an assembly thread (the index
        wire's cut sampler and extras where the model takes it, else the
        packed batcher at ``n_stack=K``) and a transfer thread that keeps
        this rank's rows under a mesh and uploads each payload on a copy
        stream of its own, so assembly, upload and the device's steps
        overlap. The index store is uploaded whole to every rank."""
        if self._index_batching_ok():
            self._dev_store = self._upload_index_store(training_set)
            gen = self._gen_index_mini_batch(training_set, rng, n_stack=K)
        else:
            gen = self._gen_packed_mini_batch(training_set, rng, n_stack=K)
        host = self._prefetch(self._with_epochs(gen, training_set), depth=depth)

        def transfer(upstream):
            # a generator function (not a genexp), so closing this stage
            # closes the upstream prefetch too
            copies = torch.cuda.Stream(device=self.device) if self.device.type == "cuda" else None
            inflight: collections.deque = collections.deque()
            try:
                for p in upstream:
                    ep = p.pop("_epochs", None)
                    while inflight and inflight[0][0].query():
                        inflight.popleft()  # its copies are done: its pinned buffers may go
                    if self.mesh is not None:  # this rank's rows: host slicing, no collective
                        p = (mesh_lib.index_payload_rows if "rows" in p else mesh_lib.stacked_rows)(p, self.mesh)
                    p = self._transfer(p, copies)
                    pinned = p.pop("pinned")
                    if p["ready"] is not None:
                        inflight.append((p["ready"], pinned))
                    p["_epochs"] = ep
                    yield p
            finally:
                upstream.close()
                for ev, _ in inflight:
                    ev.synchronize()

        return self._prefetch(transfer(host), depth=depth)

    # ------------------------------------------------------------------
    # optimizer steps
    # ------------------------------------------------------------------
    def _loss(self, batch):  # pragma: no cover
        """Scalar training cost of a device batch."""
        raise NotImplementedError

    def _train_params(self) -> list:
        return list(self.net.parameters())

    # ------------------------------------------------------------------
    # lazy (slice-sparse) Adam for catalog-indexed tables
    # ------------------------------------------------------------------
    # models that replace the recurrent tower (FISMCluster, SDAE) opt out
    lazy_table_ok = True

    def _resolve_lazy_path(self):
        """Path of the catalog-indexed input table (the embedding, else the
        first layer's ``W_in``), or None without ``--lazy_updates``. Its
        gradient is nonzero only on the rows the batch names."""
        if not self.lazy_updates:
            return None
        if not self.lazy_table_ok:
            raise ValueError(f"--lazy_updates: {type(self).__name__} has no recurrent-tower input table")
        if not isinstance(self.updater, Adam):
            raise ValueError("--lazy_updates is implemented for adam only")
        rl = self.recurrent_layer
        if rl.embedding_size > 0:
            return ("tower", "embedding")
        if rl.bidirectional:
            raise ValueError("--lazy_updates: bidirectional towers have two input tables (fwd/bwd); not supported")
        return ("tower", "layer0_fwd", "W_in")

    def _resolve_lazy_specs(self):
        """Lazy-update specs ``{"path", "axis", "ids"}``: the parameter, the
        axis its touched slices lie on, and a function of the device batch
        giving the global batch's touched indices (under a mesh, every data
        rank's, ``_data_ids``). Here the input table's rows; heads whose
        output gradient is sparse too override this (RNNSampling)."""
        path = self._resolve_lazy_path()
        if path is None:
            return None
        return [{"path": path, "axis": 0, "ids": lambda b: self._data_ids(b["ids"])}]

    @torch.no_grad()
    def _lazy_adam_update(self, table, state, dense_grad, ids, axis):
        """One Adam step on the slices of ``table`` (rows for ``axis=0``,
        columns for ``axis=1``) that ``ids`` names, in place; ``state``
        holds the spec's moments ``m``, ``v`` and its step ``count``.

        TF LazyAdam: untouched slices neither decay nor move, and the bias
        correction uses the spec's own count. Duplicate ids gather the same
        gradient slice and so write the same bits: a scatter-set
        (``index_copy_``) needs no dedup. Negative ids (padded feature
        slots, another shard's slices) drop out: they are pointed at the
        first valid id, whose value they then write again; where no id is
        valid (a shard that the batch does not touch) every slot points at
        slice 0 and writes its own values back. Both choices stay on the
        device: the step never syncs the host."""
        u = self.updater
        f32 = torch.float32
        lr = torch.tensor(u.learning_rate, dtype=f32)
        b1 = torch.tensor(u.beta1, dtype=f32)
        b2 = torch.tensor(u.beta2, dtype=f32)
        flat = ids.reshape(-1).long()
        valid = flat >= 0
        any_valid = valid.any()
        # index_select keeps the first valid id on the device (a 0-dim index would sync)
        first = flat.index_select(0, torch.argmax(valid.int()).reshape(1))
        idx = torch.where(valid, flat, torch.where(any_valid, first, 0))

        def take(a):
            return a.index_select(axis, idx)

        def keep(new, old):
            return torch.where(any_valid, new, old)

        g = take(dense_grad)
        m_old, v_old, t_old = take(state["m"]), take(state["v"]), take(table)
        m_new = b1 * m_old + (1.0 - b1) * g
        v_new = b2 * v_old + (1.0 - b2) * g * g
        state["count"] += 1
        t = torch.tensor(state["count"], dtype=f32)
        m_hat = m_new / (1.0 - b1**t)
        v_hat = v_new / (1.0 - b2**t)
        upd = -lr * m_hat / (torch.sqrt(v_hat) + 1e-8)
        table.index_copy_(axis, idx, keep(t_old + upd, t_old))
        state["m"].index_copy_(axis, idx, keep(m_new, m_old))
        state["v"].index_copy_(axis, idx, keep(v_new, v_old))

    def _shard_ids(self, key: str, ids, n_local: int):
        """Global slice ids of parameter ``key`` as indices into this
        rank's shard of ``n_local`` slices; an id outside the shard becomes
        -1, which the lazy update drops (the JAX package's ``mode="drop"``).
        Unchanged where the parameter is whole here."""
        start = self._shard_start(key)
        if start is None:
            return ids
        local = ids.long() - start
        return torch.where((local >= 0) & (local < n_local), local, -1)

    def _init_opt_state(self) -> dict:
        """The updater's state over every parameter, or, with lazy specs, a
        composite: the updater's state over the other parameters
        (``inner``) and per spec its parameter's index, its moments and
        its count (``lazy``)."""
        params = self._train_params()
        specs = self._resolve_lazy_specs()
        if not specs:
            return self.updater.init(params)
        index = {name: i for i, (name, _) in enumerate(self.net.named_parameters())}
        lazy = []
        for sp in specs:
            i = index[".".join(sp["path"])]
            zeros = torch.zeros_like(params[i])
            lazy.append({"spec": sp, "param": i, "m": zeros, "v": zeros.clone(), "count": 0})
        taken = {entry["param"] for entry in lazy}
        inner = self.updater.init([p for i, p in enumerate(params) if i not in taken])
        return {"inner": inner, "lazy": lazy}

    def _updater_layout(self, state, names) -> list:
        """(holder, key, parameter) of each leaf of the updater's ``state``
        over the parameters ``names`` (state-dict keys), in optax's leaf
        order: Adam's step count first (its parameter None), then each slot
        (``updater.slots``, the order of optax's state fields) over the
        parameters in the sorted path order of
        ``jax.tree_util.tree_leaves``."""
        order = sorted(range(len(names)), key=lambda i: names[i].split("."))
        refs = [(state, "count", None)] if self.updater.count_leaf else []
        for slot in self.updater.slots:
            refs.extend((state[slot], i, names[i]) for i in order)
        return refs

    def _opt_refs(self, state) -> list:
        """(holder, key, parameter) of each leaf of the optimizer state in
        the order of the JAX package's ``tree_leaves(opt_state)``: the
        updater's leaves, and with lazy specs ``(inner state, ((m, v,
        count) per spec))``. A moment names the parameter (state-dict key)
        whose layout it shares, under a mesh its shard; a count None."""
        names = [name for name, _ in self.net.named_parameters()]
        if "lazy" not in state:
            return self._updater_layout(state, names)
        taken = {entry["param"] for entry in state["lazy"]}
        refs = self._updater_layout(state["inner"], [n for i, n in enumerate(names) if i not in taken])
        for entry in state["lazy"]:
            name = names[entry["param"]]
            refs += [(entry, "m", name), (entry, "v", name), (entry, "count", None)]
        return refs

    def _opt_layout(self, state) -> list:
        """(holder, key) of each leaf of the optimizer state (``_opt_refs``)."""
        return [(holder, key) for holder, key, _ in self._opt_refs(state)]

    def _opt_leaves(self) -> list:
        """The optimizer state as the JAX package's ``opt`` leaves: tensors,
        and int32 scalars for the step counts; under a mesh each sharded
        moment (the lazy specs' too) gathered like its parameter (a
        collective)."""
        refs = self._opt_refs(self.opt_state)
        leaves = [
            np.asarray(holder[key], dtype=np.int32) if isinstance(holder[key], int) else holder[key]
            for holder, key, _ in refs
        ]
        if self.mesh is not None:
            leaves = [
                leaf if name is None else mesh_lib.gather_params({name: leaf}, self._param_specs, self.mesh)[name]
                for (_, _, name), leaf in zip(refs, leaves)
            ]
        return leaves

    def _opt_state_from_leaves(self, leaves) -> dict:
        """The optimizer state of ``opt`` leaves in the JAX package's order,
        each checked against a fresh state's shape and dtype."""
        state = self._init_opt_state()
        refs = self._opt_refs(state)
        if len(leaves) != len(refs):
            raise ValueError(f"the checkpoint has {len(leaves)} optimizer leaves, this optimizer {len(refs)}")
        for i, ((holder, key, name), leaf) in enumerate(zip(refs, leaves)):
            if isinstance(holder[key], int):
                holder[key] = int(np.asarray(leaf))
                continue
            t = leaf if isinstance(leaf, torch.Tensor) else torch.from_numpy(np.array(leaf))
            if self.mesh is not None:  # a full moment: this rank's shard of it
                t = mesh_lib.shard_params({name: t}, self._param_specs, self.mesh)[name]
            want = holder[key]
            if t.shape != want.shape or t.dtype != want.dtype:
                raise ValueError(
                    f"optimizer leaf {i}: {t.dtype} {tuple(t.shape)} in the checkpoint, "
                    f"{want.dtype} {tuple(want.shape)} here"
                )
            holder[key] = t.to(want.device)
        return state

    def _step(self, dev_batch: dict) -> torch.Tensor:
        """One optimizer step on a device batch: autograd, the updater's
        in-place step (and the lazy Adam where it applies); returns the
        cost as a device scalar, without a host sync."""
        if self.opt_state is None:
            self.opt_state = self._init_opt_state()
        params = self._train_params()
        cost = self._loss(dev_batch)
        grads = torch.autograd.grad(cost, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        cost = cost.detach()
        names = [name for name, _ in self.net.named_parameters()]
        shards = None
        if self.mesh is not None:
            # each data rank's loss is the mean over its rows: the mean over
            # "data" of the gradients (and of the cost) is the global one
            # (parallel/collectives.py)
            mean_over_data(grads + [cost], self.mesh)
            shards = [self._shard_layout(name, p.shape) for name, p in zip(names, params)]
        lazy = self.opt_state.get("lazy")
        if not lazy:
            self.updater.step(params, grads, self.opt_state, shards)
            return cost
        taken = {entry["param"] for entry in lazy}
        rest = [i for i in range(len(params)) if i not in taken]
        self.updater.step([params[i] for i in rest], [grads[i] for i in rest], self.opt_state["inner"],
                          None if shards is None else [shards[i] for i in rest])
        for entry in lazy:
            sp, i = entry["spec"], entry["param"]
            ids = self._shard_ids(names[i], sp["ids"](dev_batch), params[i].shape[sp["axis"]])
            self._lazy_adam_update(params[i], entry, grads[i], ids, sp["axis"])
        return cost

    def train_function(self, batch):
        """One optimizer step on a host batch; returns the batch cost as a
        device scalar (the loop syncs only at progress checkpoints)."""
        ep = batch.pop("_epochs", None)
        if ep is not None:
            self._pipeline_epochs = float(ep)
        return self._step(self._device_batch(batch))

    def train_function_multi(self, batches: list) -> torch.Tensor:
        """``len(batches)`` optimizer steps as one K-step payload (the host
        batches stacked on a leading axis); returns the summed cost."""
        return self.train_function_stacked(next(self._gen_dispatch_payloads(iter(batches), len(batches))))

    def train_function_stacked(self, payload: dict) -> torch.Tensor:
        """K optimizer steps on an uploaded [K, ...] payload (``_transfer``),
        the JAX package's ``lax.scan``: the current stream waits for the
        payload's copies, then the K steps are enqueued back to back on its
        slices ``payload[k]`` (an index-wire payload's batches assembled
        from the resident store) with no host sync between them, and their
        costs are summed on the device. ``_HOST_KEYS`` are read from the
        payload's host copy."""
        ep = payload.pop("_epochs", None)
        if ep is not None:
            self._pipeline_epochs = float(ep)
        dev, host = payload["dev"], payload["host"]
        if payload["ready"] is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(payload["ready"])
            for t in dev.values():
                t.record_stream(stream)  # allocated on the copy stream
        K = len(next(iter(dev.values())))
        cost_sum = None
        for k in range(K):
            step = {key: v[k] for key, v in dev.items()}
            step.update({key: int(v[k]) for key, v in host.items()})
            if "rows" in step:
                step = self._expand_index_wire(step, self._dev_store)
            cost = self._step(self._finish_device_batch(step))
            cost_sum = cost if cost_sum is None else cost_sum + cost
        return cost_sum

    # ------------------------------------------------------------------
    # validation and the training loop (contract of rnn_base.py:215-356)
    # ------------------------------------------------------------------
    def _compute_validation_metrics(self, metrics):
        ev = evaluation.Evaluator(self.dataset, k=10)
        # the validation inputs are the same at every checkpoint: encode and
        # upload them once, unless --rand_test_target randomizes the goals
        cacheable = self.target_selection.determinist_test
        if not cacheable or getattr(self, "_val_cache", None) is None:
            instances = list(self._iter_test_instances(self.dataset.validation_set(epochs=1)))
            staged = (
                self._stage_eval_inputs(
                    [seq for seq, _, _ in instances], user_ids=[u for _, _, u in instances]
                )
                if instances
                else []
            )
            if cacheable:
                self._val_cache = (instances, staged)
        else:
            instances, staged = self._val_cache
        if not instances:
            for name in self.metrics:
                metrics[name].append(0.0)
            return metrics
        recs = self._topk_from_staged(staged, k=10)
        for (_, goal, _), rec in zip(instances, recs):
            ev.add_instance(goal, rec.tolist())
        metrics["recall"].append(ev.average_recall())
        metrics["sps"].append(ev.sps())
        metrics["ndcg"].append(ev.average_ndcg())
        metrics["user_coverage"].append(ev.user_coverage())
        metrics["item_coverage"].append(ev.item_coverage())
        metrics["blockbuster_share"].append(ev.blockbuster_share())
        return metrics

    def get_pareto_front(self, metrics, metrics_names):
        costs = np.zeros((len(metrics[metrics_names[0]]), len(metrics_names)))
        for i, m in enumerate(metrics_names):
            costs[:, i] = np.array(metrics[m]) * self.metrics[m]["direction"]
        is_efficient = np.ones(costs.shape[0], dtype=bool)
        for i, c in enumerate(costs):
            if is_efficient[i]:
                is_efficient[is_efficient] = np.any(costs[is_efficient] >= c, axis=1)
        return np.where(is_efficient)[0].tolist()

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
        if len(set(validation_metrics) & set(self.metrics.keys())) < len(validation_metrics):
            raise ValueError(
                "Incorrect validation metrics. Metrics must be chosen among: "
                + ", ".join(self.metrics.keys())
            )
        if not self._has_params:
            self.params_from_numpy(self._init_params())

        iterations = 0
        epochs_offset = 0
        if load_last_model:
            epochs_offset = self.load_last(save_dir)
        if self.opt_state is None:
            self.opt_state = self._init_opt_state()

        # K-step payloads need the packed batcher's fixed shapes; K counts
        # the optimizer steps of one loop iteration in all the accounting. A
        # mesh run always takes the stacked pipeline, even at K = 1, where
        # each rank keeps its rows of a payload
        use_stacked = self._fast_batching_ok() and (self.steps_per_dispatch > 1 or self.mesh is not None)
        K = self.steps_per_dispatch if self._fast_batching_ok() else 1
        if self._fast_batching_ok():
            # packed batches assembled on a prefetch thread, with a generator
            # of their own (numpy Generators are not thread-safe)
            batch_rng = np.random.default_rng(self.seed + 77)
            if use_stacked:
                batch_generator = self._payload_pipeline(dataset.training_set, batch_rng, K)
            else:
                batch_generator = self._prefetch(
                    self._with_epochs(self._gen_packed_mini_batch(dataset.training_set, batch_rng),
                                      dataset.training_set)
                )
        else:
            batch_generator = self._gen_mini_batch(self.sequence_noise(dataset.training_set()))
            if self.mesh is not None:
                batch_generator = (mesh_lib.batch_rows(b, self.mesh) for b in batch_generator)

        start_time = time()
        next_save = int(progress)
        train_costs = []
        cost_sum = None  # device-side running sum: one host pull per checkpoint
        cost_count = 0
        # the epochs of the last consumed batch (its assembly tag); the
        # training set's own count runs ahead with the prefetch thread and
        # is read only on the synchronous per-sequence path
        self._pipeline_epochs = None
        epochs = []
        metrics = {name: [] for name in self.metrics.keys()}
        filename = {}
        try:
            while time() - start_time < max_time and iterations < max_iter:
                try:
                    if use_stacked:
                        cost = self.train_function_stacked(next(batch_generator))
                    else:
                        cost = self.train_function(next(batch_generator))
                except StopIteration:
                    break
                cost_sum = cost if cost_sum is None else cost_sum + cost
                cost_count += K
                iterations += K
                progress_indicator = int(time() - start_time) if time_based_progress else iterations

                if progress_indicator >= next_save:
                    if progress_indicator >= min_iterations:
                        consumed = (
                            self._pipeline_epochs if self._pipeline_epochs is not None
                            else dataset.training_set.epochs
                        )
                        epochs.append(epochs_offset + consumed)
                        mean_cost = float(cost_sum) / max(cost_count, 1)
                        if np.isnan(mean_cost):
                            raise ValueError("Cost is NaN")
                        train_costs.append(mean_cost)
                        cost_sum, cost_count = None, 0
                        metrics = self._compute_validation_metrics(metrics)
                        self._print_progress(
                            iterations, epochs[-1], start_time, train_costs, metrics, validation_metrics
                        )
                        run_nb = len(metrics[list(self.metrics.keys())[0]]) - 1
                        if autosave == "All":
                            filename[run_nb] = save_dir + self._get_model_filename(round(epochs[-1], 3))
                            self.save(filename[run_nb], async_write=True)
                        elif autosave == "Best":
                            pareto_runs = self.get_pareto_front(metrics, validation_metrics)
                            if run_nb in pareto_runs:
                                filename[run_nb] = save_dir + self._get_model_filename(round(epochs[-1], 3))
                                to_delete = [r for r in filename if r not in pareto_runs and r != run_nb]
                                if to_delete:
                                    # a dethroned checkpoint may still be queued: let
                                    # every write land before deleting, and before
                                    # queueing the new one (which need not wait)
                                    self._drain_saves()
                                for run in to_delete:
                                    if writes_files():
                                        try:
                                            os.remove(filename[run])
                                        except OSError:
                                            print("Warning : Previous model could not be deleted")
                                    del filename[run]
                                self.save(filename[run_nb], async_write=True)
                        if early_stopping is not None and all(
                            early_stopping(epochs, metrics[m]) for m in validation_metrics
                        ):
                            break
                    # catch up past the current indicator (iterations move by
                    # K a dispatch, and a slow validation pass can overshoot
                    # a time-based schedule)
                    while next_save <= progress_indicator:
                        if isinstance(progress, int):
                            next_save += min(progress, max_progress_interval)
                        else:
                            next_save += min(max_progress_interval, next_save * (progress - 1))
        except KeyboardInterrupt:
            print("Training interrupted")
        finally:
            # release the prefetch threads (a no-op on the synchronous path)
            batch_generator.close()
            # every queued write lands before train returns (callers read the
            # files at once); a writer's error is raised, unless another
            # exception (the NaN abort) is already on its way out
            aborting = sys.exc_info()[0] is not None
            try:
                self._drain_saves()
            except Exception as save_exc:
                if not aborting:
                    raise
                print(f"Warning: async checkpoint write failed during abort: {save_exc}", file=sys.stderr)

        if not metrics[validation_metrics[0]]:
            # no checkpoint was reached before the iteration/time budget ran out
            return ({m: None for m in self.metrics}, time() - start_time, None)
        best_run = np.argmax(
            np.array(metrics[validation_metrics[0]]) * self.metrics[validation_metrics[0]]["direction"]
        )
        return (
            {m: metrics[m][best_run] for m in self.metrics.keys()},
            time() - start_time,
            filename.get(best_run),
        )

    def _print_progress(self, iterations, epochs, start_time, train_costs, metrics, validation_metrics):
        print(self.name, iterations, "batchs, ", epochs, " epochs in", time() - start_time, "s")
        # training throughput since the previous checkpoint (sequences/s)
        now = time()
        last_iters, last_time = getattr(self, "_tp_mark", (0, start_time))
        if iterations > last_iters and now > last_time:
            # an LTM iteration is one epoch (no batch_size): 1 a step
            rate = (iterations - last_iters) * getattr(self, "batch_size", 1) / (now - last_time)
            print("Throughput : ", round(rate, 1), " sequences/s")
        self._tp_mark = (iterations, now)
        print("Last train cost : ", train_costs[-1])
        for m in self.metrics:
            print(m, ": ", metrics[m][-1])
            if m in validation_metrics:
                print(
                    "Best ", m, ": ",
                    max(np.array(metrics[m]) * self.metrics[m]["direction"]) * self.metrics[m]["direction"],
                )
        print("-----------------")
        # machine-readable TSV progress on stderr (rnn_base.py:434)
        print(
            iterations, epochs, time() - start_time, train_costs[-1],
            " ".join(str(metrics[m][-1]) for m in self.metrics),
            file=sys.stderr,
        )

    # ------------------------------------------------------------------
    # checkpoints (parity with rnn_base.py:470-515)
    # ------------------------------------------------------------------
    # True writes exact-resume checkpoints (the optimizer state too); the
    # reference never saves optimizer state, so the default is False
    save_optimizer_state = False

    def save(self, filename: str, async_write: bool = False) -> None:
        """Write the JAX package's ``.npz`` checkpoint (``{"params": ...}``,
        and ``"opt"`` with ``save_optimizer_state``; path-encoded keys).
        Synchronous by default: on disk when this returns.

        The training loop's autosaves pass ``async_write=True``: the
        optimizers update the parameters in place, so the parameters (and
        optimizer leaves) are copied on the device, on the current stream,
        before the next step can change them; a CUDA event recorded after
        the copies lets a worker thread wait for them before its host copy
        and npz write. ``train`` drains the queue before it returns.

        Under a mesh every rank gathers the full tree (a collective, in
        program order) and only the rank with ``LOCAL_RANK`` 0 writes; on
        more than one rank the save is synchronous."""
        print("Save model in " + filename)
        opt = self.save_optimizer_state and self.opt_state is not None
        if not async_write or (self.mesh is not None and self.mesh.size > 1):
            tree = {"params": self.params_to_numpy()}
            if opt:
                tree["opt"] = {str(i): leaf for i, leaf in enumerate(self._opt_leaves())}
            if writes_files():
                pytree_save(filename, tree)
            return
        with torch.no_grad():
            snap = {key: t.detach().clone() for key, t in self.net.state_dict().items()}
            opt_leaves = [leaf.clone() if isinstance(leaf, torch.Tensor) else leaf
                          for leaf in self._opt_leaves()] if opt else None
        ready = None
        if self.device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record()
        self._save_executor_submit(filename, snap, opt_leaves, ready)

    def _save_executor_submit(self, filename, snap, opt_leaves, ready) -> None:
        if not hasattr(self, "_save_queue"):
            # at most two snapshots queued: each pins a device copy of the
            # parameters; a third save waits (degrades to a synchronous save)
            q: queue.Queue = queue.Queue(maxsize=2)
            errbox: list = []

            # the worker closes over (q, errbox) only: a reference to self
            # would keep the model alive as long as the thread
            def worker():
                copies = None
                while True:
                    item = q.get()
                    if item is None:
                        q.task_done()
                        return
                    fname, params, opts, event = item
                    try:
                        ctx = contextlib.nullcontext()
                        if event is not None:
                            event.synchronize()
                            # host copies on a stream of their own, so they do
                            # not queue behind the training steps since
                            if copies is None:
                                copies = torch.cuda.Stream(device=next(iter(params.values())).device)
                            ctx = torch.cuda.stream(copies)
                        with ctx:
                            tree = {"params": _unflatten(params)}
                            if opts is not None:
                                tree["opt"] = {str(i): leaf for i, leaf in enumerate(opts)}
                            pytree_save(fname, tree)
                    except Exception as exc:  # raised by _drain_saves
                        errbox.append(exc)
                    finally:
                        q.task_done()

            t = threading.Thread(target=worker, daemon=True)
            t.start()
            self._save_queue, self._save_errbox, self._save_thread = q, errbox, t
        self._save_queue.put((filename, snap, opt_leaves, ready))

    def _drain_saves(self) -> None:
        """Block until every queued checkpoint is on disk, stop the worker
        thread (a later save starts a new one) and raise the first write
        error."""
        if hasattr(self, "_save_queue"):
            q, errbox, t = self._save_queue, self._save_errbox, self._save_thread
            del self._save_queue, self._save_errbox, self._save_thread
            q.join()
            q.put(None)
            t.join()
            if errbox:
                raise errbox[0]

    def load_last(self, save_dir: str) -> float:
        """Load the checkpoint of this configuration with the most epochs
        under ``save_dir``; returns its epoch count (0 if there is none)."""
        base = self._get_model_filename("*").replace("\\", "/").split("/")[-1]
        # the ``ne*`` wildcard must capture only the epoch number: the
        # filename scheme omits defaulted tokens, so the glob also matches
        # sibling configurations (``..._ne1.5_GRU_...`` for an LSTM)
        rx = re.compile(re.escape(base).replace(re.escape("*"), r"([0-9]+(\.[0-9]+)?)") + r"$")
        files = [
            f for f in glob.glob(save_dir + self._get_model_filename("*"))
            if rx.search(f.replace("\\", "/").split("/")[-1])
        ]
        if not files:
            print("No previous model, starting from scratch")
            return 0
        last_batch = max(float(re.search(r"_ne([0-9]+(\.[0-9]+)?)_", f).group(1)) for f in files)
        last_model = save_dir + self._get_model_filename(last_batch)
        print("Starting from model " + last_model)
        self.load(last_model)
        return last_batch

    # ------------------------------------------------------------------
    # filenames (parity with rnn_base.py:111-130)
    # ------------------------------------------------------------------
    def _common_filename(self, epochs) -> str:
        filename = (
            "ml"
            + str(self.max_length)
            + "_bs"
            + str(self.batch_size)
            + "_ne"
            + str(epochs)
            + "_"
            + self.recurrent_layer.name
            + "_"
            + self.updater.name
            + ("_lu" if self.lazy_updates else "")
            + "_"
            + self.target_selection.name
        )
        if self.sequence_noise.name != "":
            filename += "_" + self.sequence_noise.name
        if not self.interactions_are_unique:
            filename += "_ri"
        if not (self.use_ratings_features or self.use_movies_features or self.use_users_features):
            filename += "_nf"
        if self.use_ratings_features:
            filename += "_rf"
        if self.use_movies_features:
            filename += "_mf"
        if self.use_users_features:
            filename += "_uf"
        return filename

    def _get_model_filename(self, epochs):  # pragma: no cover
        raise NotImplementedError
