"""RNN-family base predictor, serving half: encoding, checkpoints, batched
masked top-k.

Counterpart of ``seqrec_tpu/models/base.py:RNNBase``. The predictor
protocol the test CLI relies on is kept — ``prepare_model(dataset)``,
``load``, ``set_dataset``, ``_iter_test_instances``,
``_stage_eval_inputs``/``_topk_from_staged``, ``top_k_recommendations``,
``metrics`` — and so are the filename scheme and the ``.npz`` checkpoint
format (path-encoded keys), so a checkpoint of either package loads in the
other. The network is an ``nn.Module`` (``self.net``) whose state-dict keys
are the JAX parameter paths with ``/`` replaced by ``.``.

Training (batching, the loop, optimizer steps, saving during training)
comes with the training slice of the port.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from seqrec_tpu_torch import resolve_device
from seqrec_tpu_torch.data.noise import SequenceNoise
from seqrec_tpu_torch.data.targets import SelectTargets
from seqrec_tpu_torch.models.recurrent import RecurrentLayers
from seqrec_tpu_torch.models.updates import Adagrad
from seqrec_tpu_torch.ops.core import masked_top_k
from seqrec_tpu_torch.ops.score_topk import fused_score_topk

# Defaults (reference rnn_base.py:24,32)
MAX_LENGTH = 200
BATCH_SIZE = 10

# npz cannot hold extension dtypes (ml_dtypes, e.g. bfloat16): the JAX
# package stores such a leaf as a same-width unsigned-int view with the
# dtype name after this marker in its key.
_DTYPE_MARK = "#dtype="


def pytree_save(filename: str, params) -> None:
    """Save a nested dict of arrays to an npz with path-encoded keys."""
    flat = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(prefix + (k,), v)
        else:
            flat["/".join(prefix)] = np.asarray(node)

    walk((), params)
    if os.path.dirname(filename):
        os.makedirs(os.path.dirname(filename), exist_ok=True)
    with open(filename, "wb") as f:
        np.savez(f, **flat)


def pytree_load(filename: str) -> dict:
    """Inverse of the JAX package's ``pytree_save``. ``ml_dtypes`` is
    imported only when an archive holds an extension-dtype leaf."""
    out: dict = {}
    with np.load(filename) as data:
        for key in data.files:
            arr = data[key]
            if _DTYPE_MARK in key or key.endswith("#bf16"):
                import ml_dtypes

                if _DTYPE_MARK in key:
                    key, _, name = key.partition(_DTYPE_MARK)
                else:  # legacy marker
                    key, name = key[: -len("#bf16")], "bfloat16"
                arr = arr.view(np.dtype(getattr(ml_dtypes, "bfloat16" if name == "bf16" else name)))
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


class RNNBase:
    """Base for sequence predictors (serving half)."""

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
        lazy_updates: bool = False,
        device="cuda",
    ):
        if use_movies_features or use_users_features:
            raise NotImplementedError("--mf/--uf come with a later slice of the port")
        self.sequence_noise = sequence_noise or SequenceNoise()
        self.recurrent_layer = recurrent_layer or RecurrentLayers()
        self.updater = updater or Adagrad()
        self.target_selection = target_selection or SelectTargets()
        self.interactions_are_unique = interactions_are_unique
        self.use_ratings_features = use_ratings_features
        self.max_length = max_length
        self.batch_size = batch_size
        self.seed = seed
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
        self.eval_batch_size = max(batch_size, 64)

    # ------------------------------------------------------------------
    # featurization: packed sparse ids per timestep
    # ------------------------------------------------------------------
    @property
    def n_feature_slots(self) -> int:
        """Static number of feature ids per timestep (F)."""
        return 1 + (1 if self.use_ratings_features else 0)

    def _input_size(self) -> int:
        # the rating one-hot occupies 10 id slots (rnn_base.py:578-593)
        return self.n_items + (10 if self.use_ratings_features else 0)

    def _feature_ids(self, item_id: int, rating: float):
        ids = [item_id]
        if self.use_ratings_features:
            bucket = int(round(rating * 2)) - 1
            ids.append(self.n_items + max(0, min(9, bucket)))
        return ids

    def _encode_sequences(self, seqs, user_ids=None):
        """Pack a list of [(item, rating), ...] into arrays: (ids [B,L,F]
        int32, id_mask [B,L,F] f32 or None, mask [B,L] f32)."""
        B, L, F = len(seqs), self.max_length, self.n_feature_slots
        ids = np.zeros((B, L, F), dtype=np.int32)
        mask = np.zeros((B, L), dtype=np.float32)
        for i, seq in enumerate(seqs):
            for t, (item, rating) in enumerate(seq[:L]):
                ids[i, t, :] = self._feature_ids(int(item), float(rating))
            mask[i, : min(len(seq), L)] = 1.0
        id_mask = None
        if F > 1:
            id_mask = np.broadcast_to(mask[:, :, None], ids.shape).astype(np.float32)
        return ids, id_mask, mask

    # ------------------------------------------------------------------
    # model lifecycle
    # ------------------------------------------------------------------
    def prepare_model(self, dataset) -> None:
        """Must be called before load, params_from_numpy or prediction."""
        self._prepare_networks(dataset.n_items)

    def _prepare_networks(self, n_items: int) -> None:  # pragma: no cover
        raise NotImplementedError

    def set_dataset(self, dataset) -> None:
        self.dataset = dataset
        self.target_selection.set_dataset(dataset)

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
        # np.require copies only leaves that are read-only or not C-contiguous
        state = {key: torch.from_numpy(np.require(arr, requirements="CW")) for key, arr in _flatten(tree)}
        self.net.load_state_dict(state, strict=True)
        return self.net

    def load(self, filename: str) -> None:
        tree = pytree_load(filename)
        if "params" not in tree:  # archives from before the opt-state split
            tree = {"params": tree}
        self.params_from_numpy(tree["params"])

    # ------------------------------------------------------------------
    # prediction
    # ------------------------------------------------------------------
    def _tensor(self, arr):
        return None if arr is None else torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

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
        ids, id_mask, mask = self._encode_sequences([seq])
        scores = self._scores(self._tensor(ids), self._tensor(id_mask), self._tensor(mask))
        scores = scores[0].cpu().numpy()
        if self.interactions_are_unique:
            scores[[int(i[0]) for i in sequence]] = -np.inf
        scores[list(exclude)] = -np.inf
        return list(np.argpartition(-scores, range(k))[:k])

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
        if not self.fused_eval_head:
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
        one padded with its last row) and upload them as the compact wire
        format; returns [(n_real_rows, (ids, lengths)), ...]."""
        chunk = self.eval_batch_size
        staged = []
        for c0 in range(0, len(inputs), chunk):
            batch = inputs[c0 : c0 + chunk]
            batch_p = batch + [batch[-1]] * (chunk - len(batch))
            ids, _, mask = self._encode_sequences(batch_p)
            lengths = mask.sum(axis=1).astype(np.int32)
            if self._input_size() + 1 < np.iinfo(np.int16).max:
                ids = ids.astype(np.int16)
            staged.append((len(batch), (self._tensor(ids), self._tensor(lengths))))
        return staged

    @torch.inference_mode()
    def _topk_from_staged(self, staged, k: int) -> np.ndarray:
        pending = [(n, self._topk_wire(ids, lengths, k)) for n, (ids, lengths) in staged]
        return np.concatenate([top[:n].cpu().numpy() for n, top in pending], axis=0)

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
        # "_nf" (no features) or "_rf"; --mf/--uf ("_mf", "_uf") are not ported yet
        filename += "_rf" if self.use_ratings_features else "_nf"
        return filename

    def _get_model_filename(self, epochs):  # pragma: no cover
        raise NotImplementedError
