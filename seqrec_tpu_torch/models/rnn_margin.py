"""RNN with multi-target margin losses (hinge, logit, logsig).

Counterpart of ``seqrec_tpu/models/rnn_margin.py:RNNMargin``. Only the id
arrays of the targets and of the seen items cross to the device. Below
``STREAMING_MARGIN_MIN_ITEMS`` items the dense target (``Y``) and weight
(``W``) rows are built there by scatters into an ``n_items+1``-wide buffer
(the extra column takes the padded ids, which point at ``n_items``); at or
above it the loss runs through the streaming margin
(``ops/streaming_margin.py``), which keeps no [B, n_items] tensor. Both
are plain PyTorch: the JAX package leaves them to XLA.

Semantics kept:
- negative weight ``w = balance * |T| / (n_items - |T| - |seq|)``, with
  ``|seq|`` read from the mask;
- targets weigh -1 with Y = 1; seen items, when interactions are unique,
  weigh 0 with Y = 0 and override a target;
- default target 0, or the popularity-based
  ``min(1 - p, (1 - min_access) * p / min_access)``;
- the loss sums over the catalog and averages over the batch.

Serving ranks the raw logits, so evaluation goes through the fused score +
mask + top-k kernel K4.

Under a mesh whose "model" axis shards ``W_out``'s columns, the dense
margin runs on the rank's local predictions [B/D, N/M] with its slice of
the default targets, every id outside its columns (pads and the other
shards' items) scattered into the extra column, and the per-example
partials summed over "model"; the streaming head is
``sharded_streaming_margin``. ``w_neg`` keeps the whole catalog's size.
Both take ``--bf16``'s compute dtype, as on one device.
"""

from __future__ import annotations

import numpy as np
import torch

from seqrec_tpu_torch.models.base import RNNBase
from seqrec_tpu_torch.models.rnn_one_hot import OneHotNetwork
from seqrec_tpu_torch.ops import losses
from seqrec_tpu_torch.ops.streaming_margin import (
    STREAMING_MARGIN_MIN_ITEMS,
    pick_chunk,
    sharded_streaming_margin,
    streaming_margin,
)
from seqrec_tpu_torch.parallel.collectives import reduce_from_model


def dense_margin(predictions, tgt_ids, seen_ids, w_neg, default_target, loss_name: str, unique: bool):
    """Per-example margin loss [B] of the dense predictions [B, N]: Y and W
    scattered into [B, N+1] rows (int64 ids; padded ids point at N) from
    the defaults, targets (1, -1), then seen items (0, 0) when ``unique``.
    Scatters of a constant make duplicate ids idempotent."""
    B, n1 = predictions.shape[0], predictions.shape[1] + 1
    Y = torch.cat([default_target, default_target.new_zeros(1)]).expand(B, n1).clone()
    Y.scatter_(1, tgt_ids, 1.0)
    W = w_neg[:, None].expand(B, n1).clone()
    W.scatter_(1, tgt_ids, -1.0)
    if unique:
        Y.scatter_(1, seen_ids, 0.0)
        W.scatter_(1, seen_ids, 0.0)
    return losses.MARGIN_LOSSES[loss_name](predictions, Y[:, :-1], W[:, :-1])


def local_ids(ids, col0: int, n_local: int):
    """Global item ids as columns of the shard [col0, col0 + n_local); an id
    outside it (a pad, another shard's item) points at the extra column
    ``n_local``."""
    local = ids - col0
    return torch.where((local >= 0) & (local < n_local), local, n_local)


class RNNMargin(RNNBase):
    fused_eval_head = True
    # catalogs at least this large train through the streaming head
    streaming_min_items = STREAMING_MARGIN_MIN_ITEMS

    def __init__(
        self,
        loss_function: str = "hinge",
        balance: float = 1.0,
        popularity_based: bool = False,
        min_access: float = 0.05,
        **kwargs,
    ):
        super().__init__(**kwargs)
        self.balance = balance
        self.popularity_based = popularity_based
        self.min_access = min_access
        loss_function = loss_function or "hinge"
        if loss_function not in losses.MARGIN_LOSSES:
            raise ValueError("Unknown loss function")
        self.loss_function_name = loss_function
        self.name = "RNN multi-targets"

    def _get_model_filename(self, epochs) -> str:
        filename = "rnn_multitarget_" + self.loss_function_name + "_b" + str(self.balance)
        if self.popularity_based:
            filename += "_pb_ma" + str(self.min_access)
        return filename + "_" + self._common_filename(epochs)

    # ------------------------------------------------------------------
    def _prepare_networks(self, n_items: int) -> None:
        self.n_items = n_items
        self.net = OneHotNetwork(self.recurrent_layer, self._input_size(), n_items, self.device)

    def set_dataset(self, dataset) -> None:
        super().set_dataset(dataset)
        if self.popularity_based:
            view_prob = dataset.item_popularity / dataset.training_set.n_users
            default = np.minimum(1 - view_prob, (1 - self.min_access) * view_prob / self.min_access)
        else:
            default = np.zeros(self.n_items)
        self._default_target = default.astype(np.float32)
        self._default_target_dev = None

    def _init_params(self) -> dict:
        rng = self.rng
        tower = self.recurrent_layer.init_params(rng, self._input_size())
        h_out = self.recurrent_layer.output_size
        limit = np.sqrt(6.0 / (h_out + self.n_items))
        return {
            "tower": tower,
            "W_out": rng.uniform(-limit, limit, size=(h_out, self.n_items)).astype(np.float32),
            "b_out": np.zeros(self.n_items, dtype=np.float32),
        }

    # ------------------------------------------------------------------
    def _use_streaming_head(self) -> bool:
        return self.n_items >= self.streaming_min_items

    def _default_target_of(self, batch):
        """The batch's default targets (the per-sequence batcher ships
        them) or the model's, uploaded once."""
        if "default_target" in batch:
            return batch["default_target"]
        if self._default_target_dev is None or self._default_target_dev.device != self.device:
            self._default_target_dev = torch.from_numpy(self._default_target).to(self.device)
        return self._default_target_dev

    def _loss(self, batch):
        net = self.net
        h = net.tower(batch["ids"], batch["mask"], batch.get("id_mask"), train=True)
        tgt_ids, seen_ids = batch["target_ids"], batch["seen_ids"]  # padded slots point at n_items
        t_count = batch["t_count"]
        w_neg = self.balance * t_count / (self.n_items - t_count - batch["mask"].sum(dim=1))
        default_target = self._default_target_of(batch)
        col0 = self._shard_start("W_out")  # None unless W_out is column-sharded
        unique = self.interactions_are_unique
        if col0 is not None:
            if self._use_streaming_head():
                per_ex = sharded_streaming_margin(h, net.W_out, net.b_out, tgt_ids, seen_ids, w_neg, default_target,
                                                  self.mesh, col0, self.loss_function_name, unique,
                                                  compute_dtype=self.compute_dtype)
                return per_ex.mean()
            n_local = net.W_out.shape[1]
            part = dense_margin(
                losses.sharded_out_matmul(h, net.W_out, net.b_out, self.mesh, self.compute_dtype),
                local_ids(tgt_ids, col0, n_local),
                local_ids(seen_ids, col0, n_local), w_neg, default_target[col0 : col0 + n_local],
                self.loss_function_name, unique,
            )
            return reduce_from_model(part, self.mesh).mean()
        if self._use_streaming_head():
            per_ex = streaming_margin(
                h, net.W_out, net.b_out, tgt_ids, seen_ids, w_neg, default_target,
                self.loss_function_name, self.interactions_are_unique, pick_chunk(self.n_items),
                compute_dtype=self.compute_dtype,
            )
            return per_ex.mean()
        return dense_margin(
            self._out_matmul(h, net.W_out, net.b_out), tgt_ids, seen_ids, w_neg, default_target,
            self.loss_function_name, self.interactions_are_unique,
        ).mean()

    def _scores(self, ids, id_mask, mask):
        return self._logits(ids, id_mask, mask)

    def _finalize_packed_batch(self, packed, target_ratings):
        B = len(packed["targets"])
        packed["target_ids"] = packed["targets"].reshape(B, 1)
        packed["t_count"] = np.ones(B, dtype=np.float32)
        packed["seen_ids"] = np.where(packed["mask"] > 0, packed["ids"][:, :, 0], self.n_items).astype(np.int32)
        del packed["targets"]
        return packed

    # index wire: every field (single-target ids, counts, seen-item sets)
    # derives on the device from (store, rows, cuts)
    index_wire_ok = True

    def _expand_index_wire(self, batch, store):
        out = super()._expand_index_wire(batch, store)
        B = out["targets"].shape[0]
        out["target_ids"] = out["targets"].reshape(B, 1)
        out["t_count"] = torch.ones(B, dtype=torch.float32, device=out["mask"].device)
        out["seen_ids"] = torch.where(out["mask"] > 0, out["ids"][:, :, 0], self.n_items).int()
        del out["targets"], out["target_pop"], out["targets_in_catalog"]
        return out

    def _prepare_input(self, sequences):
        ids, id_mask, mask = self._encode_sequences([s[1] for s in sequences], user_ids=[s[0] for s in sequences])
        B = len(sequences)
        T = max(1, self.target_selection.n_targets)
        target_ids = np.full((B, T), self.n_items, dtype=np.int32)
        t_count = np.zeros(B, dtype=np.float32)
        seen_ids = np.full((B, self.max_length), self.n_items, dtype=np.int32)
        for i, (_, in_seq, target) in enumerate(sequences):
            t = [int(x[0]) for x in target[:T]]
            target_ids[i, : len(t)] = t
            t_count[i] = len(t)
            s = [int(x[0]) for x in in_seq[: self.max_length]]
            seen_ids[i, : len(s)] = s
        batch = {
            "ids": ids,
            "mask": mask,
            "target_ids": target_ids,
            "t_count": t_count,
            "seen_ids": seen_ids,
            "default_target": self._default_target,
        }
        if id_mask is not None:
            batch["id_mask"] = id_mask
        return batch
