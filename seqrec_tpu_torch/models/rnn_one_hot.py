"""RNN with full-catalog categorical cross-entropy (the parity flagship).

Counterpart of ``seqrec_tpu/models/rnn_one_hot.py``: the recurrent tower
feeds a dense output layer over the whole catalog, and the per-example CCE
is divided by ``target_popularity^diversity_bias``. Catalogs of
``STREAMING_CCE_MIN_ITEMS`` items or more train through the streaming CCE
(``ops/streaming_cce.py``, kernel K2; with ``--bf16`` its bf16 chunk
loop), smaller ones through the dense logits ``h W_out + b``
(``torch.matmul``, or bf16 operands with ``--bf16``, as the JAX package
leaves it to XLA). Regularization applies to the output bias only: L2 for a positive
value, L1 for a negative one. Ranking the raw logits ranks the softmax, so
batched evaluation goes through the fused score + seen-mask + top-k kernel
(``ops/score_topk.py``).

Under a mesh whose "model" axis shards ``W_out``'s columns (the catalog
divides it), the streaming head is ``sharded_streaming_cce`` (K2 on the
rank's columns; with ``--bf16`` the bf16 chunk loop there) and the dense
head ``losses.vocab_parallel_cce`` (its product in the compute dtype); the
``b_out`` penalty sums over the shards (``reduce_from_model``). A catalog
that does not divide the axis keeps ``W_out`` whole on every rank, and the
heads above run data-parallel.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from seqrec_tpu_torch.models.base import RNNBase
from seqrec_tpu_torch.models.recurrent import RecurrentLayers
from seqrec_tpu_torch.ops import losses
from seqrec_tpu_torch.ops.streaming_cce import STREAMING_CCE_MIN_ITEMS, sharded_streaming_cce, streaming_cce
from seqrec_tpu_torch.parallel.collectives import reduce_from_model


class OneHotNetwork(nn.Module):
    """Recurrent tower + dense output layer; state-dict keys
    ``tower.layer0_fwd.W_in``, ..., ``W_out``, ``b_out``. The logits are the
    model's ``_logits`` (``base.py:_out_matmul``, f32 or bf16 operands)."""

    def __init__(self, tower: RecurrentLayers, true_input_size: int, n_items: int, device):
        super().__init__()
        tower.build(true_input_size, device)
        self.tower = tower
        h_out = tower.output_size
        self.W_out = nn.Parameter(torch.empty((h_out, n_items), device=device))
        self.b_out = nn.Parameter(torch.empty((n_items,), device=device))


class RNNOneHot(RNNBase):
    def __init__(self, diversity_bias: float = 0.0, regularization: float = 0.0, **kwargs):
        super().__init__(**kwargs)
        self.diversity_bias = float(diversity_bias)
        self.regularization = float(regularization)
        self.name = "RNN with categorical cross entropy"

    def _get_model_filename(self, epochs) -> str:
        return (
            "rnn_cce_db"
            + str(self.diversity_bias)
            + "_r"
            + str(self.regularization)
            + "_"
            + self._common_filename(epochs)
        )

    def _prepare_networks(self, n_items: int) -> None:
        self.n_items = n_items
        self.net = OneHotNetwork(self.recurrent_layer, self._input_size(), n_items, self.device)

    def _init_params(self) -> dict:
        rng = self.rng
        tower = self.recurrent_layer.init_params(rng, self._input_size())
        h_out = self.recurrent_layer.output_size
        # DenseLayer defaults: GlorotUniform W, zero b
        limit = np.sqrt(6.0 / (h_out + self.n_items))
        return {
            "tower": tower,
            "W_out": rng.uniform(-limit, limit, size=(h_out, self.n_items)).astype(np.float32),
            "b_out": np.zeros(self.n_items, dtype=np.float32),
        }

    def _scores(self, ids, id_mask, mask):
        # deterministic output = softmax over the catalog (rnn_one_hot.py:65)
        return torch.softmax(self._logits(ids, id_mask, mask), dim=-1)

    def _rank_scores(self, ids, id_mask, mask):
        # ranking raw logits == ranking the softmax
        return self._logits(ids, id_mask, mask)

    fused_eval_head = True
    # catalogs at least this large train through the streaming head
    streaming_min_items = STREAMING_CCE_MIN_ITEMS

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------
    def _use_streaming_head(self) -> bool:
        return self.n_items >= self.streaming_min_items

    def _loss(self, batch):
        net = self.net
        h = net.tower(batch["ids"], batch["mask"], batch.get("id_mask"), train=True)
        col0 = self._shard_start("W_out")  # None unless W_out is column-sharded
        check = not batch.get("targets_in_catalog", False)
        if self._use_streaming_head():
            if col0 is not None:
                per_ex = sharded_streaming_cce(h, net.W_out, net.b_out, batch["targets"], self.mesh, col0,
                                               check_targets=check, compute_dtype=self.compute_dtype)
            else:
                per_ex = streaming_cce(h, net.W_out, net.b_out, batch["targets"], compute_dtype=self.compute_dtype,
                                       check_targets=check)
            cost = (per_ex / batch["target_pop"]).mean()
        elif col0 is not None:
            cost = losses.vocab_parallel_cce(h, net.W_out, net.b_out, batch["targets"], batch["target_pop"],
                                             self.mesh, col0, self.compute_dtype)
        else:
            logits = self._out_matmul(h, net.W_out, net.b_out)
            cost = losses.diversity_biased_cce(logits, batch["targets"], batch["target_pop"])
        if self.regularization != 0.0:
            if self.regularization > 0.0:
                penalty = self.regularization * torch.sum(torch.square(net.b_out))
            else:
                penalty = -self.regularization * losses.l1_penalty(net.b_out)
            if col0 is not None:  # b_out is sharded with W_out
                penalty = reduce_from_model(penalty, self.mesh)
            cost = cost + penalty
        return cost

    def _finalize_packed_batch(self, packed, target_ratings):
        packed["target_pop"] = (
            self.dataset.item_popularity[packed["targets"]] ** self.diversity_bias
        ).astype(np.float32)
        return packed

    # the whole CCE batch derives on the device from (store, rows, cuts):
    # target_pop is a lookup in the store's popularity table
    index_wire_ok = True

    def _prepare_input(self, sequences):
        """sequences: list of [user_id, input_sequence, targets]."""
        ids, id_mask, mask = self._encode_sequences([s[1] for s in sequences], user_ids=[s[0] for s in sequences])
        targets = np.array([s[2][0][0] for s in sequences], dtype=np.int32)  # first and only target
        pop = (self.dataset.item_popularity[targets] ** self.diversity_bias).astype(np.float32)
        batch = {"ids": ids, "mask": mask, "targets": targets, "target_pop": pop}
        if id_mask is not None:
            batch["id_mask"] = id_mask
        return batch
