"""RNN with sampled losses (BPR, TOP1, Blackout).

Counterpart of ``seqrec_tpu/models/rnn_sampling.py:RNNSampling``. At train
time only the output columns of the batch's targets and of ``S`` shared
negative samples are scored: a gather of ``B+S`` columns of ``W_out``
(``index_select``) and one ``[B, H] x [H, B+S]`` product, in plain
PyTorch as the JAX package leaves them to XLA. The diagonal of the left
``[B, B]`` block scores each example's own target.

Under a mesh each data rank scores its ``B / D`` rows against the global
batch's ``B`` targets (gathered over "data") and the ``S`` samples, its
own targets from column ``d * B / D`` on, as the JAX package's global
program does; a column-sharded ``W_out`` gives its ``B+S`` columns
through ``parallel/columns.py:gather_columns``.

The samples are drawn on the host per batch from the model's own generator
(``self.rng``), at the same points and in the same order as the JAX
package: uniform over the catalog, or ``pop^sampling_bias`` through a
cumsum and ``searchsorted``; under ``--spd`` each of the K steps draws its
own set (on the index wire, K sets beside the payload's rows and cuts).
Serving ranks the raw logits (ranking the
softmax), so evaluation goes through the fused score + mask + top-k kernel
K4. ``--lazy_updates`` moves the head (``W_out`` columns, ``b_out``
entries) onto the lazy Adam; the input table keeps dense Adam. Under a
mesh the lazy columns are the global batch's, localized to the rank's
shard of a column-sharded head. ``--bf16`` leaves the training product in
f32, as the JAX package does (a plain ``jnp.dot`` of the gathered
columns); evaluation scores as on one device.
"""

from __future__ import annotations

import numpy as np
import torch

from seqrec_tpu_torch.models.base import RNNBase
from seqrec_tpu_torch.models.rnn_one_hot import OneHotNetwork
from seqrec_tpu_torch.ops import losses


class RNNSampling(RNNBase):
    fused_eval_head = True

    def __init__(
        self,
        loss_function: str = "Blackout",
        sampling=32,
        last_layer_tanh: bool = False,
        last_layer_init: float = 1.0,
        diversity_bias: float = 0.0,
        sampling_bias: float = 0.0,
        **kwargs,
    ):
        super().__init__(**kwargs)
        self.last_layer_init = last_layer_init
        self.last_layer_tanh = last_layer_tanh
        self.diversity_bias = float(diversity_bias)
        self.sampling = sampling
        self.sampling_bias = sampling_bias
        loss_function = loss_function or "Blackout"
        if loss_function not in losses.SAMPLED_LOSSES:
            raise ValueError("Unknown loss function")
        self.loss_function_name = loss_function
        self.name = "RNN with sampling loss"

    def _get_model_filename(self, epochs) -> str:
        filename = "rnn_sampling_" + self.loss_function_name + "_"
        if self.sampling_bias > 0.0:
            filename += "p" + str(self.sampling_bias)
        filename += "s" + str(self.sampling) + "_ini" + str(self.last_layer_init) + "_db" + str(self.diversity_bias)
        return filename + "_" + self._common_filename(epochs)

    # ------------------------------------------------------------------
    def _prepare_networks(self, n_items: int) -> None:
        self.n_items = n_items
        # a fractional --sampling is a share of the catalog
        self.effective_sampling = int(self.sampling * n_items) if self.sampling < 1 else int(self.sampling)
        self.net = OneHotNetwork(self.recurrent_layer, self._input_size(), n_items, self.device)

    def _init_params(self) -> dict:
        rng = self.rng
        tower = self.recurrent_layer.init_params(rng, self._input_size())
        h_out = self.recurrent_layer.output_size
        limit = self.last_layer_init * np.sqrt(6.0 / (h_out + self.n_items))
        return {
            "tower": tower,
            "W_out": rng.uniform(-limit, limit, size=(h_out, self.n_items)).astype(np.float32),
            "b_out": np.zeros(self.n_items, dtype=np.float32),
        }

    # ------------------------------------------------------------------
    def _loss(self, batch):
        net = self.net
        h = net.tower(batch["ids"], batch["mask"], batch.get("id_mask"), train=True)
        targets, offset = self._batch_targets(batch["targets"])
        w_cols, b_cols = self._head_columns(torch.cat([targets, batch["samples"]]))
        scores = h @ w_cols + b_cols
        if self.last_layer_tanh and self.loss_function_name != "Blackout":
            scores = torch.tanh(scores)
        per_example = losses.SAMPLED_LOSSES[self.loss_function_name](scores, targets.shape[0], offset)
        return (per_example / batch["target_pop"]).mean()

    def _scores(self, ids, id_mask, mask):
        return torch.softmax(self._logits(ids, id_mask, mask), dim=-1)

    def _rank_scores(self, ids, id_mask, mask):
        # ranking raw logits == ranking the softmax
        return self._logits(ids, id_mask, mask)

    # ------------------------------------------------------------------
    def _draw_samples(self) -> np.ndarray:
        if self.sampling_bias > 0:
            if not hasattr(self, "_cumsum"):
                self._cumsum = np.cumsum(np.power(self.dataset.item_popularity, self.sampling_bias))
            u = self.rng.uniform(0, self._cumsum[-1], size=self.effective_sampling)
            return np.searchsorted(self._cumsum, u, side="right").astype(np.int32)
        return self.rng.choice(self.n_items, self.effective_sampling).astype(np.int32)

    def _finalize_packed_batch(self, packed, target_ratings):
        packed["target_pop"] = (
            self.dataset.item_popularity[packed["targets"]] ** self.diversity_bias
        ).astype(np.float32)
        packed["samples"] = self._draw_samples()
        return packed

    def _restack_wire(self, batch, n_stack):
        out = super()._restack_wire(batch, n_stack)
        # the samples are shared within a step and drawn anew for each of
        # the K steps, after the super-batch's own draw
        out["samples"] = np.stack([np.asarray(batch["samples"])] + [self._draw_samples() for _ in range(n_stack - 1)])
        return out

    # index wire: the batch derives on the device from (store, rows, cuts),
    # and the host-drawn samples ship beside them
    index_wire_ok = True

    def _index_payload_extras(self, k):
        return {"samples": np.stack([self._draw_samples() for _ in range(k)])}

    def _resolve_lazy_specs(self):
        """Only the target and sample columns score, so the head's gradient
        is column-sparse (about B+S of n_items columns a step): the lazy
        Adam takes ``W_out``'s columns and ``b_out``'s entries, and the
        input table keeps dense Adam. The columns are the global batch's
        targets (gathered over "data" under a mesh) and the samples."""
        if self._resolve_lazy_path() is None:
            return None

        def cols(batch):
            return torch.cat([self._batch_targets(batch["targets"])[0], batch["samples"]])

        return [{"path": ("W_out",), "axis": 1, "ids": cols}, {"path": ("b_out",), "axis": 0, "ids": cols}]

    def _prepare_input(self, sequences):
        ids, id_mask, mask = self._encode_sequences([s[1] for s in sequences], user_ids=[s[0] for s in sequences])
        targets = np.array([s[2][0][0] for s in sequences], dtype=np.int32)
        pop = (self.dataset.item_popularity[targets] ** self.diversity_bias).astype(np.float32)
        batch = {"ids": ids, "mask": mask, "targets": targets, "target_pop": pop, "samples": self._draw_samples()}
        if id_mask is not None:
            batch["id_mask"] = id_mask
        return batch
