"""Stacked denoising autoencoder over bag-of-items inputs.

Counterpart of ``seqrec_tpu/models/sdae.py``: a multi-hot item vector in,
a dense stack of ReLU layers with dropout, a sigmoid output over the
catalog, and the mean squared error against the full (undropped)
multi-hot. Input denoising drops items from the bag in the batch
generator, with ``self.rng.random()`` per item in the JAX package's order,
so one seed gives the same batches.

Only padded item-id lists cross to the device; the multi-hot vectors are
built there by a scatter with an extra pad column. The layer dropout
(``--do``) is drawn on the model's device from a ``torch.Generator``
seeded with the batch's ``dropout_seed``: the JAX package's distribution
and seeding schedule, drawn from other bits. The stack is plain PyTorch
matmuls, as the JAX package leaves it to XLA (no kernel); evaluation ranks
the sigmoid scores with ``masked_top_k``.

Under a mesh whose "model" axis shards ``W_out``'s columns (``W0`` stays
whole, the JAX package's layout) the output layer and the target bag run
on the rank's columns, and the squared error summed over them is summed
over "model" before the mean over the rank's rows and the catalog; the
layer dropout is drawn in the global batch's shape, each rank keeping its
rows, so a mesh run draws the one-device run's bits. Evaluation takes each
shard's masked top-k and merges them (``parallel/topk.py``).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from seqrec_tpu_torch.models.base import RNNBase
from seqrec_tpu_torch.ops.core import mask_seen, pad_bucket
from seqrec_tpu_torch.parallel.collectives import all_gather, copy_to_model, reduce_from_model
from seqrec_tpu_torch.parallel.topk import local_seen, sharded_top_k


def _bucket(n: int) -> int:
    return pad_bucket(n, floor=16)


class SDAENetwork(nn.Module):
    """State-dict keys ``W0``, ``b0``, ..., ``W_out``, ``b_out``."""

    def __init__(self, n_items: int, layers, device):
        super().__init__()
        in_dim = n_items
        for li, h in enumerate(layers):
            self.register_parameter(f"W{li}", nn.Parameter(torch.empty((in_dim, h), device=device)))
            self.register_parameter(f"b{li}", nn.Parameter(torch.empty((h,), device=device)))
            in_dim = h
        self.W_out = nn.Parameter(torch.empty((in_dim, n_items), device=device))
        self.b_out = nn.Parameter(torch.empty((n_items,), device=device))


class StackedDenoisingAutoencoder(RNNBase):
    lazy_table_ok = False  # dense multi-hot input, no gather table
    _DEVICE_ID_KEYS = RNNBase._DEVICE_ID_KEYS + ("x_ids", "y_ids")
    _HOST_KEYS = ("dropout_seed",)

    def __init__(self, layers=(20,), input_dropout=0.2, dropout=0.5, **kwargs):
        super().__init__(**kwargs)
        self.layers = list(layers)
        self.input_dropout = input_dropout
        self.dropout = dropout
        self.name = "Stacked Denoising Autoencoder"
        self._dropout_seed = 0

    def _get_model_filename(self, epochs) -> str:
        filename = "sda_bs" + str(self.batch_size) + "_ne" + str(epochs)
        filename += "_h" + "-".join(map(str, self.layers))
        filename += "_" + self.updater.name
        return filename + ("_rf" if self.use_ratings_features else "_nf")

    # ------------------------------------------------------------------
    def _prepare_networks(self, n_items: int) -> None:
        self.n_items = n_items
        self.net = SDAENetwork(n_items, self.layers, self.device)

    def _input_size(self) -> int:
        return self.n_items

    def _init_params(self) -> dict:
        rng = self.rng
        params: dict = {}
        in_dim = self.n_items
        for li, h in enumerate(self.layers):
            limit = np.sqrt(6.0 / (in_dim + h))
            params[f"W{li}"] = rng.uniform(-limit, limit, size=(in_dim, h)).astype(np.float32)
            params[f"b{li}"] = np.zeros(h, dtype=np.float32)
            in_dim = h
        limit = np.sqrt(6.0 / (in_dim + self.n_items))
        params["W_out"] = rng.uniform(-limit, limit, size=(in_dim, self.n_items)).astype(np.float32)
        params["b_out"] = np.zeros(self.n_items, dtype=np.float32)
        return params

    # ------------------------------------------------------------------
    def _bag(self, ids, mask, col0: int = 0, n: int | None = None):
        """[B, P] padded ids under mask [B, P] -> multi-hot [B, n] over the
        columns [col0, col0 + n) (by default the whole catalog)."""
        n = self.n_items if n is None else n
        B = ids.shape[0]
        bag = torch.zeros((B, n + 1), dtype=torch.float32, device=ids.device)
        local = ids.long() - col0
        # the extra column swallows pad slots (and another shard's items)
        safe = torch.where((mask > 0) & (local >= 0) & (local < n), local, n)
        return bag.scatter_(1, safe, 1.0)[:, :n]

    def _forward(self, x, dropout_seed=None):
        """The sigmoid output over the output layer's columns: the whole
        catalog, or under a mesh the rank's shard of it."""
        net = self.net
        h = x
        gen = None
        if dropout_seed is not None and self.dropout:
            gen = torch.Generator(device=x.device)
            gen.manual_seed(dropout_seed)
        rows, row0 = self._global_rows(x.shape[0])
        for li in range(len(self.layers)):
            h = torch.relu(h @ getattr(net, f"W{li}") + getattr(net, f"b{li}"))
            if gen is not None:  # the global batch's draw, this rank's rows
                keep = torch.rand((rows, h.shape[1]), generator=gen, device=h.device) < 1.0 - self.dropout
                h = torch.where(keep[row0 : row0 + h.shape[0]], h / (1.0 - self.dropout), 0.0)
        if self._shard_start("W_out") is not None:
            h = copy_to_model(h, self.mesh)
        return torch.sigmoid(h @ net.W_out + net.b_out)

    def _loss(self, batch):
        x = self._bag(batch["x_ids"], batch["x_mask"])
        out = self._forward(x, dropout_seed=batch["dropout_seed"])
        col0 = self._shard_start("W_out")
        if col0 is None:
            return torch.square(out - self._bag(batch["y_ids"], batch["y_mask"])).mean()
        y = self._bag(batch["y_ids"], batch["y_mask"], col0, out.shape[1])
        # the mean over the rank's rows and the whole catalog
        return reduce_from_model(torch.square(out - y).sum(), self.mesh) / (out.shape[0] * self.n_items)

    def _eval_output(self, ids, mask):
        """The deterministic output (no dropout) over the output layer's
        columns."""
        return self._forward(self._bag(ids[..., 0] if ids.dim() == 3 else ids, mask))

    def _scores(self, ids, id_mask, mask):
        out = self._eval_output(ids, mask)
        if self._shard_start("W_out") is not None:
            out = all_gather(out, self.mesh, "model", dim=1)
        return out

    def _topk(self, ids, id_mask, mask, seen_ids, seen_mask, k):
        col0 = self._shard_start("W_out")
        if col0 is None:
            return super()._topk(ids, id_mask, mask, seen_ids, seen_mask, k)
        # each shard's masked scores, its top k merged
        scores = self._eval_output(ids, mask)
        if seen_ids is not None:
            scores = mask_seen(scores, *local_seen(seen_ids, seen_mask, col0, scores.shape[1]))
        return sharded_top_k(self.mesh, scores, col0, k)[1]

    # ------------------------------------------------------------------
    # batching: whole sequences, a denoised input against the full target
    # ------------------------------------------------------------------
    def _fast_batching_ok(self) -> bool:
        return False  # its own bag-of-items batch layout

    def _encode_bag(self, seq_lists, pad):
        B = len(seq_lists)
        ids = np.zeros((B, pad), dtype=np.int32)
        mask = np.zeros((B, pad), dtype=np.float32)
        for i, items in enumerate(seq_lists):
            items = items[:pad]
            ids[i, : len(items)] = items
            mask[i, : len(items)] = 1.0
        return ids, mask

    def _gen_mini_batch(self, sequence_generator, test=False, **kwargs):
        while True:
            if test:
                sequence, user_id = next(sequence_generator)
                half = len(sequence) // 2
                seq_items = [i[0] for i in sequence[:half]]
                x_ids, x_mask = self._encode_bag([seq_items], _bucket(len(seq_items)))
                yield {"ids": x_ids, "mask": x_mask}, [i[0] for i in sequence[half:]]
                continue

            xs, ys = [], []
            for _ in range(self.batch_size):
                sequence, user_id = next(sequence_generator)
                items = [i[0] for i in sequence]
                xs.append([i for i in items if self.rng.random() >= self.input_dropout])
                ys.append(items)
            pad = _bucket(max(1, max(len(y) for y in ys)))
            x_ids, x_mask = self._encode_bag(xs, pad)
            y_ids, y_mask = self._encode_bag(ys, pad)
            self._dropout_seed += 1
            yield {
                "x_ids": x_ids,
                "x_mask": x_mask,
                "y_ids": y_ids,
                "y_mask": y_mask,
                "dropout_seed": np.int32(self._dropout_seed),
            }

    # evaluation encodes the whole first half of the sequence as an
    # order-free bag, never cut to max_length; the ids keep a trailing
    # feature axis so the base's eval wire rebuilds masks and seen ids
    def _encode_sequences(self, seqs, user_ids=None):
        pad = _bucket(max(1, max(len(s) for s in seqs)))
        ids, mask = self._encode_bag([[int(x[0]) for x in s] for s in seqs], pad)
        return ids[..., None], None, mask

    def _input_window(self, sequence):
        return sequence

    # batched eval: input = the first half's bag, goal = the suffix
    def _iter_test_instances(self, sequence_generator):
        for sequence, user_id in sequence_generator:
            half = len(sequence) // 2
            if half == 0:
                continue
            goal = [i[0] for i in sequence[half:]]
            yield sequence[:half], goal, user_id
