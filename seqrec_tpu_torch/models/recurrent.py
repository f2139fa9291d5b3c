"""Recurrent tower: GRU, LSTM and Vanilla stacks as an ``nn.Module``.

Counterpart of ``seqrec_tpu/models/recurrent.py``. Same CLI flags, same
``name`` string, same parameter names and shapes
(``layer{i}_{fwd,bwd}/W_in, W_hid, b, h0``, for the LSTM also ``c0`` and
the peepholes ``w_ci, w_cf, w_co``, and ``embedding``) and the same numpy
draw order in :meth:`RecurrentLayers.init_params`, so one seed gives
bit-identical parameters in both packages.

The input is the sparse one-hot trick: the gather-sum of ``W_in`` rows over
the active feature ids, for all steps at once, before the time scan
(``ops/gather_sum.py``: on CUDA a kernel pair, its backward a segment sum
in a fixed order). The
last layer's final state goes through a kernel: for the GRU the eval scan
(``ops/rnn_scan.py:gru_scan``, K3) for serving and the training scan with
its backward (``ops/rnn_scan_train.py``, K1) when ``train=True``; for the
LSTM the eval scan (``ops/rnn_scan.py:lstm_scan``, K6) and the training
scan (``ops/lstm_scan_train.py``, K5). Earlier layers, which return every
step, run the plain masked-carry scan under autograd. The Vanilla tower
runs the plain scan in every layer, on the CPU and on CUDA alike: the JAX
package has no Pallas kernel for it by design (``recurrent.py:274-279``;
its cell is one [B, H] x [H, H] product and a tanh), so there is no kernel
to port. Lasagne's gradient clipping clips the cotangents of ``x_pre``
(here) and, in the step or inside K1/K5's backward, of ``hid = h W_hid``
(GRU) or of the summed pre-activation ``x_pre + h W_hid`` (LSTM, Vanilla).
The JAX package's remat gate (``recurrent.py:378-398``) is XLA tuning and
is not ported.

Under a mesh (``models/base.py:set_mesh``) the item-indexed input tables,
the embedding and the first layer's ``W_in``, may hold only this rank's
rows (``input_shards``): the sparse input is then the sharded gather-sum
(``ops/gather_sum.py:sharded_gather_sum``), and a dense input into a
row-sharded ``W_in`` (after ``--r_emb``) is a row-parallel product, the
rank's columns of the input against its rows, reduced over "model".
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from seqrec_tpu_torch.ops.core import maybe_grad_clip
from seqrec_tpu_torch.ops.gather_sum import gather_sum, sharded_gather_sum
from seqrec_tpu_torch.ops.lstm_scan_train import lstm_scan_train
from seqrec_tpu_torch.ops.rnn_scan import gru_scan, gru_step, lstm_scan, lstm_step, vanilla_step
from seqrec_tpu_torch.ops.rnn_scan_train import gru_scan_train

GATE_COUNT = {"GRU": 3, "LSTM": 4, "Vanilla": 1}
# leaves drawn from N(0, 0.1) at init; all others start at 0
_NORMAL_LEAVES = ("embedding", "W_in", "W_hid", "w_ci", "w_cf", "w_co")


def recurrent_layers_command_parser(parser) -> None:
    parser.add_argument(
        "--r_t",
        dest="recurrent_layer_type",
        choices=["LSTM", "GRU", "Vanilla", "HSTU"],
        help="Type of recurrent layer (HSTU: the attention tower of models/hstu.py, width --r_l)",
        default="GRU",
    )
    parser.add_argument(
        "--r_l", help="Layers' size, (eg: 100-50-50)", default="50", type=str
    )
    parser.add_argument("--r_bi", help="Bidirectional layers.", action="store_true")
    parser.add_argument(
        "--r_emb",
        help="Add an embedding layer before the RNN (size of the embedding; <1 disables).",
        type=int,
        default=0,
    )
    parser.add_argument("--hstu_blocks", help="HSTU: number of blocks", type=int, default=8)
    parser.add_argument("--hstu_heads", help="HSTU: attention heads a block", type=int, default=4)
    parser.add_argument("--hstu_dqk", help="HSTU: query and key width of a head", type=int, default=64)
    parser.add_argument("--hstu_dv", help="HSTU: value width of a head", type=int, default=64)


def get_recurrent_layers(args):
    if args.recurrent_layer_type == "HSTU":
        from seqrec_tpu_torch.models.hstu import HSTULayers

        if args.r_bi or args.r_emb > 0 or "-" in str(args.r_l):
            raise ValueError("HSTU takes one width (--r_l) and neither --r_bi nor --r_emb")
        if getattr(args, "mesh", "") or getattr(args, "bf16", False):
            raise ValueError("HSTU runs in float32 on one device: neither --mesh nor --bf16")
        return HSTULayers(hidden=int(args.r_l), blocks=args.hstu_blocks, heads=args.hstu_heads,
                          dqk=args.hstu_dqk, dv=args.hstu_dv, max_length=getattr(args, "max_length", 200))
    return RecurrentLayers(
        layer_type=args.recurrent_layer_type,
        layers=[int(x) for x in args.r_l.split("-")],
        bidirectional=args.r_bi,
        embedding_size=args.r_emb,
    )


class RecurrentLayers(nn.Module):
    """Configuration, parameters and forward pass of the recurrent stack."""

    def __init__(
        self,
        layer_type: str = "LSTM",
        layers=(32,),
        bidirectional: bool = False,
        embedding_size: int = 0,
        grad_clipping: float = 100,
    ):
        super().__init__()
        if layer_type not in GATE_COUNT:
            raise ValueError("Unknown layer type")
        self.layer_type = layer_type
        self.layers = list(layers)
        self.bidirectional = bidirectional
        self.embedding_size = embedding_size
        self.grad_clip = grad_clipping
        # {"embedding" | "layer0_fwd" | "layer0_bwd": (mesh, first row)} of
        # the input tables that hold one shard of their rows
        self.input_shards: dict = {}
        self.set_name()

    def set_name(self) -> None:
        """Filename fragment; format parity with recurrent_layers.py:28-39."""
        self.name = ""
        if self.bidirectional:
            self.name += "b" + self.layer_type + "_"
        elif self.layer_type != "LSTM":
            self.name += self.layer_type + "_"
        self.name += "gc" + str(self.grad_clip) + "_"
        if self.embedding_size > 0:
            self.name += "e" + str(self.embedding_size)
        self.name += "h" + "-".join(map(str, self.layers))

    @property
    def output_size(self) -> int:
        return self.layers[-1] * (2 if self.bidirectional else 1)

    def _directions(self):
        return ["fwd", "bwd"] if self.bidirectional else ["fwd"]

    def param_shapes(self, true_input_size: int) -> dict:
        """Nested ``{name: shape}`` of every parameter, in draw order."""
        G = GATE_COUNT[self.layer_type]
        shapes: dict = {}
        in_dim = true_input_size
        if self.embedding_size > 0:
            shapes["embedding"] = (true_input_size, self.embedding_size)
            in_dim = self.embedding_size
        for li, h in enumerate(self.layers):
            for d in self._directions():
                layer = {"W_in": (in_dim, G * h), "W_hid": (h, G * h), "b": (G * h,), "h0": (h,)}
                if self.layer_type == "LSTM":
                    layer.update(c0=(h,), w_ci=(h,), w_cf=(h,), w_co=(h,))
                shapes[f"layer{li}_{d}"] = layer
            in_dim = h * (2 if self.bidirectional else 1)
        return shapes

    def init_params(self, rng: np.random.Generator, true_input_size: int) -> dict:
        """Numpy parameter tree, drawn as the JAX package draws it: weights
        ~ N(0, 0.1) in declaration order, biases and initial states 0."""

        def leaf(name, shape):
            if name in _NORMAL_LEAVES:
                return rng.normal(0.0, 0.1, size=shape).astype(np.float32)
            return np.zeros(shape, dtype=np.float32)

        return {
            key: leaf(key, val) if isinstance(val, tuple) else {n: leaf(n, s) for n, s in val.items()}
            for key, val in self.param_shapes(true_input_size).items()
        }

    def build(self, true_input_size: int, device) -> None:
        """Create the (uninitialised, trainable) parameters on ``device``; a
        numpy tree is loaded into them with ``load_state_dict``."""

        def param(shape):
            return nn.Parameter(torch.empty(shape, device=device))

        for key, val in self.param_shapes(true_input_size).items():
            if isinstance(val, tuple):
                self.register_parameter(key, param(val))
            else:
                self.add_module(key, nn.ParameterDict({n: param(s) for n, s in val.items()}))

    # ------------------------------------------------------------------
    def forward(self, inputs, mask, id_mask=None, only_return_final: bool = True, train: bool = False):
        """inputs: integer ``[B, L, F]`` feature ids; mask: float ``[B, L]``
        (1 = valid step); id_mask: optional float ``[B, L, F]``. ``train``
        runs the last layer through the differentiable training scan.
        Returns ``[B, H_out]`` (final state) or ``[B, L, H_out]``."""
        sparse = not inputs.is_floating_point()
        x = inputs
        if self.embedding_size > 0:
            if not sparse:
                raise ValueError("Embedding layer only works with sparse inputs")
            x, sparse = self._gather_sum("embedding", self.embedding, inputs, id_mask), False

        n_layers = len(self.layers)
        for li in range(n_layers):
            orf = only_return_final and li == n_layers - 1
            outs = [
                self._run_layer(f"layer{li}_{d}", x, mask, id_mask, sparse, orf, d == "bwd", train)
                for d in self._directions()
            ]
            x = torch.cat(outs, dim=-1) if len(outs) > 1 else outs[0]
            sparse = False  # deeper layers are densely encoded
            id_mask = None
        return x

    def _gather_sum(self, key, table, ids, id_mask):
        shard = self.input_shards.get(key)
        if shard is None:
            return gather_sum(table, ids, id_mask)
        return sharded_gather_sum(table, ids, id_mask, *shard)

    def _dense_input(self, key, x, W_in):
        shard = self.input_shards.get(key)
        if shard is None:
            return torch.einsum("bld,dg->blg", x, W_in)
        from seqrec_tpu_torch.parallel.collectives import copy_to_model, reduce_from_model

        mesh, start = shard
        x = copy_to_model(x, mesh)[..., start : start + W_in.shape[0]]
        return reduce_from_model(torch.einsum("bld,dg->blg", x, W_in), mesh)

    def _run_layer(self, key, x, mask, id_mask, sparse, only_return_final, backwards, train):
        """One unidirectional recurrent layer over time."""
        lp = getattr(self, key)
        if sparse:
            x_pre = self._gather_sum(key, lp["W_in"], x, id_mask) + lp["b"]
        else:
            x_pre = self._dense_input(key, x, lp["W_in"]) + lp["b"]
        x_pre = maybe_grad_clip(x_pre, self.grad_clip)
        if backwards:
            # a backwards layer is the forward scan of the time-flipped inputs
            x_pre, mask = x_pre.flip(1), mask.flip(1)
        B, H = x_pre.shape[0], lp["h0"].shape[0]
        h0 = lp["h0"].expand(B, H).contiguous()
        lstm = self.layer_type == "LSTM"
        if lstm:
            c0 = lp["c0"].expand(B, H).contiguous()
            peep = torch.stack([lp["w_ci"], lp["w_cf"], lp["w_co"]])
        if only_return_final and self.layer_type != "Vanilla":
            x_pre, mask = x_pre.contiguous(), mask.contiguous()
            if lstm:
                args = (x_pre, mask, lp["W_hid"], peep, h0, c0)
                return lstm_scan_train(*args, self.grad_clip) if train else lstm_scan(*args)
            args = (x_pre, mask, lp["W_hid"], h0)
            return gru_scan_train(*args, self.grad_clip) if train else gru_scan(*args)
        h, c, states = h0, (c0 if lstm else None), []
        for t in range(x_pre.shape[1]):
            x_t, m = x_pre[:, t], mask[:, t : t + 1]
            if lstm:
                h, c = lstm_step(h, c, x_t, m, lp["W_hid"], peep, self.grad_clip)
            elif self.layer_type == "GRU":
                h = gru_step(h, x_t, m, lp["W_hid"], self.grad_clip)
            else:
                h = vanilla_step(h, x_t, m, lp["W_hid"], self.grad_clip)
            states.append(h)
        if only_return_final:
            return h
        ys = torch.stack(states, dim=1)
        return ys.flip(1) if backwards else ys
