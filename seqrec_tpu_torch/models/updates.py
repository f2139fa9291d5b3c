"""Optimizers: flags, the filename-encoded ``name`` strings and the step
math.

Same CLI surface and ``name`` strings as ``seqrec_tpu/models/updates.py``
(``Ug_lr…``, ``Ud_lr…_rho…``, ``Ur…``, ``Un…``, ``Ua…``). Each ``step``
follows the optax transformation the JAX package builds
(``updates.py:75-144``) operation for operation, as plain tensor code that
updates the parameters in place (``torch.no_grad``); the state holds one
f32 tensor per parameter and slot. ``torch.optim`` is not used: Adagrad
and RMSProp put eps inside the rsqrt in optax and outside the sqrt in
torch. ``--u_moments bfloat16`` stores both Adam moments in bf16, does the
update math in f32 and stores the new moments with stochastic rounding,
as ``updates.py:_scale_by_adam_bf16_moments`` does; its rounding noise
comes from a ``torch.Generator`` seeded per step, so the law is the JAX
package's and the bits are not. Under a mesh each sharded moment's noise
is drawn in its parameter's full shape and sliced to the rank's shard, so
a mesh run draws the one-device run's bits. Each ``step`` is a
``seqrec::update`` span (``utils/tracing.py``), inside whatever wraps the
call.
"""

from __future__ import annotations

import torch

from seqrec_tpu_torch.utils import tracing


def update_manager_command_parser(parser) -> None:
    parser.add_argument(
        "--u_m",
        dest="update_manager",
        choices=["adagrad", "adadelta", "rmsprop", "nesterov", "adam"],
        help="Update mechanism",
        default="adam",
    )
    parser.add_argument("--u_l", help="Learning rate", default=0.001, type=float)
    parser.add_argument(
        "--u_rho",
        help="rho for Adadelta/RMSProp (momentum for Nesterov)",
        default=0.9,
        type=float,
    )
    parser.add_argument("--u_b1", help="Beta 1 for Adam", default=0.9, type=float)
    parser.add_argument("--u_b2", help="Beta 2 for Adam", default=0.999, type=float)
    parser.add_argument(
        "--u_moments",
        dest="moment_dtype",
        choices=["float32", "bfloat16"],
        default="float32",
        help="Adam moment storage dtype (bfloat16 halves the optimizer's "
        "memory traffic; the update math runs in float32).",
    )


def get_update_manager(args):
    if args.update_manager == "adagrad":
        return Adagrad(learning_rate=args.u_l)
    if args.update_manager == "adadelta":
        return Adadelta(learning_rate=args.u_l, rho=args.u_rho)
    if args.update_manager == "rmsprop":
        return RMSProp(learning_rate=args.u_l, rho=args.u_rho)
    if args.update_manager == "nesterov":
        return NesterovMomentum(learning_rate=args.u_l, momentum=args.u_rho)
    if args.update_manager == "adam":
        return Adam(
            learning_rate=args.u_l,
            beta1=args.u_b1,
            beta2=args.u_b2,
            moment_dtype=getattr(args, "moment_dtype", "float32"),
        )
    raise ValueError("Unknown update option")


class UpdateManager:
    """Carries a display ``name`` (used in model filenames) and the step
    math: ``init(params)`` gives the state, ``step(params, grads, state)``
    updates ``params`` and ``state`` in place. ``shards`` (under a mesh)
    holds per parameter None, or (full shape, sharded dimension, first
    index) of the rank's shard it holds; only the seeded draws of
    bf16-moment Adam read it."""

    name: str
    slots: tuple = ()
    # optax's state holds a step count (a leading int32 leaf) for Adam only
    count_leaf = False

    def init(self, params) -> dict:
        state = {slot: [torch.zeros_like(p) for p in params] for slot in self.slots}
        state["count"] = 0
        return state

    @torch.no_grad()
    def step(self, params, grads, state, shards=None) -> None:
        with tracing.span("seqrec::update"):
            state["count"] += 1
            for i, (p, g) in enumerate(zip(params, grads)):
                p.add_(self._update(g, [state[s][i] for s in self.slots], state["count"]))

    def _update(self, g, slots, count):  # pragma: no cover
        raise NotImplementedError


class Adagrad(UpdateManager):
    """optax.adagrad(lr, initial_accumulator_value=0, eps=1e-6)."""

    slots = ("sum_of_squares",)

    def __init__(self, learning_rate: float = 0.1):
        self.learning_rate = learning_rate
        self.name = "Ug_lr" + str(learning_rate)

    def _update(self, g, slots, count):
        (acc,) = slots
        acc.copy_(g * g + acc)
        inv = torch.where(acc > 0, torch.rsqrt(acc + 1e-6), torch.zeros_like(acc))
        return inv * g * -self.learning_rate


class Adadelta(UpdateManager):
    """optax.adadelta(lr, rho, eps=1e-6)."""

    slots = ("e_g", "e_x")

    def __init__(self, learning_rate: float = 1.0, rho: float = 0.9):
        self.learning_rate = learning_rate
        self.rho = rho
        self.name = "Ud_lr" + str(learning_rate) + "_rho" + str(rho)

    def _update(self, g, slots, count):
        e_g, e_x = slots
        rho, eps = self.rho, 1e-6
        e_g.copy_((1 - rho) * (g * g) + rho * e_g)
        u = (torch.sqrt(e_x + eps) / torch.sqrt(e_g + eps)) * g
        e_x.copy_((1 - rho) * (u * u) + rho * e_x)
        return u * -self.learning_rate


class RMSProp(UpdateManager):
    """optax.rmsprop(lr, decay=rho, eps=1e-6): eps inside the rsqrt."""

    slots = ("nu",)

    def __init__(self, learning_rate: float = 1.0, rho: float = 0.9):
        self.learning_rate = learning_rate
        self.rho = rho
        self.name = "Ur_lr" + str(learning_rate) + "_rho" + str(rho)

    def _update(self, g, slots, count):
        (nu,) = slots
        nu.copy_((1 - self.rho) * (g * g) + self.rho * nu)
        return torch.rsqrt(nu + 1e-6) * g * -self.learning_rate


class NesterovMomentum(UpdateManager):
    """optax.sgd(lr, momentum, nesterov=True)."""

    slots = ("trace",)

    def __init__(self, learning_rate: float = 1.0, momentum: float = 0.9):
        self.learning_rate = learning_rate
        self.momentum = momentum
        self.name = "Un_lr" + str(learning_rate) + "_m" + str(momentum)

    def _update(self, g, slots, count):
        (trace,) = slots
        trace.copy_(g + self.momentum * trace)
        return (g + self.momentum * trace) * -self.learning_rate


class Adam(UpdateManager):
    """optax.adam(lr, b1, b2, eps=1e-8): f32 moments, or with
    ``moment_dtype="bfloat16"`` bf16 moments stored by stochastic
    rounding."""

    slots = ("mu", "nu")
    count_leaf = True
    # the rounding noise's stream: one generator seeded per step from this
    # and the step count
    SEED = 0x5EED

    def __init__(
        self,
        learning_rate: float = 0.001,
        beta1: float = 0.9,
        beta2: float = 0.999,
        moment_dtype: str = "float32",
    ):
        if moment_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"moment_dtype must be float32 or bfloat16, got {moment_dtype!r}")
        self.learning_rate = learning_rate
        self.beta1 = beta1
        self.beta2 = beta2
        self.moment_dtype = moment_dtype
        self.name = (
            "Ua_lr" + str(learning_rate) + "_b1" + str(beta1) + "_b2" + str(beta2)
        )
        if moment_dtype != "float32":
            # legacy filenames stay byte-identical for the f32 default
            self.name += "_mbf16"

    def init(self, params) -> dict:
        state = super().init(params)
        if self.moment_dtype == "bfloat16":
            for slot in self.slots:
                state[slot] = [m.to(torch.bfloat16) for m in state[slot]]
        return state

    def _corrections(self, count):
        # optax computes the corrections in f32: 1 - decay**count
        c = torch.tensor(count, dtype=torch.float32)
        bc1 = (1 - torch.tensor(self.beta1, dtype=torch.float32) ** c).item()
        bc2 = (1 - torch.tensor(self.beta2, dtype=torch.float32) ** c).item()
        return bc1, bc2

    @torch.no_grad()
    def step(self, params, grads, state, shards=None) -> None:
        if self.moment_dtype == "float32":
            return super().step(params, grads, state)
        with tracing.span("seqrec::update"):
            state["count"] += 1
            b1, b2 = self.beta1, self.beta2
            bc1, bc2 = self._corrections(state["count"])
            gen = None
            for i, (p, g) in enumerate(zip(params, grads)):
                if gen is None or gen.device != p.device:
                    gen = torch.Generator(device=p.device)
                    gen.manual_seed(self.SEED * 1_000_003 + state["count"])
                g32 = g.float()
                m32 = b1 * state["mu"][i].float() + (1.0 - b1) * g32
                v32 = b2 * state["nu"][i].float() + (1.0 - b2) * (g32 * g32)
                p.add_((m32 / bc1) / (torch.sqrt(v32 / bc2) + 1e-8) * -self.learning_rate)
                shard = shards[i] if shards is not None else None
                state["mu"][i] = stochastic_round_bf16(m32, gen, shard)
                state["nu"][i] = stochastic_round_bf16(v32, gen, shard)

    def _update(self, g, slots, count):
        mu, nu = slots
        b1, b2 = self.beta1, self.beta2
        mu.copy_((1 - b1) * g + b1 * mu)
        nu.copy_((1 - b2) * (g * g) + b2 * nu)
        bc1, bc2 = self._corrections(count)
        return (mu / bc1) / (torch.sqrt(nu / bc2) + 1e-8) * -self.learning_rate


def stochastic_round_bf16(x32: torch.Tensor, generator: torch.Generator, shard=None) -> torch.Tensor:
    """Unbiased f32 -> bf16 rounding (``updates.py:_stochastic_round_bf16``):
    add a uniform 16-bit integer to the low half of the f32 bits, then
    truncate. Round-to-nearest would absorb Adam's (1 - b2)-sized
    second-moment increments, below bf16's ulp; stochastic rounding keeps
    them in expectation. Non-finite values pass through the plain cast.

    ``shard`` (full shape, dimension, first index): ``x32`` is a shard of a
    larger tensor, whose noise is drawn whole and sliced here, so every
    shard takes its own bits of the one-device draw and the generator
    advances as it does there. The draw is transient: an int32 tensor of
    the full shape, about 25 MB for GRU-128's W_out at 50,000 items."""
    bits = x32.contiguous().view(torch.int32)
    if shard is None:
        noise = torch.randint(0, 1 << 16, x32.shape, generator=generator, device=x32.device, dtype=torch.int32)
    else:
        full, dim, start = shard
        noise = torch.randint(0, 1 << 16, full, generator=generator, device=x32.device, dtype=torch.int32)
        noise = noise.narrow(dim, start, x32.shape[dim])
    # finite values stay below 0x7F7FFFFF + 0xFFFF, so the int32 sum cannot
    # overflow; the mask keeps the upper 16 bits, sign included
    rounded = ((bits + noise) & -65536).view(torch.float32)
    return torch.where(torch.isfinite(x32), rounded, x32).to(torch.bfloat16)
