"""Optimizer flags and the filename-encoded ``name`` strings.

Same CLI surface and ``name`` strings as ``seqrec_tpu/models/updates.py``
(``Ug_lr…``, ``Ud_lr…_rho…``, ``Ur…``, ``Un…``, ``Ua…``): the model-filename
scheme needs them to find a checkpoint. The update step math comes with
the training slice of the port.
"""

from __future__ import annotations


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
    """Carries a display ``name`` (used in model filenames)."""

    name: str


class Adagrad(UpdateManager):
    def __init__(self, learning_rate: float = 0.1):
        self.learning_rate = learning_rate
        self.name = "Ug_lr" + str(learning_rate)


class Adadelta(UpdateManager):
    def __init__(self, learning_rate: float = 1.0, rho: float = 0.9):
        self.learning_rate = learning_rate
        self.rho = rho
        self.name = "Ud_lr" + str(learning_rate) + "_rho" + str(rho)


class RMSProp(UpdateManager):
    def __init__(self, learning_rate: float = 1.0, rho: float = 0.9):
        self.learning_rate = learning_rate
        self.rho = rho
        self.name = "Ur_lr" + str(learning_rate) + "_rho" + str(rho)


class NesterovMomentum(UpdateManager):
    def __init__(self, learning_rate: float = 1.0, momentum: float = 0.9):
        self.learning_rate = learning_rate
        self.momentum = momentum
        self.name = "Un_lr" + str(learning_rate) + "_m" + str(momentum)


class Adam(UpdateManager):
    def __init__(
        self,
        learning_rate: float = 0.001,
        beta1: float = 0.9,
        beta2: float = 0.999,
        moment_dtype: str = "float32",
    ):
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
