"""Composable CLI flags and the predictor factory.

Same flag surface as ``seqrec_tpu/utils/command_parser.py`` (one flag
namespace shared by the train and test CLIs; each plugin module
contributes its own sub-parser). ``get_predictor`` builds what the port
has so far: the RNN family's single-model heads, ``RNNOneHot`` (``--loss
CCE``), ``RNNSampling`` (``BPR``, ``TOP1``, ``Blackout``) and
``RNNMargin`` (``hinge``, ``logit``, ``logsig``), each on a GRU, LSTM or
Vanilla tower or, with ``--r_t HSTU``, the HSTU tower of ``models/hstu.py``
(``--r_l`` its width, ``--hstu_blocks``, ``--hstu_heads``, ``--hstu_dqk``,
``--hstu_dv``; a port-only flag set, the JAX package has no HSTU); the cluster models
``RNNCluster`` (``-m RNN --clusters K``) and ``FISMCluster`` (``-m FISM
--clusters K``); ``StackedDenoisingAutoencoder`` (``-m SDA``); ``LTM``
(``-m LTM``); and the lazy baselines ``Pop``, ``MarkovModel`` and
``UserKNN`` (``-m POP``, ``MM``, ``UKNN``); and the factorization models
``BPRMF``, ``FPMC``, ``FISM`` (without ``--clusters``; ``--loss BPR`` or
``RMSE``) and ``Fossil``. ``--bf16`` sets the RNN family's compute dtype
(``compute_dtype="bfloat16"``), which the other models ignore, as in the
JAX package.
"""

from __future__ import annotations

import argparse

from seqrec_tpu_torch.data.noise import get_sequence_noise, sequence_noise_command_parser
from seqrec_tpu_torch.data.targets import get_target_selection, target_selection_command_parser
from seqrec_tpu_torch.models.recurrent import (
    get_recurrent_layers,
    recurrent_layers_command_parser,
)
from seqrec_tpu_torch.models.updates import get_update_manager, update_manager_command_parser
from seqrec_tpu_torch.utils.early_stopping import (  # noqa: F401 (re-export)
    early_stopping_command_parser,
    get_early_stopper,
)


def command_parser(*sub_command_parser, argv=None):
    parser = argparse.ArgumentParser()
    for scp in sub_command_parser:
        scp(parser)
    return parser.parse_args(argv)


def predictor_command_parser(parser) -> None:
    parser.add_argument(
        "-m",
        dest="method",
        choices=[
            "RNN",
            "SDA",
            "BPRMF",
            "FPMC",
            "FISM",
            "Fossil",
            "LTM",
            "UKNN",
            "MM",
            "POP",
        ],
        help="Method",
        default="RNN",
    )
    parser.add_argument("-b", dest="batch_size", help="Batch size", default=16, type=int)
    parser.add_argument(
        "-l", dest="learning_rate", help="Learning rate", default=0.01, type=float
    )
    parser.add_argument(
        "-r",
        dest="regularization",
        help="Regularization (positive for L2, negative for L1)",
        default=0.0,
        type=float,
    )
    parser.add_argument(
        "-g", dest="gradient_clipping", help="Gradient clipping", default=100, type=int
    )
    parser.add_argument(
        "-H",
        dest="hidden",
        help="Number of hidden neurons (for LTM and BPRMF)",
        default=20,
        type=int,
    )
    parser.add_argument(
        "-L", dest="layers", help="Layers (for SDA)", default="20", type=str
    )
    parser.add_argument(
        "--loss",
        help="Loss function: TOP1/BPR/Blackout (sampling), hinge/logit/logsig "
        "(multi-targets), or CCE",
        default="CCE",
        type=str,
    )
    parser.add_argument(
        "--sampling",
        help="Number of samples for the RNNSampling loss",
        default=32.0,
        type=float,
    )
    parser.add_argument(
        "--sampling_bias",
        help="0. = uniform sampling, 1. = proportional to item frequency",
        default=0.0,
        type=float,
    )
    parser.add_argument(
        "--db",
        dest="diversity_bias",
        help="Diversity bias (RNN with CCE/TOP1/BPR/Blackout loss)",
        default=0.0,
        type=float,
    )
    parser.add_argument(
        "--in_do", dest="input_dropout", help="Input dropout (SDA)", default=0.2, type=float
    )
    parser.add_argument("--do", dest="dropout", help="Dropout (SDA)", default=0.5, type=float)
    parser.add_argument(
        "--bf16",
        help="Compute catalog-sized matmuls in bfloat16 (f32 accumulation).",
        action="store_true",
    )
    parser.add_argument(
        "--lazy_updates",
        help="Row-sparse Adam for the catalog input table: only rows the "
        "batch touched get moment updates (TF LazyAdam semantics). Cuts "
        "the optimizer's HBM traffic from O(n_items) to O(batch tokens) "
        "per step — the dominant cost at 10^5-item catalogs. RNN "
        "families with adam only.",
        action="store_true",
    )
    parser.add_argument("--rf", help="Use rating features.", action="store_true")
    parser.add_argument("--mf", help="Use movie features.", action="store_true")
    parser.add_argument("--uf", help="Use users features.", action="store_true")
    parser.add_argument("--ns", help="Neighborhood size (UKNN).", default=80, type=int)
    parser.add_argument("--pb", help="Popularity based (RNNMargin).", action="store_true")
    parser.add_argument(
        "--balance",
        help="Balance between false positive/negative error (RNNMargin)",
        default=1.0,
        type=float,
    )
    parser.add_argument(
        "--min_access",
        help="Estimated minimum access probability (RNNMargin)",
        default=0.05,
        type=float,
    )
    parser.add_argument("--k_cf", help="CF factors (FPMC)", default=32, type=int)
    parser.add_argument("--k_mc", help="MC factors (FPMC)", default=32, type=int)
    parser.add_argument(
        "--init_sigma", help="Gaussian init sigma (MF family)", default=1, type=float
    )
    parser.add_argument(
        "--fpmc_bias", help="Sampling bias (BPRMF/FPMC)", default=100.0, type=float
    )
    parser.add_argument(
        "--no_adaptive_sampling", help="Disable adaptive sampling", action="store_true"
    )
    parser.add_argument("--cooling", help="Simulated annealing", default=1.0, type=float)
    parser.add_argument(
        "--ltm_damping", help="Temporal damping (LTM)", default=0.8, type=float
    )
    parser.add_argument("--ltm_window", help="word2vec window (LTM)", default=5, type=int)
    parser.add_argument(
        "--ltm_no_trajectory",
        help="Plain word2vec without user trajectory (LTM)",
        action="store_true",
    )
    parser.add_argument(
        "--max_length",
        help="Maximum sequence length during training (RNNs)",
        default=30,
        type=int,
    )
    parser.add_argument(
        "--repeated_interactions",
        help="Allow recommending already-consumed items",
        action="store_true",
    )
    parser.add_argument("--fism_alpha", help="FISM alpha", default=0.2, type=float)
    parser.add_argument(
        "--fossil_order", help="Markov order in Fossil", default=1, type=int
    )

    parser.add_argument(
        "--c_sampling",
        help="Samples for the clustering loss (unset: reuse recommendation-loss samples)",
        default=-1,
        type=int,
    )
    parser.add_argument(
        "--ignore_clusters", help="Skip clusters at test time", action="store_true"
    )
    parser.add_argument(
        "--clusters", help="Number of clusters (unset: no clustering)", default=-1, type=int
    )
    parser.add_argument(
        "--init_scale", help="Initial cluster softmax/sigmoid scale", default=1.0, type=float
    )
    parser.add_argument(
        "--scale_growing_rate",
        help="Geometric growth rate of the cluster scale",
        default=1.0,
        type=float,
    )
    parser.add_argument(
        "--max_scale", help="Max cluster softmax/sigmoid scale", default=50, type=float
    )
    parser.add_argument("--csn", help="Cluster selection noise", default=0.0, type=float)
    parser.add_argument(
        "--cluster_type",
        choices=["softmax", "mix", "sigmoid"],
        help="softmax: exactly 1 cluster/item; sigmoid: 0..n; mix: 1..n",
        default="mix",
        type=str,
    )

    update_manager_command_parser(parser)
    recurrent_layers_command_parser(parser)
    sequence_noise_command_parser(parser)
    target_selection_command_parser(parser)


def get_predictor(args):
    """Build the predictor described by the parsed flags, on
    ``args.device`` (default cuda)."""
    args.layers = [int(x) for x in str(args.layers).split("-")]
    device = getattr(args, "device", "cuda")

    mf = dict(
        reg=args.regularization,
        learning_rate=args.learning_rate,
        annealing=args.cooling,
        init_sigma=args.init_sigma,
        device=device,
    )
    if args.method == "BPRMF":
        from seqrec_tpu_torch.models.factorization import BPRMF

        return BPRMF(
            k=args.hidden, adaptive_sampling=(not args.no_adaptive_sampling), sampling_bias=args.fpmc_bias, **mf
        )
    if args.method == "FPMC":
        from seqrec_tpu_torch.models.factorization import FPMC

        return FPMC(
            k_cf=args.k_cf, k_mc=args.k_mc, adaptive_sampling=(not args.no_adaptive_sampling),
            sampling_bias=args.fpmc_bias, **mf,
        )
    if args.method == "FISM" and args.clusters <= 0:
        from seqrec_tpu_torch.models.factorization import FISM

        return FISM(k=args.hidden, loss=args.loss, alpha=args.fism_alpha, **mf)
    if args.method == "Fossil":
        from seqrec_tpu_torch.models.factorization import Fossil

        return Fossil(k=args.hidden, order=args.fossil_order, alpha=args.fism_alpha, **mf)
    if args.method == "LTM":
        from seqrec_tpu_torch.models.ltm import LTM

        return LTM(
            k=args.hidden,
            alpha=args.ltm_damping,
            window=args.ltm_window,
            learning_rate=args.learning_rate,
            use_trajectory=(not args.ltm_no_trajectory),
            device=device,
        )
    if args.method == "UKNN":
        from seqrec_tpu_torch.models.lazy import UserKNN

        return UserKNN(neighborhood_size=args.ns)
    if args.method == "POP":
        from seqrec_tpu_torch.models.lazy import Pop

        return Pop()
    if args.method == "MM":
        from seqrec_tpu_torch.models.lazy import MarkovModel

        return MarkovModel()

    if args.method == "SDA":
        from seqrec_tpu_torch.models.sdae import StackedDenoisingAutoencoder

        return StackedDenoisingAutoencoder(
            interactions_are_unique=(not args.repeated_interactions),
            layers=args.layers,
            input_dropout=args.input_dropout,
            dropout=args.dropout,
            updater=get_update_manager(args),
            batch_size=args.batch_size,
            use_ratings_features=args.rf,
            device=device,
        )

    common_rnn = dict(
        interactions_are_unique=(not args.repeated_interactions),
        max_length=args.max_length,
        updater=get_update_manager(args),
        target_selection=get_target_selection(args),
        sequence_noise=get_sequence_noise(args),
        recurrent_layer=get_recurrent_layers(args),
        use_ratings_features=args.rf,
        use_movies_features=args.mf,
        use_users_features=args.uf,
        batch_size=args.batch_size,
        compute_dtype="bfloat16" if args.bf16 else "float32",
        lazy_updates=args.lazy_updates,
        device=device,
    )
    if args.clusters > 0:
        from seqrec_tpu_torch.models.cluster import FISMCluster, RNNCluster

        common_cluster = dict(
            loss=args.loss,
            predict_with_clusters=(not args.ignore_clusters),
            sampling_bias=args.sampling_bias,
            sampling=args.sampling,
            cluster_sampling=args.c_sampling,
            init_scale=args.init_scale,
            scale_growing_rate=args.scale_growing_rate,
            max_scale=args.max_scale,
            n_clusters=args.clusters,
            cluster_type=args.cluster_type,
            **common_rnn,
        )
        if args.method == "FISM":
            return FISMCluster(h=args.hidden, reg=args.regularization, alpha=args.fism_alpha, **common_cluster)
        return RNNCluster(cluster_selection_noise=args.csn, **common_cluster)
    if args.loss == "CCE":
        from seqrec_tpu_torch.models.rnn_one_hot import RNNOneHot

        return RNNOneHot(diversity_bias=args.diversity_bias, regularization=args.regularization, **common_rnn)
    if args.loss in ("hinge", "logit", "logsig"):
        from seqrec_tpu_torch.models.rnn_margin import RNNMargin

        return RNNMargin(
            loss_function=args.loss,
            balance=args.balance,
            popularity_based=args.pb,
            min_access=args.min_access,
            **common_rnn,
        )
    if args.loss in ("BPR", "TOP1", "Blackout"):
        from seqrec_tpu_torch.models.rnn_sampling import RNNSampling

        return RNNSampling(
            loss_function=args.loss,
            diversity_bias=args.diversity_bias,
            sampling=args.sampling,
            sampling_bias=args.sampling_bias,
            **common_rnn,
        )
    raise ValueError("Unknown loss for the RNN model")
