"""The port's predictors and their building blocks.

``rnn_one_hot.RNNOneHot``, ``rnn_sampling.RNNSampling`` and
``rnn_margin.RNNMargin`` (the RNN heads), ``cluster.RNNCluster`` and
``cluster.FISMCluster`` (the clustered-softmax models),
``sdae.StackedDenoisingAutoencoder``, ``ltm.LTM``, the factorization
family ``factorization.BPRMF``, ``FPMC``, ``FISM`` and ``Fossil``, and the
lazy baselines
``lazy.Pop``, ``lazy.MarkovModel`` and ``lazy.UserKNN``; ``get_predictor`` in
``utils/command_parser.py`` builds them from the CLI flags.
"""

from seqrec_tpu_torch.models.recurrent import (
    RecurrentLayers,
    get_recurrent_layers,
    recurrent_layers_command_parser,
)
from seqrec_tpu_torch.models.updates import get_update_manager, update_manager_command_parser

__all__ = [
    "RecurrentLayers",
    "get_recurrent_layers",
    "get_update_manager",
    "recurrent_layers_command_parser",
    "update_manager_command_parser",
]
