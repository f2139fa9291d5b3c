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
