from seqrec_tpu_torch.data.dataset import DataHandler, SequenceGenerator, SequenceStore
from seqrec_tpu_torch.data.noise import SequenceNoise, get_sequence_noise, sequence_noise_command_parser
from seqrec_tpu_torch.data.targets import SelectTargets, get_target_selection, target_selection_command_parser

__all__ = [
    "DataHandler",
    "SequenceGenerator",
    "SequenceStore",
    "SequenceNoise",
    "SelectTargets",
    "get_sequence_noise",
    "get_target_selection",
    "sequence_noise_command_parser",
    "target_selection_command_parser",
]
