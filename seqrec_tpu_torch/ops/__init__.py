from seqrec_tpu_torch.ops.core import masked_top_k
from seqrec_tpu_torch.ops.gather_sum import gather_sum

__all__ = ["gather_sum", "masked_top_k"]
