from seqrec_tpu_torch.ops.core import gather_sum, masked_top_k

__all__ = ["gather_sum", "masked_top_k"]
