"""The ("data", "model") mesh on ``torch.distributed`` (counterpart of
``seqrec_tpu/parallel/``): one process per rank, the catalog tables
sharded over "model", the batch over "data"."""

from seqrec_tpu_torch.parallel.distributed import init_distributed, make_pod_mesh, rank_device
from seqrec_tpu_torch.parallel.mesh import (
    Mesh,
    batch_rows,
    gather_params,
    index_payload_rows,
    make_mesh,
    param_sharding,
    shard_params,
    stacked_rows,
)

__all__ = [
    "Mesh",
    "batch_rows",
    "gather_params",
    "index_payload_rows",
    "init_distributed",
    "make_mesh",
    "make_pod_mesh",
    "param_sharding",
    "rank_device",
    "shard_params",
    "stacked_rows",
]
