"""Collective schedules on rank-major tensors: allreduce, reduce-scatter,
allgather and alltoall(v)."""

from rocnrdma_tpu_torch.collectives.alltoall import (  # noqa: F401
    bruck_alltoall,
    fused_alltoallv,
    ragged_mask,
    rotation_alltoall,
)
from rocnrdma_tpu_torch.collectives.fused import (  # noqa: F401
    fused_allgather,
    fused_allreduce,
    fused_alltoall,
    fused_reduce_scatter,
)
from rocnrdma_tpu_torch.collectives.reduce_op import (  # noqa: F401
    REDUCE_OPS,
    combine_fn,
    finalize,
    identity,
)
from rocnrdma_tpu_torch.collectives.ring import (  # noqa: F401
    ring_allgather,
    ring_allreduce,
    ring_reduce_scatter,
)
