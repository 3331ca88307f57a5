"""Collective schedules on rank-major tensors (allreduce only in this slice)."""

from rocnrdma_tpu_torch.collectives.fused import fused_allreduce  # noqa: F401
from rocnrdma_tpu_torch.collectives.reduce_op import (  # noqa: F401
    REDUCE_OPS,
    combine_fn,
    finalize,
    identity,
)
from rocnrdma_tpu_torch.collectives.ring import ring_allreduce  # noqa: F401
