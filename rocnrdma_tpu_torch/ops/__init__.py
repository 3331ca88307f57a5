"""Hand-written kernels of the port, each beside its plain PyTorch version:
CUDA sources in ``ops/csrc/`` (``ops/_build.py`` compiles them at first
use) and one Triton kernel (``ops/local_triton.py``, compiled at first
launch). Importing this package builds and loads nothing."""

from rocnrdma_tpu_torch.ops import alltoall_cuda, local_cuda, local_triton, ring_cuda
from rocnrdma_tpu_torch.ops.alltoall_cuda import (  # noqa: F401
    alltoall,
    alltoall_plain,
    alltoallv,
)
from rocnrdma_tpu_torch.ops.local_cuda import hbm_combine, hbm_combine_plain  # noqa: F401
from rocnrdma_tpu_torch.ops.local_triton import hbm_combine_pipelined  # noqa: F401
from rocnrdma_tpu_torch.ops.ring_cuda import (  # noqa: F401
    hbm_ring_allreduce,
    hbm_ring_allreduce_plain,
    ring_allgather,
    ring_allgather_plain,
    ring_allreduce,
    ring_allreduce_plain,
    ring_reduce_scatter,
    ring_reduce_scatter_plain,
)

_COUNTERS = (local_cuda.LAUNCHES, ring_cuda.LAUNCHES, alltoall_cuda.LAUNCHES,
             local_triton.LAUNCHES)


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {k: v for c in _COUNTERS for k, v in c.items()}


def reset_launch_counts() -> None:
    for c in _COUNTERS:
        for k in c:
            c[k] = 0
