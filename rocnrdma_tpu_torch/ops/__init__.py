"""Hand-written kernels of the port, each beside its plain PyTorch version:
CUDA sources in ``ops/csrc/`` (``ops/_build.py`` compiles them at first
use) and one Triton kernel (``ops/local_triton.py``, compiled at first
launch). Importing this package builds and loads nothing."""

import torch

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

def cuda_ring_plain(collective: str, full: torch.Tensor) -> torch.Tensor:
    """The ``cuda_ring`` arm's result on every rank's rows ``full`` (n, ...)
    from its kernels' plain PyTorch versions, with the arm's tiles
    (``collective``: the runner's name, ``reducescatter`` among them)."""
    from rocnrdma_tpu_torch.transport.api import cuda_ring_tile_rows

    if collective == "alltoall":
        return alltoall_cuda.alltoall_plain(full)
    verb = {"reducescatter": "reduce_scatter"}.get(collective, collective)
    tile_rows = cuda_ring_tile_rows(full, verb)
    if collective == "allreduce":
        return (ring_cuda.ring_allreduce_plain(full) if tile_rows is None
                else ring_cuda.hbm_ring_allreduce_plain(full.clone(), tile_rows))
    if collective == "reducescatter":
        return ring_cuda.ring_reduce_scatter_plain(full, tile_rows)
    return ring_cuda.ring_allgather_plain(full, tile_rows)


_COUNTERS = (local_cuda.LAUNCHES, ring_cuda.LAUNCHES, alltoall_cuda.LAUNCHES,
             local_triton.LAUNCHES)


_STAGED = (ring_cuda.STAGED_BYTES, alltoall_cuda.STAGED_BYTES)


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {k: v for c in _COUNTERS for k, v in c.items()}


def staged_bytes() -> dict[str, int]:
    """Bytes the wrappers across processes staged before the kernel
    (``<wrapper>_in``) and sliced or copied back after it
    (``<wrapper>_out``) since the last reset: 0 for aligned rows."""
    return {k: v for c in _STAGED for k, v in c.items()}


def reset_launch_counts() -> None:
    """Zero the launch counts and the staged bytes."""
    for c in _COUNTERS + _STAGED:
        for k in c:
            c[k] = 0
