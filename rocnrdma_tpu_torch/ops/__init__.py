"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version. Sources are in ``ops/csrc/``; ``ops/_build.py`` compiles them at
first use. Importing this package builds and loads nothing."""

from rocnrdma_tpu_torch.ops import local_cuda, ring_cuda
from rocnrdma_tpu_torch.ops.local_cuda import hbm_combine, hbm_combine_plain  # noqa: F401
from rocnrdma_tpu_torch.ops.ring_cuda import (  # noqa: F401
    hbm_ring_allreduce,
    hbm_ring_allreduce_plain,
    ring_allreduce,
    ring_allreduce_plain,
)

_COUNTERS = (local_cuda.LAUNCHES, ring_cuda.LAUNCHES)


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {k: v for c in _COUNTERS for k, v in c.items()}


def reset_launch_counts() -> None:
    for c in _COUNTERS:
        for k in c:
            c[k] = 0
