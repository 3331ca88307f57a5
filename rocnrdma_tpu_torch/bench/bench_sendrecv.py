"""``bench_sendrecv`` - the sendrecv sweep, on PyTorch/CUDA (the rccl-tests
``sendrecv_perf`` slot of the reference's benchmark family).

Every rank sends its buffer to rank ``r + --shift`` (mod n) and receives
from ``r - shift``; busbw factor 1. One arm, ``fused`` (a roll of the rank
axis): the single step is the whole schedule. 1-D meshes only: with
``--mesh2d`` it exits 1. With ``--fake-devices N`` the N ranks share one
GPU, so the bandwidth is the card's HBM at work, not NVLink.

Examples::

    python -m rocnrdma_tpu_torch.bench.bench_sendrecv --fake-devices 8 \\
        --algos fused --shift 3 --sizes 256M
    python -m rocnrdma_tpu_torch.bench.bench_sendrecv --ranks 6 --shift 3 \\
        --sizes 16K --platform cpu --fake-devices 6
"""

from __future__ import annotations

import sys

from rocnrdma_tpu_torch.bench import cli_common, runner


def main(argv=None) -> int:
    args = runner.make_parser("bench_sendrecv", "sendrecv").parse_args(argv)
    runner.run_sweep("bench_sendrecv", "sendrecv", args)
    return 0


if __name__ == "__main__":
    sys.exit(cli_common.main(main))
