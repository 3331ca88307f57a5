"""``bench_allreduce`` - the north-star entrypoint, on PyTorch/CUDA.

Reports allreduce bus bandwidth (GB/s per rank) for the explicit ring
schedules, the hand-written CUDA ring (``cuda_ring``) and the fused
library reduction. With ``--fake-devices N`` the N ranks share one GPU,
so the bandwidth is the card's HBM at work, not NVLink.

Examples::

    # 8 ranks on the one GPU, every arm
    python -m rocnrdma_tpu_torch.bench.bench_allreduce --fake-devices 8 \\
        --algos cuda_ring,fused

    # the loopback correctness anchor on the CPU
    python -m rocnrdma_tpu_torch.bench.bench_allreduce --preset loopback2 \\
        --fake-devices 2 --platform cpu
"""

from __future__ import annotations

import sys

from rocnrdma_tpu_torch.bench import cli_common, runner


def main(argv=None) -> int:
    args = runner.make_parser("bench_allreduce", "allreduce").parse_args(argv)
    runner.run_sweep("bench_allreduce", "allreduce", args)
    return 0


if __name__ == "__main__":
    sys.exit(cli_common.main(main))
