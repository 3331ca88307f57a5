"""``bench_alltoall`` - alltoall algorithmic bandwidth, the MoE
dispatch/combine primitive, on PyTorch/CUDA (``BASELINE.json:2``).

Each rank holds S bytes, n chunks of S/n, chunk d destined for rank d.
Arms: ``ring`` (the rotation schedule), ``bruck`` (log-step), ``fused``
(one transpose) and ``cuda_ring`` (the hand-written direct alltoall
kernel). Every point is checked for exact equality. With
``--fake-devices N`` the N ranks share one GPU, so the bandwidth is the
card's HBM at work, not NVLink.

Examples::

    python -m rocnrdma_tpu_torch.bench.bench_alltoall --fake-devices 8 \\
        --algos cuda_ring,ring,bruck,fused
    python -m rocnrdma_tpu_torch.bench.bench_alltoall --ranks 4 \\
        --sizes 16K --platform cpu --fake-devices 4
"""

from __future__ import annotations

import sys

from rocnrdma_tpu_torch.bench import cli_common, runner


def main(argv=None) -> int:
    args = runner.make_parser("bench_alltoall", "alltoall").parse_args(argv)
    runner.run_sweep("bench_alltoall", "alltoall", args)
    return 0


if __name__ == "__main__":
    sys.exit(cli_common.main(main))
