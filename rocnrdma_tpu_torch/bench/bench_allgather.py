"""``bench_allgather`` - the allgather sweep, on PyTorch/CUDA.

Size convention, as in the reference: ``--sizes`` is the OUTPUT per-rank
size S; each rank contributes S/n. Arms: ``ring`` (the explicit PyTorch
ring), ``fused`` (one library concatenation) and ``cuda_ring`` (the
hand-written ring kernel in allgather mode). Every point is checked for
exact equality. With ``--fake-devices N`` the N ranks share one GPU, so
the bandwidth is the card's HBM at work, not NVLink.

Examples::

    python -m rocnrdma_tpu_torch.bench.bench_allgather --fake-devices 8 \\
        --algos cuda_ring,ring,fused
    python -m rocnrdma_tpu_torch.bench.bench_allgather --ranks 4 \\
        --sizes 16K --platform cpu --fake-devices 4
"""

from __future__ import annotations

import sys

from rocnrdma_tpu_torch.bench import cli_common, runner


def main(argv=None) -> int:
    args = runner.make_parser("bench_allgather", "allgather").parse_args(argv)
    runner.run_sweep("bench_allgather", "allgather", args)
    return 0


if __name__ == "__main__":
    sys.exit(cli_common.main(main))
