"""``bench_broadcast`` - the broadcast sweep, on PyTorch/CUDA (the rccl-tests
``broadcast_perf`` slot of the reference's benchmark family).

Every rank ends with ``--root``'s buffer; busbw factor 1. Arms:
``binomial`` (recursive doubling, log2 n row copies) and ``fused`` (one
copy of root's row to every row). With ``--fake-devices N`` the N ranks
share one GPU, so the bandwidth is the card's HBM at work, not NVLink.

Examples::

    python -m rocnrdma_tpu_torch.bench.bench_broadcast --fake-devices 8 \\
        --algos binomial,fused --root 3 --sizes 256M
    python -m rocnrdma_tpu_torch.bench.bench_broadcast --ranks 6 --root 3 \\
        --sizes 16K --platform cpu --fake-devices 6
"""

from __future__ import annotations

import sys

from rocnrdma_tpu_torch.bench import cli_common, runner


def main(argv=None) -> int:
    args = runner.make_parser("bench_broadcast", "broadcast").parse_args(argv)
    runner.run_sweep("bench_broadcast", "broadcast", args)
    return 0


if __name__ == "__main__":
    sys.exit(cli_common.main(main))
