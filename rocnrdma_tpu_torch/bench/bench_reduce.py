"""``bench_reduce`` - the reduce sweep, on PyTorch/CUDA (the rccl-tests
``reduce_perf`` slot of the reference's benchmark family).

``--root``'s row ends as the ``--redop``-reduction of every rank's, the
other rows zeroed; busbw factor 1. Arms: ``binomial`` (the broadcast tree
in reverse, each receiver folding its partner's row) and ``fused`` (one
library reduction). With ``--fake-devices N`` the N ranks share one GPU,
so the bandwidth is the card's HBM at work, not NVLink.

Examples::

    python -m rocnrdma_tpu_torch.bench.bench_reduce --fake-devices 8 \\
        --algos binomial,fused --root 3 --redop avg --sizes 256M
    python -m rocnrdma_tpu_torch.bench.bench_reduce --ranks 6 --root 3 --redop avg \\
        --sizes 16K --platform cpu --fake-devices 6
"""

from __future__ import annotations

import sys

from rocnrdma_tpu_torch.bench import cli_common, runner


def main(argv=None) -> int:
    args = runner.make_parser("bench_reduce", "reduce").parse_args(argv)
    runner.run_sweep("bench_reduce", "reduce", args)
    return 0


if __name__ == "__main__":
    sys.exit(cli_common.main(main))
