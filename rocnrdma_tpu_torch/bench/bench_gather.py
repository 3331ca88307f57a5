"""``bench_gather`` - the gather sweep, on PyTorch/CUDA (the rccl-tests
``gather_perf`` slot of the reference's benchmark family).

``--root``'s row ends with every rank's chunk in rank order, the other
rows zeroed; busbw factor (n-1)/n. ``--sizes`` is the gathered size, each
rank contributing S/n. Arms: ``binomial`` (subtree gather in virtual-rank
slot order) and ``fused`` (one copy). With ``--fake-devices N`` the N
ranks share one GPU, so the bandwidth is the card's HBM at work, not
NVLink.

Examples::

    python -m rocnrdma_tpu_torch.bench.bench_gather --fake-devices 8 \\
        --algos binomial,fused --root 3 --sizes 256M
    python -m rocnrdma_tpu_torch.bench.bench_gather --ranks 6 --root 3 \\
        --sizes 16K --platform cpu --fake-devices 6
"""

from __future__ import annotations

import sys

from rocnrdma_tpu_torch.bench import cli_common, runner


def main(argv=None) -> int:
    args = runner.make_parser("bench_gather", "gather").parse_args(argv)
    runner.run_sweep("bench_gather", "gather", args)
    return 0


if __name__ == "__main__":
    sys.exit(cli_common.main(main))
