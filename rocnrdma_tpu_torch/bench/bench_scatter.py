"""``bench_scatter`` - the scatter sweep, on PyTorch/CUDA (the rccl-tests
``scatter_perf`` slot of the reference's benchmark family).

``--root``'s buffer is split n ways and rank r ends with chunk r; busbw
factor (n-1)/n. Arms: ``binomial`` (halving scatter) and ``fused`` (one
copy). With ``--fake-devices N`` the N ranks share one GPU, so the
bandwidth is the card's HBM at work, not NVLink.

Examples::

    python -m rocnrdma_tpu_torch.bench.bench_scatter --fake-devices 8 \\
        --algos binomial,fused --root 3 --sizes 256M
    python -m rocnrdma_tpu_torch.bench.bench_scatter --ranks 6 --root 3 \\
        --sizes 16K --platform cpu --fake-devices 6
"""

from __future__ import annotations

import sys

from rocnrdma_tpu_torch.bench import cli_common, runner


def main(argv=None) -> int:
    args = runner.make_parser("bench_scatter", "scatter").parse_args(argv)
    runner.run_sweep("bench_scatter", "scatter", args)
    return 0


if __name__ == "__main__":
    sys.exit(cli_common.main(main))
