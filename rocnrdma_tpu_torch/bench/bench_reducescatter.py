"""``bench_reducescatter`` - the reduce-scatter sweep, on PyTorch/CUDA.

Rank r ends with the ``--redop``-reduced r-th 1/n of its buffer; busbw
factor (n-1)/n. Arms: ``ring`` (the explicit PyTorch ring), ``fused`` (one
library reduction) and ``cuda_ring`` (the hand-written ring kernel in
reduce-scatter mode, sum only, at sizes that are a multiple of ``n*128``
elements). With ``--fake-devices N`` the N ranks share one GPU, so the
bandwidth is the card's HBM at work, not NVLink.

Examples::

    python -m rocnrdma_tpu_torch.bench.bench_reducescatter --fake-devices 8 \\
        --algos cuda_ring,ring,fused
    python -m rocnrdma_tpu_torch.bench.bench_reducescatter --ranks 4 \\
        --sizes 16K --platform cpu --fake-devices 4
"""

from __future__ import annotations

import sys

from rocnrdma_tpu_torch.bench import cli_common, runner


def main(argv=None) -> int:
    args = runner.make_parser("bench_reducescatter", "reducescatter").parse_args(argv)
    runner.run_sweep("bench_reducescatter", "reducescatter", args)
    return 0


if __name__ == "__main__":
    sys.exit(cli_common.main(main))
