"""``bench_small_calls`` - the host path of the Transport's small calls.

Each verb's ``cuda_ring`` and ``fused`` arm (allreduce, reduce_scatter,
allgather, alltoall) through ``Transport.jit_fn``, 8 ranks on one GPU,
fp32, at 4 KiB, 64 KiB, 1 MiB and 16 MiB per rank: the CUDA-event span of
10 back-to-back calls (what a caller waits, host enqueue included), and,
at 4 KiB, every arm's host enqueue time and its device time with the host
out of the way (``timing.enqueue_s`` / ``timing.device_s``). One JSON line
per run.

It reads only ``Transport.jit_fn``, ``rank_mesh``, the ops' build and
``bench/timing.py``, so it runs against an older tree's package too: put
that tree's root first on ``PYTHONPATH`` and run this file by its path, in
turns with the current tree in one call on one card (older, current,
current, older)::

    PYTHONPATH=/path/to/older python rocnrdma_tpu_torch/bench/bench_small_calls.py \\
        --label older
    python -m rocnrdma_tpu_torch.bench.bench_small_calls --label current
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from rocnrdma_tpu_torch.bench.timing import device_s, enqueue_s, time_fn
from rocnrdma_tpu_torch.ops import _build
from rocnrdma_tpu_torch.runtime import rank_mesh
from rocnrdma_tpu_torch.transport import Transport

SIZES = (4096, 65536, 1 << 20, 16 << 20)


def run(label: str, n: int = 8, calls: int = 200) -> dict:
    for name in _build.build():
        _build.load(name)
    t = Transport(rank_mesh(n))
    g = torch.Generator(device="cuda").manual_seed(0)
    res = {"label": label, "device": torch.cuda.get_device_name(0),
           "span_us": {}, "split_4k_us": {}}
    for size in SIZES:
        e = size // 4
        shapes = {"allreduce": (n, e), "reduce_scatter": (n, e),
                  "allgather": (n, e // n), "alltoall": (n, n, e // n)}
        for verb, shape in shapes.items():
            x = torch.randn(shape, generator=g, device="cuda")
            for algo in ("cuda_ring", "fused"):
                fn = t.jit_fn(verb, algo)
                key = f"{verb}/{algo}"
                res["span_us"][f"{key}/{size}"] = time_fn(
                    fn, x, warmup=20, repeats=7, calls_per_repeat=10).mean_s * 1e6
                if size == SIZES[0]:
                    h = enqueue_s(lambda: fn(x), calls)
                    res["split_4k_us"][key] = {
                        "host": h * 1e6, "device": device_s(lambda: fn(x), calls, h) * 1e6}
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="bench_small_calls", description=__doc__.split("\n")[0])
    p.add_argument("--label", default="current", help="names the tree in the JSON line")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible; bench_small_calls times the card")
    print("small_calls " + json.dumps(run(args.label)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
