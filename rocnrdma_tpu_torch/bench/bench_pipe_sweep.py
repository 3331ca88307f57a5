"""``bench_pipe_sweep`` - the Triton combine kernel
(``ops/local_triton.py``) at each (BLOCK, NUM_STAGES) pair, beside the
CUDA combine kernel and ``torch.add``. Its numbers set the module
constants ``local_triton.BLOCK`` and ``local_triton.NUM_STAGES``. Needs
the card: Triton kernels run nowhere else.

    python -m rocnrdma_tpu_torch.bench.bench_pipe_sweep --size 256M \\
        --blocks 1024,2048,4096,8192,16384 --stages 1,2,3,4 --out pipe.jsonl

Every point is first held bitwise to ``hbm_combine_plain``, then timed with
CUDA events (``timing.time_fn``). ``GBps`` counts (k+1) bytes per element
moved (k reads + 1 write).
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from rocnrdma_tpu_torch.bench import cli_common
from rocnrdma_tpu_torch.bench.runner import DTYPES, parse_size
from rocnrdma_tpu_torch.bench.timing import time_fn
from rocnrdma_tpu_torch.ops import hbm_combine, hbm_combine_plain, local_triton


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="bench_pipe_sweep",
        description="Triton combine kernel per (BLOCK, NUM_STAGES)")
    p.add_argument("--size", type=str, default="256M", help="per-operand bytes")
    p.add_argument("--ks", type=str, default="2,3", help="operand counts")
    p.add_argument("--blocks", type=str, default="1024,2048,4096,8192,16384")
    p.add_argument("--stages", type=str, default="1,2,3,4")
    p.add_argument("--dtype", choices=tuple(DTYPES), default="float32")
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--out", type=str, default=None, help="append JSONL rows here")
    return p


def run(args) -> list[dict]:
    topo = cli_common.setup_backend(None, "auto", default_ranks=1)
    dtype = DTYPES[args.dtype]
    elems = parse_size(args.size) // dtype.itemsize
    ks = [int(k) for k in args.ks.split(",")]
    g = torch.Generator(device=topo.device).manual_seed(0)
    xs = [torch.randn((elems,), generator=g, device=topo.device).to(dtype)
          for _ in range(max(ks))]
    rows = []
    for k in ks:
        ops = xs[:k]
        want = hbm_combine_plain(*ops)
        nbytes = (k + 1) * elems * dtype.itemsize
        base = {"bench": "bench_pipe_sweep", "k": k, "dtype": args.dtype,
                "size_bytes": elems * dtype.itemsize, "device": topo.device_name}
        for name, fn in (("torch.add", lambda *_: hbm_combine_plain(*ops)),
                         ("cuda", lambda *_: hbm_combine(*ops))):
            ms = time_fn(fn, ops[0], repeats=args.repeats,
                         calls_per_repeat=args.iters).mean_s * 1e3
            rows.append({**base, "kernel": name, "ms": ms, "GBps": nbytes / ms / 1e6})
        for block in (int(b) for b in args.blocks.split(",")):
            for asked in (int(s) for s in args.stages.split(",")):
                stages = local_triton.stages_for(k, block, dtype.itemsize, asked)
                if stages != asked:
                    print(f"# skip k={k} BLOCK={block} NUM_STAGES={asked}: the "
                          f"load buffers do not fit shared memory", file=sys.stderr)
                    continue
                out = torch.empty_like(ops[0])

                def launch(*_, out=out, block=block, stages=stages):
                    local_triton._launch(ops, out, block, stages)
                launch()
                if not torch.equal(out, want):
                    raise SystemExit(f"k={k} BLOCK={block} NUM_STAGES={stages}: "
                                     f"disagrees with the plain version")
                ms = time_fn(launch, ops[0], repeats=args.repeats,
                             calls_per_repeat=args.iters).mean_s * 1e3
                rows.append({**base, "kernel": "triton", "block": block,
                             "num_stages": stages, "ms": ms,
                             "GBps": nbytes / ms / 1e6})
    for r in rows:
        print(f"k={r['k']} {r['kernel']:9s} block={r.get('block', '-'):>6} "
              f"stages={r.get('num_stages', '-'):>2}  {r['ms']:.4f} ms  "
              f"{r['GBps']:.1f} GB/s")
    if args.out:
        with open(args.out, "a") as fp:
            for r in rows:
                fp.write(json.dumps(r) + "\n")
    return rows


def main(argv=None) -> int:
    run(make_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
