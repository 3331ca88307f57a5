"""``bench_local`` - the on-device combine, the memory-bound half of a ring
step, timed three ways:

  torch2 / torch3   a chain of ``torch.add`` (counterpart of xla2 / xla3)
  cuda2 / cuda3     ``ops.hbm_combine``, the hand-written CUDA combine
                    kernel (counterpart of pallas2 / pallas3)
  pipe2 / pipe3     ``ops.hbm_combine_pipelined``, the persistent Triton
                    kernel whose loads the compiler's pipeliner overlaps
                    (the same names as the reference's emit_pipeline rows)

The trailing digit is the operand count: 2 = a ring step's fold, 3 = a
tree node's. On the CPU (``--platform cpu``) the cudaN and pipeN rows run
the kernels' plain version: correct, not a measurement of the kernels.

Timing: the two-depth chained marginal (``timing.marginal_s_per_op``);
GB/s counts (k+1) bytes moved per element (k reads + 1 write).
"""

from __future__ import annotations

import argparse
import json
import re
import sys

import numpy as np
import torch

from rocnrdma_tpu_torch import metrics as M
from rocnrdma_tpu_torch.bench import cli_common
from rocnrdma_tpu_torch.bench.runner import DTYPES, parse_size
from rocnrdma_tpu_torch.bench.timing import marginal_s_per_op
from rocnrdma_tpu_torch.ops import hbm_combine, hbm_combine_pipelined

KERNELS = ("torch2", "torch3", "cuda2", "cuda3", "pipe2", "pipe3")


def kernel_n_ops(kernel: str) -> int:
    """Operand count of a combine-kernel name (its trailing digits)."""
    m = re.search(r"(\d+)$", kernel)
    if not m:
        raise ValueError(f"kernel name {kernel!r} has no operand count")
    return int(m.group(1))


def combine_fn(kernel: str):
    """The one-step combine ``f(y, *bs) -> y + b1 + ... + b(k-1)``."""
    k = kernel_n_ops(kernel)
    if kernel.startswith("torch"):
        def f(y, *bs):
            out = y
            for b in bs[:k - 1]:
                out = torch.add(out, b)
            return out
        return f
    kernel_fn = hbm_combine_pipelined if kernel.startswith("pipe") else hbm_combine
    return lambda y, *bs: kernel_fn(y, *bs[:k - 1])


def make_combine_chain(kernel: str, k: int):
    """A callable running the combine ``k`` times, each step's output the
    next step's first operand."""
    f = combine_fn(kernel)

    def chain(x, *bs):
        for _ in range(k):
            x = f(x, *bs)
        return x
    return chain


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="bench_local",
        description="on-device combine: torch.add chain vs the hand-written "
                    "CUDA and Triton combine kernels")
    p.add_argument("--size", type=str, default=None,
                   help="per-operand bytes (default: 256M on the GPU, 512K "
                        "on the CPU)")
    p.add_argument("--kernels", type=str, default=None,
                   help=f"comma subset of {','.join(KERNELS)}")
    p.add_argument("--dtype", choices=tuple(DTYPES), default="float32")
    p.add_argument("--k1", type=int, default=4)
    p.add_argument("--k2", type=int, default=None,
                   help="deep chain depth (default 32 GPU / 8 CPU)")
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--trials", type=int, default=3)
    p.add_argument("--platform", choices=("auto", "cpu"), default="auto")
    p.add_argument("--out", type=str, default=None,
                   help="append JSONL records here")
    return p


def run(args) -> list[dict]:
    topo = cli_common.setup_backend(None, args.platform, default_ranks=1)
    dev = topo.device
    size = parse_size(args.size) if args.size else (
        512 * M.KiB if topo.is_oracle else 256 * M.MiB)
    k2 = args.k2 or (8 if topo.is_oracle else 32)
    kernels = args.kernels.split(",") if args.kernels else list(KERNELS)
    for kname in kernels:
        if kname not in KERNELS:
            raise SystemExit(f"unknown kernel {kname!r}; pick from {KERNELS}")
    dtype = DTYPES[args.dtype]
    elems = size // dtype.itemsize
    rng = np.random.default_rng(0)
    need = max(kernel_n_ops(k) for k in kernels)
    x0 = tuple(torch.from_numpy(rng.standard_normal((elems,), dtype=np.float32))
               .to(dev).to(dtype) for _ in range(need))

    # correctness gate before any timing: a 2-deep chain of each kernel vs
    # numpy on a slice of the operands; after two steps y = x + 2*sum(b)
    gate = min(elems, 1 << 16)
    x_gate = tuple(x[:gate].contiguous() for x in x0)
    f32 = [x.float().cpu().numpy() for x in x_gate]
    tol = 1e-3 if dtype.itemsize == 4 else 3e-2
    rows = []
    for kname in kernels:
        n_ops = kernel_n_ops(kname)
        want = f32[0] + 2 * sum(f32[1:n_ops])
        got = make_combine_chain(kname, 2)(*x_gate).float().cpu().numpy()
        if not np.allclose(got, want, rtol=tol, atol=tol):
            bad = int(np.argmax(~np.isclose(got, want, rtol=tol, atol=tol)))
            raise SystemExit(f"{kname}: self-check failed at element {bad} "
                             f"({got[bad]} vs {want[bad]})")
        sec = marginal_s_per_op(
            lambda k, kname=kname: make_combine_chain(kname, k),
            x0, args.k1, k2, args.repeats, args.trials)
        gbps = (n_ops + 1) * elems * dtype.itemsize / sec / 1e9
        rows.append({"bench": "bench_local", "kernel": kname,
                     "dtype": args.dtype, "size_bytes": size, "GBps": gbps, "s_per_op": sec,
                     "platform": topo.platform, "device": topo.device_name})
        print(f"{kname:8s} {args.dtype:9s} {size:>12d} B  {gbps:10.3f} GB/s  "
              f"{sec * 1e3:.4f} ms/op  on {topo.device_name}")
    if args.out:
        with open(args.out, "a") as fp:
            for rec in rows:
                fp.write(json.dumps(rec) + "\n")
    return rows


def main(argv=None) -> int:
    run(make_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
