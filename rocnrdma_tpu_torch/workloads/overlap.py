"""Compute/communication overlap workload (the DDP backward-overlap figure).

Counterpart of ``rocnrdma_tpu/workloads/overlap.py``: a layer-by-layer
loop where step i runs a matmul (the "backward of layer i-1") while
allreducing an independent gradient buffer (the "bucket of layer i"), the
dependency shape a DDP trainer hands the scheduler. Three callables over
the same mesh:

- ``compute``: the matmul chain alone, ``y = tanh(y @ W)`` per layer;
- ``comm``: the per-layer gradient allreduce alone;
- ``both``: matmul and allreduce per layer. On the card the allreduces
  run on a second CUDA stream, joined to the caller's stream by events,
  so the card may run them beside the matmuls: the PyTorch form of the
  one program the reference hands XLA's scheduler. On the CPU they run in
  order.

Overlap metric: ``overlap_frac = (Tc + Tm - Tboth) / min(Tc, Tm)``, the
fraction of the shorter phase hidden under the longer (1.0 = fully
hidden, 0 = serial, < 0 = combining hurt).

Across processes (a launcher's environment, ``cli_common``), each process
is one rank of ``rank_mesh(N, group=WORLD)`` holding its rows of the
inputs drawn whole; the side stream runs the spanning ``fused`` (NCCL with
a GPU a process, gloo staged through pinned memory on one card) or
``ring`` allreduce. Each of the three times is its maximum over the ranks
(a barrier before each repeat), and ``overlap_frac`` is computed from
those; rank 0 alone prints and writes ``--out``.

Usage::

    python -m rocnrdma_tpu_torch.workloads.overlap --fake-devices 8 --layers 4 --platform cpu
    torchrun --nproc-per-node 4 -m rocnrdma_tpu_torch.workloads.overlap
"""

from __future__ import annotations

import argparse
import contextlib
import sys

import numpy as np
import torch

from rocnrdma_tpu_torch import metrics as M
from rocnrdma_tpu_torch.bench import cli_common
from rocnrdma_tpu_torch.bench.runner import DTYPES
from rocnrdma_tpu_torch.bench.timing import time_fn
from rocnrdma_tpu_torch.transport import Transport
from rocnrdma_tpu_torch.workloads import from_numpy


def build_fns(t: Transport, algo: str = "fused"):
    """(compute, comm, both) callables over ``t``'s mesh. Shapes (global,
    rank-leading): ``y (ranks..., b, d)``, ``Ws (K, d, d)`` (replicated),
    ``grads (ranks..., K, g)``."""
    if algo == "ring":
        if t.is_2d:
            raise ValueError("ring overlap needs a 1-D rank mesh")
    elif algo != "fused":
        raise ValueError(f"overlap workload knows algos fused|ring, not {algo!r}")
    reduce_g = t.jit_fn("allreduce", algo)
    streams: dict = {}  # device -> the comm stream of ``both``

    def compute(y, Ws):
        for W in Ws:
            y = torch.tanh(y @ W)
        return y

    def comm(grads):
        return torch.stack([reduce_g(grads[..., k, :]) for k in range(grads.shape[-2])],
                           dim=-2)

    def both(y, Ws, grads):
        side = None
        if y.device.type == "cuda":
            main = torch.cuda.current_stream(y.device)
            side = streams.get(y.device)
            if side is None:
                side = streams[y.device] = torch.cuda.Stream(y.device)
            side.wait_stream(main)  # the grads are ready on the caller's stream
        outs = []
        for k, W in enumerate(Ws):
            y = torch.tanh(y @ W)
            with torch.cuda.stream(side) if side is not None else contextlib.nullcontext():
                outs.append(reduce_g(grads[..., k, :]))
        if side is not None:
            main.wait_stream(side)
            for o in outs:  # made on the side stream, read and freed on main
                o.record_stream(main)
            grads.record_stream(side)
        return y, torch.stack(outs, dim=-2)

    return compute, comm, both


def example_inputs(t: Transport, layers: int, dim: int, batch: int,
                   grad_elems: int, dtype: str = "float32", seed: int = 0):
    """``(y, Ws, grads)`` on ``t``'s device, with the reference's values in
    float32 (the same numpy draws and arithmetic); bfloat16 casts those on
    the device."""
    lead = tuple(t.mesh.shape)
    rng = np.random.default_rng(seed)
    tdt = DTYPES[dtype]
    y = rng.standard_normal(lead + (batch, dim)).astype(np.float32) * 0.1
    Ws = rng.standard_normal((layers, dim, dim)).astype(np.float32) * (1.0 / np.sqrt(dim))
    grads = rng.standard_normal(lead + (layers, grad_elems)).astype(np.float32)
    Ws = from_numpy(Ws, t.device, torch.float32).to(tdt)
    return t.shard(y, tdt), Ws, t.shard(grads, tdt)


def measure(t: Transport, layers: int, dim: int, batch: int, grad_elems: int,
            algo: str = "fused", dtype: str = "float32",
            repeats: int = 5, iters: int = 3) -> dict:
    compute, comm, both = build_fns(t, algo)
    y, Ws, grads = example_inputs(t, layers, dim, batch, grad_elems, dtype)
    kw = dict(repeats=repeats, calls_per_repeat=iters, span=t.span)
    tc = time_fn(compute, y, Ws, **kw).mean_s
    tm = time_fn(comm, grads, **kw).mean_s
    tb = time_fn(both, y, Ws, grads, **kw).mean_s
    overlap = (tc + tm - tb) / max(min(tc, tm), 1e-12)
    return {"compute_s": tc, "comm_s": tm, "both_s": tb, "overlap_frac": overlap}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="overlap",
        description="compute/comm overlap measurement (DDP backward-overlap "
                    "figure): matmul chain vs gradient allreduce vs both")
    p.add_argument("--layers", type=int, default=8)
    p.add_argument("--dim", type=int, default=512)
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--grad-kb", type=float, default=256.0,
                   help="per-layer gradient bucket, KiB per rank")
    p.add_argument("--dtype", choices=tuple(DTYPES), default="float32")
    p.add_argument("--algo", default="fused", choices=["fused", "ring"])
    p.add_argument("--ranks", type=int, default=None)
    p.add_argument("--mesh2d", type=str, default=None, metavar="SLICESxPER")
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--fake-devices", type=int, default=None)
    p.add_argument("--platform", choices=("auto", "cpu"), default="auto")
    p.add_argument("--out", default=None, help="JSONL output path")
    args = p.parse_args(argv)

    topo = cli_common.setup_backend(args.fake_devices, args.platform, args.ranks,
                                    across=True)
    t = Transport(cli_common.build_mesh(args.mesh2d, args.ranks, topo))
    itemsize = DTYPES[args.dtype].itemsize
    grad_elems = max(1, int(args.grad_kb * 1024) // itemsize)
    res = measure(t, args.layers, args.dim, args.batch, grad_elems, algo=args.algo,
                  dtype=args.dtype, repeats=args.repeats, iters=args.iters)

    grad_bytes = args.layers * grad_elems * itemsize
    rec = M.BenchRecord.measure(
        "overlap", "allreduce", args.algo, t.n_ranks, grad_bytes, args.dtype,
        res["both_s"], platform=topo.platform, layers=args.layers, dim=args.dim,
        batch=args.batch, compute_s=res["compute_s"], comm_s=res["comm_s"],
        overlap_frac=res["overlap_frac"], device=topo.device_name,
        **cli_common.link_extra(topo, t.span, t.n_ranks))
    if not cli_common.is_lead():
        return 0
    if args.out:
        with open(args.out, "a") as fp:
            rec.write(fp)
    print(M.format_table([rec]))
    print(f"#  compute {res['compute_s'] * 1e3:8.2f} ms | "
          f"comm {res['comm_s'] * 1e3:8.2f} ms | "
          f"both {res['both_s'] * 1e3:8.2f} ms | "
          f"overlap {res['overlap_frac'] * 100:5.1f}% of the shorter phase hidden")
    return 0


if __name__ == "__main__":
    sys.exit(cli_common.main(main))
