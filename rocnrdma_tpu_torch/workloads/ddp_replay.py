"""DDP gradient-bucket trace replay (component C12; ``BASELINE.json:10``).

Counterpart of ``rocnrdma_tpu/workloads/ddp_replay.py``. Replays a
Llama-3-8B bucket trace (``llama_trace``) through the Transport's
allreduce, the traffic a data-parallel trainer makes each step, in three
modes (``workloads/_replay.py`` says what each measures on one stream):

- ``sequential``: allreduce each bucket and wait before the next;
- ``overlap``: issue every bucket in ready order with a bounded window of
  waits, one wait at the end;
- ``jit_fused``: one function allreducing all buckets, one wait.

Full-size Llama-3-8B gradients are ~32 GiB a rank in fp32, so the replay
divides every bucket's size by ``--scale`` (the count and order stay the
trace's) and reports both measured and full-size bytes. On the CPU the
bucket values are the reference's (numpy draws); on the card they are
made on the card, ~16 GiB at ``--scale 16`` that host draws would take
tens of seconds to make and copy.

Across processes (a launcher's environment, ``cli_common``), each
process is one rank of ``rank_mesh(N, group=WORLD)``: every bucket is
drawn whole, as one process draws it, one bucket at a time, and each
rank keeps its row, so rank r replays row r of the one-process run. Each
repeat starts after a barrier and each step time is the maximum over the
ranks; rank 0 alone prints and writes ``--out``. ``--check-plain`` holds
every ``cuda_ring`` result of every mode to its kernels' plain versions
on the whole buckets, bitwise, agreed across the fleet.

Usage::

    python -m rocnrdma_tpu_torch.workloads.ddp_replay --fake-devices 8 --scale 1024 \\
        --platform cpu
    python -m rocnrdma_tpu_torch.workloads.ddp_replay --fake-devices 8 --scale 16 \\
        --algo cuda_ring
    torchrun --nproc-per-node 4 -m rocnrdma_tpu_torch.workloads.ddp_replay \\
        --scale 16 --algo cuda_ring --check-plain
"""

from __future__ import annotations

import argparse
import math
import sys

import numpy as np
import torch

from rocnrdma_tpu_torch import metrics as M
from rocnrdma_tpu_torch import ops
from rocnrdma_tpu_torch.bench import cli_common
from rocnrdma_tpu_torch.bench.runner import DTYPES
from rocnrdma_tpu_torch.transport import Transport
from rocnrdma_tpu_torch.workloads import _replay
from rocnrdma_tpu_torch.workloads.llama_trace import LLAMA3_8B, Trace, generate_trace

MODES = ("sequential", "overlap", "jit_fused")


def whole_source(t: Transport, dtype: str):
    """``draw(shape)``: a whole rank-major buffer (every rank's rows,
    leading dims the mesh shape) of standard-normal values on ``t``'s
    device as ``dtype``, seeded. On the CPU the reference's draws (numpy
    ``default_rng(0)``, in call order); on the card a seeded generator on
    the card."""
    tdt = DTYPES[dtype]
    if t.device.type == "cpu":
        rng = np.random.default_rng(0)
        return lambda shape: torch.from_numpy(
            rng.standard_normal(size=shape, dtype=np.float32)).to(tdt)
    gen = torch.Generator(device=t.device).manual_seed(0)
    return lambda shape: torch.randn(shape, generator=gen, device=t.device).to(tdt)


def normal_source(t: Transport, dtype: str):
    """``draw(shape)``: ``whole_source``'s buffer of the whole ``shape`` as
    ``t`` holds it: the whole on one process, this process's rows (not a
    view of the whole, which is freed) on a mesh that spans processes."""
    whole = whole_source(t, dtype)
    if t.span is None:
        return whole
    return lambda shape: t.shard(whole(shape)).clone()


def plain_rows(t: Transport, dtype: str, draws) -> list:
    """This process's rows of the ``cuda_ring`` result on each buffer
    ``whole_source`` draws, in its order: ``draws`` is (runner collective,
    whole shape) a buffer. Each from its kernels' plain versions on the
    whole buffer, one buffer at a time, kept on the host, flat a rank."""
    whole = whole_source(t, dtype)
    rows = math.prod(t.mesh.local_shape)
    first = 0 if t.span is None else t.span.index * rows
    n = t.n_ranks
    return [ops.cuda_ring_plain(collective, whole(shape)).reshape(n, -1)[first:first + rows]
            .cpu() for collective, shape in draws]


def _bucket_arrays(t: Transport, trace: Trace, scale: int, dtype: str) -> list:
    """One rank-major buffer per bucket, ``max(1, numel // scale)`` elements
    a rank (values: ``normal_source``)."""
    lead = tuple(t.mesh.shape)
    draw = normal_source(t, dtype)
    return [draw(lead + (max(1, b.numel // scale),)) for b in trace.buckets]


def replay(t: Transport, bufs: list, algo: str, mode: str, repeats: int = 5,
           window: int = 0, cross_dtype=None, out: list | None = None) -> float:
    """Seconds for one full-trace replay (trimmed mean over repeats; across
    processes each repeat's maximum over the ranks).

    ``window`` bounds the waits in ``overlap`` mode (0 = unbounded).
    ``cross_dtype``: the cross-slice wire dtype of the hierarchical
    schedule (2-D meshes). ``out``: receives the last repeat's reduced
    buckets."""
    fn = t.jit_fn("allreduce", algo, cross_dtype=cross_dtype)
    if mode == "jit_fused":
        return _replay.timed_fused(lambda xs: [fn(x) for x in xs], (bufs,), repeats,
                                   t.device, out, t.span)
    for b in bufs:  # warm every bucket shape
        fn(b)
    _replay._sync(t.device)
    thunks = [lambda x=b: fn(x) for b in bufs]
    if mode == "sequential":
        return _replay.timed_sequential(thunks, repeats, t.device, out, t.span)
    if mode == "overlap":
        return _replay.timed_overlap(thunks, repeats, window, t.device, out, t.span)
    raise ValueError(f"unknown mode {mode!r}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="ddp_replay", description="Llama-3-8B DDP gradient-bucket allreduce replay")
    p.add_argument("--bucket-mb", type=float, default=25.0)
    p.add_argument("--dtype", choices=tuple(DTYPES), default="float32")
    p.add_argument("--scale", type=int, default=1024,
                   help="divide every bucket's numel by this (1 = full size)")
    p.add_argument("--ranks", type=int, default=None)
    p.add_argument("--mesh2d", type=str, default=None, metavar="SLICESxPER")
    p.add_argument("--algo", default="auto")
    p.add_argument("--cross-dtype", default=None, metavar="DTYPE",
                   help="cross-slice wire dtype for the hierarchical schedule "
                        "on --mesh2d runs (e.g. bfloat16)")
    p.add_argument("--modes", default=",".join(MODES))
    p.add_argument("--window", type=int, default=None,
                   help="max issues in flight in overlap mode (default: 4 on "
                        "the CPU, unbounded on the card)")
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--fake-devices", type=int, default=None)
    p.add_argument("--platform", choices=("auto", "cpu"), default="auto")
    p.add_argument("--out", default=None, help="JSONL output path")
    p.add_argument("--check-plain", action="store_true",
                   help="--algo cuda_ring: hold every mode's results to the "
                        "kernels' plain versions, bitwise")
    p.add_argument("--trace-out", default=None, help="write the trace JSON and exit")
    args = p.parse_args(argv)

    trace = generate_trace(LLAMA3_8B, bucket_mb=args.bucket_mb, dtype=args.dtype)
    if args.trace_out:
        with open(args.trace_out, "w") as fp:
            fp.write(trace.to_json())
        print(f"# wrote {len(trace.buckets)} buckets "
              f"({trace.total_bytes / M.GiB:.2f} GiB) to {args.trace_out}")
        return 0
    modes = args.modes.split(",")
    for mode in modes:
        if mode not in MODES:
            raise SystemExit(f"unknown mode {mode!r}; know {MODES}")

    topo = cli_common.setup_backend(args.fake_devices, args.platform, args.ranks,
                                    across=True)
    t = Transport(cli_common.build_mesh(args.mesh2d, args.ranks, topo))
    lead = cli_common.is_lead()
    bufs = _bucket_arrays(t, trace, args.scale, args.dtype)
    nlead = len(t.mesh.shape)
    scaled_bytes = sum(int(np.prod(b.shape[nlead:])) * b.element_size() for b in bufs)
    if lead:
        print(f"# {trace.model}: {len(bufs)} buckets, "
              f"{trace.total_bytes / M.GiB:.2f} GiB full / "
              f"{scaled_bytes / M.MiB:.1f} MiB at scale {args.scale}, "
              f"{t.n_ranks} ranks, algo={args.algo}", file=sys.stderr)
    plain = None
    if args.check_plain and args.algo == "cuda_ring":
        whole = tuple(t.mesh.shape)
        plain = plain_rows(t, args.dtype,
                           [("allreduce", whole + b.shape[nlead:]) for b in bufs])

    window = args.window if args.window is not None else _replay.default_window(topo)
    means, extras = _replay.run_modes(
        t, modes, lambda mode, out: replay(t, bufs, args.algo, mode, repeats=args.repeats,
                                           window=window, cross_dtype=args.cross_dtype,
                                           out=out),
        plain, f"ddp_replay {args.algo}")
    # speedups only against a measured sequential run
    base = means.get("sequential")

    records = []
    for mode in modes:
        extra = dict(mode=mode, n_buckets=len(bufs), scale=args.scale,
                     full_bytes=trace.total_bytes, cross_dtype=args.cross_dtype,
                     device=topo.device_name, **cli_common.link_extra(topo, t.span, t.n_ranks),
                     **extras[mode])
        if base is not None:
            extra["speedup_vs_sequential"] = base / means[mode]
        records.append(M.BenchRecord.measure(
            "ddp_replay", "allreduce", args.algo, t.n_ranks, scaled_bytes,
            args.dtype, means[mode], platform=topo.platform, **extra))
    if not lead:
        return 0
    if args.out:
        with open(args.out, "a") as fp:
            for rec in records:
                rec.write(fp)
    print(M.format_table(records))
    for r in records:
        speed = (f"  {r.extra['speedup_vs_sequential']:.2f}x vs sequential"
                 if "speedup_vs_sequential" in r.extra else "")
        print(f"#   {r.extra['mode']:>10}: {r.mean_s * 1e3:8.2f} ms/step{speed}")
    return 0


if __name__ == "__main__":
    sys.exit(cli_common.main(main))
