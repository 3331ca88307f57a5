"""``bench_push_across`` - the kernels across processes, one rank a
process on one GPU each, fp32, at a rank's 64 MiB and 1 GiB (nccl-tests'
sizes: the row of the allreduce, the reduce_scatter and the alltoall, the
allgather's gathered row). The verbs (``--verbs``): ``allreduce``
(``ring_cuda.ring_allreduce_across``), ``allreduce_in_place``
(``hbm_ring_allreduce_across`` at 64-row tiles), ``reduce_scatter``
(``ring_reduce_scatter_across``), ``allgather``
(``ring_allgather_across``) and ``alltoall``
(``alltoall_cuda.alltoall_across``).

- ``--split``: each call's parts, on every rank: the device time before
  the kernel's launch (a copy into the IPC workspace, where a tree stages
  one), of the launch and after it (a copy out), between CUDA events
  recorded around ``ipc.Workspace.launch`` and at ``Workspace.finish``;
  the host seconds in ``finish``; the call's wall time after a barrier,
  the slowest rank's; the staged bytes where the wrappers count them; one
  steady call on rank 0 under ``torch.profiler``, its device kernels by
  name in order; and with NCCL its call for the same function, timed the
  same way (the allreduce's in place on a copy of the row, as
  ``all_reduce`` runs). ``--knobs B/V/S`` splits the reduce kernel at that
  geometry in place of ``KNOBS["reduce"]``. The wrappers are the ones importable from
  ``PYTHONPATH``, so the same script splits an older tree's calls: unpack
  it and put it first on ``PYTHONPATH``.
- ``--sweep``: the geometry of each verb's kernel (``ops/push_cuda.py``,
  ``KNOBS``): blocks an SM, vectors a thread and sub-step bytes, every
  point held bitwise to the rows it must give, the slowest rank's median
  wall time.

The timed rows are exact small integers, so they check what a call sums or
moves but not a reduction's order (every order gives the same bits). Both
modes therefore also hold one call of each reduction on random fp32 rows,
at every sweep point, bitwise to its plain version across processes
(``ring_cuda.*_across_plain``: the ring's order).

Every time stands beside its NVLink bound: (n-1)/n of a rank's bytes each
way at the datasheet's 450 GB/s, the allreduce's 2(n-1)/n (its reduce and
its allgather). Rank 0 prints one JSON line (``PUSHSPLIT`` or
``PUSHSWEEP``) and writes it to ``--out``. The script starts its own
processes (``--procs``, default one a GPU; NCCL with a GPU each, else gloo
with the rows on the one card)::

    python -m rocnrdma_tpu_torch.bench.bench_push_across --split --out split.json
    PYTHONPATH=old python rocnrdma_tpu_torch/bench/bench_push_across.py --split
    python -m rocnrdma_tpu_torch.bench.bench_push_across --sweep --sizes 64M,1G \
        --verbs allreduce,reduce_scatter

On the CPU (``--platform cpu``, gloo) the wrappers take their plain
versions: a rehearsal of the flow, no device numbers.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import subprocess
import sys
import time

if not __package__:  # run as a file: PYTHONPATH's package first, else this tree's
    sys.path.append(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

MiB = 1 << 20
NVLINK_GBPS = 450.0  # datasheet: NVLink 4, each way per H100
VERBS = ("allreduce", "allreduce_in_place", "reduce_scatter", "allgather", "alltoall")
# each verb's wrapper, by its launch and staged-bytes name
WRAPPER = {"allreduce": "ring_allreduce_across",
           "allreduce_in_place": "hbm_ring_allreduce_across",
           "reduce_scatter": "ring_reduce_scatter_across",
           "allgather": "ring_allgather_across", "alltoall": "alltoall_across"}
IN_PLACE_TILE_ROWS = 64


def _size(s: str) -> int:
    unit = {"K": 1 << 10, "M": MiB, "G": 1 << 30, "T": 1 << 40}
    return int(s[:-1]) * unit[s[-1]] if s[-1] in unit else int(s)


def _spawn(args) -> int:
    """Start ``args.procs`` copies of this script, one a rank; print rank
    0's output; fail if any rank failed."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    import rocnrdma_tpu_torch
    from rocnrdma_tpu_torch.ops import _build

    if args.platform != "cpu":
        _build.build()  # once, before the ranks load the libraries
    argv, skip = [], False
    for a in sys.argv[1:]:
        if not skip and not a.startswith("--procs"):
            argv.append(a)
        skip = a == "--procs"
    # the ranks import the package this process imported
    root = os.path.dirname(os.path.dirname(os.path.abspath(rocnrdma_tpu_torch.__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [v for v in [os.environ.get("PYTHONPATH")] if v]))
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), *argv,
                               "--rank", str(r), "--world", str(args.procs),
                               "--port", str(port)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(args.procs)]
    bad = 0
    for r, p in enumerate(procs):
        out, err = p.communicate(timeout=args.timeout)
        if r == 0:
            print(out, end="", flush=True)
        if p.returncode != 0:
            bad += 1
            print(f"rank {r} exit {p.returncode}\n{out[-2000:]}\n{err[-4000:]}",
                  file=sys.stderr, flush=True)
    return 1 if bad else 0


def _inputs(verb: str, n: int, rank: int, size: int, device):
    """This rank's row (1, n, size/n/4) or (1, size/4) or (1, size/n/4)
    fp32 and the result it must get, both from exact small integers: for
    the allgather and the alltoall rank r's element i of piece d is
    (r*n + d) * 2^20 + i mod 2^20; for the reductions rank r's element i is
    (r + 1) * 2^16 + i mod 2^16, so that every sum is exact (n <= 8) in
    whatever order it is folded."""
    import torch

    per = size // 4 // n
    if verb.startswith("allreduce") or verb == "reduce_scatter":
        i = torch.arange(n * per, device=device, dtype=torch.int64) % (1 << 16)
        x = ((rank + 1) * (1 << 16) + i).to(torch.float32)[None]
        want = (n * (n + 1) // 2 * (1 << 16) + n * i).to(torch.float32)[None]
        if verb == "reduce_scatter":
            want = want[:, rank * per:(rank + 1) * per].contiguous()
        return x, want
    i = torch.arange(per, device=device, dtype=torch.int64) % (1 << 20)
    if verb == "alltoall":
        d = torch.arange(n, device=device, dtype=torch.int64)[:, None]
        x = ((rank * n + d) * (1 << 20) + i).to(torch.float32)[None]
        want = ((d * n + rank) * (1 << 20) + i).to(torch.float32)[None]
    else:
        x = ((rank * n) * (1 << 20) + i).to(torch.float32)[None]
        j = torch.arange(n, device=device, dtype=torch.int64)[:, None]
        want = ((j * n) * (1 << 20) + i).to(torch.float32).reshape(1, -1)
    return x, want


def _random(verb: str, n: int, rank: int, size: int, device, span):
    """For a reduction, this rank's random fp32 row like ``_inputs``'s and
    its plain version's result across processes (the ring's order, the
    bits the kernel must give); None for the other verbs."""
    import torch

    from rocnrdma_tpu_torch.ops import ring_cuda

    if not (verb.startswith("allreduce") or verb == "reduce_scatter"):
        return None
    g = torch.Generator(device=device)
    g.manual_seed(1000 + rank)
    x = torch.randn((1, size // 4), generator=g, device=device, dtype=torch.float32)
    plain = {"allreduce": ring_cuda.ring_allreduce_across_plain,
             "allreduce_in_place": lambda x, span: ring_cuda._tiled_allreduce_across_plain(
                 x, span, IN_PLACE_TILE_ROWS),
             "reduce_scatter": ring_cuda.ring_reduce_scatter_across_plain}[verb]
    return x, plain(x, span)


def _call(verb: str, span):
    """The wrapper's call of ``verb`` (in place: it returns ``x``)."""
    from rocnrdma_tpu_torch.ops import alltoall_cuda, ring_cuda

    return {"allreduce": lambda x: ring_cuda.ring_allreduce_across(x, span),
            "allreduce_in_place": lambda x: ring_cuda.hbm_ring_allreduce_across(
                x, span, IN_PLACE_TILE_ROWS),
            "reduce_scatter": lambda x: ring_cuda.ring_reduce_scatter_across(x, span),
            "allgather": lambda x: ring_cuda.ring_allgather_across(x, span),
            "alltoall": lambda x: alltoall_cuda.alltoall_across(x, span)}[verb]


def _checked(verb: str, fn, x, want, rand=None) -> bool:
    """One call on ``x`` (in place: on a copy) equals ``want``, and with
    ``rand`` (``_random``'s pair) one call on its row is bitwise its result."""
    import torch

    def call(x):
        return fn(x.clone() if verb == "allreduce_in_place" else x)

    if not bool((call(x) == want).all()):
        return False
    return rand is None or torch.equal(call(rand[0]).view(torch.int32),
                                       rand[1].view(torch.int32))


def _ctl(dist, device):
    """The device of the bench's own exchanges: the rows' with NCCL, the
    host with gloo."""
    return device if dist.get_backend() == "nccl" else "cpu"


def _nccl(verb: str, dist, x):
    """NCCL's call for the same function as ``verb`` on rows like ``x``, its
    output allocated per call as the wrappers allocate theirs; the
    allreduce's in place on one copy of the row (``all_reduce`` has no
    other form)."""
    import torch

    def alltoall(x):
        out = torch.empty_like(x)
        dist.all_to_all_single(out.view(-1), x.view(-1))
        torch.cuda.synchronize()
        return out

    def allgather(x):
        out = x.new_empty((1, dist.get_world_size() * x.numel()))
        dist.all_gather_into_tensor(out.view(-1), x.view(-1))
        torch.cuda.synchronize()
        return out

    def reduce_scatter(x):
        out = x.new_empty((1, x.numel() // dist.get_world_size()))
        dist.reduce_scatter_tensor(out.view(-1), x.view(-1))
        torch.cuda.synchronize()
        return out

    y = x.clone() if verb.startswith("allreduce") else None

    def allreduce(_):
        dist.all_reduce(y)
        torch.cuda.synchronize()
        return y

    return {"alltoall": alltoall, "allgather": allgather, "reduce_scatter": reduce_scatter,
            "allreduce": allreduce, "allreduce_in_place": allreduce}[verb]


def _walls(fn, x, repeats: int, dist, device) -> list:
    """Each call's wall seconds after a barrier, the slowest rank's."""
    import torch

    out = []
    for _ in range(repeats):
        dist.barrier()
        t0 = time.perf_counter()
        fn(x)
        t = torch.tensor([time.perf_counter() - t0], dtype=torch.float64,
                         device=_ctl(dist, device))
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        out.append(t.item())
    return out


def _median(v: list) -> float:
    v = sorted(v)
    return v[len(v) // 2]


def _link_rows(verb: str) -> int:
    """A rank's bytes each way over the link in (n-1)/n of its row: the
    allreduce's reduce and allgather twice, the other verbs once."""
    return 2 if verb.startswith("allreduce") else 1


def _busbw(verb: str, size: int, n: int, seconds: float) -> float:
    """nccl-tests' bus bandwidth: 2(n-1)/n of the row (allreduce), else (n-1)/n."""
    return _link_rows(verb) * size / seconds / 1e9 * (n - 1) / n


def _bound_ms(verb: str, size: int, n: int) -> float:
    return _link_rows(verb) * (n - 1) / n * size / (NVLINK_GBPS * 1e9) * 1e3


def _split_parts(dist, device):
    """Wrap ``Workspace.launch`` and ``finish`` to record the events and the
    host seconds of each call; returns the list the records go into."""
    import torch

    from rocnrdma_tpu_torch.ops import ipc

    recs = []
    launch, finish = ipc.Workspace.launch, ipc.Workspace.finish

    def timed_launch(self, *a, **k):
        e1 = torch.cuda.Event(enable_timing=True)
        e1.record()
        launch(self, *a, **k)
        e2 = torch.cuda.Event(enable_timing=True)
        e2.record()
        if recs:
            recs[-1].update(e1=e1, e2=e2)

    def timed_finish(self):
        e3 = torch.cuda.Event(enable_timing=True)
        e3.record()
        t0 = time.perf_counter()
        finish(self)
        if recs:
            recs[-1].update(e3=e3, finish_s=time.perf_counter() - t0)

    ipc.Workspace.launch, ipc.Workspace.finish = timed_launch, timed_finish
    return recs


def _profile(fn, x, dist) -> list:
    """One call under ``torch.profiler``, after a barrier (the profiler's
    start must not hold this rank past the peers' bounded waits): its
    device kernels (name, us) in order of start."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        dist.barrier()
        fn(x)
        torch.cuda.synchronize()
    kern = [e for e in prof.events()
            if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    kern.sort(key=lambda e: e.time_range.start)
    return [(e.name, round(e.time_range.elapsed_us(), 3)) for e in kern]


def _split(args, rank, n, span, dist, device) -> dict:
    import torch

    from rocnrdma_tpu_torch import ops

    cuda = device.type == "cuda"
    if args.knobs:
        from rocnrdma_tpu_torch.ops import push_cuda

        base = push_cuda.geometry_for
        bps, vecs, step = args.knobs

        def knobbed(*a, kernel="push", **k):
            if kernel == "reduce":
                k.update(blocks_per_sm=bps, vecs=vecs, step_bytes=step)
            return base(*a, kernel=kernel, **k)

        push_cuda.geometry_for = knobbed
    recs = _split_parts(dist, device) if cuda else []
    res = {}
    for verb, size in itertools.product(args.verbs, args.sizes):
        x, want = _inputs(verb, n, rank, size, device)
        fn = _call(verb, span)
        rand = _random(verb, n, rank, size, device, span)
        if not _checked(verb, fn, x, want, rand):
            raise AssertionError(f"{verb} at {size} bytes: wrong result on rank {rank}")
        del rand
        staged = getattr(ops, "staged_bytes", dict)()
        recs.clear()
        walls = []
        for _ in range(args.repeats):
            dist.barrier()
            recs.append({})
            t0 = time.perf_counter()
            if cuda:
                e0 = torch.cuda.Event(enable_timing=True)
                e0.record()
                recs[-1]["e0"] = e0
            fn(x)
            walls.append(time.perf_counter() - t0)
        t = torch.tensor(walls, dtype=torch.float64, device=_ctl(dist, device))
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        wall = _median(t.tolist())
        row = {"checked": True}  # on the CPU a rehearsal: no device numbers
        if cuda:
            row.update(ms=round(wall * 1e3, 4),
                       busbw_GBps=round(_busbw(verb, size, n, wall), 2),
                       nvlink_bound_ms=round(_bound_ms(verb, size, n), 4))
            if dist.get_backend() == "nccl":  # the library call, timed the same way
                lib = _median(_walls(_nccl(verb, dist, x), x, args.repeats, dist, device))
                row.update(nccl_ms=round(lib * 1e3, 4),
                           nccl_busbw_GBps=round(_busbw(verb, size, n, lib), 2))
            torch.cuda.synchronize()
            parts = {"before_launch_ms": [r["e0"].elapsed_time(r["e1"]) for r in recs],
                     "launch_ms": [r["e1"].elapsed_time(r["e2"]) for r in recs],
                     "after_launch_ms": [r["e2"].elapsed_time(r["e3"]) for r in recs],
                     "finish_host_ms": [r["finish_s"] * 1e3 for r in recs]}
            mine = torch.tensor([_median(v) for v in parts.values()], dtype=torch.float64,
                                device=_ctl(dist, device))
            every = [torch.empty_like(mine) for _ in range(n)]
            dist.all_gather(every, mine)
            row["parts_ms_by_rank"] = {k: [round(float(e[i]), 4) for e in every]
                                       for i, k in enumerate(parts)}
            if rank == 0:
                row["profile_rank0_us"] = _profile(fn, x, dist)
            else:
                dist.barrier()
                fn(x)
        after = getattr(ops, "staged_bytes", dict)()
        row["staged_bytes"] = {k: v - staged.get(k, 0) for k, v in after.items()
                               if k.startswith(WRAPPER[verb] + "_")}
        res[f"{verb}/{size}"] = row
        del x, want
        if cuda:
            torch.cuda.empty_cache()
    return res


def _sweep(args, rank, n, span, dist, device) -> dict:
    import functools

    import torch

    from rocnrdma_tpu_torch.ops import push_cuda

    base = push_cuda.geometry_for
    grid = list(itertools.product(args.blocks_per_sm, args.vecs, args.step_bytes))
    res = {}
    for verb, size in itertools.product(args.verbs, args.sizes):
        x, want = _inputs(verb, n, rank, size, device)
        fn = _call(verb, span)
        rand = _random(verb, n, rank, size, device, span)
        kernel = "push" if verb in ("allgather", "alltoall") else "reduce"
        pts = {}
        for bps, vecs, step in grid:
            if vecs not in push_cuda.VECS_CHOICES[kernel]:
                continue
            push_cuda.geometry_for = functools.partial(base, blocks_per_sm=bps, vecs=vecs,
                                                       step_bytes=step)
            try:
                if not _checked(verb, fn, x, want, rand):
                    raise AssertionError(f"{verb} at {size}, {bps}/{vecs}/{step}: wrong "
                                         f"result on rank {rank}")
                wall = _median(_walls(fn, x, args.repeats, dist, device))
            finally:
                push_cuda.geometry_for = base
            pv = size // n // push_cuda.VEC
            geo = base(device.index, n, pv, span.per_card, kernel=kernel, blocks_per_sm=bps,
                       vecs=vecs, step_bytes=step)
            pts[f"{bps}/{vecs}/{step}"] = {"ms": round(wall * 1e3, 4),
                                           "lanes": geo.lanes, "steps": geo.steps}
        best = min(pts, key=lambda k: pts[k]["ms"])
        res[f"{verb}/{size}"] = {"points": pts, "best": best,
                                 "nvlink_bound_ms": round(_bound_ms(verb, size, n), 4)}
        del x, want, rand
        torch.cuda.empty_cache()
    return res


def _rank(args) -> int:
    import torch
    import torch.distributed as dist

    from rocnrdma_tpu_torch.runtime.mesh import rank_mesh

    n, rank = args.world, args.rank
    cuda = args.platform != "cpu"
    gpus = torch.cuda.device_count() if cuda else 0
    if cuda:
        torch.cuda.set_device(rank % gpus)
    device = torch.device("cuda", rank % gpus) if cuda else torch.device("cpu")
    backend = "nccl" if cuda and gpus >= n else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{args.port}",
                            world_size=n, rank=rank)
    span = rank_mesh(n, device, group=dist.group.WORLD).span
    res = (_split if args.split else _sweep)(args, rank, n, span, dist, device)
    if rank == 0:
        smi = "not measured"
        if cuda:
            smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                  "--format=csv,noheader"], capture_output=True,
                                 text=True).stdout.strip().splitlines()
            smi = f"{smi[0]} x {n}" if smi else "nvidia-smi gave nothing"
        line = {"card": smi, "ranks": n, "backend": backend, "results": res}
        tag = "PUSHSPLIT" if args.split else "PUSHSWEEP"
        print(f"{tag} " + json.dumps(line), flush=True)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(line, f, indent=1)
    span.close()
    dist.destroy_process_group()
    sys.stdout.flush()
    os._exit(0)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="bench_push_across", description=__doc__.split("\n")[0])
    mode = p.add_mutually_exclusive_group(required=True)
    mode.add_argument("--split", action="store_true")
    mode.add_argument("--sweep", action="store_true")
    p.add_argument("--sizes", default="64M,1G",
                   help="a rank's bytes: the row, the allgather's gathered row")
    p.add_argument("--verbs", default=",".join(VERBS), help=f"a comma list of {VERBS}")
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--blocks-per-sm", default="1,2,4")
    p.add_argument("--vecs", default="1,2,4,8",
                   help="vectors a thread (each kernel sweeps those it is built for)")
    p.add_argument("--step-bytes", default="32K,128K,512K,1T",
                   help="sub-step bytes a piece (1T: one sub-step a lane)")
    p.add_argument("--knobs", default=None,
                   help="--split: the reduce kernel's blocks an SM/vectors/sub-step bytes")
    p.add_argument("--procs", type=int, default=None)
    p.add_argument("--platform", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--out", default=None)
    p.add_argument("--timeout", type=float, default=900.0)
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--world", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    args.sizes = [_size(s) for s in args.sizes.split(",")]
    args.verbs = args.verbs.split(",")
    if set(args.verbs) - set(VERBS):
        p.error(f"--verbs {sorted(set(args.verbs) - set(VERBS))}: know {VERBS}")
    args.blocks_per_sm = [int(v) for v in args.blocks_per_sm.split(",")]
    args.vecs = [int(v) for v in args.vecs.split(",")]
    args.step_bytes = [_size(v) for v in args.step_bytes.split(",")]
    if args.knobs:
        b, v, st = args.knobs.split("/")
        args.knobs = (int(b), int(v), _size(st))
    if args.rank is not None:
        return _rank(args)
    if args.platform == "cpu" and args.sweep:
        p.error("--sweep times the kernel: it runs on the card only")
    if args.procs is None:
        import torch
        if args.platform == "cpu" or not torch.cuda.is_available():
            p.error("--procs is needed without a GPU")
        args.procs = torch.cuda.device_count()
    if args.procs < 2:
        p.error(f"the kernels across processes need >= 2 processes, got {args.procs}")
    return _spawn(args)


if __name__ == "__main__":
    sys.exit(main())
