#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``rocnrdma_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100::

    python3 chip_smoke.py

Phases, each timed, any failure exits non-zero:

1. probe: the card's name and ``nvidia-smi`` name/power limit; no CUDA
   device -> exit 2 before anything else runs;
2. build: compile every CUDA kernel of the port from ``ops/csrc`` with nvcc,
   one process per source, all at once (the Triton kernel compiles at its
   first launch, in phase 3);
3. kernels: each kernel wrapper on the card against its plain PyTorch
   version, bitwise in fp32 and bf16. Ring allreduce: n in {2,3,4,8,12}
   (12 takes the kernel's batched path), 1000 elements / 1 MiB / 64 MiB
   per rank, one tile and tiles of 8/64/512 rows, a 50-round stress loop
   with launches of n=8 and n=3 interleaved on their cached flags.
   Combine: k in 2..8 at 1000 elements and 1 MiB + 3 elements, k in {2,3}
   at 256 MiB. Ring reduce-scatter and allgather: n in {2,3,4,8,12}, one
   tile and tiles of 8/64/512 rows; reduce-scatter at about 1 MiB and 64
   MiB per rank (rounded down to n*128 elements) and 3*n*128 elements,
   allgather at a 700-element chunk and 1 MiB / 64 MiB gathered per rank.
   Alltoall: n in {2,3,8}, 77-element chunks, 1 MiB / 64 MiB per rank. A
   50-round stress loop at n=8 for reduce-scatter and alltoall. Pipelined
   (Triton) combine: k in {2,3}, 1000 elements / 256 MiB;
4. main paths, each with the launch counts zeroed before and read after,
   8 ranks on the one GPU, every point of every sweep checked against
   numpy (``--preset ring8 --fake-devices 8``: 4 KiB..256 MiB per rank,
   fp32 and bf16):
   - ``bench_allreduce --algos fused,ring,ring_bidir,cuda_ring``, then
     1 GiB fp32 per rank through ``Transport.allreduce``, ``cuda_ring`` and
     ``fused``, checked on the card against the plain ring;
   - ``bench_reducescatter --algos fused,ring,cuda_ring``, then 1 GiB fp32
     input per rank through ``Transport.reduce_scatter``;
   - ``bench_allgather --algos fused,ring,cuda_ring``, then 1 GiB fp32
     gathered per rank through ``Transport.allgather``;
   - ``bench_alltoall --algos fused,ring,bruck,cuda_ring``, then 1 GiB fp32
     per rank through ``Transport.alltoall`` (the ``BASELINE.json:2``
     metric), and ``Transport.alltoallv`` once with ragged counts;
   each 1 GiB point runs ``cuda_ring`` and ``fused``, held to the plain
   version, and prints its algbw and busbw;
5. ``bench_local`` with cuda2,cuda3,torch2,torch3,pipe2,pipe3 at 256 MiB
   per operand, the combine kernels' launch counts zeroed before and read
   after;
6. one JSON line ``{"kernels": [...]}``: per kernel its launches on its
   main path, its time, its plain version's and the library call's time at
   the main path's shapes, and its bound: the larger of its bytes (each
   input read once, each output written once) at the datasheet HBM rate
   and its fp32 adds at the datasheet fp32 rate. Before it, the ring
   kernel's bytes moved per mode at those shapes beside the bound's bytes,
   and a 4 KiB-per-rank ``cuda_ring`` allreduce split into host enqueue
   time and device time, with the kernel timed alone with and without its
   barrier and arrivals.

The last line is ``{"ok": true, "device": {...}}``. With ranks sharing one
GPU, every bus bandwidth printed here is an HBM number, not NVLink.
This script imports nothing of JAX or of the JAX package.
"""

import contextlib
import json
import os
import subprocess
import sys
import time

import torch

MiB = 1 << 20
PHASE_S: dict[str, float] = {}


@contextlib.contextmanager
def phase(name: str):
    print(f"## phase {name}", flush=True)
    t0 = time.perf_counter()
    yield
    torch.cuda.synchronize()
    PHASE_S[name] = time.perf_counter() - t0
    print(f"## phase {name}: {PHASE_S[name]:.1f} s", flush=True)


def randn(shape, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(shape, generator=g, device="cuda",
                       dtype=torch.float32).to(dtype)


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want.float()).abs().max()) if got.numel() else 0.0


def hold(what: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """Require ``got`` bitwise equal to ``want``, in every dtype; returns
    the max abs error (0.0)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{what}: {got.shape}/{got.dtype} vs {want.shape}/{want.dtype}")
    err = max_abs_err(got, want)
    if torch.equal(got, want):
        return err
    raise AssertionError(f"{what}: kernel disagrees with its plain version "
                         f"(max abs err {err})")


def check_ring_kernels(ops) -> None:
    for n in (2, 3, 4, 8, 12):
        for dtype in (torch.float32, torch.bfloat16):
            isz = torch.finfo(dtype).bits // 8
            for label, elems in (("1000 el", 1000), ("1 MiB", MiB // isz),
                                 ("64 MiB", 64 * MiB // isz)):
                x = randn((n, elems), dtype, seed=n * 1000 + elems % 997)
                x0 = x.clone()
                what = f"ring n={n} {label} {dtype}"
                hold(what, ops.ring_allreduce(x), ops.ring_allreduce_plain(x))
                if not torch.equal(x, x0):
                    raise AssertionError(f"{what}: out-of-place kernel changed its input")
                for tr in (8, 64, 512):
                    y = x.clone()
                    ret = ops.hbm_ring_allreduce(y, tile_rows=tr)
                    if ret.data_ptr() != y.data_ptr():
                        raise AssertionError(f"{what}: hbm ring did not return its input")
                    hold(f"hbm {what} tile_rows={tr}", y,
                         ops.hbm_ring_allreduce_plain(x.clone(), tile_rows=tr))
                del x, x0, y
        torch.cuda.synchronize()
        print(f"ring kernels n={n}: ok", flush=True)
    # counterpart of test_pallas_allreduce_backpressure_stress: back-to-back
    # launches on the cached, epoch-counted flags, with a launch of another
    # n (its own flags) in between
    x = randn((8, 3 * 128 * 8 + 37), torch.float32, seed=7)
    x3 = randn((3, 3 * 128 * 8 + 37), torch.float32, seed=8)
    want = ops.ring_allreduce_plain(x)
    want_hbm = ops.hbm_ring_allreduce_plain(x.clone(), tile_rows=8)
    want3 = ops.ring_allreduce_plain(x3)
    for i in range(50):
        hold(f"stress round {i}", ops.ring_allreduce(x), want)
        hold(f"n=3 stress round {i}", ops.ring_allreduce(x3), want3)
        hold(f"hbm stress round {i}", ops.hbm_ring_allreduce(x.clone(), tile_rows=8),
             want_hbm)
    torch.cuda.synchronize()
    print("ring stress x50: ok", flush=True)


def check_combine_kernel(ops) -> None:
    for k in range(2, 9):
        for dtype in (torch.float32, torch.bfloat16):
            isz = torch.finfo(dtype).bits // 8
            sizes = [("1000 el", 1000), ("1 MiB + 3 el", MiB // isz + 3)]
            if k <= 3:
                sizes.append(("256 MiB", 256 * MiB // isz))
            for label, elems in sizes:
                xs = [randn((elems,), dtype, seed=10 * k + j) for j in range(k)]
                hold(f"combine k={k} {label} {dtype}", ops.hbm_combine(*xs),
                     ops.hbm_combine_plain(*xs))
                del xs
    torch.cuda.synchronize()
    print("combine kernel: ok", flush=True)


def check_rs_ag_kernels(ops) -> None:
    for n in (2, 3, 4, 8, 12):
        for dtype in (torch.float32, torch.bfloat16):
            isz = torch.finfo(dtype).bits // 8
            align = n * 128
            for label, elems in (("3*n*128 el", 3 * align),
                                 ("~1 MiB", MiB // isz // align * align),
                                 ("~64 MiB", 64 * MiB // isz // align * align)):
                x = randn((n, elems), dtype, seed=n * 100 + elems % 991)
                x0 = x.clone()
                want = ops.ring_reduce_scatter_plain(x)
                for tr in (None, 8, 64, 512):
                    hold(f"reduce_scatter n={n} {label} {dtype} tile_rows={tr}",
                         ops.ring_reduce_scatter(x, tile_rows=tr), want)
                if not torch.equal(x, x0):
                    raise AssertionError("reduce_scatter kernel changed its input")
                del x, x0, want
            for label, chunk in (("700-el chunk", 700),
                                 ("1 MiB gathered", MiB // isz // n),
                                 ("64 MiB gathered", 64 * MiB // isz // n)):
                x = randn((n, chunk), dtype, seed=n * 200 + chunk % 991)
                want = ops.ring_allgather_plain(x)
                if not torch.equal(want, x.reshape(1, -1).expand(n, -1)):
                    raise AssertionError("allgather plain version is not the concatenation")
                for tr in (None, 8, 64, 512):
                    hold(f"allgather n={n} {label} {dtype} tile_rows={tr}",
                         ops.ring_allgather(x, tile_rows=tr), want)
                del x, want
        torch.cuda.synchronize()
        print(f"reduce_scatter/allgather kernels n={n}: ok", flush=True)
    # the reduce-scatter stress loop: many tiles, many slot reuses
    x = randn((8, 8 * 3 * 128 * 8), torch.float32, seed=8)
    want = ops.ring_reduce_scatter_plain(x)
    for i in range(50):
        hold(f"reduce_scatter stress round {i}", ops.ring_reduce_scatter(x, tile_rows=8),
             want)
    torch.cuda.synchronize()
    print("reduce_scatter stress x50: ok", flush=True)


def check_alltoall_kernel(ops) -> None:
    for n in (2, 3, 8):
        for dtype in (torch.float32, torch.bfloat16):
            isz = torch.finfo(dtype).bits // 8
            for label, chunk in (("77-el chunks", 77), ("1 MiB", MiB // isz // n),
                                 ("64 MiB", 64 * MiB // isz // n)):
                x = randn((n, n, chunk), dtype, seed=n * 300 + chunk % 991)
                got = ops.alltoall(x)
                hold(f"alltoall n={n} {label} {dtype}", got, ops.alltoall_plain(x))
                hold(f"alltoall twice n={n} {label} {dtype}", ops.alltoall(got), x)
                del x, got
        torch.cuda.synchronize()
        print(f"alltoall kernel n={n}: ok", flush=True)
    x = randn((8, 8, 1000), torch.float32, seed=9)
    want = ops.alltoall_plain(x)
    for i in range(50):
        hold(f"alltoall stress round {i}", ops.alltoall(x), want)
    torch.cuda.synchronize()
    print("alltoall stress x50: ok", flush=True)


def check_pipelined_combine_kernel(ops) -> None:
    for k in (2, 3):
        for dtype in (torch.float32, torch.bfloat16):
            isz = torch.finfo(dtype).bits // 8
            for label, elems in (("1000 el", 1000), ("256 MiB", 256 * MiB // isz)):
                xs = [randn((elems,), dtype, seed=20 * k + j) for j in range(k)]
                hold(f"pipelined combine k={k} {label} {dtype}",
                     ops.hbm_combine_pipelined(*xs), ops.hbm_combine_plain(*xs))
                del xs
    torch.cuda.synchronize()
    print("pipelined combine kernel: ok", flush=True)


def bound(nbytes: float, ops: float, kind: str) -> dict:
    """The least time for the work: the larger of its bytes at the HBM rate
    and its fp32 operations at the non-tensor-core fp32 rate."""
    from rocnrdma_tpu_torch.hw import bytes_bound_ms, fp32_ops_bound_ms
    b, o = bytes_bound_ms(nbytes, kind), fp32_ops_bound_ms(ops, kind)
    return {"bound_ms": max(b, o), "bound_by": "bytes" if b >= o else "operations"}


def ms_of(fn, *args, repeats=5, iters=5) -> float:
    from rocnrdma_tpu_torch.bench.timing import time_fn
    return time_fn(fn, *args, warmup=1, repeats=repeats,
                   calls_per_repeat=iters).mean_s * 1e3


def ring_bytes(mode: str, n: int, per: int, isz: int) -> int:
    """Bytes the ring kernel moves in ``mode`` ("ar", "rs", "ag") for n
    ranks and chunks of ``per`` elements: each of its input elements read
    once and each output element written once. Rows hold n chunks, but a
    reduce-scatter writes one chunk a rank and an allgather reads one."""
    reads = per if mode == "ag" else n * per
    writes = per if mode == "rs" else n * per
    return n * (reads + writes) * isz


def small_call_split(ops, t, n: int, calls: int = 200) -> dict:
    """A 4 KiB-per-rank ``cuda_ring`` allreduce (one tile) split into its
    host enqueue time and its device time, beside the ring kernel alone with
    and without its barrier and arrivals (``sync=False``: the data pass
    only). ``barrier_us`` is the difference of the two kernel times."""
    from rocnrdma_tpu_torch.bench.timing import device_s, enqueue_s
    from rocnrdma_tpu_torch.ops import ring_cuda
    x = randn((n, 1024), torch.float32, seed=18)
    per = 1024 // n
    out = torch.empty_like(x)
    arm = t.jit_fn("allreduce", "cuda_ring")
    fns = {"cuda_ring_call": lambda: arm(x),
           "kernel": lambda: ring_cuda._launch(x, out, n, per, ring_cuda.MODE_AR),
           "kernel_no_barrier": lambda: ring_cuda._launch(
               x, out, n, per, ring_cuda.MODE_AR, sync=False)}
    want = ops.ring_allreduce_plain(x)
    split = {}
    for name, fn in fns.items():
        out.zero_()
        got = fn()
        hold(f"4 KiB {name}", out if got is None else got, want)
        for _ in range(20):
            fn()
        h = enqueue_s(fn, calls)
        split[name] = {"host_us": h * 1e6, "device_us": device_s(fn, calls, h) * 1e6}
    split["cuda_ring_call"]["events_us"] = ms_of(arm, x) * 1e3
    split["barrier_us"] = (split["kernel"]["device_us"]
                           - split["kernel_no_barrier"]["device_us"])
    return split


# collective -> (bench CLI, Transport verb, the sweep's algos, kernel counter)
VERBS = {
    "reducescatter": ("bench_reducescatter", "reduce_scatter", "fused,ring,cuda_ring",
                      "ring_reduce_scatter"),
    "allgather": ("bench_allgather", "allgather", "fused,ring,cuda_ring",
                  "ring_allgather"),
    "alltoall": ("bench_alltoall", "alltoall", "fused,ring,bruck,cuda_ring",
                 "alltoall"),
}


def main_verb(ops, runner, collective: str, x: torch.Tensor, plain, kind: str,
              n: int = 8) -> tuple[int, float]:
    """Drive one verb's main path with the launch counts zeroed first: its
    CLI's ring8 sweep, then the 1 GiB fp32 point ``x`` through ``cuda_ring``
    (held bitwise to ``plain``) and ``fused``, timed; alltoall also runs
    ``alltoallv`` once. Returns (the kernel's launches, the point's max abs
    error)."""
    from rocnrdma_tpu_torch.metrics import BenchRecord, format_table
    from rocnrdma_tpu_torch.runtime import rank_mesh
    from rocnrdma_tpu_torch.transport import Transport

    bench, verb, algos, counter = VERBS[collective]
    ops.reset_launch_counts()
    argv = ["--preset", "ring8", "--fake-devices", str(n), "--algos", algos,
            "--repeats", "3", "--iters", "5"]
    sweep = runner.run_sweep(bench, collective,
                             runner.make_parser(bench, collective).parse_args(argv))
    if {r.algo for r in sweep} != set(algos.split(",")):
        raise AssertionError(f"{bench} sweep ran {sorted({r.algo for r in sweep})}")

    t = Transport(rank_mesh(n))
    run = getattr(t, verb)
    got = run(x, "cuda_ring")
    want = plain(x)
    err = hold(f"1 GiB {verb} cuda_ring vs plain", got, want)
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"1 GiB {verb} cuda_ring: non-finite result")
    del got
    fused = run(x, "fused")
    same = (torch.allclose(fused, want, rtol=1e-5, atol=1e-5)
            if verb == "reduce_scatter" else torch.equal(fused, want))
    if not same:
        raise AssertionError(f"1 GiB {verb} fused vs plain: max abs err "
                             f"{max_abs_err(fused, want)}")
    del fused, want
    size = x[0].numel() * x.element_size() * (n if verb == "allgather" else 1)
    recs = []
    for algo in ("cuda_ring", "fused"):
        ms = ms_of(t.jit_fn(verb, algo), x, repeats=3, iters=2)
        recs.append(BenchRecord.measure(
            bench, collective, algo, n, size, "float32", ms / 1e3,
            platform="gpu", device=kind, link="hbm-loopback"))
    print(format_table(recs))
    if verb == "alltoall":  # the ragged verb on the same kernel
        g = torch.Generator().manual_seed(5)
        counts = torch.randint(0, 65, (n, n), generator=g)
        y = randn((n, n, 64, 1024), torch.float32, seed=17)
        out, rc = t.alltoallv(y, counts, "cuda_ring")
        want, want_rc = t.alltoallv(y, counts, "fused")
        hold("alltoallv cuda_ring vs fused", out, want)
        if not torch.equal(rc, want_rc) or not torch.equal(rc.cpu(), counts.T):
            raise AssertionError("alltoallv: recv_counts differ")
        del y, out, want
    stats = t.stats()
    print(t.format_stats())
    need = [f"{verb}/cuda_ring", f"{verb}/fused"]
    if verb == "alltoall":
        need += ["alltoallv/cuda_ring", "alltoallv/fused"]
    for key in need:
        if stats.get(key, {}).get("calls", 0) < 1:
            raise AssertionError(f"Transport.stats shows no {key} call: {stats}")
    launched = ops.launch_counts()
    print(f"launches on the {bench} path: {launched}", flush=True)
    if launched[counter] < 1:
        raise AssertionError(f"{bench} path never launched {counter}")
    return launched[counter], err


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from rocnrdma_tpu_torch import ops
    from rocnrdma_tpu_torch.bench import bench_local, runner
    from rocnrdma_tpu_torch.collectives import (fused_allgather, fused_allreduce,
                                                fused_alltoall, fused_reduce_scatter)
    from rocnrdma_tpu_torch.metrics import BenchRecord, GiB, format_table
    from rocnrdma_tpu_torch.ops import _build
    from rocnrdma_tpu_torch.runtime import rank_mesh
    from rocnrdma_tpu_torch.transport import Transport
    from rocnrdma_tpu_torch.transport.api import cuda_ring_tile_rows

    kind = torch.cuda.get_device_name(0)
    with phase("probe"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout.strip()
        print(f"device: {kind} (torch {torch.__version__}, CUDA {torch.version.cuda})")
        print(f"nvidia-smi: {smi}", flush=True)

    with phase("build"):
        t0 = time.perf_counter()
        paths = _build.build()
        for name in paths:
            _build.load(name)
        print(f"built {sorted(paths)} in {time.perf_counter() - t0:.1f} s", flush=True)

    with phase("kernels"):
        check_ring_kernels(ops)
        check_combine_kernel(ops)
        check_rs_ag_kernels(ops)
        check_alltoall_kernel(ops)
        check_pipelined_combine_kernel(ops)

    # ---- main path: bench_allreduce (ring kernels) ----
    n = 8
    with phase("main_allreduce"):
        ops.reset_launch_counts()
        argv = ["--preset", "ring8", "--fake-devices", str(n), "--algos",
                "fused,ring,ring_bidir,cuda_ring", "--repeats", "3", "--iters", "5"]
        args = runner.make_parser("bench_allreduce", "allreduce").parse_args(argv)
        sweep = runner.run_sweep("bench_allreduce", "allreduce", args)
        if {r.algo for r in sweep} != {"fused", "ring", "ring_bidir", "cuda_ring"}:
            raise AssertionError(f"sweep ran {sorted({r.algo for r in sweep})}")

        # the contract point: 1 GiB fp32 per rank, 8 ranks
        t = Transport(rank_mesh(n))
        elems = GiB // 4
        x = randn((n, elems), torch.float32, seed=1)
        tr = cuda_ring_tile_rows(x)
        if tr is None:
            raise AssertionError("1 GiB per rank should take the tiled tier")
        got = t.allreduce(x, "cuda_ring")
        want = ops.hbm_ring_allreduce_plain(x.clone(), tile_rows=tr)
        hbm_err = hold("1 GiB cuda_ring vs plain ring", got, want)
        if not bool(torch.isfinite(got).all()) or got.shape != x.shape:
            raise AssertionError("1 GiB cuda_ring: non-finite or misshapen result")
        del got
        fused = t.allreduce(x, "fused")
        if not torch.allclose(fused, want, rtol=1e-5, atol=1e-5):
            raise AssertionError(f"1 GiB fused vs plain ring: max abs err "
                                 f"{max_abs_err(fused, want)}")
        del fused, want
        recs = []
        for algo in ("cuda_ring", "fused"):
            fn = t.jit_fn("allreduce", algo)
            ms = ms_of(fn, x, repeats=3, iters=2)
            recs.append(BenchRecord.measure(
                "bench_allreduce", "allreduce", algo, n, elems * 4, "float32",
                ms / 1e3, platform="gpu", device=kind, link="hbm-loopback"))
        print(format_table(recs))
        stats = t.stats()
        print(t.format_stats())
        if stats.get("allreduce/cuda_ring", {}).get("calls", 0) < 1:
            raise AssertionError(f"Transport.stats shows no cuda_ring call: {stats}")
        ring_counts = ops.launch_counts()
        print(f"launches on the main path: {ring_counts}", flush=True)
        for k in ("ring_allreduce", "hbm_ring_allreduce"):
            if ring_counts[k] < 1:
                raise AssertionError(f"main path never launched {k}")
        del x

    # ---- main paths: bench_reducescatter, bench_allgather, bench_alltoall
    # (the ring kernel's RS and AG modes, the alltoall kernel), each with
    # its 1 GiB fp32 point ----
    counts, errs = {}, {}
    with phase("main_reducescatter"):
        x = randn((n, GiB // 4), torch.float32, seed=11)
        counts["ring_reduce_scatter"], errs["ring_reduce_scatter"] = main_verb(
            ops, runner, "reducescatter", x, ops.ring_reduce_scatter_plain, kind)
        del x
    with phase("main_allgather"):
        x = randn((n, GiB // 4 // n), torch.float32, seed=12)
        counts["ring_allgather"], errs["ring_allgather"] = main_verb(
            ops, runner, "allgather", x, ops.ring_allgather_plain, kind)
        del x
    with phase("main_alltoall"):
        x = randn((n, n, GiB // 4 // n), torch.float32, seed=13)
        counts["alltoall"], errs["alltoall"] = main_verb(
            ops, runner, "alltoall", x, ops.alltoall_plain, kind)
        del x

    # ---- main path: bench_local (combine kernels) ----
    with phase("main_bench_local"):
        ops.reset_launch_counts()
        largs = bench_local.make_parser().parse_args(
            ["--kernels", "cuda2,cuda3,torch2,torch3,pipe2,pipe3", "--size", "256M"])
        local_rows = bench_local.run(largs)
        combine_counts = ops.launch_counts()
        print(f"launches on bench_local: {combine_counts}", flush=True)
        for k in ("hbm_combine", "hbm_combine_pipelined"):
            if combine_counts[k] < 1:
                raise AssertionError(f"bench_local never launched {k}")
        if len(local_rows) != 6:
            raise AssertionError(f"bench_local gave {len(local_rows)} rows")

    # ---- the kernels line, at the main path's shapes ----
    with phase("kernel_times"):
        kernels = []
        # ring_allreduce: a one-tile point of the sweep, 4 MiB fp32
        x = randn((n, 4 * MiB // 4), torch.float32, seed=2)
        S = x[0].numel() * 4
        err = max_abs_err(ops.ring_allreduce(x), ops.ring_allreduce_plain(x))
        kernels.append({
            "name": "ring_allreduce", "route": "cuda",
            "source": "rocnrdma_tpu_torch/ops/csrc/ring.cu",
            "replaces": "rocnrdma_tpu/ops/ring_pallas.py:198",
            "launches": ring_counts["ring_allreduce"], "max_abs_err": err,
            "ms": ms_of(ops.ring_allreduce, x),
            "plain_ms": ms_of(ops.ring_allreduce_plain, x),
            **bound(2 * n * S, (n - 1) * x[0].numel(), kind),
            "library_ms": ms_of(fused_allreduce, x),
            "shape": [n, x.shape[1]], "dtype": "float32"})
        moved = {"ring_allreduce": [ring_bytes("ar", n, -(-x.shape[1] // n // 128) * 128, 4),
                                    2 * n * S]}
        del x
        # hbm_ring_allreduce: the 1 GiB contract point, in place, with the
        # cuda_ring arm's tiles
        y = randn((n, GiB // 4), torch.float32, seed=3)
        S = y[0].numel() * 4
        kernels.append({
            "name": "hbm_ring_allreduce", "route": "cuda",
            "source": "rocnrdma_tpu_torch/ops/csrc/ring.cu",
            "replaces": "rocnrdma_tpu/ops/ring_pallas.py:432",
            "launches": ring_counts["hbm_ring_allreduce"], "max_abs_err": hbm_err,
            "ms": ms_of(lambda v: ops.hbm_ring_allreduce(v, tile_rows=tr), y,
                        repeats=3, iters=2),
            "plain_ms": ms_of(lambda v: ops.hbm_ring_allreduce_plain(v, tile_rows=tr),
                              y, repeats=3, iters=1),
            **bound(2 * n * S, (n - 1) * y[0].numel(), kind),
            "library_ms": ms_of(fused_allreduce, y, repeats=3, iters=2),
            "shape": [n, y.shape[1]], "dtype": "float32", "tile_rows": tr})
        moved["hbm_ring_allreduce"] = [
            ring_bytes("ar", n, -(-y.shape[1] // n // (tr * 128)) * tr * 128, 4), 2 * n * S]
        del y
        # hbm_combine: bench_local's cuda2 row, 256 MiB fp32 per operand
        a, b = (randn((64 * MiB,), torch.float32, seed=s) for s in (4, 5))
        err = max_abs_err(ops.hbm_combine(a, b), ops.hbm_combine_plain(a, b))
        kernels.append({
            "name": "hbm_combine", "route": "cuda",
            "source": "rocnrdma_tpu_torch/ops/csrc/combine.cu",
            "replaces": "rocnrdma_tpu/ops/local_pallas.py:121",
            "launches": combine_counts["hbm_combine"], "max_abs_err": err,
            "ms": ms_of(ops.hbm_combine, a, b),
            "plain_ms": ms_of(ops.hbm_combine_plain, a, b),
            **bound(3 * a.numel() * 4, a.numel(), kind),
            "library_ms": ms_of(torch.add, a, b),
            "shape": [2, a.numel()], "dtype": "float32"})
        # hbm_combine_pipelined: bench_local's pipe2 row, the same operands
        err = max_abs_err(ops.hbm_combine_pipelined(a, b), ops.hbm_combine_plain(a, b))
        kernels.append({
            "name": "hbm_combine_pipelined", "route": "triton",
            "source": "rocnrdma_tpu_torch/ops/local_triton.py",
            "replaces": "rocnrdma_tpu/ops/local_pallas.py:160",
            "launches": combine_counts["hbm_combine_pipelined"], "max_abs_err": err,
            "ms": ms_of(ops.hbm_combine_pipelined, a, b),
            "plain_ms": ms_of(ops.hbm_combine_plain, a, b),
            **bound(3 * a.numel() * 4, a.numel(), kind),
            "library_ms": ms_of(torch.add, a, b),
            "shape": [2, a.numel()], "dtype": "float32"})
        del a, b
        # ring_reduce_scatter: the 1 GiB point, with the cuda_ring arm's tiles
        x = randn((n, GiB // 4), torch.float32, seed=14)
        S = x[0].numel() * 4
        tr = cuda_ring_tile_rows(x, "reduce_scatter")
        kernels.append({
            "name": "ring_reduce_scatter", "route": "cuda",
            "source": "rocnrdma_tpu_torch/ops/csrc/ring.cu",
            "replaces": "rocnrdma_tpu/ops/ring_pallas.py:215",
            "launches": counts["ring_reduce_scatter"],
            "max_abs_err": errs["ring_reduce_scatter"],
            "ms": ms_of(lambda v: ops.ring_reduce_scatter(v, tile_rows=tr), x,
                        repeats=3, iters=2),
            "plain_ms": ms_of(ops.ring_reduce_scatter_plain, x, repeats=3, iters=1),
            **bound(n * S + S, (n - 1) * x[0].numel(), kind),
            "library_ms": ms_of(fused_reduce_scatter, x, repeats=3, iters=2),
            "shape": [n, x.shape[1]], "dtype": "float32", "tile_rows": tr})
        moved["ring_reduce_scatter"] = [ring_bytes("rs", n, x.shape[1] // n, 4), n * S + S]
        del x
        # ring_allgather: the 1 GiB point (1 GiB gathered per rank)
        x = randn((n, GiB // 4 // n), torch.float32, seed=15)
        c = x[0].numel() * 4
        tr = cuda_ring_tile_rows(x, "allgather")
        kernels.append({
            "name": "ring_allgather", "route": "cuda",
            "source": "rocnrdma_tpu_torch/ops/csrc/ring.cu",
            "replaces": "rocnrdma_tpu/ops/ring_pallas.py:239",
            "launches": counts["ring_allgather"], "max_abs_err": errs["ring_allgather"],
            "ms": ms_of(lambda v: ops.ring_allgather(v, tile_rows=tr), x,
                        repeats=3, iters=2),
            "plain_ms": ms_of(ops.ring_allgather_plain, x, repeats=3, iters=1),
            **bound(n * c + n * n * c, 0, kind),
            "library_ms": ms_of(fused_allgather, x, repeats=3, iters=2),
            "shape": [n, x.shape[1]], "dtype": "float32", "tile_rows": tr})
        moved["ring_allgather"] = [ring_bytes("ag", n, x.shape[1], 4), n * c + n * n * c]
        del x
        # alltoall: the 1 GiB point, the BASELINE.json:2 alltoall metric
        x = randn((n, n, GiB // 4 // n), torch.float32, seed=16)
        S = x[0].numel() * 4
        kernels.append({
            "name": "alltoall", "route": "cuda",
            "source": "rocnrdma_tpu_torch/ops/csrc/alltoall.cu",
            "replaces": "rocnrdma_tpu/ops/ring_pallas.py:290",
            "launches": counts["alltoall"], "max_abs_err": errs["alltoall"],
            "ms": ms_of(ops.alltoall, x, repeats=3, iters=2),
            "plain_ms": ms_of(ops.alltoall_plain, x, repeats=3, iters=1),
            **bound(2 * n * S, 0, kind),
            "library_ms": ms_of(fused_alltoall, x, repeats=3, iters=2),
            "shape": list(x.shape), "dtype": "float32"})
        del x
        split = small_call_split(ops, Transport(rank_mesh(n)), n)

    print("phase seconds: " + json.dumps({k: round(v, 1) for k, v in PHASE_S.items()}))
    for name, (b_moved, b_bound) in moved.items():
        if b_moved != b_bound:
            raise AssertionError(f"{name}: the ring kernel moves {b_moved} bytes, "
                                 f"its bound {b_bound}")
    print("ring kernel bytes moved at the kernels line's shapes [moved, bound]: "
          + json.dumps(moved))
    print("4 KiB per rank x 8, us per call (host: enqueue; device: queued behind "
          "a spinning kernel): " + json.dumps(split))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
