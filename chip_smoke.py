#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``rocnrdma_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100::

    python3 chip_smoke.py

Phases, each timed, any failure exits non-zero:

1. probe: the card's name and ``nvidia-smi`` name/power limit; no CUDA
   device -> exit 2 before anything else runs;
2. build: compile every CUDA kernel of the port from ``ops/csrc`` with nvcc;
3. kernels: each kernel wrapper on the card against its plain PyTorch
   version (ring: n in {2,3,4,8}, 1000 elements / 1 MiB / 64 MiB per rank,
   fp32 and bf16, tiles of 8/64/512 rows; a 50-round stress loop; combine:
   k in {2,3}, 1000 elements / 256 MiB, fp32 and bf16). Equality is
   bitwise; a bf16 case that is not falls back to a stated tolerance and
   says so;
4. main path: ``bench_allreduce --preset ring8 --fake-devices 8 --algos
   fused,ring,ring_bidir,cuda_ring`` (8 ranks on the one GPU, 4 KiB..256 MiB
   per rank, fp32 and bf16, every point checked against numpy), then the
   contract point, 1 GiB fp32 per rank through ``Transport.allreduce`` with
   ``cuda_ring`` and ``fused``, checked on the card against the plain ring;
   the ring kernels' launch counts are zeroed before and read after;
5. ``bench_local`` with cuda2,cuda3,torch2,torch3 at 256 MiB per operand,
   the combine kernel's launch count zeroed before and read after;
6. one JSON line ``{"kernels": [...]}``: per kernel its launches on the main
   path, its time, its plain version's and the library call's time at the
   main path's shapes, and its bound: the larger of its bytes (each input
   read once, each output written once) at the datasheet HBM rate and its
   fp32 adds at the datasheet fp32 rate.

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


def hold(what: str, got: torch.Tensor, want: torch.Tensor, hops: int = 1) -> float:
    """Require ``got`` bitwise equal to ``want``; a bf16 mismatch is
    accepted within one bf16 rounding (2^-8 relative) per hop, and
    printed."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{what}: {got.shape}/{got.dtype} vs {want.shape}/{want.dtype}")
    err = max_abs_err(got, want)
    if torch.equal(got, want):
        return err
    if got.dtype == torch.bfloat16:
        tol = hops * 2.0 ** -8
        if torch.allclose(got.float(), want.float(), rtol=tol, atol=tol):
            print(f"# {what}: bf16 not bitwise (max abs err {err}); within "
                  f"{hops} bf16 roundings ({tol}): accepted")
            return err
    raise AssertionError(f"{what}: kernel disagrees with its plain version "
                         f"(max abs err {err})")


def check_ring_kernels(ops) -> None:
    for n in (2, 3, 4, 8):
        for dtype in (torch.float32, torch.bfloat16):
            isz = torch.finfo(dtype).bits // 8
            for label, elems in (("1000 el", 1000), ("1 MiB", MiB // isz),
                                 ("64 MiB", 64 * MiB // isz)):
                x = randn((n, elems), dtype, seed=n * 1000 + elems % 997)
                x0 = x.clone()
                what = f"ring n={n} {label} {dtype}"
                hold(what, ops.ring_allreduce(x), ops.ring_allreduce_plain(x),
                     2 * (n - 1))
                if not torch.equal(x, x0):
                    raise AssertionError(f"{what}: out-of-place kernel changed its input")
                for tr in (8, 64, 512):
                    y = x.clone()
                    ret = ops.hbm_ring_allreduce(y, tile_rows=tr)
                    if ret.data_ptr() != y.data_ptr():
                        raise AssertionError(f"{what}: hbm ring did not return its input")
                    hold(f"hbm {what} tile_rows={tr}", y,
                         ops.hbm_ring_allreduce_plain(x.clone(), tile_rows=tr),
                         2 * (n - 1))
                del x, x0, y
        torch.cuda.synchronize()
        print(f"ring kernels n={n}: ok", flush=True)
    # counterpart of test_pallas_allreduce_backpressure_stress
    x = randn((8, 3 * 128 * 8 + 37), torch.float32, seed=7)
    want = ops.ring_allreduce_plain(x)
    want_hbm = ops.hbm_ring_allreduce_plain(x.clone(), tile_rows=8)
    for i in range(50):
        hold(f"stress round {i}", ops.ring_allreduce(x), want)
        hold(f"hbm stress round {i}", ops.hbm_ring_allreduce(x.clone(), tile_rows=8),
             want_hbm)
    torch.cuda.synchronize()
    print("ring stress x50: ok", flush=True)


def check_combine_kernel(ops) -> None:
    for k in (2, 3):
        for dtype in (torch.float32, torch.bfloat16):
            isz = torch.finfo(dtype).bits // 8
            for label, elems in (("1000 el", 1000), ("256 MiB", 256 * MiB // isz)):
                xs = [randn((elems,), dtype, seed=10 * k + j) for j in range(k)]
                hold(f"combine k={k} {label} {dtype}", ops.hbm_combine(*xs),
                     ops.hbm_combine_plain(*xs))
                del xs
    torch.cuda.synchronize()
    print("combine kernel: ok", flush=True)


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from rocnrdma_tpu_torch import ops
    from rocnrdma_tpu_torch.bench import bench_local, runner
    from rocnrdma_tpu_torch.collectives import fused_allreduce
    from rocnrdma_tpu_torch.hw import bytes_bound_ms
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

    # ---- main path: bench_local (combine kernel) ----
    with phase("main_bench_local"):
        ops.reset_launch_counts()
        largs = bench_local.make_parser().parse_args(
            ["--kernels", "cuda2,cuda3,torch2,torch3", "--size", "256M"])
        local_rows = bench_local.run(largs)
        combine_counts = ops.launch_counts()
        print(f"launches on bench_local: {combine_counts}", flush=True)
        if combine_counts["hbm_combine"] < 1:
            raise AssertionError("bench_local never launched hbm_combine")
        if len(local_rows) != 4:
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
        traffic = {"ring_allreduce": bytes_bound_ms(n * (9 * (n - 1) * S / n + 2 * S), kind)}
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
        traffic["hbm_ring_allreduce"] = bytes_bound_ms(n * 9 * (n - 1) * S / n, kind)
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
        del a, b

    print("phase seconds: " + json.dumps({k: round(v, 1) for k, v in PHASE_S.items()}))
    print("ring kernel's own traffic, n*[(n-1)*9C + 2S] (no 2S in place), at peak "
          "HBM, ms: " + json.dumps(traffic))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
