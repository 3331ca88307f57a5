"""Shared sweep runner behind the bench CLIs: parse flags -> backend and
rank mesh -> Transport -> timed loop -> bus-bandwidth report.

Counterpart of ``rocnrdma_tpu/bench/runner.py`` for allreduce,
reducescatter, allgather and alltoall, with the reference's per-collective
shapes and size conventions (``_shape_and_bytes``: ``--sizes`` is the
per-rank buffer S; allgather's is the gathered output, each rank
contributing S/n). Differences:

- ``--fake-devices N`` hosts N ranks on one physical device, the GPU unless
  ``--platform cpu``. A busbw measured with ranks sharing one GPU is an
  HBM number, not an NVLink one; such records carry
  ``extra["link"] = "hbm-loopback"``.
- Inputs: numpy draws float32 from ``default_rng(0)`` as the reference
  does; the tensor is cast to the sweep dtype on the device, and the
  expected result is reduced with numpy from the cast inputs widened back to
  float32 (numpy has no bfloat16). The comparison itself runs on the device.
- The self-check runs on the device against a per-rank expected tensor.
  allgather and alltoall only move data and must be exact. The reducing
  verbs accept an element within the reference's tolerance OR
  within the worst-case rounding of an (n-1)-add sum in the sweep dtype,
  about ``(n-1) * u * sum_r |x_r|`` (u = 2^-8 in bfloat16, 2^-24 in float32).
  A ring that rounds to bfloat16 after every hop can exceed the
  reference's ``atol = rtol = 5e-2`` where the ranks' values cancel (seen
  at 16 MiB per rank: error 0.057 on an expected -0.065); a lost or
  doubled rank contribution still fails it.
- The reference skips its Pallas ring above a 4 MiB VMEM limit per rank;
  ``cuda_ring`` has no such limit and runs at every size. Like the
  reference, it skips a reduce-scatter kernel point whose size is not a
  multiple of ``n*128`` elements.
- The 2-D mesh, rooted-verb and hierarchical flags (``--mesh2d``,
  ``--root``, ``--shift``, ``--cross-dtype``) wait for the slices that port
  those verbs; ``--profile DIR`` writes a ``torch.profiler`` Chrome trace.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import sys

import numpy as np
import torch

from rocnrdma_tpu_torch import metrics as M
from rocnrdma_tpu_torch.bench import cli_common
from rocnrdma_tpu_torch.bench import presets as P
from rocnrdma_tpu_torch.bench.timing import time_fn
from rocnrdma_tpu_torch.collectives.reduce_op import REDUCE_OPS
from rocnrdma_tpu_torch.runtime import PLATFORMS, rank_mesh
from rocnrdma_tpu_torch.transport import ALGOS, Transport, supports

_UNITS = {"": 1, "K": M.KiB, "M": M.MiB, "G": M.GiB}

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def parse_size(s: str) -> int:
    s = s.strip().upper().rstrip("IB")
    if s and s[-1] in _UNITS:
        return int(float(s[:-1]) * _UNITS[s[-1]])
    return int(s)


def make_parser(bench_name: str, collective: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog=bench_name,
        description=f"{collective} benchmark (PyTorch/CUDA port of the "
                    f"reference's {bench_name} entrypoint)")
    p.add_argument("--preset", choices=sorted(P.PRESETS), default=None,
                   help="named BASELINE.json config; flags override fields")
    p.add_argument("--ranks", type=int, default=None)
    p.add_argument("--sizes", type=str, default=None,
                   help="comma list of per-rank bytes, e.g. 4K,1M,256M")
    p.add_argument("--dtypes", type=str, default=None, help="e.g. float32,bfloat16")
    p.add_argument("--algos", type=str, default=None, help=f"subset of {ALGOS}")
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--iters", type=int, default=10, help="calls per timed repeat")
    p.add_argument("--redop", choices=REDUCE_OPS, default="sum",
                   help="reduction operator")
    p.add_argument("--platform", choices=PLATFORMS, default="auto",
                   help="auto = the GPU (raises without one); cpu = the CPU "
                        "correctness oracle")
    p.add_argument("--fake-devices", type=int, default=None,
                   help="host N ranks on the one physical device")
    p.add_argument("--max-bytes", type=str, default=None,
                   help="cap sweep sizes (preset auto-scaling)")
    p.add_argument("--strict-preset", action="store_true",
                   help="refuse to scale a preset down to the backend")
    p.add_argument("--out", type=str, default=None, help="JSONL output path")
    p.add_argument("--resume", action="store_true",
                   help="skip sweep points already present in --out")
    p.add_argument("--no-check", action="store_true",
                   help="skip the numpy correctness check before timing")
    p.add_argument("--paranoid", action="store_true",
                   help="run each collective twice and require bitwise-equal "
                        "results (nondeterminism/race detector)")
    p.add_argument("--profile", type=str, default=None, metavar="DIR",
                   help="write a torch.profiler Chrome trace of the sweep")
    return p


_OP = {"allreduce": "allreduce", "reducescatter": "reduce_scatter",
       "allgather": "allgather", "alltoall": "alltoall"}

# Collectives that reduce (honor --redop).
_REDUCING = ("allreduce", "reducescatter")

# Default algo pair when no preset/--algos names one: the explicit schedule
# the collective owns, benchmarked against the fused library call.
_DEFAULT_ALGOS = {"allreduce": ("ring", "fused"),
                  "reducescatter": ("ring", "fused"),
                  "allgather": ("ring", "fused"),
                  "alltoall": ("ring", "fused")}


def resolve_preset(args, collective: str) -> P.Preset:
    """Merge preset defaults and CLI overrides into one concrete Preset."""
    if args.preset:
        pre = P.get_preset(args.preset)
    else:
        pre = P.Preset(name="custom", baseline_config="(custom flags)",
                       n_ranks=args.ranks or 8, sizes=(4 * M.MiB,),
                       dtypes=("float32",),
                       algos=_DEFAULT_ALGOS.get(collective, ("fused",)))
    over = {}
    if args.ranks:
        over["n_ranks"] = args.ranks
    if args.sizes:
        over["sizes"] = tuple(parse_size(x) for x in args.sizes.split(","))
    if args.dtypes:
        over["dtypes"] = tuple(args.dtypes.split(","))
    if args.algos:
        over["algos"] = tuple(args.algos.split(","))
    if args.no_check:
        over["check"] = False
    pre = dataclasses.replace(pre, **over)
    bad = [d for d in pre.dtypes if d not in DTYPES]
    if bad:
        raise ValueError(f"unknown dtype(s) {bad}; know {sorted(DTYPES)}")
    return pre


def _shape_and_bytes(collective: str, n: int, size_bytes: int, dtype: str):
    """(per-collective global shape with the rank axis first, actual bytes
    per rank): sizes round down to whole elements and to divisibility, as
    the reference's do."""
    itemsize = DTYPES[dtype].itemsize
    elems = max(1, size_bytes // itemsize)
    if collective == "allgather":
        elems = max(n, elems // n * n)  # input chunk = S/n
        shape = (n, elems // n)
    elif collective == "alltoall":
        elems = max(n, elems // n * n)
        shape = (n, n, elems // n)
    elif collective == "reducescatter":
        elems = max(n, elems // n * n)
        shape = (n, elems)
    else:  # allreduce: full S per rank
        shape = (n, elems)
    return shape, elems * itemsize


def _build_input(t: Transport, collective: str, size_bytes: int, dtype: str):
    """(tensor on the mesh device, the same values as float32 numpy, bytes)."""
    shape, actual = _shape_and_bytes(collective, t.n_ranks, size_bytes, dtype)
    x_np = np.random.default_rng(0).standard_normal(size=shape, dtype=np.float32)
    x = t.shard(x_np, DTYPES[dtype])
    if DTYPES[dtype] != torch.float32:
        x_np = x.float().cpu().numpy()  # the values the ranks actually hold
    return x, x_np, actual


def _np_reduce(flat: np.ndarray, op: str) -> np.ndarray:
    """Rank-axis reduction matching REDUCE_OPS semantics."""
    n = flat.shape[0]
    red = {"sum": np.sum, "avg": np.sum, "prod": np.prod,
           "max": np.max, "min": np.min}[op](flat, axis=0)
    return red / n if op == "avg" else red


_UNIT_ROUNDOFF = {torch.float32: 2.0 ** -24, torch.bfloat16: 2.0 ** -8}


def _expected(collective: str, x_np: np.ndarray, op: str) -> np.ndarray:
    """What the ranks must hold after ``collective``, float32, one row per
    rank, or one row that every rank must hold."""
    n = x_np.shape[0]
    flat = x_np.reshape(n, -1)
    if collective == "allreduce":
        return _np_reduce(flat, op)[None]
    if collective == "reducescatter":
        return _np_reduce(flat, op).reshape(n, -1)
    if collective == "allgather":
        return flat.reshape(1, -1)
    if collective == "alltoall":
        return x_np.transpose(1, 0, 2).reshape(n, -1)
    raise ValueError(collective)


def _rounding_bound(x_np: np.ndarray, op: str, dtype: str,
                    collective: str = "allreduce") -> np.ndarray | None:
    """Worst-case rounding of any order of n-1 adds in ``dtype``, per element:
    gamma * sum_r |x_r| with gamma = (n-1)u / (1 - (n-1)u), laid out as
    ``_expected`` lays out the result (sum/avg only; None for the other
    ops and for the verbs that only move data)."""
    if op not in ("sum", "avg") or collective not in _REDUCING:
        return None
    n = x_np.shape[0]
    nu = (n - 1) * _UNIT_ROUNDOFF[DTYPES[dtype]]
    bound = nu / (1 - nu) * np.abs(x_np.reshape(n, -1)).sum(axis=0)
    bound = bound / n if op == "avg" else bound
    return bound.reshape(n, -1) if collective == "reducescatter" else bound


def _check(got: torch.Tensor, want: torch.Tensor, rtol: float, atol: float,
           what: str, bound: torch.Tensor | None = None) -> None:
    """``got`` (n, ...) against ``want``, on the device: one expected row
    per rank (n, E), or one row (E,) every rank must hold. An element
    passes within ``atol + rtol*|want|`` or within the rounding ``bound``;
    ``rtol = atol = 0`` with no bound asks for exact equality."""
    n = got.shape[0]
    g = got.reshape(n, -1).float()
    want = want.reshape(-1, g.shape[1])
    tol = atol + rtol * want.abs()
    if bound is not None:
        tol = torch.maximum(tol, bound.reshape(-1, g.shape[1]))
    bad = (g - want).abs() > tol
    if bool(bad.any()):
        r, i = (int(v) for v in bad.nonzero()[0])
        raise AssertionError(
            f"{what}: {int(bad.sum())} element(s) off; first rank {r} elem {i}: "
            f"got {float(g[r, i])}, want {float(want[r % want.shape[0], i])} "
            f"(rtol={rtol}, atol={atol})")


def algos_for(collective: str, algos: tuple) -> tuple:
    """Keep the algos this collective defines; unknown names raise."""
    unknown = [a for a in algos if a not in ALGOS]
    if unknown:
        raise ValueError(f"unknown algo(s) {unknown}; know {ALGOS}")
    kept = tuple(a for a in algos if supports(_OP[collective], a))
    return kept or ("fused",)


def _profiler(out_dir: str | None, device: torch.device):
    if not out_dir:
        return contextlib.nullcontext()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(out_dir, exist_ok=True)
    return torch.profiler.profile(
        activities=acts,
        on_trace_ready=lambda p: p.export_chrome_trace(
            os.path.join(out_dir, "trace.json")))


def run_sweep(bench_name: str, collective: str, args) -> list:
    pre = resolve_preset(args, collective)
    topo = cli_common.setup_backend(args.fake_devices, args.platform, pre.n_ranks)

    max_bytes = parse_size(args.max_bytes) if args.max_bytes else (
        64 * M.MiB if topo.is_oracle else 4 * M.GiB)
    if not args.strict_preset:
        scaled = pre.scaled_to(topo.n_devices, max_bytes)
        if scaled != pre:
            print(f"# preset {pre.name!r} scaled to backend: ranks {pre.n_ranks}->"
                  f"{scaled.n_ranks}, {len(scaled.sizes)} size(s)", file=sys.stderr)
        pre = scaled
    if pre.n_ranks > topo.n_devices:
        raise SystemExit(f"preset needs {pre.n_ranks} ranks; backend has "
                         f"{topo.n_devices} devices (use --fake-devices or drop "
                         f"--strict-preset)")

    t = Transport(rank_mesh(pre.n_ranks, topo.device))
    algos = algos_for(collective, pre.algos)
    if set(algos) != set(pre.algos):
        print(f"# algos for {collective}: {algos} (preset named {pre.algos})",
              file=sys.stderr)

    knobs = ({"op": args.redop}
             if collective in _REDUCING and args.redop != "sum" else {})
    op = knobs.get("op", "sum")
    extra = {"device": topo.device_name}
    if pre.n_ranks > 1:
        extra["link"] = "hbm-loopback" if topo.platform == "gpu" else "cpu-loopback"

    done = M.load_completed(args.out) if (args.out and args.resume) else set()
    out_fp = open(args.out, "a") if args.out else None
    records = []
    try:
        with _profiler(args.profile, topo.device):
            for dtype in pre.dtypes:
                for size in pre.sizes:
                    def _key(algo, nbytes):
                        return M.record_key(bench_name, collective, algo,
                                            pre.n_ranks, nbytes, dtype,
                                            M.knob_key(knobs))
                    actual = _shape_and_bytes(collective, pre.n_ranks, size, dtype)[1]
                    if done and all(_key(a, size) in done or _key(a, actual) in done
                                    for a in algos):
                        continue
                    x, x_np, actual = _build_input(t, collective, size, dtype)
                    want = bound = None
                    if pre.check:
                        want = torch.from_numpy(_expected(collective, x_np, op)).to(t.device)
                        b = _rounding_bound(x_np, op, dtype, collective)
                        bound = None if b is None else torch.from_numpy(b).to(t.device)
                    del x_np
                    for algo in algos:
                        if _key(algo, actual) in done:
                            continue
                        if (algo == "cuda_ring" and collective == "reducescatter"
                                and (actual // DTYPES[dtype].itemsize)
                                % (pre.n_ranks * 128) != 0):
                            print(f"# skip {algo} at {actual} B: reduce-scatter "
                                  f"kernel needs size % (n*128) elems == 0",
                                  file=sys.stderr)
                            continue
                        fn = t.jit_fn(_OP[collective], algo, **knobs)
                        r1 = None
                        if args.paranoid:
                            # same input, same schedule: a bit difference is a
                            # race or a nondeterministic reduction order
                            r1, r2 = fn(x), fn(x)
                            if not torch.equal(r1, r2):
                                raise AssertionError(
                                    f"paranoid: {collective}/{algo} nondeterministic "
                                    f"at {actual} B")
                        if pre.check:
                            got = r1 if r1 is not None else fn(x)
                            if collective not in _REDUCING:
                                rtol = atol = 0.0  # data movement: exact
                            elif dtype != "float32":
                                rtol, atol = 5e-2, 5e-2
                            else:
                                rtol, atol = 1e-4, 1e-5
                            _check(got, want, rtol, atol,
                                   f"{collective}/{algo} {dtype} {actual} B", bound)
                            del got
                        r1 = None
                        tm = time_fn(fn, x, warmup=args.warmup, repeats=args.repeats,
                                     calls_per_repeat=args.iters)
                        rec = M.BenchRecord.measure(
                            bench_name, collective, algo, pre.n_ranks, actual, dtype,
                            tm.mean_s, platform=topo.platform, preset=pre.name,
                            min_s=tm.min_s, max_s=tm.max_s, checked=pre.check,
                            **extra, **knobs)
                        records.append(rec)
                        if out_fp:
                            rec.write(out_fp)
                    del x, want, bound
    finally:
        if out_fp:
            out_fp.close()
    print(M.format_table(records))
    return records
