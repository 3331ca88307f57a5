"""Shared sweep runner behind the bench CLIs: parse flags -> backend and
rank mesh -> Transport -> timed loop -> bus-bandwidth report.

Counterpart of ``rocnrdma_tpu/bench/runner.py`` for every collective of
the reference's CLIs (allreduce, reducescatter, allgather, alltoall,
broadcast, reduce, gather, scatter, sendrecv), with its per-collective
shapes and size conventions (``_shape_and_bytes``: ``--sizes`` is the
per-rank buffer S; allgather's and gather's is the gathered output, each
rank contributing S/n) and its flags, ``--mesh2d SxI`` (a 2-D
``('slice', 'intra')`` mesh), ``--root``, ``--shift`` and
``--cross-dtype`` among them, refused as it refuses them (a root out of
range, or sendrecv on a 2-D mesh: the Transport raises, exit 1).
Differences:

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
- ``--intra-algo ring|khd`` (the port's own flag) reaches the
  hierarchical allreduce's intra-slice phases, which the reference reaches
  only through ``Transport.allreduce(intra_algo=...)``. Like
  ``--cross-dtype`` it applies to the hierarchical allreduce only and is
  part of a record's identity.
- On the GPU each record carries ``extra["peak_mem_bytes"]``, the
  ``torch.cuda.max_memory_allocated`` of its check and timed calls, input
  and expected result included, and ``extra["launches"]``, the kernel
  launches of its point (``ops.launch_counts``) where there were any.
- ``--profile DIR`` writes a ``torch.profiler`` Chrome trace.
- ``--check-plain`` (the port's own flag) also holds every ``cuda_ring``
  point bitwise to its kernels' plain PyTorch versions on the whole input
  (``extra["plain_max_abs_err"]``), each rank its own rows, with one more
  call after its peak memory and launches are read: the plain result is
  made before the point's arms and only this rank's rows are kept, on the
  host, so no record's ``peak_mem_bytes`` holds it.

Across processes (a launcher's environment, ``cli_common``): the CLI runs
as N processes, each one rank of ``rank_mesh(N, group=WORLD)`` (or one
slice of ``slice_mesh(N, I, group=WORLD)``). Every process builds the
same global input from ``default_rng(0)`` and keeps its rows; each rank
checks its rows against its rows of the expected result, and the verdict
is agreed across the fleet (one ``all_reduce`` of the failed ranks on the
mesh's cross group), so one rank's failed check fails every rank, naming
the ranks that failed. ``--paranoid`` compares each rank's own bytes, the
verdict agreed alike. Each point is timed across the fleet
(``timing.time_fn(span=)``: a barrier before each repeat, the maximum
over the ranks), and ``peak_mem_bytes`` is the maximum over the ranks.
Only rank 0 reads ``--out`` for ``--resume`` (it broadcasts the done
points), prints the records and the table and writes ``--out``; the
other ranks print to stderr only. ``extra["processes"]`` is N and
``extra["link"]`` is ``"nvlink"`` where the cross leg is NCCL with a GPU
a process, ``"host-loopback"`` where the processes share a GPU (gloo
staged through pinned memory), ``"cpu-loopback"`` on the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import math
import os
import sys

import numpy as np
import torch

from rocnrdma_tpu_torch import metrics as M
from rocnrdma_tpu_torch import ops
from rocnrdma_tpu_torch.bench import cli_common
from rocnrdma_tpu_torch.bench import presets as P
from rocnrdma_tpu_torch.bench.timing import agree, fleet_max, time_fn
from rocnrdma_tpu_torch.collectives.reduce_op import REDUCE_OPS
from rocnrdma_tpu_torch.runtime import PLATFORMS
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
    p.add_argument("--mesh2d", type=str, default=None, metavar="SLICESxPER",
                   help="2-D ('slice','intra') mesh, e.g. 2x4 (hierarchical)")
    p.add_argument("--sizes", type=str, default=None,
                   help="comma list of per-rank bytes, e.g. 4K,1M,256M")
    p.add_argument("--dtypes", type=str, default=None, help="e.g. float32,bfloat16")
    p.add_argument("--algos", type=str, default=None, help=f"subset of {ALGOS}")
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--iters", type=int, default=10, help="calls per timed repeat")
    p.add_argument("--root", type=int, default=0,
                   help="root rank (broadcast/reduce/gather/scatter only)")
    p.add_argument("--shift", type=int, default=1,
                   help="ring offset: send to rank+shift mod n (sendrecv only)")
    p.add_argument("--cross-dtype", default=None, metavar="DTYPE",
                   help="cross-slice dtype of the hierarchical allreduce on "
                        "--mesh2d sweeps (e.g. bfloat16); other algos in the "
                        "sweep run unaffected")
    p.add_argument("--intra-algo", choices=("ring", "khd"), default=None,
                   help="intra-slice phases of the hierarchical allreduce "
                        "on --mesh2d sweeps; other algos run unaffected")
    p.add_argument("--redop", choices=REDUCE_OPS, default="sum",
                   help="reduction operator (allreduce/reducescatter/reduce)")
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
    p.add_argument("--check-plain", action="store_true",
                   help="hold each cuda_ring point bitwise to its kernels' "
                        "plain PyTorch versions on the whole input")
    return p


_OP = {"allreduce": "allreduce", "reducescatter": "reduce_scatter",
       "allgather": "allgather", "alltoall": "alltoall",
       "broadcast": "broadcast", "reduce": "reduce", "gather": "gather",
       "scatter": "scatter", "sendrecv": "sendrecv"}

# Collectives that reduce (honor --redop) / are rooted (honor --root).
_REDUCING = ("allreduce", "reducescatter", "reduce")
_ROOTED = ("broadcast", "reduce", "gather", "scatter")

# Default algo pair when no preset/--algos names one: the explicit schedule
# the collective owns, benchmarked against the fused library call.
_DEFAULT_ALGOS = {
    "allreduce": ("ring", "fused"), "reducescatter": ("ring", "fused"),
    "allgather": ("ring", "fused"), "alltoall": ("ring", "fused"),
    "broadcast": ("binomial", "fused"), "reduce": ("binomial", "fused"),
    "gather": ("binomial", "fused"), "scatter": ("binomial", "fused"),
    "sendrecv": ("fused",),
}


def resolve_preset(args, collective: str) -> P.Preset:
    """Merge preset defaults and CLI overrides into one concrete Preset."""
    if args.preset:
        pre = P.get_preset(args.preset)
    else:
        pre = P.Preset(name="custom", baseline_config="(custom flags)",
                       n_ranks=args.ranks or 8, mesh2d=None, sizes=(4 * M.MiB,),
                       dtypes=("float32",),
                       algos=_DEFAULT_ALGOS.get(collective, ("fused",)))
    over = {}
    if args.ranks:
        over["n_ranks"] = args.ranks
    if args.mesh2d:
        s, per = cli_common.parse_mesh2d(args.mesh2d)
        over["mesh2d"] = (s, per)
        over["n_ranks"] = s * per
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
    if collective in ("allgather", "gather"):
        elems = max(n, elems // n * n)  # input chunk = S/n
        shape = (n, elems // n)
    elif collective == "alltoall":
        elems = max(n, elems // n * n)
        shape = (n, n, elems // n)
    elif collective in ("reducescatter", "scatter"):
        elems = max(n, elems // n * n)
        shape = (n, elems)
    else:  # allreduce / broadcast / reduce / sendrecv: full S per rank
        shape = (n, elems)
    return shape, elems * itemsize


def _build_input(t: Transport, collective: str, size_bytes: int, dtype: str):
    """(tensor on the mesh device, the same values as float32 numpy, bytes).
    The tensor's leading dims are the mesh shape (this process's rows where
    the mesh spans processes); the numpy array is every rank's, rank-major
    with one leading rank dim."""
    shape, actual = _shape_and_bytes(collective, t.n_ranks, size_bytes, dtype)
    x_np = np.random.default_rng(0).standard_normal(
        size=tuple(t.mesh.shape) + shape[1:], dtype=np.float32)
    x = t.shard(x_np, DTYPES[dtype])
    if DTYPES[dtype] != torch.float32:
        # the values the ranks actually hold: the cast rounds to nearest
        # even on the host as on the card
        held = x if t.span is None else torch.from_numpy(x_np).to(DTYPES[dtype])
        x_np = held.float().cpu().numpy()
    return x, x_np.reshape(shape), actual


def _np_reduce(flat: np.ndarray, op: str) -> np.ndarray:
    """Rank-axis reduction matching REDUCE_OPS semantics."""
    n = flat.shape[0]
    red = {"sum": np.sum, "avg": np.sum, "prod": np.prod,
           "max": np.max, "min": np.min}[op](flat, axis=0)
    return red / n if op == "avg" else red


_UNIT_ROUNDOFF = {torch.float32: 2.0 ** -24, torch.bfloat16: 2.0 ** -8}


def _expected(collective: str, x_np: np.ndarray, op: str = "sum",
              root: int = 0, shift: int = 1) -> np.ndarray:
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
    if collective == "broadcast":
        return flat[root][None]
    if collective == "reduce":
        out = np.zeros_like(flat)
        out[root] = _np_reduce(flat, op)
        return out
    if collective == "gather":
        out = np.zeros((n, flat.size), flat.dtype)
        out[root] = flat.reshape(-1)
        return out
    if collective == "scatter":
        return flat[root].reshape(n, -1)  # row r = chunk r of root's buffer
    if collective == "sendrecv":
        return np.roll(flat, shift, axis=0)
    raise ValueError(collective)


def _rounding_bound(x_np: np.ndarray, op: str, dtype: str,
                    collective: str = "allreduce", root: int = 0,
                    wire: str | None = None) -> np.ndarray | None:
    """Worst-case rounding of any order of n-1 adds in ``dtype`` (or in the
    coarser ``wire`` dtype a phase casts to), per element: gamma *
    sum_r |x_r| with gamma = (n-1)u / (1 - (n-1)u), laid out as
    ``_expected`` lays out the result (sum/avg only; None for the other
    ops and for the verbs that only move data)."""
    if op not in ("sum", "avg") or collective not in _REDUCING:
        return None
    n = x_np.shape[0]
    u = max(_UNIT_ROUNDOFF[DTYPES[d]] for d in (dtype, wire or dtype))
    nu = (n - 1) * u
    bound = nu / (1 - nu) * np.abs(x_np.reshape(n, -1)).sum(axis=0)
    bound = bound / n if op == "avg" else bound
    if collective == "reduce":
        out = np.zeros((n, bound.size), bound.dtype)
        out[root] = bound
        return out
    return bound.reshape(n, -1) if collective == "reducescatter" else bound


def _check(got: torch.Tensor, want: torch.Tensor, rtol: float, atol: float,
           what: str, bound: torch.Tensor | None = None,
           ranks: int | None = None, first: int = 0) -> None:
    """``got`` (n, ...) against ``want``, on the device: one expected row
    per rank (n, E), or one row (E,) every rank must hold. An element
    passes within ``atol + rtol*|want|`` or within the rounding ``bound``;
    ``rtol = atol = 0`` with no bound asks for exact equality. ``first``:
    the rank of ``got``'s first row (this process's first rank where the
    mesh spans processes; ``want`` and ``bound`` are then its rows)."""
    rows = got.reshape(ranks or got.shape[0], -1)
    want = want.reshape(-1, rows.shape[1])
    if bound is not None:
        bound = bound.reshape(-1, rows.shape[1])
    off = []
    # rank by rank, so the temporaries stay one row deep
    for r in range(rows.shape[0]):
        w = want[r % want.shape[0]]
        tol = atol + rtol * w.abs()
        if bound is not None:
            tol = torch.maximum(tol, bound[r % bound.shape[0]])
        bad = (rows[r].float() - w).abs() > tol
        if bool(bad.any()):
            off.append((r, int(bad.sum()), int(bad.nonzero()[0])))
    if off:
        r, _, i = off[0]
        raise AssertionError(
            f"{what}: {sum(c for _, c, _ in off)} element(s) off; first rank "
            f"{first + r} elem {i}: got {float(rows[r, i])}, want "
            f"{float(want[r % want.shape[0], i])} (rtol={rtol}, atol={atol})")


def algos_for(collective: str, algos: tuple, is_2d: bool = False) -> tuple:
    """Keep the algos this collective defines on this mesh; unknown names
    raise. Presets bundle algos for a whole config (``multislice`` names
    the hierarchical allreduce and alltoall), so each CLI keeps its own,
    falling back to ``fused``."""
    unknown = [a for a in algos if a not in ALGOS]
    if unknown:
        raise ValueError(f"unknown algo(s) {unknown}; know {ALGOS}")
    kept = tuple(a for a in algos if supports(_OP[collective], a, is_2d))
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


def _mine(rows: np.ndarray | None, first: int, count: int):
    """This process's rows ``[first, first + count)`` of a per-rank array
    (one row a rank), or the array itself where every rank holds its one
    row (or there is none)."""
    if rows is None or rows.ndim < 2 or rows.shape[0] == 1:
        return rows
    return rows[first:first + count]


def run_sweep(bench_name: str, collective: str, args) -> list:
    pre = resolve_preset(args, collective)
    topo = cli_common.setup_backend(args.fake_devices, args.platform, pre.n_ranks,
                                     across=True)
    across = cli_common.joined()
    if across and args.mesh2d:  # named before any scaling
        cli_common.check_slices(*pre.mesh2d, topo)

    max_bytes = parse_size(args.max_bytes) if args.max_bytes else (
        64 * M.MiB if topo.is_oracle else 4 * M.GiB)
    if not args.strict_preset:
        scaled = pre.scaled_to(topo.n_devices, max_bytes,
                               topo.n_processes if across else None)
        if scaled != pre:
            print(f"# preset {pre.name!r} scaled to backend: ranks {pre.n_ranks}->"
                  f"{scaled.n_ranks}, mesh2d {pre.mesh2d}->{scaled.mesh2d}, "
                  f"{len(scaled.sizes)} size(s)", file=sys.stderr)
        pre = scaled
    if not across and pre.n_ranks > topo.n_devices:
        raise SystemExit(f"preset needs {pre.n_ranks} ranks; backend has "
                         f"{topo.n_devices} devices (use --fake-devices or drop "
                         f"--strict-preset)")

    t = Transport(cli_common.mesh_for(pre.mesh2d, pre.n_ranks, topo))
    span = t.span
    lead = cli_common.is_lead()
    rows = math.prod(t.mesh.local_shape)  # the ranks this process holds
    first = 0 if span is None else span.index * rows
    algos = algos_for(collective, pre.algos, t.is_2d)
    if set(algos) != set(pre.algos):
        print(f"# algos for {collective} on this mesh: {algos} "
              f"(preset named {pre.algos})", file=sys.stderr)

    # per-collective knobs from the CLI; only what the verb understands
    knobs = {}
    if collective in _REDUCING and args.redop != "sum":
        knobs["op"] = args.redop
    if collective in _ROOTED and args.root:
        knobs["root"] = args.root
    if collective == "sendrecv" and args.shift != 1:
        knobs["shift"] = args.shift
    op = knobs.get("op", "sum")
    extra = {"device": topo.device_name, **cli_common.link_extra(topo, span, pre.n_ranks)}
    on_gpu = topo.device.type == "cuda"

    def hier_knobs(algo: str) -> dict:
        # --cross-dtype / --intra-algo apply only where they exist (the
        # hierarchical allreduce) and are part of the sweep point's identity
        if collective != "allreduce" or algo != "hierarchical":
            return {}
        return {k: v for k, v in (("cross_dtype", args.cross_dtype),
                                  ("intra_algo", args.intra_algo)) if v}

    # every arm's callable first: a refused knob (a root out of range,
    # sendrecv on a 2-D mesh) fails before any input is built
    fns = {a: t.jit_fn(_OP[collective], a, **knobs, **hier_knobs(a)) for a in algos}

    done = M.load_completed(args.out) if (args.out and args.resume and lead) else set()
    if span is not None and args.resume:
        box = [done]  # rank 0 read the file; every rank skips the same points
        torch.distributed.broadcast_object_list(box, src=span.peers[0],
                                                group=span.cross_group)
        done = box[0]
    out_fp = open(args.out, "a") if (args.out and lead) else None
    records = []
    try:
        with _profiler(args.profile, topo.device):
            for dtype in pre.dtypes:
                for size in pre.sizes:
                    def _key(algo, nbytes):
                        return M.record_key(bench_name, collective, algo,
                                            pre.n_ranks, nbytes, dtype,
                                            M.knob_key({**knobs, **hier_knobs(algo)}))
                    actual = _shape_and_bytes(collective, pre.n_ranks, size, dtype)[1]
                    if done and all(_key(a, size) in done or _key(a, actual) in done
                                    for a in algos):
                        continue
                    x, x_np, actual = _build_input(t, collective, size, dtype)
                    want = None
                    bounds: dict = {}  # wire dtype -> rounding bound on the device
                    if pre.check:
                        want = torch.from_numpy(_mine(_expected(
                            collective, x_np, op, knobs.get("root", 0),
                            knobs.get("shift", 1)), first, rows)).to(t.device)
                        for algo in algos:
                            wire = hier_knobs(algo).get("cross_dtype")
                            if wire not in bounds:
                                b = _mine(_rounding_bound(x_np, op, dtype, collective,
                                                          knobs.get("root", 0), wire),
                                          first, rows)
                                bounds[wire] = (None if b is None
                                                else torch.from_numpy(b).to(t.device))
                    plain = None
                    if args.check_plain and "cuda_ring" in algos:
                        # this rank's rows of the plain result, kept on the
                        # host: no arm's peak memory holds the n-rank result
                        full = torch.from_numpy(x_np.reshape(
                            (pre.n_ranks,) + x.shape[len(t.mesh.local_shape):]))
                        plain = ops.cuda_ring_plain(collective, full.to(t.device).to(DTYPES[dtype]))
                        plain = plain.reshape(pre.n_ranks, -1)[first:first + rows].cpu()
                        del full
                    del x_np
                    for algo in algos:
                        xk = hier_knobs(algo)
                        if _key(algo, actual) in done:
                            continue
                        if (algo == "cuda_ring" and collective == "reducescatter"
                                and (actual // DTYPES[dtype].itemsize)
                                % (pre.n_ranks * 128) != 0):
                            print(f"# skip {algo} at {actual} B: reduce-scatter "
                                  f"kernel needs size % (n*128) elems == 0",
                                  file=sys.stderr)
                            continue
                        fn = fns[algo]
                        what = f"{collective}/{algo} {dtype} {actual} B"
                        if on_gpu:
                            torch.cuda.reset_peak_memory_stats(t.device)
                            launched = ops.launch_counts()
                        rec_extra = dict(extra)
                        r1 = None
                        if args.paranoid:
                            # same input, same schedule: a bit difference is a
                            # race or a nondeterministic reduction order
                            r1, r2 = fn(x), fn(x)
                            agree(span, None if torch.equal(r1, r2) else
                                   f"paranoid: {collective}/{algo} nondeterministic "
                                   f"at {actual} B", what)
                        if pre.check:
                            got = r1 if r1 is not None else fn(x)
                            if collective not in _REDUCING:
                                rtol = atol = 0.0  # data movement: exact
                            elif dtype != "float32" or xk.get("cross_dtype"):
                                rtol, atol = 5e-2, 5e-2
                            else:
                                rtol, atol = 1e-4, 1e-5
                            err = None
                            try:
                                _check(got, want, rtol, atol, what,
                                       bounds.get(xk.get("cross_dtype")), rows, first)
                            except AssertionError as e:
                                err = str(e)
                            agree(span, err, what)
                            del got
                        r1 = None
                        tm = time_fn(fn, x, warmup=args.warmup, repeats=args.repeats,
                                     calls_per_repeat=args.iters, span=span)
                        if on_gpu:
                            peak = torch.cuda.max_memory_allocated(t.device)
                            rec_extra["peak_mem_bytes"] = (
                                peak if span is None else int(fleet_max([peak], span)[0]))
                            now = ops.launch_counts()
                            ran = {k: now[k] - launched[k] for k in now
                                   if now[k] > launched[k]}
                            if ran:
                                rec_extra["launches"] = ran
                        if plain is not None and algo == "cuda_ring":
                            # after the peak and the launches are read: one
                            # more call, held to the plain rows
                            got = fn(x).reshape(rows, -1)
                            want_plain = plain.to(t.device)
                            diff = float((got.float() - want_plain.float()).abs().max())
                            rec_extra["plain_max_abs_err"] = diff
                            agree(span, None if torch.equal(got, want_plain) else
                                   f"{what}: not bitwise its kernels' plain versions "
                                   f"(max abs err {diff})", what)
                            del got, want_plain
                        rec = M.BenchRecord.measure(
                            bench_name, collective, algo, pre.n_ranks, actual, dtype,
                            tm.mean_s, platform=topo.platform, preset=pre.name,
                            mesh2d=list(pre.mesh2d) if pre.mesh2d else None,
                            min_s=tm.min_s, max_s=tm.max_s, checked=pre.check,
                            **rec_extra, **knobs, **xk)
                        records.append(rec)
                        if out_fp:
                            rec.write(out_fp)
                    del x, want, bounds, plain
    finally:
        if out_fp:
            out_fp.close()
    if lead:
        print(M.format_table(records))
    return records
