"""FSDP/ZeRO-3 communication replay: allgather params, reduce-scatter grads.

Counterpart of ``rocnrdma_tpu/workloads/fsdp_replay.py``. Every rank owns
a 1/n shard of each wrap unit's parameters, and a training step's
communication is

- forward, unit 0..L:   allgather(unit params)
- backward, unit L..0:  allgather(unit params), then reduce_scatter(unit grads)

so a rank moves 3(n-1)/n S a step against DDP's 2(n-1)/n S. The units are
FSDP's per-transformer-block wrapping of the public Llama-3-8B shapes (no
weights needed). The modes are ``ddp_replay``'s (``workloads/_replay.py``).

The ``cuda_ring`` reduce-scatter kernel, like the reference's Pallas one,
needs a rank buffer of whole 128-lane chunks (``n * 128`` elements); with
``--algo cuda_ring`` each shard is padded up to a multiple of 128
elements, the padding a caller of the kernel adds. Every other algo keeps
the reference's shard sizes (and on the CPU its values).

Across processes (a launcher's environment) each process is one rank, as
``ddp_replay`` says: every shard and gradient buffer is drawn whole, one
at a time, each rank keeping its row; step times are the maximum over the
ranks; rank 0 alone prints and writes ``--out``; ``--check-plain`` holds
every ``cuda_ring`` allgather and reduce-scatter to its kernels' plain
versions, bitwise, agreed across the fleet.

Usage::

    python -m rocnrdma_tpu_torch.workloads.fsdp_replay --fake-devices 8 --scale 4096 \\
        --platform cpu
    python -m rocnrdma_tpu_torch.workloads.fsdp_replay --fake-devices 8 --scale 16 \\
        --algo cuda_ring
    torchrun --nproc-per-node 4 -m rocnrdma_tpu_torch.workloads.fsdp_replay \\
        --scale 16 --algo cuda_ring --check-plain
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from rocnrdma_tpu_torch import metrics as M
from rocnrdma_tpu_torch.bench import cli_common
from rocnrdma_tpu_torch.bench.runner import DTYPES
from rocnrdma_tpu_torch.transport import Transport
from rocnrdma_tpu_torch.workloads import _replay
from rocnrdma_tpu_torch.workloads.ddp_replay import normal_source, plain_rows
from rocnrdma_tpu_torch.workloads.llama_trace import LLAMA3_8B, ModelSpec, _numel

MODES = ("sequential", "overlap", "jit_fused")
CUDA_RING_GRAIN = 128  # shard elements a multiple of this under cuda_ring


def flat_units(spec: ModelSpec) -> list[tuple[str, int]]:
    """(unit name, numel) per FSDP wrap unit: one per transformer block,
    plus the embedding and the norm+head, per-block auto-wrap."""
    units: dict[str, int] = {}
    for name, shape in spec.param_shapes():
        if name.startswith("layers."):
            unit = ".".join(name.split(".")[:2])  # "layers.N"
        elif name == "embed_tokens":
            unit = "embed"
        else:
            unit = "head"  # final norm + lm_head wrap together
        units[unit] = units.get(unit, 0) + _numel(shape)
    return list(units.items())


def _unit_arrays(t: Transport, units, scale: int, dtype: str, grain: int = 1):
    """Per-unit (shard, full) buffers: the 1/n shard each rank owns, and a
    full-size gradient buffer for the reduce_scatter. A shard holds
    ``max(1, numel // scale // n)`` elements, rounded up to a multiple of
    ``grain`` (values: ``ddp_replay.normal_source``)."""
    lead = tuple(t.mesh.shape)
    n = t.n_ranks
    draw = normal_source(t, dtype)
    shards, fulls = [], []
    for per in _shard_elems(units, scale, n, grain):
        shards.append(draw(lead + (per,)))
        fulls.append(draw(lead + (n * per,)))
    return shards, fulls


def _shard_elems(units, scale: int, n: int, grain: int) -> list:
    """Each unit's shard elements: ``max(1, numel // scale // n)`` rounded
    up to a multiple of ``grain``."""
    return [-(-max(1, numel // scale // n) // grain) * grain for _, numel in units]


def _plain_rows(t: Transport, units, scale: int, dtype: str, grain: int) -> list:
    """``step_plan``'s results from the kernels' plain versions, this
    process's rows (``ddp_replay.plain_rows`` over ``_unit_arrays``' draws)."""
    lead, n = tuple(t.mesh.shape), t.n_ranks
    draws = []
    for per in _shard_elems(units, scale, n, grain):
        draws += [("allgather", lead + (per,)), ("reducescatter", lead + (n * per,))]
    rows = plain_rows(t, dtype, draws)
    return [rows[2 * i + (kind == "rs")] for kind, i in step_plan(len(units))]


def step_plan(n_units: int) -> list[tuple[str, int]]:
    """The step's collective sequence: ("ag"|"rs", unit index)."""
    plan = [("ag", i) for i in range(n_units)]              # forward
    for i in reversed(range(n_units)):                      # backward
        plan.append(("ag", i))
        plan.append(("rs", i))
    return plan


def replay(t: Transport, shards, fulls, algo: str, mode: str,
           repeats: int = 5, window: int = 0, out: list | None = None) -> float:
    """Seconds per full-step replay (trimmed mean over repeats). ``out``
    receives the last repeat's results in ``step_plan`` order."""
    ag = t.jit_fn("allgather", algo)
    rs = t.jit_fn("reduce_scatter", algo)
    plan = step_plan(len(shards))

    def issue(kind, i):
        return ag(shards[i]) if kind == "ag" else rs(fulls[i])

    if mode == "jit_fused":
        def fn(sh, fl):
            return [ag(sh[i]) if k == "ag" else rs(fl[i]) for k, i in plan]
        return _replay.timed_fused(fn, (shards, fulls), repeats, t.device, out, t.span)

    for kind, i in sorted(set(plan)):  # warm every (verb, unit shape) pair
        issue(kind, i)
    _replay._sync(t.device)
    thunks = [lambda k=kind, j=i: issue(k, j) for kind, i in plan]
    if mode == "sequential":
        return _replay.timed_sequential(thunks, repeats, t.device, out, t.span)
    if mode == "overlap":
        return _replay.timed_overlap(thunks, repeats, window, t.device, out, t.span)
    raise ValueError(f"unknown mode {mode!r}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="fsdp_replay",
        description="Llama-3-8B FSDP/ZeRO-3 allgather+reduce-scatter replay")
    p.add_argument("--dtype", choices=tuple(DTYPES), default="float32")
    p.add_argument("--scale", type=int, default=4096,
                   help="divide every unit's numel by this (1 = full size)")
    p.add_argument("--ranks", type=int, default=None)
    p.add_argument("--mesh2d", type=str, default=None, metavar="SLICESxPER")
    p.add_argument("--algo", default="auto")
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
    args = p.parse_args(argv)
    modes = args.modes.split(",")
    for mode in modes:
        if mode not in MODES:
            raise SystemExit(f"unknown mode {mode!r}; know {MODES}")

    topo = cli_common.setup_backend(args.fake_devices, args.platform, args.ranks,
                                    across=True)
    t = Transport(cli_common.build_mesh(args.mesh2d, args.ranks, topo))
    lead = cli_common.is_lead()
    units = flat_units(LLAMA3_8B)
    grain = CUDA_RING_GRAIN if args.algo == "cuda_ring" else 1
    shards, fulls = _unit_arrays(t, units, args.scale, args.dtype, grain)
    itemsize = DTYPES[args.dtype].itemsize
    full_param_bytes = sum(numel for _, numel in units) * itemsize
    # wire bytes per step per rank (algorithmic): 2 AG + 1 RS of everything
    full_step_bytes = 3 * full_param_bytes
    nlead = len(t.mesh.shape)
    scaled_bytes = sum(int(np.prod(f.shape[nlead:])) * f.element_size() for f in fulls)
    if lead:
        print(f"# {LLAMA3_8B.name} FSDP: {len(units)} wrap units, "
              f"{full_param_bytes / M.GiB:.2f} GiB params "
              f"({full_step_bytes / M.GiB:.2f} GiB step traffic) / "
              f"{scaled_bytes / M.MiB:.1f} MiB at scale {args.scale}, "
              f"{t.n_ranks} ranks, algo={args.algo}", file=sys.stderr)
    plain = None
    if args.check_plain and args.algo == "cuda_ring":
        plain = _plain_rows(t, units, args.scale, args.dtype, grain)

    window = args.window if args.window is not None else _replay.default_window(topo)
    means, extras = _replay.run_modes(
        t, modes, lambda mode, out: replay(t, shards, fulls, args.algo, mode,
                                           repeats=args.repeats, window=window, out=out),
        plain, f"fsdp_replay {args.algo}")
    base = means.get("sequential")

    records = []
    for mode in modes:
        extra = dict(mode=mode, n_units=len(units), scale=args.scale,
                     full_bytes=full_step_bytes, pattern="fsdp", device=topo.device_name,
                     **cli_common.link_extra(topo, t.span, t.n_ranks), **extras[mode])
        if base is not None:
            extra["speedup_vs_sequential"] = base / means[mode]
        records.append(M.BenchRecord.measure(
            "fsdp_replay", "fsdp", args.algo, t.n_ranks, 3 * scaled_bytes,
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
