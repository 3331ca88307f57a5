"""``bench_pipe_sweep`` - the Triton combine kernel (``ops/local_triton.py``,
K2) in every form tried on the H100, beside the CUDA combine kernel and
``torch.add``. Its numbers set the module constants ``local_triton.BLOCK``,
``NUM_STAGES`` and ``NUM_WARPS``. Needs the card: Triton kernels run
nowhere else.

    python -m rocnrdma_tpu_torch.bench.bench_pipe_sweep --size 256M \\
        --tile-rows 16,32,64 --stages 1,2,3 --warps 4,8 --out pipe.jsonl

Forms (``--forms``), each over tiles of ``tile_rows`` x 128 elements:

- ``flat``: the committed kernel as it runs, one tile a program (a grid of
  every tile), at ``--stages`` 1 only: nothing for the pipeliner to
  overlap, the warp scheduler overlaps the programs;
- ``pointer``: the committed kernel persistent, on a grid of the programs
  resident at once (sized from the compiled kernel's shared memory), its
  loads pipelined by Triton (``cp.async`` into shared memory) at
  ``--stages``;
- ``tma``: the TMA design, tiles of (rows, 128) loaded through TMA tensor
  descriptors (the pipeliner lowers them to TMA copies on ``mbarrier``s),
  the sum stored through a descriptor or with ``st.global``
  (``--tma-store 1,0``), with or without Triton's warp specialisation
  (``--warp-specialize 0,1``), persistent on a grid of the programs
  resident at once (``tma_geometry``); the last ``numel % 128`` elements,
  outside every row, summed by the last program with masked loads;
- ``parent``: the committed kernel as the previous design ran it, 8192
  elements a tile, 3 stages (cut to fit as it cut them), 4 warps, a grid of
  4 programs per SM, once per k.

Every point is first held bitwise to ``hbm_combine_plain``, then timed with
CUDA events (``timing.time_fn``). ``GBps`` counts (k+1) bytes per element
moved (k reads + 1 write). Each TMA row carries the shared memory the
compiled program uses beside ``tma_smem_bytes``'s model of it, which sizes
its grid. A configuration that does not compile (shared memory, or a loop
Triton cannot warp-specialise) is reported and skipped.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import sys

import torch

from rocnrdma_tpu_torch.bench import cli_common
from rocnrdma_tpu_torch.bench.runner import DTYPES, parse_size
from rocnrdma_tpu_torch.bench.timing import time_fn
from rocnrdma_tpu_torch.ops import hbm_combine, hbm_combine_plain, local_triton as LT

LANES = 128  # elements a row of the TMA form's 2-D view, the reference's lanes
# Shared memory on the H100: what one program may use, what one SM holds
# for all its resident programs, and what the system keeps per program.
SMEM_BYTES = 227 * 1024
SMEM_PER_SM = 228 * 1024
SMEM_RESERVED = 1024
SMEM_BARRIERS = 128  # the pipeline's mbarriers, with room to spare
THREADS_PER_SM = 2048
PROGRAMS_PER_SM_MAX = 32


def tma_smem_bytes(k: int, block: int, itemsize: int, stages: int,
                   tma_store: bool = True) -> int:
    """Shared memory of one program of the TMA form: Triton's pipeliner
    buffers ``stages - 1`` tiles of every operand ahead of the one in use,
    and the asynchronous store stages one tile of the sum; with no pipeline
    (one stage) the operands' loads and the store take turns in one tile
    (compiled footprints on the H100, k=2, 16 KiB tiles: 16392, 49160 and
    81936 bytes at 1, 2 and 3 stages with the TMA store)."""
    tile = block * itemsize
    if stages == 1:
        return tile + SMEM_BARRIERS
    return (stages - 1) * k * tile + (tile if tma_store else 0) + SMEM_BARRIERS


def tma_stages_for(k: int, block: int, itemsize: int, num_stages: int,
                   tma_store: bool = True) -> int:
    """The pipeline depth a k-operand launch of the TMA form runs:
    ``num_stages``, cut to what fits ``SMEM_BYTES``."""
    fit = 1 + ((SMEM_BYTES - tma_smem_bytes(k, block, itemsize, 1, tma_store))
               // (k * block * itemsize))
    return max(1, min(num_stages, fit))


def resident_per_sm(smem: int, num_warps: int) -> int:
    """Programs of ``smem`` bytes and ``num_warps`` warps resident on one SM."""
    return max(1, min(SMEM_PER_SM // (smem + SMEM_RESERVED),
                      THREADS_PER_SM // (32 * num_warps), PROGRAMS_PER_SM_MAX))


@dataclasses.dataclass(frozen=True)
class TmaGeometry:
    rows: int         # whole LANES-element rows: the descriptors' view
    tail: int         # elements after them (0 .. LANES-1), summed by pointer
    n_tiles: int      # tiles of tile_rows rows over those rows
    box: tuple        # the TMA box, (tile_rows, LANES)
    stages: int       # pipeline depth, cut to fit shared memory
    smem: int         # shared memory of one program
    per_sm: int       # programs resident on one SM
    grid: int         # programs launched: all resident at once


def tma_geometry(numel: int, k: int, itemsize: int, sms: int, tile_rows: int,
                 num_stages: int, num_warps: int, tma_store: bool = True) -> TmaGeometry:
    """The TMA form's launch of a k-operand combine of ``numel`` elements on
    a card with ``sms`` SMs: the grid is the programs that fit at once by
    shared memory and threads, never more than there are tiles."""
    if not 1 <= tile_rows <= 256 or tile_rows & (tile_rows - 1):
        raise ValueError(f"tile_rows must be a power of two in 1..256 (a TMA box "
                         f"dimension), got {tile_rows}")
    rows = numel // LANES
    block = tile_rows * LANES
    stages = tma_stages_for(k, block, itemsize, num_stages, tma_store)
    smem = tma_smem_bytes(k, block, itemsize, stages, tma_store)
    per_sm = resident_per_sm(smem, num_warps)
    n_tiles = -(-rows // tile_rows)
    return TmaGeometry(rows=rows, tail=numel - rows * LANES, n_tiles=n_tiles,
                       box=(tile_rows, LANES), stages=stages, smem=smem, per_sm=per_sm,
                       grid=max(1, min(n_tiles, sms * per_sm)))


@functools.lru_cache(maxsize=None)
def _tma_kernel():
    """The TMA form of the combine (built at first launch, on the card)."""
    import triton
    import triton.language as tl

    @triton.jit
    def fold(acc, x):
        # one add in fp32, rounded to the operands' dtype
        return (acc + x.to(tl.float32)).to(x.dtype).to(tl.float32)

    @triton.jit
    def combine_tma(out_d, d0, d1, d2, d3, d4, d5, d6, d7,
                    out_p, p0, p1, p2, p3, p4, p5, p6, p7,
                    n_tiles, n_rows, tail_start, n_elems,
                    K: tl.constexpr, TILE_ROWS: tl.constexpr, LANES: tl.constexpr,
                    NUM_STAGES: tl.constexpr, TMA_STORE: tl.constexpr,
                    WARP_SPECIALIZE: tl.constexpr):
        pid = tl.program_id(0)
        n_prog = tl.num_programs(0)
        for t in tl.range(pid, n_tiles, n_prog, num_stages=NUM_STAGES,
                          warp_specialize=WARP_SPECIALIZE):
            row = t * TILE_ROWS
            v = d0.load([row, 0])
            dt = v.dtype
            acc = v.to(tl.float32)
            acc = fold(acc, d1.load([row, 0]))
            if K > 2:
                acc = fold(acc, d2.load([row, 0]))
            if K > 3:
                acc = fold(acc, d3.load([row, 0]))
            if K > 4:
                acc = fold(acc, d4.load([row, 0]))
            if K > 5:
                acc = fold(acc, d5.load([row, 0]))
            if K > 6:
                acc = fold(acc, d6.load([row, 0]))
            if K > 7:
                acc = fold(acc, d7.load([row, 0]))
            if TMA_STORE:
                out_d.store([row, 0], acc.to(dt))
            else:
                r = row + tl.arange(0, TILE_ROWS)[:, None]
                offs = r.to(tl.int64) * LANES + tl.arange(0, LANES)[None, :]
                tl.store(out_p + offs, acc.to(dt), mask=r < n_rows)
        # the last numel % LANES elements, outside every row
        if pid == n_prog - 1:
            if tail_start < n_elems:
                offs = tail_start + tl.arange(0, LANES)
                m = offs < n_elems
                tv = tl.load(p0 + offs, mask=m)
                tacc = tv.to(tl.float32)
                tacc = fold(tacc, tl.load(p1 + offs, mask=m))
                if K > 2:
                    tacc = fold(tacc, tl.load(p2 + offs, mask=m))
                if K > 3:
                    tacc = fold(tacc, tl.load(p3 + offs, mask=m))
                if K > 4:
                    tacc = fold(tacc, tl.load(p4 + offs, mask=m))
                if K > 5:
                    tacc = fold(tacc, tl.load(p5 + offs, mask=m))
                if K > 6:
                    tacc = fold(tacc, tl.load(p6 + offs, mask=m))
                if K > 7:
                    tacc = fold(tacc, tl.load(p7 + offs, mask=m))
                tl.store(out_p + offs, tacc.to(tv.dtype), mask=m)

    return combine_tma


def tma_launch(xs, out: torch.Tensor, g: TmaGeometry, num_warps: int,
               tma_store: bool, warp_specialize: bool):
    """One launch of the TMA form over geometry ``g``; operands and ``out``
    contiguous and 16-byte aligned. Returns Triton's compiled kernel."""
    from triton.tools.tensor_descriptor import TensorDescriptor

    # A descriptor needs at least one row; with none, n_tiles is 0 and no
    # tile is ever loaded through it.
    shape, strides = [max(g.rows, 1), LANES], [LANES, 1]

    def desc(t):
        return TensorDescriptor(t, shape, strides, list(g.box))
    descs = [desc(x) for x in xs]
    descs += [descs[0]] * (LT.MAX_OPERANDS - len(xs))  # unused slots
    ptrs = list(xs) + [xs[0]] * (LT.MAX_OPERANDS - len(xs))
    with torch.cuda.device(out.device):
        return _tma_kernel()[(g.grid,)](
            desc(out), *descs, out, *ptrs, g.n_tiles, g.rows, g.rows * LANES,
            out.numel(), K=len(xs), TILE_ROWS=g.box[0], LANES=LANES,
            NUM_STAGES=g.stages, TMA_STORE=tma_store, WARP_SPECIALIZE=warp_specialize,
            num_warps=num_warps)


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="bench_pipe_sweep",
        description="Triton combine kernel per (form, tile rows, stages, warps)")
    p.add_argument("--size", type=str, default="256M", help="per-operand bytes")
    p.add_argument("--ks", type=str, default="2,3", help="operand counts")
    p.add_argument("--tile-rows", type=str, default="16,32,64",
                   help="rows of 128 elements a tile")
    p.add_argument("--stages", type=str, default="1,2,3")
    p.add_argument("--warps", type=str, default="4,8")
    p.add_argument("--tma-store", type=str, default="1,0",
                   help="TMA form: 1 stores through a descriptor, 0 with st.global")
    p.add_argument("--warp-specialize", type=str, default="0,1",
                   help="TMA form: 1 runs the loop on Triton's producer/consumer warps")
    p.add_argument("--forms", type=str, default="flat,pointer,tma,parent")
    p.add_argument("--dtype", choices=tuple(DTYPES), default="float32")
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--out", type=str, default=None, help="append JSONL rows here")
    return p


def _skip(what: str, e: Exception) -> None:
    first = str(e).splitlines()[0] if str(e) else ""
    print(f"# skip {what}: {type(e).__name__}: {first}", file=sys.stderr)


def run(args) -> list[dict]:
    topo = cli_common.setup_backend(None, "auto", default_ranks=1)
    dtype = DTYPES[args.dtype]
    elems = parse_size(args.size) // dtype.itemsize
    ks = [int(k) for k in args.ks.split(",")]
    forms = args.forms.split(",")
    sms = torch.cuda.get_device_properties(topo.device).multi_processor_count
    g = torch.Generator(device=topo.device).manual_seed(0)
    xs = [torch.randn((elems,), generator=g, device=topo.device).to(dtype)
          for _ in range(max(ks))]
    configs = [(int(tr), int(st), int(w)) for tr in args.tile_rows.split(",")
               for st in args.stages.split(",") for w in args.warps.split(",")]
    tma_knobs = [(bool(int(ts)), bool(int(ws))) for ts in args.tma_store.split(",")
                 for ws in args.warp_specialize.split(",")]
    rows = []
    for k in ks:
        ops = xs[:k]
        want = hbm_combine_plain(*ops)
        nbytes = (k + 1) * elems * dtype.itemsize
        base = {"bench": "bench_pipe_sweep", "k": k, "dtype": args.dtype,
                "size_bytes": elems * dtype.itemsize, "device": topo.device_name}
        out = torch.empty_like(ops[0])

        def timed(name, fn, **kw):
            ms = time_fn(fn, ops[0], repeats=args.repeats,
                         calls_per_repeat=args.iters).mean_s * 1e3
            rows.append({**base, "kernel": name, **kw, "ms": ms,
                         "GBps": nbytes / ms / 1e6})
            print(json.dumps(rows[-1]), flush=True)

        def held(what, launch):
            compiled = launch()
            if not torch.equal(out, want):
                raise SystemExit(f"k={k} {what}: disagrees with the plain version")
            return compiled

        timed("torch.add", lambda *_: hbm_combine_plain(*ops))
        timed("cuda", lambda *_: hbm_combine(*ops))
        if "parent" in forms:
            # the previous stages_for: (stages - 1) tiles of 8192 in 224 KiB
            st = max(1, min(3, 1 + 224 * 1024 // (k * 8192 * dtype.itemsize)))

            def launch(*_, st=st):
                return LT._launch(ops, out, 8192, st, 4, 4 * sms)
            held("parent", launch)
            timed("triton_parent", launch, block=8192, num_stages=st, num_warps=4,
                  grid=4 * sms)
        for tile_rows, stages, warps in configs:
            block = tile_rows * LANES
            knobs = {"tile_rows": tile_rows, "num_stages": stages, "num_warps": warps}
            if "flat" in forms and stages == 1:
                def launch(*_, b=block, w=warps):
                    return LT._launch(ops, out, b, 1, w)
                held(f"flat {knobs}", launch)
                timed("triton_flat", launch, **knobs, grid=-(-elems // block))
            if "pointer" in forms and LT.stages_for(k, block, dtype.itemsize, stages) == stages:
                try:
                    first = LT._launch(ops, out, block, stages, warps, sms)
                    grid = sms * resident_per_sm(first.metadata.shared, warps)

                    def launch(*_, b=block, s=stages, w=warps, gr=grid):
                        return LT._launch(ops, out, b, s, w, gr)
                    held(f"pointer {knobs}", launch)
                    timed("triton_pointer", launch, **knobs, grid=grid,
                          smem_compiled=first.metadata.shared)
                except Exception as e:  # noqa: BLE001 - a config the card refuses
                    if "OutOfResources" not in type(e).__name__:
                        raise
                    _skip(f"k={k} pointer {knobs}", e)
            for tma_store, ws in tma_knobs if "tma" in forms else ():
                geo = tma_geometry(elems, k, dtype.itemsize, sms, tile_rows, stages,
                                   warps, tma_store)
                if geo.stages != stages:
                    continue  # the model's buffers do not fit shared memory
                kn = {**knobs, "tma_store": int(tma_store), "warp_specialize": int(ws)}

                def launch(*_, geo=geo, w=warps, ts=tma_store, ws=ws):
                    return tma_launch(ops, out, geo, w, ts, ws)
                try:
                    compiled = held(f"tma {kn}", launch)
                except Exception as e:  # noqa: BLE001 - a config the card refuses
                    if not ws and "OutOfResources" not in type(e).__name__:
                        raise
                    _skip(f"k={k} tma {kn}", e)
                    continue
                timed("triton_tma", launch, **kn, grid=geo.grid, smem_model=geo.smem,
                      smem_compiled=compiled.metadata.shared, regs=compiled.n_regs,
                      spills=compiled.n_spills)
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
