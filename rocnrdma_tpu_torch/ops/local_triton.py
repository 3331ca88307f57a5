"""The streaming k-operand combine ``x0 + x1 + ... + x(k-1)`` as a Triton
kernel whose loads the compiler schedules, counterpart of
``rocnrdma_tpu/ops/local_pallas.py::pallas_hbm_combine_pipelined``.

The reference kernel computes the same sum as ``pallas_hbm_combine`` (K1,
``local_cuda.hbm_combine`` here), but leaves the schedule of the stream to
the compiler: Mosaic's pipeline emitter overlaps each grid step's loads
with the previous step's adds, against K1's hand-rotated slots. Here the
kernel walks tiles ``pid, pid + grid, ...`` with
``tl.range(..., num_stages=NUM_STAGES)``, so Triton's software pipeliner
can keep the loads of the next ``NUM_STAGES - 1`` tiles in flight
(``cp.async`` into shared memory) while a tile is folded and stored.

What the H100 chose (``bench/bench_pipe_sweep.py``, PERF.md): one tile a
program and no software pipeline. A grid of every tile keeps up to 8
programs of 8 warps resident on each SM, and the warp scheduler overlaps
one program's loads with another's adds, loads straight into registers.
At 2 x 256 MiB fp32 every form that stages tiles through shared memory
ran slower at its best, by 1.5-5.3%: the pipeliner's ``cp.async`` at 2-3
stages on a persistent grid, and TMA descriptor loads (and stores) on a
grid of the programs resident at once, with or without Triton's warp
specialisation. So ``NUM_STAGES`` is 1 and the grid is every tile; the
loop runs once a program, and the sweep launches the same kernel
persistent to compare.

Bound on the H100: device-memory bytes, ``(k+1) * E * itemsize`` at
3.35 TB/s (each operand read once, the sum written once); the k-1 adds per
element are far below the fp32 rate. The fold goes left to right, in fp32,
and rounds to the operands' dtype after every add, as the reference's
``acc = acc + x`` in bf16 and ``combine.cu`` do, so the kernel equals
``hbm_combine_plain`` bit for bit.

``BLOCK`` (elements a tile), ``NUM_STAGES`` and ``NUM_WARPS`` are module
constants, set from ``bench/bench_pipe_sweep.py`` on the card (PERF.md);
``tile_rows`` stays in the signature for parity with the reference and is
validated, as ``local_cuda.hbm_combine`` does. ``triton`` is imported
inside the launching function only, so importing this module needs no GPU
stack.
"""

from __future__ import annotations

import functools

import torch

from rocnrdma_tpu_torch.ops.local_cuda import DTYPE_CODES, MAX_OPERANDS, hbm_combine_plain

# launches of the kernel wrapper since the last reset
LAUNCHES = {"hbm_combine_pipelined": 0}

# Set from bench/bench_pipe_sweep.py on the H100 (PERF.md, the K2 sweep):
# 16 rows of 128 a tile, 8 warps, one tile a program: the fastest of every
# form swept at k=2 and k=3, 256 MiB fp32.
BLOCK = 2048       # elements a tile, a power of two
NUM_STAGES = 1     # the software pipeline's depth: none
NUM_WARPS = 8
# Shared memory the pipeliner may use for its load buffers: it stages
# (num_stages - 1) tiles of every operand there (seen on the H100: k=8,
# fp32, BLOCK 4096, 3 stages asked for 262144 bytes of the 232448 a block
# may have), so a wide combine runs a shallower pipeline.
SMEM_BYTES = 224 * 1024


def stages_for(k: int, block: int, itemsize: int, num_stages: int = NUM_STAGES) -> int:
    """The pipeline depth a k-operand launch runs: ``num_stages``, cut to
    what fits the load buffers in ``SMEM_BYTES``."""
    fit = 1 + SMEM_BYTES // (k * block * itemsize)
    return max(1, min(num_stages, fit))


def _validate(xs, tile_rows: int) -> None:
    if len(xs) < 2:
        raise ValueError("the streaming combine needs >= 2 operands")
    if tile_rows < 1:
        raise ValueError(f"tile_rows must be >= 1, got {tile_rows}")
    x0 = xs[0]
    for x in xs[1:]:
        if x.shape != x0.shape or x.dtype != x0.dtype or x.device != x0.device:
            raise ValueError("operands must share shape, dtype and device")


@functools.lru_cache(maxsize=None)
def _kernel():
    """The jitted Triton kernel (built at first launch, on the card)."""
    import triton
    import triton.language as tl

    @triton.jit
    def combine_kernel(out_ptr, x0, x1, x2, x3, x4, x5, x6, x7, n_elems, n_tiles,
                       K: tl.constexpr, BLOCK: tl.constexpr,
                       NUM_STAGES: tl.constexpr):
        pid = tl.program_id(0)
        n_prog = tl.num_programs(0)
        for t in tl.range(pid, n_tiles, n_prog, num_stages=NUM_STAGES):
            offs = t.to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
            mask = offs < n_elems
            v = tl.load(x0 + offs, mask=mask)
            dt = v.dtype
            acc = v.to(tl.float32)
            acc = (acc + tl.load(x1 + offs, mask=mask).to(tl.float32)).to(dt).to(tl.float32)
            if K > 2:
                acc = (acc + tl.load(x2 + offs, mask=mask).to(tl.float32)).to(dt).to(tl.float32)
            if K > 3:
                acc = (acc + tl.load(x3 + offs, mask=mask).to(tl.float32)).to(dt).to(tl.float32)
            if K > 4:
                acc = (acc + tl.load(x4 + offs, mask=mask).to(tl.float32)).to(dt).to(tl.float32)
            if K > 5:
                acc = (acc + tl.load(x5 + offs, mask=mask).to(tl.float32)).to(dt).to(tl.float32)
            if K > 6:
                acc = (acc + tl.load(x6 + offs, mask=mask).to(tl.float32)).to(dt).to(tl.float32)
            if K > 7:
                acc = (acc + tl.load(x7 + offs, mask=mask).to(tl.float32)).to(dt).to(tl.float32)
            tl.store(out_ptr + offs, acc.to(dt), mask=mask)

    return combine_kernel


def _launch(xs, out: torch.Tensor, block: int = BLOCK, num_stages: int = NUM_STAGES,
            num_warps: int = NUM_WARPS, grid: int | None = None):
    """Launch the kernel: ``out = x0 + ... + x(k-1)``, operands and ``out``
    contiguous on one card, over ``grid`` programs (default: one a tile).
    ``bench/bench_pipe_sweep.py`` calls it with other knobs, and persistent
    grids, to set the module constants. Returns Triton's compiled kernel
    (its ``metadata.shared`` is a program's shared memory)."""
    if block < 16 or block & (block - 1):
        raise ValueError(f"BLOCK must be a power of two >= 16, got {block}")
    n = out.numel()
    n_tiles = -(-n // block)
    ptrs = list(xs) + [xs[0]] * (MAX_OPERANDS - len(xs))  # unused slots
    stages = stages_for(len(xs), block, out.element_size(), num_stages)
    with torch.cuda.device(out.device):
        return _kernel()[(grid or n_tiles,)](
            out, *ptrs, n, n_tiles, K=len(xs), BLOCK=block, NUM_STAGES=stages,
            num_warps=num_warps)


def hbm_combine_pipelined(*xs: torch.Tensor, tile_rows: int = 2048) -> torch.Tensor:
    """Elementwise sum of k same-shaped tensors (2 <= k <= 8 on the GPU)."""
    _validate(xs, tile_rows)
    x0 = xs[0]
    if x0.device.type == "cpu":
        return hbm_combine_plain(*xs, tile_rows=tile_rows)
    if x0.device.type != "cuda":
        raise ValueError(f"hbm_combine_pipelined runs on cuda or cpu, got {x0.device}")
    if x0.dtype not in DTYPE_CODES:
        raise ValueError(f"hbm_combine_pipelined kernel takes float32/bfloat16, "
                         f"got {x0.dtype}")
    if len(xs) > MAX_OPERANDS:
        raise ValueError(f"hbm_combine_pipelined kernel takes <= {MAX_OPERANDS} "
                         f"operands, got {len(xs)}")
    for x in xs:
        if not x.is_contiguous():
            raise ValueError("hbm_combine_pipelined kernel needs contiguous operands")
    out = torch.empty_like(x0)
    if x0.numel() == 0:
        return out
    _launch(xs, out)
    LAUNCHES["hbm_combine_pipelined"] += 1
    return out
