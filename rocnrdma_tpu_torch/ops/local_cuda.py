"""The streaming k-operand combine ``x0 + x1 + ... + x(k-1)`` (kernel
``ops/csrc/combine.cu``), counterpart of
``rocnrdma_tpu/ops/local_pallas.py::pallas_hbm_combine``.

``hbm_combine`` launches the CUDA kernel for CUDA tensors and runs
``hbm_combine_plain`` only for tensors on the CPU; on a CUDA tensor it
launches or raises. The fold goes left to right and, in bf16, rounds after
every add, exactly as ``hbm_combine_plain`` and the reference do.
``tile_rows`` and ``n_slots`` are the reference's knobs, kept so callers and
tests match; this first kernel does not stage tiles, so they are validated
and otherwise unused.
"""

from __future__ import annotations

import ctypes

import torch

from rocnrdma_tpu_torch.ops import _build

# launches of each kernel wrapper since the last reset (the only mutable
# module state of the port)
LAUNCHES = {"hbm_combine": 0}

MAX_OPERANDS = 8
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _validate(xs, tile_rows: int, n_slots: int) -> None:
    if len(xs) < 2:
        raise ValueError("the streaming combine needs >= 2 operands")
    if n_slots < 2:
        raise ValueError("n_slots must be >= 2 (single-buffer cannot "
                         "overlap load with combine)")
    if tile_rows < 1:
        raise ValueError(f"tile_rows must be >= 1, got {tile_rows}")
    x0 = xs[0]
    for x in xs[1:]:
        if x.shape != x0.shape or x.dtype != x0.dtype or x.device != x0.device:
            raise ValueError("operands must share shape, dtype and device")


def hbm_combine_plain(*xs: torch.Tensor, tile_rows: int = 2048,
                      n_slots: int = 2) -> torch.Tensor:
    """The plain PyTorch version: ``((x0 + x1) + x2) + ...`` in the
    operands' dtype, one rounding per add."""
    _validate(xs, tile_rows, n_slots)
    out = xs[0] + xs[1]
    for x in xs[2:]:
        out = out + x
    return out


def hbm_combine(*xs: torch.Tensor, tile_rows: int = 2048,
                n_slots: int = 2) -> torch.Tensor:
    """Elementwise sum of k same-shaped tensors (2 <= k <= 8 on the GPU)."""
    _validate(xs, tile_rows, n_slots)
    x0 = xs[0]
    if x0.device.type == "cpu":
        return hbm_combine_plain(*xs, tile_rows=tile_rows, n_slots=n_slots)
    if x0.device.type != "cuda":
        raise ValueError(f"hbm_combine runs on cuda or cpu, got {x0.device}")
    if x0.dtype not in DTYPE_CODES:
        raise ValueError(f"hbm_combine kernel takes float32/bfloat16, got {x0.dtype}")
    if len(xs) > MAX_OPERANDS:
        raise ValueError(f"hbm_combine kernel takes <= {MAX_OPERANDS} operands, "
                         f"got {len(xs)}")
    for x in xs:
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError("hbm_combine kernel needs contiguous, 16-byte "
                             "aligned operands")
    out = torch.empty_like(x0)
    if x0.numel() == 0:
        return out
    lib = _build.load("combine")
    ptrs = (ctypes.c_void_p * len(xs))(*(x.data_ptr() for x in xs))
    with torch.cuda.device(x0.device):
        stream = torch.cuda.current_stream(x0.device).cuda_stream
        rc = lib.rnr_combine(ctypes.cast(ptrs, ctypes.c_void_p), len(xs),
                             out.data_ptr(), x0.numel(), DTYPE_CODES[x0.dtype],
                             stream)
    _build.check(lib, "rnr_combine_error", rc, "combine kernel launch")
    LAUNCHES["hbm_combine"] += 1
    return out
