"""Ring allreduce (sum) through the hand-written kernel ``ops/csrc/ring.cu``.

Two wrappers over one kernel, counterparts of the two Pallas tiers in
``rocnrdma_tpu/ops/ring_pallas.py``:

- ``ring_allreduce(x)`` <- ``pallas_ring_allreduce``: out of place, each
  chunk one tile, chunks padded to 128 lanes as ``_pad_chunks`` pads them.
- ``hbm_ring_allreduce(x, tile_rows)`` <- ``pallas_hbm_ring_allreduce``:
  IN PLACE on ``x`` (the reference aliases its buffer,
  ``input_output_aliases={0: 0}``), chunks padded to whole
  ``tile_rows * 128`` tiles and walked in (step, tile) order.

``x`` is rank-major: row ``x[r]`` is rank r's buffer; in this slice every
rank lives on the tensor's one device. For a CUDA tensor a wrapper
launches the kernel or raises; only a CPU tensor takes the plain version.

The plain versions walk the kernel's hop schedule in lockstep over the
padded ``(n, chunks, per)`` tensor (per step every rank sends, then every
rank folds ``mine + recvd``), with the kernel's padding and fold order,
so the kernel equals them bit for bit in float32 and bfloat16. Walking
the tiles of a step together instead of one by one changes nothing: tiles
are disjoint, and each element sees the same folds in the same order.
"""

from __future__ import annotations

import ctypes

import torch

from rocnrdma_tpu_torch.ops import _build
from rocnrdma_tpu_torch.ops.local_cuda import DTYPE_CODES

# launches of each kernel wrapper since the last reset
LAUNCHES = {"ring_allreduce": 0, "hbm_ring_allreduce": 0}

LANES = 128
MAX_RANKS = 32
FLAG_WORDS = 8  # per lane and rank, as ring.cu's RNR_FLAG_WORDS


def _geometry(x: torch.Tensor, align: int) -> tuple[int, int, int]:
    """(n ranks, elements per rank, padded chunk elements)."""
    n = x.shape[0]
    size = x[0].numel() if n else 0
    per = -(-size // n) if n else 0
    return n, size, -(-per // align) * align


def _pad_chunks(x: torch.Tensor, align: int) -> torch.Tensor:
    """Rank-major x -> a fresh zero-padded (n, n, per) buffer."""
    n, size, per = _geometry(x, align)
    buf = x.new_zeros((n, n * per))
    buf[:, :size] = x.reshape(n, -1)
    return buf.reshape(n, n, per)


def _plain_walk(buf: torch.Tensor) -> torch.Tensor:
    """Run the ring on a padded (n, n, per) buffer, in place, in lockstep:
    n-1 accumulate hops, then n-1 overwrite hops."""
    n = buf.shape[0]
    r = torch.arange(n, device=buf.device)
    for s in range(n - 1):
        recvd = torch.roll(buf[r, (r - s) % n], 1, 0)  # rank r gets r-1's
        recv = (r - s - 1) % n
        buf[r, recv] = buf[r, recv] + recvd
    for s in range(n - 1):
        buf[r, (r - s) % n] = torch.roll(buf[r, (r + 1 - s) % n], 1, 0)
    return buf


def _unpad(buf: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    n, size, _ = _geometry(x, 1)
    return buf.reshape(n, -1)[:, :size].reshape(x.shape)


def ring_allreduce_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``ring_allreduce`` (out of place)."""
    if x.shape[0] == 1:
        return x.clone()
    return _unpad(_plain_walk(_pad_chunks(x, LANES)), x)


def hbm_ring_allreduce_plain(x: torch.Tensor, tile_rows: int = 64) -> torch.Tensor:
    """Plain PyTorch version of ``hbm_ring_allreduce``: writes the result
    into ``x`` and returns it."""
    if x.shape[0] > 1:
        x.copy_(_unpad(_plain_walk(_pad_chunks(x, tile_rows * LANES)), x))
    return x


def _check(x: torch.Tensor, what: str) -> bool:
    """Validate ``x``; True when it lies on the CPU (plain path)."""
    if x.dim() < 1:
        raise ValueError(f"{what}: x must be rank-major (n, ...), got a scalar")
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu, got {x.device}")
    if x.dtype not in DTYPE_CODES:
        raise ValueError(f"{what} kernel takes float32/bfloat16, got {x.dtype}")
    if x.shape[0] > MAX_RANKS:
        raise ValueError(f"{what} kernel takes <= {MAX_RANKS} ranks, got {x.shape[0]}")
    return False


def _direct(x: torch.Tensor, n: int, size: int, per: int) -> bool:
    """Can the kernel address ``x``'s storage as its (n, n*per) buffer?"""
    return x.is_contiguous() and size == n * per and x.data_ptr() % 16 == 0


def _launch(src: torch.Tensor | None, data: torch.Tensor, n: int, per: int,
            tile: int) -> None:
    """Run the kernel on ``data`` (n rows of n*per elements), copying ``src``
    in first when given."""
    lib = _build.load("ring")
    code = DTYPE_CODES[data.dtype]
    dev = data.device
    with torch.cuda.device(dev):
        lanes = lib.rnr_ring_lanes(n, tile, code)
        _build.check(lib, "rnr_ring_error", min(lanes, 0), "ring lane query")
        comm = torch.empty((n, 2 * tile), dtype=data.dtype, device=dev)
        flags = torch.empty((n, lanes * FLAG_WORDS), dtype=torch.int32, device=dev)

        def table(t):
            if t is None:
                return None
            base = t.data_ptr()
            stride = t.stride(0) * t.element_size()
            return (ctypes.c_void_p * n)(*(base + r * stride for r in range(n)))

        tabs = [table(src), table(data), table(comm), table(flags)]
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.rnr_ring_allreduce(
            *(None if t is None else ctypes.cast(t, ctypes.c_void_p) for t in tabs),
            n, per, tile, lanes, code, flags.data_ptr(),
            flags.numel() * flags.element_size(), stream)
    _build.check(lib, "rnr_ring_error", rc, "ring kernel launch (cooperative)")


def ring_allreduce(x: torch.Tensor) -> torch.Tensor:
    """Sum allreduce of rank-major ``x``; returns a new tensor (x unchanged)."""
    if _check(x, "ring_allreduce"):
        return ring_allreduce_plain(x)
    n, size, per = _geometry(x, LANES)
    if n == 1 or size == 0:
        return x.clone()
    src = (x.reshape(n, n * per) if _direct(x, n, size, per)
           else _pad_chunks(x, LANES).reshape(n, n * per))
    out = torch.empty((n, n * per), dtype=x.dtype, device=x.device)
    _launch(src, out, n, per, per)
    LAUNCHES["ring_allreduce"] += 1
    return _unpad(out, x)


def hbm_ring_allreduce(x: torch.Tensor, tile_rows: int = 64) -> torch.Tensor:
    """Sum allreduce of rank-major ``x`` IN PLACE: the result overwrites
    ``x``, which is returned. When ``x``'s size is not a whole number of
    tiles per chunk, the kernel runs on a padded copy that is then written
    back into ``x``."""
    if tile_rows < 1:
        raise ValueError(f"tile_rows must be >= 1, got {tile_rows}")
    if _check(x, "hbm_ring_allreduce"):
        return hbm_ring_allreduce_plain(x, tile_rows)
    tile = tile_rows * LANES
    n, size, per = _geometry(x, tile)
    if n == 1 or size == 0:
        return x
    if _direct(x, n, size, per):
        _launch(None, x.view(n, n * per), n, per, tile)
    else:
        buf = _pad_chunks(x, tile).reshape(n, n * per)
        _launch(None, buf, n, per, tile)
        x.copy_(_unpad(buf, x))
    LAUNCHES["hbm_ring_allreduce"] += 1
    return x
