"""The direct alltoall through the hand-written kernel
``ops/csrc/alltoall.cu``, counterpart of
``rocnrdma_tpu/ops/ring_pallas.py::pallas_alltoall``; ``alltoallv`` is it
plus the receiver-side mask, as ``pallas_alltoallv`` is.

``x`` is rank-major ``(n, n, c...)``: ``x[r, d]`` is rank r's chunk for
rank d. The output has the same shape, ``out[r, j]`` = what rank j sent
rank r. Each chunk is padded row-wise to 128 lanes (``ring_pallas.py``
pads it so for the same reason: padding the flattened whole would shift
chunk boundaries off the row boundaries); an aligned, contiguous input is
addressed directly, with no copy. For a CUDA tensor ``alltoall`` launches
the kernel or raises; only a CPU tensor takes ``alltoall_plain``, the
padded transpose. The kernel only copies, so it equals the plain version
bit for bit in every dtype.

The host path of a launch allocates only the output: lanes are cached per
shape, and the epoch-counted flags per (device, stream, n, lanes), as
``ring_cuda`` caches them; the C entry point builds the per-rank pointer
tables from each tensor's base and row stride.
"""

from __future__ import annotations

import functools

import torch

from rocnrdma_tpu_torch.collectives.alltoall import ragged_mask
from rocnrdma_tpu_torch.collectives.fused import alltoall_ranks
from rocnrdma_tpu_torch.ops import _build
from rocnrdma_tpu_torch.ops.local_cuda import DTYPE_CODES

# launches of the kernel wrapper since the last reset
LAUNCHES = {"alltoall": 0}

LANES = 128
MAX_RANKS = 32
FLAG_WORDS = 2  # per lane and rank, as alltoall.cu's RNR_A2A_FLAG_WORDS


def _rows(x: torch.Tensor) -> tuple[int, int, int]:
    """(n ranks, chunk elements, chunk elements padded to 128 lanes)."""
    n = alltoall_ranks(x)
    per = x.numel() // (n * n) if n else 0
    return n, per, -(-per // LANES) * LANES


def alltoall_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``alltoall``: pad each chunk to 128 lanes,
    transpose the rank and chunk axes, unpad."""
    n, per, padded = _rows(x)
    buf = x.new_zeros((n, n, padded))
    buf[:, :, :per] = x.reshape(n, n, per)
    return buf.transpose(0, 1)[:, :, :per].reshape(x.shape)


@functools.lru_cache(maxsize=256)
def _lanes(device: int, n: int, per: int, code: int) -> int:
    """The kernel's lanes per rank for n ranks of ``per``-element chunks,
    from one occupancy query per shape."""
    lib = _build.load("alltoall")
    lanes = lib.rnr_a2a_lanes(n, per, code, device)
    _build.check(lib, "rnr_a2a_error", min(lanes, 0), "alltoall lane query")
    return lanes


# (device, stream, n, lanes) -> [flag words (n, lanes * FLAG_WORDS),
# launches so far]. The kernel's flags are epoch-counted: zeroed once here,
# never reset, each launch on the stream waits for its own epoch's counts.
_FLAGS: dict[tuple, list] = {}


def _flags(device: torch.device, stream: int, n: int, lanes: int) -> list:
    key = (device, stream, n, lanes)
    entry = _FLAGS.get(key)
    if entry is None:
        words = torch.zeros((n, lanes * FLAG_WORDS), dtype=torch.int32, device=device)
        entry = _FLAGS[key] = [words, 0]
    return entry


def _launch(src: torch.Tensor, out: torch.Tensor, n: int, per: int,
            sync: bool = True) -> None:
    """Run the kernel from the n rows of ``src`` into the n rows of ``out``
    (each n chunks of ``per`` elements, 16-byte aligned). ``sync=False``
    skips the barrier and the arrivals: only for timing the data pass
    alone. A launch that raises leaves the epoch where it was."""
    lib = _build.load("alltoall")
    code = DTYPE_CODES[out.dtype]
    device = out.device
    lanes = _lanes(device.index, n, per, code)
    # the raw handle: torch.cuda.current_stream() builds a Stream object
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    flags = _flags(device, stream, n, lanes)
    words, isz = flags[0], out.element_size()
    epoch = flags[1] + 1 if sync else flags[1]
    rc = lib.rnr_alltoall_rows(
        src.data_ptr(), src.stride(0) * isz, out.data_ptr(), out.stride(0) * isz,
        words.data_ptr(), words.stride(0) * 4, n, per, lanes, code,
        epoch & 0xFFFFFFFF, int(sync), device.index, stream)
    _build.check(lib, "rnr_a2a_error", rc, "alltoall kernel launch (cooperative)")
    flags[1] = epoch


def alltoall(x: torch.Tensor) -> torch.Tensor:
    """Alltoall of rank-major ``x`` (n, n, c...); returns a new tensor."""
    n, per, padded = _rows(x)
    if x.device.type == "cpu":
        return alltoall_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"alltoall runs on cuda or cpu, got {x.device}")
    if x.dtype not in DTYPE_CODES:
        raise ValueError(f"alltoall kernel takes float32/bfloat16, got {x.dtype}")
    if n > MAX_RANKS:
        raise ValueError(f"alltoall kernel takes <= {MAX_RANKS} ranks, got {n}")
    if n == 1 or per == 0:
        return x.clone()
    if x.is_contiguous() and per == padded and x.data_ptr() % 16 == 0:
        src = x.reshape(n, n * per)
    else:
        src = x.new_zeros((n, n, padded))
        src[:, :, :per] = x.reshape(n, n, per)
        src = src.reshape(n, n * padded)
    out = torch.empty((n, n * padded), dtype=x.dtype, device=x.device)
    _launch(src, out, n, padded)
    LAUNCHES["alltoall"] += 1
    if per == padded:
        return out.view(x.shape)
    return out.view(n, n, padded)[:, :, :per].reshape(x.shape)


def alltoallv(x: torch.Tensor, counts) -> tuple[torch.Tensor, torch.Tensor]:
    """Ragged alltoall: ``alltoall`` over the full static capacity, then the
    receiver masks each chunk to its count (``ragged_mask``). ``x``:
    (n, n, max_count, ...); ``counts``: the (n, n) matrix, ``counts[r, d]``
    valid rows from rank r for rank d. Returns ``(out, recv_counts)``."""
    return ragged_mask(alltoall(x), counts)
