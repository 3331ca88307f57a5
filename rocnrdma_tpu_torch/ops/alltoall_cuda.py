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

Across processes, one rank a process (a 1-D mesh that spans processes):
``alltoall_across`` and ``alltoallv_across`` take this process's row
``(1, n, c...)`` and the span and return its row of ``alltoall`` /
``alltoallv``, bit for bit. On a CUDA tensor one launch of the push kernel
across processes (``ops/push_cuda.py``, ``ops/csrc/push_across.cu``) reads
the chunks from ``x`` itself when its row is contiguous, 16-byte aligned
and of whole 128-element chunks, pushes chunk d into rank d's IPC
workspace output row (``ops/ipc.py``) and drains this rank's row into a
new tensor inside the launch. Any other row is staged into the workspace
input row first, and a padded result is sliced out after the kernel; both
copies are counted in ``STAGED_BYTES``. On a CPU tensor the plain version
across processes gathers every rank's row on the span's cross group and
keeps this process's row of ``alltoall_plain``.
"""

from __future__ import annotations

import functools

import torch

from rocnrdma_tpu_torch.collectives._exchange import cross_allgather
from rocnrdma_tpu_torch.collectives.alltoall import ragged_mask
from rocnrdma_tpu_torch.collectives.fused import alltoall_ranks
from rocnrdma_tpu_torch.ops import _build, push_cuda
from rocnrdma_tpu_torch.ops.local_cuda import DTYPE_CODES

# launches of the kernel wrappers since the last reset (alltoall_across: one
# rank's launch across processes)
LAUNCHES = {"alltoall": 0, "alltoall_across": 0}
# bytes alltoall_across copied into the workspace input row (staged a row
# that was not contiguous, aligned and of whole chunks) and out of the
# kernel's output after it (sliced a padded result), since the last reset
STAGED_BYTES = {"alltoall_across_in": 0, "alltoall_across_out": 0}

LANES = 128
MAX_RANKS = 32
FLAG_WORDS = 2  # per lane and rank, as alltoall.cu's RNR_A2A_FLAG_WORDS
KERNEL_CODE = 3  # the workspace header's kernel code of the alltoall


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


# ---------------------------------------------------------------------------
# Across processes, one rank a process (module docstring).


def _row_chunks(x: torch.Tensor, span) -> tuple[int, int, int]:
    """(n ranks, chunk elements, chunk elements padded to 128 lanes) of this
    process's row ``x`` (1, n, c...) of ``span``'s ranks."""
    n = span.size
    if x.dim() < 2 or tuple(x.shape[:2]) != (1, n):
        raise ValueError(f"alltoall across processes takes this process's row "
                         f"(1, {n}, ...), got shape {tuple(x.shape)}")
    per = x.numel() // n
    return n, per, -(-per // LANES) * LANES


def alltoall_across_plain(x: torch.Tensor, span) -> torch.Tensor:
    """Plain version of ``alltoall_across``."""
    _row_chunks(x, span)
    full = cross_allgather(x[0], span)
    return alltoall_plain(full)[span.index:span.index + 1]


def alltoall_across(x: torch.Tensor, span) -> torch.Tensor:
    """Alltoall across processes: ``x`` is this process's row (1, n, c...)
    of ``span``'s ranks, chunk d for rank d; returns a new (1, n, c...),
    chunk j what rank j sent this one."""
    n, per, padded = _row_chunks(x, span)
    if x.device.type == "cpu":
        return alltoall_across_plain(x, span)
    if x.device.type != "cuda":
        raise ValueError(f"alltoall runs on cuda or cpu, got {x.device}")
    if x.dtype not in DTYPE_CODES:
        raise ValueError(f"alltoall kernel takes float32/bfloat16, got {x.dtype}")
    if n > MAX_RANKS:
        raise ValueError(f"alltoall kernel takes <= {MAX_RANKS} ranks, got {n}")
    if n == 1 or per == 0:
        return x.clone()
    return _alltoall_across_kernel(x, span, n, per, padded)


def _alltoall_across_kernel(x: torch.Tensor, span, n: int, per: int,
                            padded: int) -> torch.Tensor:
    """``alltoall_across``'s launch of the push kernel on a validated row
    of n chunks of ``per`` elements, ``padded`` to 128."""
    isz, code = x.element_size(), DTYPE_CODES[x.dtype]
    pv = padded * isz // push_cuda.VEC
    geo = push_cuda.geometry_for(x.get_device(), n, pv, span.per_card)
    ws = span.workspace(x.device)
    direct = per == padded and x.is_contiguous() and x.data_ptr() % push_cuda.VEC == 0
    inp, _ = ws.rows(x.dtype, 0 if direct else n * padded, n * padded,
                     (KERNEL_CODE, code, padded, geo.lanes))
    if direct:
        src = x
    else:  # the pad of a chunk lands in the pad of its receiver's chunk, never read
        src = inp
        inp.view(n, padded)[:, :per].copy_(x.reshape(n, per))
        STAGED_BYTES["alltoall_across_in"] += n * per * isz
    out = torch.empty((n, padded), dtype=x.dtype, device=x.device)
    push_cuda.launch(ws, geo, src, pv, out, pv)
    if per == padded:
        res = out.view(x.shape)
    else:
        res = out[:, :per].reshape(x.shape)
        STAGED_BYTES["alltoall_across_out"] += n * per * isz
    ws.finish()
    LAUNCHES["alltoall_across"] += 1
    return res


def alltoallv_across(x: torch.Tensor, counts, span) -> tuple[torch.Tensor, torch.Tensor]:
    """``alltoallv`` across processes: ``alltoall_across`` of this process's
    row (1, n, max_count, ...), then its receiver-side mask; returns ``(out,
    recv_counts)``, each this process's row."""
    return ragged_mask(alltoall_across(x, span), counts, span=span)
