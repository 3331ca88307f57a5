"""The ring collectives (sum) through the hand-written kernel
``ops/csrc/ring.cu``: one kernel, three modes, four wrappers, counterparts
of the Pallas ring kernels in ``rocnrdma_tpu/ops/ring_pallas.py``:

- ``ring_allreduce(x)`` <- ``pallas_ring_allreduce``: out of place, each
  chunk one tile, chunks padded to 128 lanes as ``_pad_chunks`` pads them.
- ``hbm_ring_allreduce(x, tile_rows)`` <- ``pallas_hbm_ring_allreduce``:
  IN PLACE on ``x`` (the reference aliases its buffer,
  ``input_output_aliases={0: 0}``), chunks padded to whole
  ``tile_rows * 128`` tiles and walked in (step, tile) order.
- ``ring_reduce_scatter(x, tile_rows)`` <- ``pallas_ring_reduce_scatter``:
  out of place, ``(n, S)`` -> ``(n, S/n)``, rank r keeps chunk r. Like the
  reference it needs ``S % (n*128) == 0``, so the chunks are the semantic
  1/n splits.
- ``ring_allgather(x, tile_rows)`` <- ``pallas_ring_allgather``: ``(n, c)``
  -> ``(n, n*c)``, each rank's chunk padded to 128 lanes and the output
  unpadded per chunk.

``tile_rows=None`` runs one tile per chunk; otherwise chunks are cut into
``tile_rows * 128``-element tiles, a chunk padded at its end to whole
tiles. The kernel's tile loop is the same in every mode.

``x`` is rank-major: row ``x[r]`` is rank r's buffer; in this slice every
rank lives on the tensor's one device. For a CUDA tensor a wrapper
launches the kernel or raises; only a CPU tensor takes the plain version.

The plain versions walk the kernel's hop schedule in lockstep over the
padded ``(n, chunks, per)`` tensor (per step every rank sends, then every
rank folds ``mine + recvd`` or overwrites), with the kernel's padding and
fold order, so the kernel equals them bit for bit in float32 and bfloat16.
Walking the tiles of a step together instead of one by one changes
nothing: tiles are disjoint, and each element sees the same folds in the
same order.
"""

from __future__ import annotations

import torch

from rocnrdma_tpu_torch.ops import _build
from rocnrdma_tpu_torch.ops.local_cuda import DTYPE_CODES

# launches of each kernel wrapper since the last reset
LAUNCHES = {"ring_allreduce": 0, "hbm_ring_allreduce": 0,
            "ring_reduce_scatter": 0, "ring_allgather": 0}

LANES = 128
MAX_RANKS = 32
FLAG_WORDS = 8  # per lane and rank, as ring.cu's RNR_FLAG_WORDS
MODE_AR, MODE_RS, MODE_AG = 0, 1, 2  # ring.cu's RNR_MODE_*


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


def _tiles(per: int, tile_rows: int | None) -> tuple[int, int]:
    """(tile elements, chunk elements padded to whole tiles) for a chunk of
    ``per`` elements: one 128-lane-padded tile when ``tile_rows`` is None."""
    if tile_rows is None:
        padded = -(-per // LANES) * LANES
        return padded, padded
    if tile_rows < 1:
        raise ValueError(f"tile_rows must be >= 1, got {tile_rows}")
    tile = tile_rows * LANES
    return tile, -(-per // tile) * tile


def _rs_chunk(x: torch.Tensor) -> int:
    """Chunk elements of a reduce-scatter of ``x``; raises the reference's
    error when the rank buffer is not a whole number of 128-lane chunks."""
    n, size = x.shape[0], x[0].numel()
    if size % (n * LANES):
        raise ValueError(
            f"ring reduce_scatter needs size % (n*128) == 0, got size={size}, "
            f"n={n} (pad at the caller)")
    return size // n


def ring_reduce_scatter_plain(x: torch.Tensor,
                              tile_rows: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of ``ring_reduce_scatter``: the -1-shifted
    reduce phase, n-1 accumulate hops with send ``(r-s-1)``, recv
    ``(r-s-2)``, in lockstep; returns ``(n, S/n)``, row r chunk r."""
    n = x.shape[0]
    if n == 1:
        return x.reshape(1, -1).clone()
    per = _rs_chunk(x)
    _tiles(per, tile_rows)  # validates tile_rows; the padding changes no bit
    buf = x.reshape(n, n, per).clone()
    r = torch.arange(n, device=buf.device)
    for s in range(n - 1):
        recvd = torch.roll(buf[r, (r - s - 1) % n], 1, 0)  # rank r gets r-1's
        recv = (r - s - 2) % n
        buf[r, recv] = buf[r, recv] + recvd
    return buf[r, r]


def ring_allgather_plain(x: torch.Tensor,
                         tile_rows: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of ``ring_allgather``: chunk r of rank r is its
    own padded buffer, then n-1 overwrite hops with send ``(r-s)``, recv
    ``(r-s-1)``, in lockstep; returns ``(n, n*c)``, unpadded per chunk."""
    n = x.shape[0]
    flat = x.reshape(n, -1)
    c = flat.shape[1]
    if n == 1:
        return flat.clone()
    _, per = _tiles(c, tile_rows)
    buf = flat.new_zeros((n, n, per))
    r = torch.arange(n, device=buf.device)
    buf[r, r, :c] = flat
    for s in range(n - 1):
        buf[r, (r - s - 1) % n] = torch.roll(buf[r, (r - s) % n], 1, 0)
    return buf[:, :, :c].reshape(n, n * c)


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


def _aligned(x: torch.Tensor, row_elems: int) -> bool:
    """Can the kernel address ``x``'s storage as rows of ``row_elems``?"""
    return (x.is_contiguous() and x[0].numel() == row_elems
            and x.data_ptr() % 16 == 0)


def _launch(src: torch.Tensor | None, data: torch.Tensor, n: int, per: int,
            tile: int, mode: int = MODE_AR) -> None:
    """Run the kernel in ``mode`` on ``data`` (n rows of n*per elements),
    copying ``src`` in first when given."""
    lib = _build.load("ring")
    code = DTYPE_CODES[data.dtype]
    dev = data.device
    with torch.cuda.device(dev):
        lanes = lib.rnr_ring_lanes(n, tile, code)
        _build.check(lib, "rnr_ring_error", min(lanes, 0), "ring lane query")
        comm = torch.empty((n, 2 * tile), dtype=data.dtype, device=dev)
        flags = torch.empty((n, lanes * FLAG_WORDS), dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.rnr_ring(
            *(None if t is None else _build.row_pointers(t, n)
              for t in (src, data, comm, flags)),
            n, per, tile, lanes, code, mode, flags.data_ptr(),
            flags.numel() * flags.element_size(), stream)
    _build.check(lib, "rnr_ring_error", rc, "ring kernel launch (cooperative)")


def ring_allreduce(x: torch.Tensor) -> torch.Tensor:
    """Sum allreduce of rank-major ``x``; returns a new tensor (x unchanged)."""
    if _check(x, "ring_allreduce"):
        return ring_allreduce_plain(x)
    n, size, per = _geometry(x, LANES)
    if n == 1 or size == 0:
        return x.clone()
    src = (x.reshape(n, n * per) if _aligned(x, n * per)
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
    if _aligned(x, n * per):
        _launch(None, x.view(n, n * per), n, per, tile)
    else:
        buf = _pad_chunks(x, tile).reshape(n, n * per)
        _launch(None, buf, n, per, tile)
        x.copy_(_unpad(buf, x))
    LAUNCHES["hbm_ring_allreduce"] += 1
    return x


def ring_reduce_scatter(x: torch.Tensor, tile_rows: int | None = None) -> torch.Tensor:
    """Sum reduce-scatter of rank-major ``x`` (n, S), out of place: returns
    ``(n, S/n)``, row r the summed chunk r. ``S`` must be a multiple of
    ``n*128``."""
    if _check(x, "ring_reduce_scatter"):
        return ring_reduce_scatter_plain(x, tile_rows)
    n = x.shape[0]
    if n == 1:
        return x.reshape(1, -1).clone()
    per = _rs_chunk(x)
    tile, padded = _tiles(per, tile_rows)
    if padded == per and _aligned(x, n * per):
        src = x.reshape(n, n * per)
    else:  # pad each chunk at its end to whole tiles
        src = x.new_zeros((n, n, padded))
        src[:, :, :per] = x.reshape(n, n, per)
        src = src.reshape(n, n * padded)
    data = torch.empty((n, n * padded), dtype=x.dtype, device=x.device)
    _launch(src, data, n, padded, tile, MODE_RS)
    LAUNCHES["ring_reduce_scatter"] += 1
    r = torch.arange(n, device=x.device)
    return data.view(n, n, padded)[r, r, :per]


def ring_allgather(x: torch.Tensor, tile_rows: int | None = None) -> torch.Tensor:
    """Allgather of rank-major ``x`` (n, c...): returns ``(n, n*c)``, every
    row the concatenation of all rank buffers."""
    if _check(x, "ring_allgather"):
        return ring_allgather_plain(x, tile_rows)
    n = x.shape[0]
    c = x[0].numel()
    if n == 1 or c == 0:
        return x.reshape(n, -1).clone()
    tile, padded = _tiles(c, tile_rows)
    if _aligned(x, padded):
        src = x.reshape(n, padded)
    else:  # pad each rank's chunk to whole tiles
        src = x.new_zeros((n, padded))
        src[:, :c] = x.reshape(n, c)
    data = torch.empty((n, n * padded), dtype=x.dtype, device=x.device)
    _launch(src, data, n, padded, tile, MODE_AG)
    LAUNCHES["ring_allgather"] += 1
    return data.view(n, n, padded)[:, :, :c].reshape(n, n * c)
