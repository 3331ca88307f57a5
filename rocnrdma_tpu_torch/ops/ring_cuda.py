"""The ring collectives (sum) through the hand-written kernel
``ops/csrc/ring.cu``: one kernel, three modes, four wrappers, counterparts
of the Pallas ring kernels in ``rocnrdma_tpu/ops/ring_pallas.py``:

- ``ring_allreduce(x)`` <- ``pallas_ring_allreduce``: out of place, chunks
  padded to 128 lanes as ``_pad_chunks`` pads them.
- ``hbm_ring_allreduce(x, tile_rows)`` <- ``pallas_hbm_ring_allreduce``:
  IN PLACE on ``x`` (the reference aliases its buffer,
  ``input_output_aliases={0: 0}``), chunks padded to whole
  ``tile_rows * 128`` tiles.
- ``ring_reduce_scatter(x, tile_rows)`` <- ``pallas_ring_reduce_scatter``:
  out of place, ``(n, S)`` -> ``(n, S/n)``, rank r keeps chunk r. Like the
  reference it needs ``S % (n*128) == 0``, so the chunks are the semantic
  1/n splits.
- ``ring_allgather(x, tile_rows)`` <- ``pallas_ring_allgather``: ``(n, c)``
  -> ``(n, n*c)``, every row the concatenation.

``x`` is rank-major: row ``x[r]`` is rank r's buffer, every rank on the
tensor's one device. For a CUDA tensor a wrapper launches the kernel or
raises; only a CPU tensor takes the plain version.

Across processes, one rank a process (a 1-D mesh that spans processes,
``runtime.mesh.ProcessSpan``): ``ring_allreduce_across``,
``hbm_ring_allreduce_across`` (and ``_tiled_allreduce_across``),
``ring_reduce_scatter_across`` and ``ring_allgather_across`` take this
process's row ``(1, ...)`` and the span, and return this process's row of
the one-process wrapper's result, bit for bit: the chunk geometry comes
from the span's n, so padding, chunk ownership and fold order are the one
process's. On a CUDA tensor each copies the row into this process's IPC
workspace (``ops/ipc.py``), launches its rank's blocks of the same kernel
at ``kSys`` with every rank's rows and flags mapped from CUDA IPC handles,
and copies its row of the result out. Each has a plain version across
processes for a CPU tensor: every rank's row gathered on the span's cross
group, the one-process plain version, this process's row.

The TPU ring relays chunk c around the ring, each hop adding one rank's
value to the running sum, starting at rank c (allreduce) or rank c+1
(reduce-scatter): ``acc = x[c]; acc = x[c+k] + acc`` for k = 1..n-1, ranks
mod n. The kernel and the plain versions fold the n rows of every chunk
directly in that order, so both equal the Pallas kernels bit for bit in
float32 and bfloat16. The allreduce's padding is its chunk geometry: it
decides which chunk an element lies in, and so its fold order. In
reduce-scatter and allgather tiles would only pad a chunk at its end,
which moves no element to another chunk, so there ``tile_rows`` is
validated and changes nothing.
"""

from __future__ import annotations

import functools

import torch

from rocnrdma_tpu_torch.collectives._exchange import cross_allgather
from rocnrdma_tpu_torch.ops import _build
from rocnrdma_tpu_torch.ops.local_cuda import DTYPE_CODES

# launches of each kernel wrapper since the last reset; the *_across ones
# are one rank's launch across processes
LAUNCHES = {"ring_allreduce": 0, "hbm_ring_allreduce": 0,
            "ring_reduce_scatter": 0, "ring_allgather": 0,
            "ring_allreduce_across": 0, "hbm_ring_allreduce_across": 0,
            "ring_reduce_scatter_across": 0, "ring_allgather_across": 0}

LANES = 128
MAX_RANKS = 32
FLAG_WORDS = 2  # per lane and rank, as ring.cu's RNR_FLAG_WORDS
MODE_AR, MODE_RS, MODE_AG = 0, 1, 2  # ring.cu's RNR_MODE_*


def _geometry(x: torch.Tensor, align: int, n: int | None = None) -> tuple[int, int, int]:
    """(n ranks, elements per rank, padded chunk elements); ``n`` defaults
    to ``x``'s rows (across processes it is the span's, ``x`` one row)."""
    rows = x.shape[0]
    n = rows if n is None else n
    size = x.numel() // rows if rows else 0
    per = -(-size // n) if n else 0
    return n, size, -(-per // align) * align


def _pad_chunks(x: torch.Tensor, align: int) -> torch.Tensor:
    """Rank-major x -> a fresh zero-padded (n, n, per) buffer."""
    n, size, per = _geometry(x, align)
    buf = x.new_zeros((n, n * per))
    buf[:, :size] = x.reshape(n, -1)
    return buf.reshape(n, n, per)


def _fold_chunks(buf: torch.Tensor, first: int) -> torch.Tensor:
    """Sum a rank-major ``(n, n, per)`` buffer chunk by chunk in the ring's
    order: chunk c is ``acc = buf[c+first, c]``, then
    ``acc = buf[c+first+k, c] + acc`` for k = 1..n-1 (ranks mod n). Returns
    ``(n, per)``, row c the sum of chunk c."""
    n = buf.shape[0]
    c = torch.arange(n, device=buf.device)
    acc = buf[(c + first) % n, c]
    for k in range(1, n):
        acc = buf[(c + first + k) % n, c] + acc
    return acc


def _unpad(buf: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    if buf.numel() == x.numel():
        return buf.view(x.shape)
    n, size, _ = _geometry(x, 1)
    return buf.reshape(n, -1)[:, :size].reshape(x.shape)


def _allreduce_plain(x: torch.Tensor, align: int) -> torch.Tensor:
    """The allreduce of rank-major ``x`` with chunks padded to ``align``,
    out of place."""
    n, size, _ = _geometry(x, align)
    if n == 1:
        return x.clone()
    row = _fold_chunks(_pad_chunks(x, align), 0).reshape(-1)[:size]
    return row.expand(n, size).reshape(x.shape).contiguous()


def ring_allreduce_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``ring_allreduce`` (out of place)."""
    return _allreduce_plain(x, LANES)


def hbm_ring_allreduce_plain(x: torch.Tensor, tile_rows: int = 64) -> torch.Tensor:
    """Plain PyTorch version of ``hbm_ring_allreduce``: writes the result
    into ``x`` and returns it."""
    if x.shape[0] > 1:
        x.copy_(_allreduce_plain(x, tile_rows * LANES))
    return x


def _check_tile_rows(tile_rows: int | None) -> None:
    """Raise unless ``tile_rows`` is None (one tile a chunk) or >= 1."""
    if tile_rows is not None and tile_rows < 1:
        raise ValueError(f"tile_rows must be >= 1, got {tile_rows}")


def _rs_chunk(x: torch.Tensor, n: int | None = None) -> int:
    """Chunk elements of a reduce-scatter of ``x`` over ``n`` ranks
    (default: its rows); raises the reference's error when the rank buffer
    is not a whole number of 128-lane chunks."""
    n, size = x.shape[0] if n is None else n, x[0].numel()
    if size % (n * LANES):
        raise ValueError(
            f"ring reduce_scatter needs size % (n*128) == 0, got size={size}, "
            f"n={n} (pad at the caller)")
    return size // n


def ring_reduce_scatter_plain(x: torch.Tensor,
                              tile_rows: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of ``ring_reduce_scatter``: chunk r folded from
    rank r+1 in ring order; returns ``(n, S/n)``, row r chunk r."""
    n = x.shape[0]
    if n == 1:
        return x.reshape(1, -1).clone()
    per = _rs_chunk(x)
    _check_tile_rows(tile_rows)
    return _fold_chunks(x.reshape(n, n, per), 1)


def ring_allgather_plain(x: torch.Tensor,
                         tile_rows: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of ``ring_allgather``: returns ``(n, n*c)``,
    every row the concatenation of the ranks' buffers."""
    n = x.shape[0]
    flat = x.reshape(n, -1)
    if n == 1:
        return flat.clone()
    _check_tile_rows(tile_rows)
    return flat.reshape(1, -1).expand(n, -1).contiguous()


def _check(x: torch.Tensor, what: str) -> bool:
    """Validate ``x``; True when it lies on the CPU (plain path)."""
    if x.dim() < 1:
        raise ValueError(f"{what}: x must be rank-major (n, ...), got a scalar")
    if not x.is_cuda:
        if x.device.type == "cpu":
            return True
        raise ValueError(f"{what} runs on cuda or cpu, got {x.device}")
    if x.dtype not in DTYPE_CODES:
        raise ValueError(f"{what} kernel takes float32/bfloat16, got {x.dtype}")
    if x.shape[0] > MAX_RANKS:
        raise ValueError(f"{what} kernel takes <= {MAX_RANKS} ranks, got {x.shape[0]}")
    return False


def _aligned(x: torch.Tensor, row_elems: int) -> bool:
    """Can the kernel address ``x``'s storage as rows of ``row_elems``?"""
    return (x.is_contiguous() and x.numel() == x.shape[0] * row_elems
            and x.data_ptr() % 16 == 0)


@functools.lru_cache(maxsize=256)
def _lanes(device: int, n: int, per: int, code: int) -> int:
    """The kernel's lanes per rank for n ranks of ``per``-element chunks,
    from one occupancy query per shape."""
    lib = _build.load("ring")
    with torch.cuda.device(device):
        lanes = lib.rnr_ring_lanes(n, per, code)
    _build.check(lib, "rnr_ring_error", min(lanes, 0), "ring lane query")
    return lanes


# (device, stream, n, lanes) -> [flag words (n, lanes * FLAG_WORDS), their
# row pointer table, launches so far]. The kernel's flags are epoch-counted:
# zeroed once here, never reset, each launch on the stream waits for its
# own epoch's counts.
_FLAGS: dict[tuple, list] = {}


def _flags(device: int, stream: int, n: int, lanes: int) -> list:
    key = (device, stream, n, lanes)
    entry = _FLAGS.get(key)
    if entry is None:
        words = torch.zeros((n, lanes * FLAG_WORDS), dtype=torch.int32, device=device)
        entry = _FLAGS[key] = [words, _build.row_pointers(words, n), 0]
    return entry


def _launch(src: torch.Tensor, dst: torch.Tensor, n: int, per: int, mode: int,
            sync: bool = True) -> None:
    """Run the kernel in ``mode`` from the n rows of ``src`` into the n rows
    of ``dst`` (the same rows: in place), chunks of ``per`` elements.
    ``sync=False`` skips the barrier and the arrivals: only for timing the
    data pass alone."""
    lib = _build.load("ring")
    code = DTYPE_CODES[dst.dtype]
    device = dst.get_device()
    lanes = _lanes(device, n, per, code)
    # the raw handle: torch.cuda.current_stream() builds a Stream object,
    # several microseconds a call on the host
    stream = torch._C._cuda_getCurrentRawStream(device)
    flags = _flags(device, stream, n, lanes)
    epoch = flags[2] + 1 if sync else flags[2]
    rc = lib.rnr_ring(_build.row_pointers(src, n), _build.row_pointers(dst, n),
                      flags[1], n, per, lanes, code, mode, epoch & 0xFFFFFFFF,
                      int(sync), device, stream)
    _build.check(lib, "rnr_ring_error", rc, "ring kernel launch (cooperative)")
    flags[2] = epoch


def _allreduce(x: torch.Tensor, align: int, counter: str) -> torch.Tensor:
    """The kernel's allreduce of CUDA ``x`` with chunks padded to
    ``align``, out of place; counts one launch of ``counter``."""
    n, size, per = _geometry(x, align)
    if n == 1 or size == 0:
        return x.clone()
    if _aligned(x, n * per):
        out = torch.empty_like(x)
        _launch(x, out, n, per, MODE_AR)
    else:  # reduce a padded copy in place
        out = _pad_chunks(x, align).reshape(n, n * per)
        _launch(out, out, n, per, MODE_AR)
    LAUNCHES[counter] += 1
    return _unpad(out, x)


def ring_allreduce(x: torch.Tensor) -> torch.Tensor:
    """Sum allreduce of rank-major ``x``; returns a new tensor (x unchanged)."""
    if _check(x, "ring_allreduce"):
        return ring_allreduce_plain(x)
    return _allreduce(x, LANES, "ring_allreduce")


def hbm_ring_allreduce(x: torch.Tensor, tile_rows: int = 64) -> torch.Tensor:
    """Sum allreduce of rank-major ``x`` IN PLACE: the result overwrites
    ``x``, which is returned. When ``x``'s size is not a whole number of
    tiles per chunk, the kernel runs on a padded copy that is then written
    back into ``x``."""
    _check_tile_rows(tile_rows)
    if _check(x, "hbm_ring_allreduce"):
        return hbm_ring_allreduce_plain(x, tile_rows)
    tile = tile_rows * LANES
    n, size, per = _geometry(x, tile)
    if n == 1 or size == 0:
        return x
    if _aligned(x, n * per):
        _launch(x, x, n, per, MODE_AR)
        LAUNCHES["hbm_ring_allreduce"] += 1
    else:
        x.copy_(_allreduce(x, tile, "hbm_ring_allreduce"))
    return x


def _tiled_allreduce(x: torch.Tensor, tile_rows: int) -> torch.Tensor:
    """``hbm_ring_allreduce``'s result, out of place: ``x`` is left as it
    is. The ``cuda_ring`` arm's tiled tier, counted as
    ``hbm_ring_allreduce``."""
    _check_tile_rows(tile_rows)
    if _check(x, "hbm_ring_allreduce"):
        return _allreduce_plain(x, tile_rows * LANES)
    return _allreduce(x, tile_rows * LANES, "hbm_ring_allreduce")


def _contiguous_rows(x: torch.Tensor, n: int, row: int) -> torch.Tensor:
    """``x`` as n 16-byte-aligned contiguous rows of ``row`` elements,
    copied only when it is not already."""
    rows = x.reshape(n, row)
    return rows if _aligned(rows, row) else rows.clone(memory_format=torch.contiguous_format)


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
    _check_tile_rows(tile_rows)
    out = torch.empty((n, per), dtype=x.dtype, device=x.device)
    _launch(_contiguous_rows(x, n, n * per), out, n, per, MODE_RS)
    LAUNCHES["ring_reduce_scatter"] += 1
    return out


def ring_allgather(x: torch.Tensor, tile_rows: int | None = None) -> torch.Tensor:
    """Allgather of rank-major ``x`` (n, c...): returns ``(n, n*c)``, every
    row the concatenation of all rank buffers."""
    if _check(x, "ring_allgather"):
        return ring_allgather_plain(x, tile_rows)
    n = x.shape[0]
    c = x[0].numel()
    if n == 1 or c == 0:
        return x.reshape(n, -1).clone()
    _check_tile_rows(tile_rows)
    vec = 16 // x.element_size()
    per = -(-c // vec) * vec  # chunks start 16-byte aligned
    if per == c:
        src = _contiguous_rows(x, n, c)
    else:
        src = x.new_zeros((n, per))
        src[:, :c] = x.reshape(n, c)
    out = torch.empty((n, n * per), dtype=x.dtype, device=x.device)
    _launch(src, out, n, per, MODE_AG)
    LAUNCHES["ring_allgather"] += 1
    return out if per == c else out.view(n, n, per)[:, :, :c].reshape(n, n * c)


# ---------------------------------------------------------------------------
# Across processes, one rank a process (module docstring).


def _check_row(x: torch.Tensor, span, what: str) -> bool:
    """Validate this process's row ``x`` of ``span``'s ranks; True when it
    lies on the CPU (the plain version across processes)."""
    if x.dim() < 1 or x.shape[0] != 1:
        raise ValueError(f"{what}: x must be this process's row (1, ...), got "
                         f"shape {tuple(x.shape)}")
    if span.size > MAX_RANKS:
        raise ValueError(f"{what} kernel takes <= {MAX_RANKS} ranks, got {span.size}")
    return _check(x, what)


def _gathered(x: torch.Tensor, span) -> torch.Tensor:
    """Every rank's row, rank-major ``(n, ...)``: one all-gather on the
    span's cross group."""
    return cross_allgather(x[0], span)


def _mine(out: torch.Tensor, span) -> torch.Tensor:
    return out[span.index:span.index + 1]


def ring_allreduce_across_plain(x: torch.Tensor, span) -> torch.Tensor:
    """Plain version of ``ring_allreduce_across``."""
    return _mine(ring_allreduce_plain(_gathered(x, span)), span)


def _tiled_allreduce_across_plain(x: torch.Tensor, span, tile_rows: int) -> torch.Tensor:
    """Plain version of ``_tiled_allreduce_across`` (out of place)."""
    return _mine(_allreduce_plain(_gathered(x, span), tile_rows * LANES), span)


def ring_reduce_scatter_across_plain(x: torch.Tensor, span,
                                     tile_rows: int | None = None) -> torch.Tensor:
    """Plain version of ``ring_reduce_scatter_across``."""
    if span.size > 1:  # refused before any exchange, as by the kernel's wrapper
        _rs_chunk(x, span.size)
    return _mine(ring_reduce_scatter_plain(_gathered(x, span), tile_rows), span)


def ring_allgather_across_plain(x: torch.Tensor, span,
                                tile_rows: int | None = None) -> torch.Tensor:
    """Plain version of ``ring_allgather_across``."""
    return _mine(ring_allgather_plain(_gathered(x, span), tile_rows), span)


@functools.lru_cache(maxsize=256)
def _lanes_across(device: int, n: int, per: int, code: int) -> int:
    """The across launch's lanes for n ranks of ``per``-element chunks: the
    same in every process of a job on like cards."""
    lib = _build.load("ring_across")
    with torch.cuda.device(device):
        lanes = lib.rnr_ring_lanes_across(n, per, code)
    _build.check(lib, "rnr_ring_error", min(lanes, 0), "ring lane query")
    return lanes


def _run_across(x: torch.Tensor, span, mode: int, per: int, in_elems: int,
                out_elems: int, fill) -> tuple:
    """One launch of this rank's blocks in ``mode`` over chunks of ``per``
    elements: ``fill(inp)`` writes this process's input row (``in_elems``),
    then the kernel runs. Returns the workspace and its output row
    (``out_elems``), which the caller copies out before ``finish``."""
    lib = _build.load("ring_across")
    n, code = span.size, DTYPE_CODES[x.dtype]
    lanes = _lanes_across(x.get_device(), n, per, code)
    ws = span.workspace(x.device)
    inp, out = ws.rows(x.dtype, in_elems, out_elems, (mode, code, per, lanes))
    fill(inp)
    ws.launch("ring", lanes, lib, "rnr_ring_rank", n, per, lanes, code, mode)
    return ws, out


def _copy_row(x: torch.Tensor, size: int):
    """``fill`` of a row of ``size`` elements from ``x``, zero-padded."""
    def fill(inp: torch.Tensor) -> None:
        inp[:size].copy_(x.reshape(-1))
        inp[size:].zero_()
    return fill


def _allreduce_across(x: torch.Tensor, span, align: int, counter: str,
                      into: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel's allreduce of this process's CUDA row ``x`` with chunks
    padded to ``align``, into ``into`` or a new tensor; counts one launch of
    ``counter``."""
    n, size, per = _geometry(x, align, span.size)
    if n == 1 or size == 0:
        return x.clone() if into is None else into
    ws, out = _run_across(x, span, MODE_AR, per, n * per, n * per, _copy_row(x, size))
    res = torch.empty_like(x) if into is None else into
    res.copy_(out[:size].view(x.shape))
    ws.finish()
    LAUNCHES[counter] += 1
    return res


def ring_allreduce_across(x: torch.Tensor, span) -> torch.Tensor:
    """Sum allreduce across processes: ``x`` is this process's row
    ``(1, S)`` of ``span``'s n ranks; returns its row of ``ring_allreduce``
    of every rank's row (``x`` unchanged)."""
    if _check_row(x, span, "ring_allreduce"):
        return ring_allreduce_across_plain(x, span)
    return _allreduce_across(x, span, LANES, "ring_allreduce_across")


def hbm_ring_allreduce_across(x: torch.Tensor, span, tile_rows: int = 64) -> torch.Tensor:
    """``hbm_ring_allreduce`` across processes: the result overwrites this
    process's row ``x``, which is returned."""
    _check_tile_rows(tile_rows)
    if _check_row(x, span, "hbm_ring_allreduce"):
        return x.copy_(_tiled_allreduce_across_plain(x, span, tile_rows))
    return _allreduce_across(x, span, tile_rows * LANES, "hbm_ring_allreduce_across", into=x)


def _tiled_allreduce_across(x: torch.Tensor, span, tile_rows: int) -> torch.Tensor:
    """``hbm_ring_allreduce_across``'s result, out of place: the
    ``cuda_ring`` arm's tiled tier across processes."""
    _check_tile_rows(tile_rows)
    if _check_row(x, span, "hbm_ring_allreduce"):
        return _tiled_allreduce_across_plain(x, span, tile_rows)
    return _allreduce_across(x, span, tile_rows * LANES, "hbm_ring_allreduce_across")


def ring_reduce_scatter_across(x: torch.Tensor, span,
                               tile_rows: int | None = None) -> torch.Tensor:
    """Sum reduce-scatter across processes: ``x`` is this process's row
    ``(1, S)``; returns ``(1, S/n)``, this rank's summed chunk. ``S`` must be
    a multiple of ``n*128``."""
    if _check_row(x, span, "ring_reduce_scatter"):
        return ring_reduce_scatter_across_plain(x, span, tile_rows)
    n = span.size
    if n == 1:
        return x.reshape(1, -1).clone()
    per = _rs_chunk(x, n)
    _check_tile_rows(tile_rows)
    ws, out = _run_across(x, span, MODE_RS, per, n * per, per, _copy_row(x, n * per))
    res = out.clone().view(1, per)
    ws.finish()
    LAUNCHES["ring_reduce_scatter_across"] += 1
    return res


def ring_allgather_across(x: torch.Tensor, span,
                          tile_rows: int | None = None) -> torch.Tensor:
    """Allgather across processes: ``x`` is this process's row ``(1, c...)``;
    returns ``(1, n*c)``, the concatenation of every rank's buffer."""
    if _check_row(x, span, "ring_allgather"):
        return ring_allgather_across_plain(x, span, tile_rows)
    n, c = span.size, x[0].numel()
    if n == 1 or c == 0:
        return x.reshape(1, -1).clone()
    _check_tile_rows(tile_rows)
    vec = 16 // x.element_size()
    per = -(-c // vec) * vec  # chunks start 16-byte aligned
    ws, out = _run_across(x, span, MODE_AG, per, per, n * per, _copy_row(x, c))
    res = out.view(n, per)[:, :c].clone().reshape(1, n * c)
    ws.finish()
    LAUNCHES["ring_allgather_across"] += 1
    return res
