"""Ring collectives as explicit PyTorch schedules (the ``ring`` and
``ring_bidir`` arms of allreduce, the ``ring`` arm of reduce-scatter and
allgather).

Counterpart of ``rocnrdma_tpu/collectives/ring.py``. There each step is a
``lax.ppermute`` between devices; here every rank is a row of one
rank-major tensor ``x`` of shape ``(n, ...)``, and each step moves one
chunk per rank with tensor indexing: gather every rank's send chunk, rotate
the gathered rows by the ring shift (rank r receives from r - shift), and
fold into every rank's receive chunk. The chunk indices, the chunking
(``ceil(size/n)``, no lane padding), the fold order ``combine(mine,
recvd)`` and the ``bidir`` split are the reference's, so on float32 the
two agree bit for bit. This arm is plain tensor code, not a kernel.

Each step runs in one step span (``_steps.step_span``). The ``*_rows``
forms run B rings of the same size in lockstep, one span a step: the
hierarchical schedules run a phase's rings that way, as the reference runs
them concurrently. Every schedule here also takes a ``span`` (the rank
axis of a 1-D mesh, or the slice axis of a 2-D one, across processes):
then each ring's axis holds this process's one row, and the rotate is
``_exchange.shift_rows`` across processes, with the same chunks and fold
order.
"""

from __future__ import annotations

import torch

from rocnrdma_tpu_torch.collectives._exchange import ring_positions, shift_rows
from rocnrdma_tpu_torch.collectives._steps import step_span
from rocnrdma_tpu_torch.collectives.reduce_op import combine_fn, finalize


def _chunk_rows(g: torch.Tensor, n: int | None = None) -> torch.Tensor:
    """(B, rows, size) -> a fresh zero-padded (B, rows, n chunks, chunk)
    buffer: B independent rings of n ranks (default: n = rows, every rank
    held here)."""
    b, rows, size = g.shape
    n = rows if n is None else n
    chunk = -(-size // n)  # ceil
    buf = g.new_zeros((b, rows, n * chunk))
    buf[..., :size] = g
    return buf.reshape(b, rows, n, chunk)


def _chunked(x: torch.Tensor, n: int) -> tuple[torch.Tensor, int, tuple]:
    """Rank-major x -> a fresh zero-padded (rows, n chunks, chunk) buffer
    for an n-rank axis (rows: x's leading dim, the ranks held here)."""
    flat = x.reshape(1, x.shape[0], -1)
    return _chunk_rows(flat, n)[0], flat.shape[2], x.shape


def _unchunk(buf: torch.Tensor, size: int, shape: tuple) -> torch.Tensor:
    return buf.reshape(buf.shape[0], -1)[:, :size].reshape(shape)


def _rank_major(lanes):
    """(B, n, n, chunk) lanes as (n, n, B, chunk) views: the rank and chunk
    axes lead, so a step indexes them first, as for one ring."""
    return [(buf.movedim(0, 2), shift) for buf, shift in lanes]


def _rs_phase(lanes, n: int, offset: int = 0, combine=torch.add,
              tag: str = "ring rs", span=None) -> None:
    """Reduce-scatter phase, in place: n-1 rotate-and-accumulate steps.
    ``lanes``: (buf, shift) pairs, each buf (B, n, n, chunk) holding B
    rings (across processes, ``span``: (B, 1, n, chunk), this process's
    rank); step s of every lane runs in one step span. Afterwards rank r
    owns the fully reduced chunk ``(r + d + offset) mod n`` (d = ring
    direction)."""
    rows, r = ring_positions(n, span, lanes[0][0].device)
    lanes = _rank_major(lanes)
    for s in range(n - 1):
        with step_span(f"{tag} step {s}"):
            for buf, shift in lanes:
                d = 1 if shift == 1 else -1
                send_idx = (r - d * s + offset) % n
                recvd = shift_rows(buf[rows, send_idx], shift, 0, span)
                recv_idx = (r - d * (s + 1) + offset) % n
                mine = buf[rows, recv_idx]
                buf[rows, recv_idx] = combine(mine, recvd)


def _ag_phase(lanes, n: int, owned_offset: int, tag: str = "ring ag",
              span=None) -> None:
    """Allgather phase, in place: rotate completed chunks. ``owned_offset``
    is the offset of the chunk each rank starts with (+1 after a
    reduce-scatter in the same direction)."""
    rows, r = ring_positions(n, span, lanes[0][0].device)
    lanes = _rank_major(lanes)
    for s in range(n - 1):
        with step_span(f"{tag} step {s}"):
            for buf, shift in lanes:
                d = 1 if shift == 1 else -1
                send_idx = (r + d * (owned_offset - s)) % n
                recvd = shift_rows(buf[rows, send_idx], shift, 0, span)
                recv_idx = (r + d * (owned_offset - s - 1)) % n
                buf[rows, recv_idx] = recvd


def allreduce_rows(g: torch.Tensor, op: str = "sum",
                   tag: str = "ring", span=None) -> torch.Tensor:
    """Ring allreduce of B independent rings at once: (B, n, size) ->
    (B, n, size), row (b, r) the ``op``-reduction of ring b's rows. Every
    step of the B rings runs in one step span. With ``span`` each ring is
    the slice axis across processes: (B, 1, size), this process's rows."""
    b, rows, size = g.shape
    n = rows if span is None else span.size
    if n == 1:
        return finalize(g.clone(), op, 1)
    buf = _chunk_rows(g, n)
    _rs_phase([(buf, 1)], n, combine=combine_fn(op), tag=f"{tag} rs", span=span)
    _ag_phase([(buf, 1)], n, owned_offset=1, tag=f"{tag} ag", span=span)
    return finalize(buf.reshape(b, rows, -1)[..., :size], op, n)


def reduce_scatter_rows(g: torch.Tensor, op: str = "sum",
                        tag: str = "ring rs", span=None) -> torch.Tensor:
    """Ring reduce-scatter of B rings: (B, n, S) -> (B, n, S/n); with
    ``span``, (B, 1, S) -> (B, 1, S/n), this process's rows."""
    b, rows, size = g.shape
    n = rows if span is None else span.size
    if n == 1:
        return finalize(g.clone(), op, 1)
    if size % n:
        raise ValueError(f"reduce_scatter buffer ({size} elems) must "
                         f"divide by axis size {n}")
    buf = g.reshape(b, rows, n, -1).clone()
    # offset=-1: the schedule ends with rank r owning chunk r, the
    # conventional reduce-scatter layout, with no fixup hop
    _rs_phase([(buf, 1)], n, offset=-1, combine=combine_fn(op), tag=tag, span=span)
    held, r = ring_positions(n, span, buf.device)
    return finalize(buf[:, held, r], op, n)


def allgather_rows(g: torch.Tensor, tag: str = "ring ag", span=None) -> torch.Tensor:
    """Ring allgather of B rings: (B, n, c) -> (B, n, n*c); with ``span``,
    (B, 1, c) -> (B, 1, n*c), this process's rows."""
    b, rows, c = g.shape
    n = rows if span is None else span.size
    if n == 1:
        return g.clone()
    buf = g.new_zeros((b, rows, n, c))
    held, r = ring_positions(n, span, buf.device)
    buf[:, held, r] = g
    _ag_phase([(buf, 1)], n, owned_offset=0, tag=tag, span=span)
    return buf.reshape(b, rows, -1)


def ring_allreduce(x: torch.Tensor, *, bidir: bool = False,
                   op: str = "sum", span=None) -> torch.Tensor:
    """Allreduce of the rank-major tensor ``x`` (rank r = row ``x[r]``) via
    reduce-scatter + allgather over the ring. Returns a new tensor of the
    same shape, every row the elementwise ``op``-reduction of all rows.
    ``span``: the rank axis across processes, ``x`` this process's row."""
    rows = x.shape[0]
    n = rows if span is None else span.size
    if n == 1:
        return finalize(x.clone(), op, 1)
    if not bidir:
        return allreduce_rows(x.reshape(1, rows, -1), op, span=span)[0].reshape(x.shape)

    # bidirectional: per rank, the first half rides the +1 ring and the
    # second half the -1 ring; step s of both rings is one schedule step
    flat = x.reshape(rows, -1)
    half = flat.shape[1] // 2
    lo, hi = _chunked(flat[:, :half], n), _chunked(flat[:, half:], n)
    lanes = [(lo[0][None], 1), (hi[0][None], -1)]
    _rs_phase(lanes, n, combine=combine_fn(op), tag="ring_bidir rs", span=span)
    _ag_phase(lanes, n, owned_offset=1, tag="ring_bidir ag", span=span)
    out = torch.cat([_unchunk(*lo), _unchunk(*hi)], dim=1)
    return finalize(out, op, n).reshape(x.shape)


def ring_reduce_scatter(x: torch.Tensor, op: str = "sum", span=None) -> torch.Tensor:
    """Reduce-scatter of rank-major ``x``: returns ``(n, S/n)``, row r the
    fully ``op``-reduced r-th 1/n of the flattened rank buffers. Each
    rank's buffer must flatten to a multiple of n. ``span``: as in
    ``ring_allreduce``."""
    return reduce_scatter_rows(x.reshape(1, x.shape[0], -1), op, span=span)[0]


def ring_allgather(x: torch.Tensor, span=None) -> torch.Tensor:
    """Allgather of rank-major ``x`` (n, c...): returns ``(n, n*c)``, every
    row the concatenation of all rank buffers in rank order. ``span``: as
    in ``ring_allreduce``."""
    return allgather_rows(x.reshape(1, x.shape[0], -1), span=span)[0]
