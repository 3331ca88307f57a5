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
"""

from __future__ import annotations

import torch

from rocnrdma_tpu_torch.collectives.reduce_op import combine_fn, finalize


def _chunked(x: torch.Tensor, n: int) -> tuple[torch.Tensor, int, tuple]:
    """Rank-major x -> a fresh zero-padded (n ranks, n chunks, chunk) buffer."""
    shape = x.shape
    flat = x.reshape(n, -1)
    size = flat.shape[1]
    chunk = -(-size // n)  # ceil
    buf = flat.new_zeros((n, n * chunk))
    buf[:, :size] = flat
    return buf.reshape(n, n, chunk), size, shape


def _unchunk(buf: torch.Tensor, size: int, shape: tuple) -> torch.Tensor:
    n = buf.shape[0]
    return buf.reshape(n, -1)[:, :size].reshape(shape)


def _rs_phase(buf: torch.Tensor, n: int, shift: int, offset: int = 0,
              combine=torch.add) -> torch.Tensor:
    """Reduce-scatter phase: n-1 rotate-and-accumulate steps. Afterwards
    rank r owns the fully reduced chunk ``(r + d + offset) mod n``
    (d = ring direction)."""
    r = torch.arange(n, device=buf.device)
    d = 1 if shift == 1 else -1
    for s in range(n - 1):
        send_idx = (r - d * s + offset) % n
        recvd = torch.roll(buf[r, send_idx], shifts=shift, dims=0)
        recv_idx = (r - d * (s + 1) + offset) % n
        mine = buf[r, recv_idx]
        buf[r, recv_idx] = combine(mine, recvd)
    return buf


def _ag_phase(buf: torch.Tensor, n: int, shift: int,
              owned_offset: int) -> torch.Tensor:
    """Allgather phase: rotate completed chunks. ``owned_offset`` is the
    offset of the chunk each rank starts with (+1 after a reduce-scatter in
    the same direction)."""
    r = torch.arange(n, device=buf.device)
    d = 1 if shift == 1 else -1
    for s in range(n - 1):
        send_idx = (r + d * (owned_offset - s)) % n
        recvd = torch.roll(buf[r, send_idx], shifts=shift, dims=0)
        recv_idx = (r + d * (owned_offset - s - 1)) % n
        buf[r, recv_idx] = recvd
    return buf


def ring_allreduce(x: torch.Tensor, *, bidir: bool = False,
                   op: str = "sum") -> torch.Tensor:
    """Allreduce of the rank-major tensor ``x`` (rank r = row ``x[r]``) via
    reduce-scatter + allgather over the ring. Returns a new tensor of the
    same shape, every row the elementwise ``op``-reduction of all rows."""
    n = x.shape[0]
    combine = combine_fn(op)
    if n == 1:
        return finalize(x.clone(), op, 1)
    if not bidir:
        buf, size, shape = _chunked(x, n)
        buf = _rs_phase(buf, n, shift=1, combine=combine)
        buf = _ag_phase(buf, n, shift=1, owned_offset=1)
        return finalize(_unchunk(buf, size, shape), op, n)

    # bidirectional: per rank, the first half rides the +1 ring and the
    # second half the -1 ring
    flat = x.reshape(n, -1)
    half = flat.shape[1] // 2
    lo = ring_allreduce(flat[:, :half], op=op)
    hi = _bidir_partner(flat[:, half:], n, op)
    return torch.cat([lo, hi], dim=1).reshape(x.shape)


def _bidir_partner(x: torch.Tensor, n: int, op: str = "sum") -> torch.Tensor:
    buf, size, shape = _chunked(x, n)
    buf = _rs_phase(buf, n, shift=-1, combine=combine_fn(op))
    buf = _ag_phase(buf, n, shift=-1, owned_offset=1)
    return finalize(_unchunk(buf, size, shape), op, n)


def ring_reduce_scatter(x: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """Reduce-scatter of rank-major ``x``: returns ``(n, S/n)``, row r the
    fully ``op``-reduced r-th 1/n of the flattened rank buffers. Each
    rank's buffer must flatten to a multiple of n."""
    n = x.shape[0]
    flat = x.reshape(n, -1)
    combine = combine_fn(op)
    if n == 1:
        return finalize(flat.clone(), op, 1)
    if flat.shape[1] % n:
        raise ValueError(f"reduce_scatter buffer ({flat.shape[1]} elems) must "
                         f"divide by axis size {n}")
    buf = flat.reshape(n, n, -1).clone()
    # offset=-1: the schedule ends with rank r owning chunk r, the
    # conventional reduce-scatter layout, with no fixup hop
    buf = _rs_phase(buf, n, shift=1, offset=-1, combine=combine)
    r = torch.arange(n, device=buf.device)
    return finalize(buf[r, r], op, n)


def ring_allgather(x: torch.Tensor) -> torch.Tensor:
    """Allgather of rank-major ``x`` (n, c...): returns ``(n, n*c)``, every
    row the concatenation of all rank buffers in rank order."""
    n = x.shape[0]
    flat = x.reshape(n, -1)
    if n == 1:
        return flat.clone()
    buf = flat.new_zeros((n, n, flat.shape[1]))
    r = torch.arange(n, device=buf.device)
    buf[r, r] = flat
    return _ag_phase(buf, n, shift=1, owned_offset=0).reshape(n, -1)
