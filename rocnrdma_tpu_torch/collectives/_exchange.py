"""The row exchanges of a rank axis, within a process or across processes.

Every step of an explicit schedule moves one row per rank by a ring shift:
rank r receives the row rank r - shift sent. Where every rank of the axis
is a row of one tensor in this process, that is ``torch.roll`` over the
rank axis. Where the axis is the slice axis of a mesh that spans
processes (``runtime.mesh.ProcessSpan``), this process holds one row of
it: the row goes to slice ``index + shift`` and the row of slice
``index - shift`` comes back, one ``batch_isend_irecv`` pair on the
span's cross group. The schedules call ``shift_rows`` for both, so the
chunk they send, the row they fold it into and the fold
``combine(mine, recvd)`` are the same in both layouts, and so are the
bits of a result.

Also here, the library calls of the slice axis across processes (the
``fused`` cross phase and the ``fused`` verbs of such a mesh):
``cross_allreduce`` and ``cross_alltoall``. Where ``span.staged``, each
exchange copies its send rows into pinned host memory, exchanges them on
the gloo cross group and copies what arrived back to the device. Each
exchange counts its bytes and host seconds in ``span.stats``, and so
does each staging copy, each way.
"""

from __future__ import annotations

import time

import torch

from rocnrdma_tpu_torch.collectives.reduce_op import finalize, fused_reduce

_DIST_OPS = {"sum": "SUM", "prod": "PRODUCT", "max": "MAX", "min": "MIN"}


def ring_positions(n: int, span, device) -> tuple[torch.Tensor, torch.Tensor]:
    """``(rows, ranks)``: the row index into this process's tensor and the
    ring position of each rank of an n-rank axis held here: every rank
    (both ``arange(n)``), or, across processes, the one local row (0) at
    position ``span.index``."""
    if span is None:
        r = torch.arange(n, device=device)
        return r, r
    return (torch.zeros(1, dtype=torch.long, device=device),
            torch.full((1,), span.index, dtype=torch.long, device=device))


def _settled(t: torch.Tensor) -> None:
    """Wait for the work queued on ``t``'s device, so that a staging copy's
    host seconds count the copy alone and not the kernels before it."""
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def _wire(t: torch.Tensor, span) -> torch.Tensor:
    """``t`` as the cross group carries it: contiguous, and in pinned
    host memory where the span stages."""
    if not span.staged:
        return t.contiguous()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    _settled(t)
    t0 = time.perf_counter()
    host.copy_(t)
    span.count("d2h", host.numel() * host.element_size(),
               time.perf_counter() - t0)
    return host


def _landing(like: torch.Tensor, span) -> torch.Tensor:
    """Where an exchange lands: pinned host memory where the span stages,
    else beside ``like`` on its device."""
    if span.staged:
        return torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
    return torch.empty_like(like)


def _unwire(t: torch.Tensor, device: torch.device, span) -> torch.Tensor:
    """What arrived, back on ``device``."""
    if not span.staged:
        return t
    out = torch.empty(t.shape, dtype=t.dtype, device=device)
    _settled(out)
    t0 = time.perf_counter()
    out.copy_(t)
    span.count("h2d", t.numel() * t.element_size(), time.perf_counter() - t0)
    return out


def shift_rows(t: torch.Tensor, shift: int, dim: int = 0,
               span=None) -> torch.Tensor:
    """Rotate the ranks of ``dim`` by ``shift``: row r of the result is
    row r - shift. Without ``span``, ``torch.roll``. With one, ``dim``
    holds this process's one row of the span's slice axis; it is sent to
    slice ``index + shift`` and the row of ``index - shift`` is
    returned."""
    if span is None:
        return torch.roll(t, shifts=shift, dims=dim)
    if t.shape[dim] != 1:
        raise ValueError(f"across processes a rank axis holds this "
                         f"process's one row, got {t.shape[dim]} on dim {dim}")
    m = span.size
    if shift % m == 0:
        return t.clone()
    dist = torch.distributed
    send = _wire(t, span)
    recv = _landing(send, span)
    group = span.cross_group
    t0 = time.perf_counter()
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, send, span.peers[(span.index + shift) % m], group),
        dist.P2POp(dist.irecv, recv, span.peers[(span.index - shift) % m], group)])
    for req in reqs:
        req.wait()
    span.count("exchange", send.numel() * send.element_size(),
               time.perf_counter() - t0)
    return _unwire(recv, t.device, span)


def cross_allreduce(t: torch.Tensor, op: str, span) -> torch.Tensor:
    """The ``op``-reduction of ``t`` over the span's slices (every slice
    gets it): one ``all_reduce`` on the cross group, torch's order of
    summation. ``op``: sum/prod/max/min (an ``avg`` sums here and divides
    at its end)."""
    dist = torch.distributed
    w = _wire(t, span)
    if not span.staged:
        w = w.clone()  # all_reduce writes in place; t stays the caller's
    t0 = time.perf_counter()
    dist.all_reduce(w, op=getattr(dist.ReduceOp, _DIST_OPS[op]),
                    group=span.cross_group)
    span.count("exchange", w.numel() * w.element_size(), time.perf_counter() - t0)
    return _unwire(w, t.device, span)


def cross_alltoall(t: torch.Tensor, span) -> torch.Tensor:
    """``t[s]`` goes to slice s; row s of the result is what slice s sent
    this one: one ``all_to_all_single`` on the cross group, a
    permutation, so exact."""
    if t.shape[0] != span.size:
        raise ValueError(f"leading dim {t.shape[0]} != the {span.size} slices")
    w = _wire(t, span)
    out = _landing(w, span)
    t0 = time.perf_counter()
    torch.distributed.all_to_all_single(out, w, group=span.cross_group)
    span.count("exchange", w.numel() * w.element_size(), time.perf_counter() - t0)
    return _unwire(out, t.device, span)


def spanning_fused_allreduce(x: torch.Tensor, mesh_shape, span,
                             op: str = "sum") -> torch.Tensor:
    """The ``fused`` allreduce of a mesh that spans processes: this
    process's rows (per_slice, ...) reduced in one library call, then
    across the slices, every row the result."""
    m, n = mesh_shape
    inner = "sum" if op == "avg" else op
    red = cross_allreduce(fused_reduce(x, inner).unsqueeze(0), inner, span)
    return finalize(red, op, m * n).expand(x.shape).contiguous()


def spanning_fused_alltoall(x: torch.Tensor, mesh_shape, span) -> torch.Tensor:
    """The ``fused`` alltoall of a mesh that spans processes: this
    process's rows (per_slice, N, c...), N = slices * per_slice, chunk g
    for global rank g; row i's chunk g of the result is what rank g sent
    rank (index, i). One ``all_to_all_single``, exact."""
    m, n = mesh_shape
    if x.dim() < 2 or x.shape[0] != n or x.shape[1] != m * n:
        raise ValueError(f"expected this process's rows ({n}, {m * n}, ...), "
                         f"got {tuple(x.shape)}")
    rest = tuple(x.shape[2:])
    # [dest slice t, src intra i, dest intra j]
    send = x.reshape((n, m, n) + rest).transpose(0, 1)
    got = cross_alltoall(send, span)  # [src slice t, src intra i, dest intra j]
    return got.permute((2, 0, 1) + tuple(range(3, 3 + len(rest)))) \
        .reshape(x.shape).contiguous()
