"""The row exchanges of a rank axis, within a process or across processes.

Every step of an explicit schedule moves one piece per rank along a
permutation of the ranks, ``lax.ppermute(perm=pairs)`` in the reference:
rank d receives what rank s sent for each ``(s, d)`` pair, and a rank that
is no destination receives nothing. Where every rank of the axis is a row
of one tensor in this process, that is a gather of rows (``torch.roll``
for a ring shift). Where the axis spans processes (the rank axis of a 1-D
mesh or the slice axis of a 2-D one, ``runtime.mesh.ProcessSpan``), this
process holds one index of it: its piece goes to its destination and its
source's piece comes back, one ``batch_isend_irecv`` on the span's cross
group. ``shift_rows`` is the ring shift (rank r receives what r - shift
sent), ``permute_rows`` any permutation. Across processes the sender
ships exactly the piece its destination reads, and the schedules fold or
copy it where the one-process schedule reads that rank's row, so the
chunks sent, the rows folded into and the fold ``combine(mine, recvd)``
are the same in both layouts, and so are the bits of a result.

Also here, the library calls of that axis across processes (the
``fused`` verbs of such a mesh and the hierarchical ``fused`` cross
phase), one ``torch.distributed`` call each on the span's cross group:
``cross_allreduce``, ``cross_alltoall``, ``cross_reduce_scatter``,
``cross_allgather`` and the rooted ``cross_broadcast``, ``cross_reduce``,
``cross_gather`` and ``cross_scatter``; and the ``spanning_fused_*`` verbs
built on them, each this process's rows of the one-process
``collectives.fused`` verb (a 1-D mesh is their ``(n, 1)`` case: n slices
of one rank). Where ``span.staged``, each exchange copies
its send rows into pinned host memory, exchanges them on the gloo cross
group and copies what arrived back to the device. Each exchange counts
the bytes this process put into it and its host seconds in
``span.stats``, and so does each staging copy, each way. A process that
sends nothing (a broadcast's or a scatter's other slices, a permutation's
non-sources) stages nothing out, and one that receives nothing (a
reduce's or a gather's other slices, a permutation's non-destinations)
allocates and stages no landing buffer.
"""

from __future__ import annotations

import time

import torch

from rocnrdma_tpu_torch.collectives.reduce_op import finalize, fused_reduce

_DIST_OPS = {"sum": "SUM", "prod": "PRODUCT", "max": "MAX", "min": "MIN"}


def _dist_op(op: str):
    return getattr(torch.distributed.ReduceOp, _DIST_OPS[op])


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
    span.count("d2h", _nbytes(host), time.perf_counter() - t0)
    return host


def _scratch_wire(t: torch.Tensor, span) -> torch.Tensor:
    """``t`` on the wire as a buffer the call may write: a reduction
    writes in place, and ``t`` stays the caller's."""
    w = _wire(t, span)
    return w if span.staged else w.clone()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _landing(like: torch.Tensor, span, lead: tuple = ()) -> torch.Tensor:
    """Where an exchange lands, ``lead + like.shape`` of ``like``'s dtype:
    pinned host memory where the span stages, else beside ``like`` on its
    device."""
    shape = tuple(lead) + tuple(like.shape)
    if span.staged:
        return torch.empty(shape, dtype=like.dtype, pin_memory=True)
    return torch.empty(shape, dtype=like.dtype, device=like.device)


def _unwire(t: torch.Tensor, device: torch.device, span) -> torch.Tensor:
    """What arrived, back on ``device``."""
    if not span.staged:
        return t
    out = torch.empty(t.shape, dtype=t.dtype, device=device)
    _settled(out)
    t0 = time.perf_counter()
    out.copy_(t)
    span.count("h2d", _nbytes(t), time.perf_counter() - t0)
    return out


def _p2p(t: torch.Tensor, to, frm, span) -> torch.Tensor | None:
    """Send ``t`` to index ``to`` of the span and receive a piece shaped
    like it from index ``frm`` (either None: no send, no receive), one
    ``batch_isend_irecv`` on the cross group; returns what arrived, on
    ``t``'s device, or None."""
    dist = torch.distributed
    group = span.cross_group
    ops, send, recv = [], None, None
    if to is not None:
        send = _wire(t, span)
        ops.append(dist.P2POp(dist.isend, send, span.peers[to], group))
    if frm is not None:
        recv = _landing(t, span)
        ops.append(dist.P2POp(dist.irecv, recv, span.peers[frm], group))
    if not ops:
        return None
    t0 = time.perf_counter()
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    span.count("exchange", _nbytes(send) if send is not None else 0,
               time.perf_counter() - t0)
    return None if recv is None else _unwire(recv, t.device, span)


def _one_row(t: torch.Tensor, dim: int) -> None:
    if t.shape[dim] != 1:
        raise ValueError(f"across processes a rank axis holds this "
                         f"process's one row, got {t.shape[dim]} on dim {dim}")


def shift_rows(t: torch.Tensor, shift: int, dim: int = 0,
               span=None) -> torch.Tensor:
    """Rotate the ranks of ``dim`` by ``shift``: row r of the result is
    row r - shift. Without ``span``, ``torch.roll``. With one, ``dim``
    holds this process's one row of the span's axis; it is sent to index
    ``index + shift`` and the row of ``index - shift`` is returned."""
    if span is None:
        return torch.roll(t, shifts=shift, dims=dim)
    _one_row(t, dim)
    m = span.size
    if shift % m == 0:
        return t.clone()
    return _p2p(t, (span.index + shift) % m, (span.index - shift) % m, span)


def permute_rows(t: torch.Tensor, pairs, span=None) -> torch.Tensor | None:
    """``lax.ppermute(t, perm=pairs)`` over the rank axis, dim 0: row d of
    the result is row s of ``t`` for each ``(s, d)`` pair (each rank at
    most once a source and once a destination). Without ``span`` every
    rank is a row here, and a row no pair lands in is zero, as in the
    reference. With one, ``t`` is this process's one row: it goes to its
    destination, and the row its source sent comes back, ``(1, ...)``, or
    None where no pair lands here (the caller folds the op's identity, or
    keeps its row, where the one-process schedule does)."""
    if span is None:
        out = torch.zeros_like(t)
        if pairs:
            src, dst = zip(*pairs)
            out[list(dst)] = t[list(src)]
        return out
    _one_row(t, 0)
    me = span.index
    to = next((d for s, d in pairs if s == me), None)
    frm = next((s for s, d in pairs if d == me), None)
    if to == me and frm == me:  # a rank that keeps its own row
        return t.clone()
    return _p2p(t, to, frm, span)


def cross_allreduce(t: torch.Tensor, op: str, span) -> torch.Tensor:
    """The ``op``-reduction of ``t`` over the span's slices (every slice
    gets it): one ``all_reduce`` on the cross group, torch's order of
    summation. ``op``: sum/prod/max/min (an ``avg`` sums here and divides
    at its end)."""
    w = _scratch_wire(t, span)
    t0 = time.perf_counter()
    torch.distributed.all_reduce(w, op=_dist_op(op), group=span.cross_group)
    span.count("exchange", _nbytes(w), time.perf_counter() - t0)
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
    span.count("exchange", _nbytes(w), time.perf_counter() - t0)
    return _unwire(out, t.device, span)


def cross_reduce_scatter(t: torch.Tensor, op: str, span) -> torch.Tensor:
    """``t`` is (slices, c...): row s of the result's ``op``-reduction over
    the slices goes to slice s, and this slice's row is returned, (c...).
    One ``reduce_scatter`` on the cross group, torch's order of
    summation."""
    if t.shape[0] != span.size:
        raise ValueError(f"leading dim {t.shape[0]} != the {span.size} slices")
    w = _wire(t, span)
    out = _landing(w[0], span)
    t0 = time.perf_counter()
    torch.distributed.reduce_scatter_tensor(
        out.view(-1), w.view(-1), op=_dist_op(op), group=span.cross_group)
    span.count("exchange", _nbytes(w), time.perf_counter() - t0)
    return _unwire(out, t.device, span)


def cross_allgather(t: torch.Tensor, span) -> torch.Tensor:
    """Every slice's ``t``, stacked in slice order: (slices, *t.shape).
    One ``all_gather`` on the cross group, exact."""
    w = _wire(t, span)
    out = _landing(w, span, (span.size,))
    t0 = time.perf_counter()
    torch.distributed.all_gather_into_tensor(out.view(-1), w.view(-1),
                                             group=span.cross_group)
    span.count("exchange", _nbytes(w), time.perf_counter() - t0)
    return _unwire(out, t.device, span)


def cross_broadcast(t: torch.Tensor, root: int, span) -> torch.Tensor:
    """Slice ``root``'s ``t`` on every slice; the others' ``t`` gives only
    its shape and dtype. One ``broadcast`` on the cross group, exact."""
    mine = span.index == root
    w = _wire(t, span) if mine else _landing(t, span)
    t0 = time.perf_counter()
    torch.distributed.broadcast(w, src=span.peers[root], group=span.cross_group)
    span.count("exchange", _nbytes(w) if mine else 0, time.perf_counter() - t0)
    return t if mine else _unwire(w, t.device, span)


def cross_reduce(t: torch.Tensor, op: str, root: int, span) -> torch.Tensor | None:
    """The ``op``-reduction of ``t`` over the slices on slice ``root``,
    None on the others (they receive nothing). One ``reduce`` on the cross
    group, torch's order of summation."""
    w = _scratch_wire(t, span)  # reduce uses every slice's buffer as scratch
    t0 = time.perf_counter()
    torch.distributed.reduce(w, dst=span.peers[root], op=_dist_op(op),
                             group=span.cross_group)
    span.count("exchange", _nbytes(w), time.perf_counter() - t0)
    return _unwire(w, t.device, span) if span.index == root else None


def cross_gather(t: torch.Tensor, root: int, span) -> torch.Tensor | None:
    """Every slice's ``t`` stacked in slice order, (slices, *t.shape), on
    slice ``root``; None on the others (they receive nothing). One
    ``gather`` on the cross group, exact."""
    mine = span.index == root
    w = _wire(t, span)
    out = _landing(w, span, (span.size,)) if mine else None
    t0 = time.perf_counter()
    torch.distributed.gather(w, gather_list=list(out.unbind(0)) if mine else None,
                             dst=span.peers[root], group=span.cross_group)
    span.count("exchange", _nbytes(w), time.perf_counter() - t0)
    return _unwire(out, t.device, span) if mine else None


def cross_scatter(t: torch.Tensor, root: int, span) -> torch.Tensor:
    """Row s of slice ``root``'s ``t`` (slices, c...) goes to slice s; this
    slice's row is returned, (c...). The other slices' ``t`` gives only its
    shape and dtype. One ``scatter`` on the cross group, exact."""
    if t.shape[0] != span.size:
        raise ValueError(f"leading dim {t.shape[0]} != the {span.size} slices")
    mine = span.index == root
    w = _wire(t, span) if mine else None
    out = _landing(t[0], span)
    t0 = time.perf_counter()
    torch.distributed.scatter(out, scatter_list=list(w.unbind(0)) if mine else None,
                              src=span.peers[root], group=span.cross_group)
    span.count("exchange", _nbytes(w) if mine else 0, time.perf_counter() - t0)
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


def spanning_fused_reduce_scatter(x: torch.Tensor, mesh_shape, span,
                                  op: str = "sum") -> torch.Tensor:
    """The ``fused`` reduce_scatter of a mesh that spans processes: this
    process's rows (per_slice, S) reduced in one library call, then
    reduce-scattered over the slices; row i of the result is the reduced
    shard of rank (index, i), (per_slice, S/N)."""
    m, n = mesh_shape
    flat = x.reshape(n, -1)
    if flat.shape[1] % (m * n):
        raise ValueError(f"reduce_scatter buffer ({flat.shape[1]}) must divide "
                         f"by {m * n}")
    inner = "sum" if op == "avg" else op
    part = fused_reduce(flat, inner).reshape(m, -1)  # [dest slice, its n shards]
    return finalize(cross_reduce_scatter(part, inner, span), op, m * n).reshape(n, -1)


def spanning_fused_allgather(x: torch.Tensor, mesh_shape, span) -> torch.Tensor:
    """The ``fused`` allgather of a mesh that spans processes: this
    process's rows (per_slice, c...) gathered over the slices; every row
    the concatenation of all N ranks' rows, (per_slice, N*c)."""
    n = mesh_shape[1]
    got = cross_allgather(x.reshape(1, -1), span)  # [slice, its n rows]
    return got.reshape(1, -1).expand(n, -1).contiguous()


def spanning_fused_broadcast(x: torch.Tensor, mesh_shape, span,
                             root: int = 0) -> torch.Tensor:
    """The ``fused`` broadcast of a mesh that spans processes: every row
    becomes flat rank ``root``'s row, sent from its slice."""
    s, i = divmod(root, mesh_shape[1])  # the root's (slice, intra)
    return cross_broadcast(x[i], s, span).unsqueeze(0).expand(x.shape).contiguous()


def spanning_fused_rooted_reduce(x: torch.Tensor, mesh_shape, span,
                                 root: int = 0, op: str = "sum") -> torch.Tensor:
    """The ``fused`` reduce of a mesh that spans processes: this
    process's rows reduced in one library call, then over the slices onto
    the root's slice; flat rank ``root``'s row is the ``op``-reduction, every
    other row zero."""
    m, n = mesh_shape
    s, i = divmod(root, n)  # the root's (slice, intra)
    inner = "sum" if op == "avg" else op
    red = cross_reduce(fused_reduce(x, inner), inner, s, span)
    out = torch.zeros_like(x)
    if red is not None:
        out[i] = finalize(red, op, m * n)
    return out


def spanning_fused_gather(x: torch.Tensor, mesh_shape, span,
                          root: int = 0) -> torch.Tensor:
    """The ``fused`` gather of a mesh that spans processes: (per_slice,
    c...) -> (per_slice, N, c...), flat rank ``root``'s row every rank's
    row in rank order, the others zero."""
    m, n = mesh_shape
    s, i = divmod(root, n)  # the root's (slice, intra)
    got = cross_gather(x, s, span)  # [slice, its n rows], on the root's slice
    out = x.new_zeros((n, m * n) + tuple(x.shape[1:]))
    if got is not None:
        out[i] = got.reshape((m * n,) + tuple(x.shape[1:]))
    return out


def spanning_fused_scatter(x: torch.Tensor, mesh_shape, span,
                           root: int = 0) -> torch.Tensor:
    """The ``fused`` scatter of a mesh that spans processes: flat rank
    ``root``'s row (flattening to N*c) is split N ways and row i of the
    result is the chunk of rank (index, i), (per_slice, c). Only the root's
    row is read."""
    m, n = mesh_shape
    s, i = divmod(root, n)  # the root's (slice, intra)
    flat = x.reshape(n, -1)
    if flat.shape[1] % (m * n):
        raise ValueError(f"scatter buffer ({flat.shape[1]}) must divide by {m * n}")
    return cross_scatter(flat[i].reshape(m, -1), s, span).reshape(n, -1)
