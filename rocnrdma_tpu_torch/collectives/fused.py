"""The library path (the ``fused`` arm), in the role of XLA's collectives.

With every rank a row of one tensor, each collective is one library call
over the rank axis: a reduction written back to every rank row
(allreduce), a reduction cut into rank shards (reduce-scatter), a
concatenation broadcast to every row (allgather), a transpose of the rank
and chunk axes (alltoall), a row copied to every row (broadcast), a roll
of the rank axis (sendrecv; across processes one send and one receive,
``_exchange.shift_rows``). The rooted verbs zero the off-root rows of
reduce and gather, as the reference does. The reference's fused arm is
XLA's own lowering, so a library call is its counterpart here. A
reduction's order of summation is torch's, not the ring's: compare it with
a tolerance. The data-moving verbs are exact.
"""

from __future__ import annotations

import torch

from rocnrdma_tpu_torch.collectives._exchange import shift_rows
from rocnrdma_tpu_torch.collectives.reduce_op import fused_reduce


def fused_allreduce(x: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """(n, ...) -> (n, ...), every row the ``op``-reduction of all rows."""
    return fused_reduce(x, op).unsqueeze(0).expand(x.shape).contiguous()


def fused_reduce_scatter(x: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """(n, ...) -> (n, S/n): row r is the reduced r-th 1/n of the flattened
    rank buffers, like ``ring_reduce_scatter``. Sum and avg reduce and
    scatter in one pass; the other ops reduce the whole buffer, then keep
    each rank's shard, as the reference does (its scatter-reduce
    collective is sum-only)."""
    n = x.shape[0]
    flat = x.reshape(n, -1)
    if flat.shape[1] % n:
        raise ValueError(f"reduce_scatter buffer ({flat.shape[1]}) must divide by {n}")
    return fused_reduce(flat, op).reshape(n, -1)


def fused_allgather(x: torch.Tensor) -> torch.Tensor:
    """(n, c...) -> (n, n*c): every row the concatenation of all rows."""
    n = x.shape[0]
    return x.reshape(1, -1).expand(n, -1).contiguous()


def alltoall_ranks(x: torch.Tensor) -> int:
    """The rank count n of an alltoall input, which must be (n, n, c...):
    rank r's chunk d is ``x[r, d]``."""
    n = x.shape[0]
    if x.dim() < 2 or x.shape[1] != n:
        raise ValueError(f"leading dim {x.shape[1] if x.dim() > 1 else None} "
                         f"!= axis size {n}")
    return n


def fused_alltoall(x: torch.Tensor) -> torch.Tensor:
    """(n, n, c...) -> the same shape: the global transpose of the rank and
    chunk axes, row r's chunk j = what rank j sent to rank r."""
    alltoall_ranks(x)
    return x.transpose(0, 1).contiguous()


def fused_sendrecv(x: torch.Tensor, shift: int = 1, span=None) -> torch.Tensor:
    """Pairwise shift exchange: every rank sends its row to rank
    ``r + shift`` (mod n), so row r of the result is row ``r - shift``.
    ``span``: the rank axis across processes, ``x`` this process's row."""
    return shift_rows(x, shift, 0, span)


def fused_broadcast(x: torch.Tensor, root: int = 0) -> torch.Tensor:
    """Every row becomes row ``root``."""
    return x[root].unsqueeze(0).expand(x.shape).contiguous()


def fused_rooted_reduce(x: torch.Tensor, root: int = 0,
                        op: str = "sum") -> torch.Tensor:
    """Row ``root`` becomes the ``op``-reduction of all rows; the others
    zero."""
    out = torch.zeros_like(x)
    out[root] = fused_reduce(x, op)
    return out


def fused_gather(x: torch.Tensor, root: int = 0) -> torch.Tensor:
    """(n, ...) -> (n, n, ...): row ``root`` holds every rank's row in rank
    order; the others zero."""
    out = x.new_zeros((x.shape[0],) + tuple(x.shape))
    out[root] = x
    return out


def fused_scatter(x: torch.Tensor, root: int = 0) -> torch.Tensor:
    """Row ``root`` (flattening to n*c) is split n ways: row r of the
    result is its chunk r. Only row ``root`` is read."""
    n = x.shape[0]
    flat = x.reshape(n, -1)
    if flat.shape[1] % n:
        raise ValueError(f"scatter buffer ({flat.shape[1]}) must divide by {n}")
    return flat[root].reshape(n, -1).clone()
