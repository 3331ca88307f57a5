"""The library path (the ``fused`` arm), in the role of XLA's collectives.

With every rank a row of one tensor, each collective is one library call
over the rank axis: a reduction written back to every rank row
(allreduce), a reduction cut into rank shards (reduce-scatter), a
concatenation broadcast to every row (allgather), a transpose of the rank
and chunk axes (alltoall). The reference's fused arm is XLA's own
lowering, so a library call is its counterpart here. A reduction's order
of summation is torch's, not the ring's: compare it with a tolerance. The
data-moving verbs are exact.
"""

from __future__ import annotations

import torch

from rocnrdma_tpu_torch.collectives.reduce_op import REDUCE_OPS, finalize


def _reduce(x: torch.Tensor, op: str) -> torch.Tensor:
    """The ``op``-reduction of the rank rows, one row."""
    if op in ("sum", "avg"):
        return finalize(x.sum(0), op, x.shape[0])
    if op == "prod":
        return x.prod(0)
    if op == "max":
        return x.amax(0)
    if op == "min":
        return x.amin(0)
    raise ValueError(f"unknown reduce op {op!r}; know {REDUCE_OPS}")


def fused_allreduce(x: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """(n, ...) -> (n, ...), every row the ``op``-reduction of all rows."""
    return _reduce(x, op).unsqueeze(0).expand(x.shape).contiguous()


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
    return _reduce(flat, op).reshape(n, -1)


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
