"""Reduction operators of the allreduce family (sum/prod/max/min/avg).

- ``combine_fn(op)(a, b)`` is the pairwise step the explicit ring folds
  with. ``avg`` combines as ``sum``; the divide by the rank count happens
  once, at the end (``finalize``).
- ``fused_reduce(x, op)`` is the one library call over the rank axis (the
  ``fused`` arms, and the cross-slice phase of the hierarchical schedule).
- Padding: the ring pads buffers to a multiple of the rank count; padded
  elements are reduced like any others and sliced off, so no per-op
  identity bookkeeping is needed there.
"""

from __future__ import annotations

import torch

REDUCE_OPS = ("sum", "prod", "max", "min", "avg")

_COMBINE = {
    "sum": torch.add,
    "avg": torch.add,
    "prod": torch.mul,
    "max": torch.maximum,
    "min": torch.minimum,
}


def combine_fn(op: str):
    """The pairwise combiner the explicit schedules fold with."""
    try:
        return _COMBINE[op]
    except KeyError:
        raise ValueError(f"unknown reduce op {op!r}; know {REDUCE_OPS}") from None


def fold_(acc: torch.Tensor, other: torch.Tensor, op: str) -> torch.Tensor:
    """``acc = combine(acc, other)``, written into ``acc`` (a view of a
    schedule's buffer): the same rounding as the out-of-place combine, with
    no temporary."""
    return combine_fn(op)(acc, other, out=acc)


def fold_identity_(acc: torch.Tensor, op: str) -> torch.Tensor:
    """``acc = combine(acc, identity(op))`` in place: what a reference rank
    that receives nothing in a substep computes, since its SPMD program
    folds the op's identity in. Only a sum's identity fold can change bits
    (``-0.0 + 0.0 = +0.0``), and doing it twice equals doing it once; the
    other ops' identity folds are exact no-ops and are skipped."""
    if op in ("sum", "avg"):
        acc.add_(0)
    return acc


def identity(op: str, dtype: torch.dtype) -> torch.Tensor:
    """The op's identity element (combine(x, identity) == x)."""
    if op in ("sum", "avg"):
        return torch.zeros((), dtype=dtype)
    if op == "prod":
        return torch.ones((), dtype=dtype)
    if op in ("max", "min"):
        # floats: -inf/+inf, not finfo extremes, so a legitimate inf input
        # survives
        if dtype.is_floating_point:
            v = float("-inf") if op == "max" else float("inf")
        else:
            info = torch.iinfo(dtype)
            v = info.min if op == "max" else info.max
        return torch.tensor(v, dtype=dtype)
    raise ValueError(f"unknown reduce op {op!r}; know {REDUCE_OPS}")


def finalize(x: torch.Tensor, op: str, n_total: int) -> torch.Tensor:
    """``avg`` scales the summed result by 1/rank-count once; every other op
    is already final. It multiplies by the reciprocal, rounded to the
    buffer's dtype, because that is what the compiled reference computes:
    XLA rewrites its division by the constant rank count that way."""
    if op == "avg":
        return x * torch.tensor(1.0 / n_total, dtype=x.dtype)
    return x


def fused_reduce(x: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """The ``op``-reduction of the rank rows of ``x`` (dim 0), one row: the
    library call in the role of the reference's ``psum``/``pmax``/``pmin``
    (and of its gather-then-multiply ``prod``). Its order of summation is
    torch's."""
    if op in ("sum", "avg"):
        return finalize(x.sum(0), op, x.shape[0])
    if op == "prod":
        return x.prod(0)
    if op == "max":
        return x.amax(0)
    if op == "min":
        return x.amin(0)
    raise ValueError(f"unknown reduce op {op!r}; know {REDUCE_OPS}")
