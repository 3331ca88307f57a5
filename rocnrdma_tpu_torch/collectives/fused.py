"""The library path (the ``fused`` arm), in the role of XLA's ``psum``.

With every rank a row of one tensor, the allreduce is one reduction over
the rank axis, written back to every rank row. The reference's fused arm
is XLA's own lowering, so a library call is its counterpart here. Its
order of summation is torch's, not the ring's: compare it with a
tolerance.
"""

from __future__ import annotations

import torch

from rocnrdma_tpu_torch.collectives.reduce_op import REDUCE_OPS, finalize


def fused_allreduce(x: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """(n, ...) -> (n, ...), every row the ``op``-reduction of all rows."""
    if op in ("sum", "avg"):
        red = finalize(x.sum(0), op, x.shape[0])
    elif op == "prod":
        red = x.prod(0)
    elif op == "max":
        red = x.amax(0)
    elif op == "min":
        red = x.amin(0)
    else:
        raise ValueError(f"unknown reduce op {op!r}; know {REDUCE_OPS}")
    return red.unsqueeze(0).expand(x.shape).contiguous()
