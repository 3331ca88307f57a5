"""Halving-doubling allreduce, the ``tree`` arm: 2 log2(n) steps instead of
the ring's 2(n-1), the same 2(n-1)/n * S of traffic. Needs a power-of-two
rank count.

Counterpart of ``rocnrdma_tpu/collectives/tree.py``. The buffer is padded
and cut into n chunks as there; rank r's segment start and length follow
``schedule.hd_masks`` step by step. Where the reference exchanges a half
segment with ``lax.ppermute`` to rank ``r XOR mask``, rank r here folds
its partner's row of the same chunk range into its own (``combine(kept,
recvd)``, the reference's order, so fp32 results equal it bit for bit). A
pair's kept and sent halves are disjoint, so rows update in place. Each
mask is one step span.

Across processes (``span``: the rank axis of a 1-D mesh, one rank a
process), ``x`` is this process's row, and every rank can compute every
rank's segment: in halving a rank ships its partner the half the partner
keeps, and in doubling its own segment, one ``_exchange.permute_rows`` a
mask, and folds or lands what arrives where the one-process schedule
reads the partner's row.
"""

from __future__ import annotations

import torch

from rocnrdma_tpu_torch.collectives._exchange import permute_rows
from rocnrdma_tpu_torch.collectives._steps import step_span
from rocnrdma_tpu_torch.collectives.reduce_op import finalize, fold_
from rocnrdma_tpu_torch.collectives.ring import _chunked, _unchunk
from rocnrdma_tpu_torch.collectives.schedule import hd_masks


def hd_allreduce(x: torch.Tensor, op: str = "sum", span=None) -> torch.Tensor:
    """Allreduce of rank-major ``x`` by recursive halving + recursive
    doubling (``op``: sum/prod/max/min/avg). ``span``: the rank axis
    across processes (module docstring)."""
    n = x.shape[0] if span is None else span.size
    if n == 1:
        return finalize(x.clone(), op, 1)
    masks = hd_masks(n)  # raises on a non-power-of-two n
    buf, size, shape = _chunked(x, n)
    start, length = [0] * n, n  # each rank's segment, in chunks
    # recursive halving (reduce-scatter): keep one half, fold the
    # partner's copy of it in
    for mask in masks:
        half = length // 2
        start = [s + half if r & mask else s for r, s in enumerate(start)]
        with step_span(f"tree halving mask {mask}"):
            if span is None:
                for r in range(n):
                    seg = slice(start[r], start[r] + half)
                    fold_(buf[r, seg], buf[r ^ mask, seg], op)
            else:
                r = span.index
                p = start[r ^ mask]  # the partner's kept half
                recvd = permute_rows(buf[:, p:p + half], _xor_pairs(n, mask), span)
                fold_(buf[0, start[r]:start[r] + half], recvd[0], op)
        length = half
    # recursive doubling (allgather): copy in the partner's segment, the
    # sibling half of the parent segment
    for mask in reversed(masks):
        with step_span(f"tree doubling mask {mask}"):
            if span is None:
                for r in range(n):
                    p = start[r ^ mask]
                    buf[r, p:p + length] = buf[r ^ mask, p:p + length]
            else:
                r = span.index
                mine, p = start[r], start[r ^ mask]
                buf[0, p:p + length] = permute_rows(
                    buf[:, mine:mine + length], _xor_pairs(n, mask), span)[0]
        start = [min(s, start[r ^ mask]) for r, s in enumerate(start)]
        length *= 2
    return finalize(_unchunk(buf, size, shape), op, n)


def _xor_pairs(n: int, mask: int) -> list:
    """The (src, dst) pairs of a halving-doubling step: r and r ^ mask."""
    return [(r, r ^ mask) for r in range(n)]
