"""Double binary tree allreduce, the ``dtree`` arm: two complementary
in-order trees each reduce, then broadcast, half of the buffer. Any rank
count.

Counterpart of ``rocnrdma_tpu/collectives/dtree.py``, with the same trees,
levels and substeps (``schedule.dbtree_parents`` /
``schedule.dbtree_up_levels``). In the reference every substep is a
partial ``lax.ppermute``: a rank that receives nothing gets the op's
identity (``_dst_gate``), and each level folds its substeps' arrivals into
every rank in substep order. Here a receiving rank folds its child's row,
and the others fold the identity (``reduce_op.fold_identity_``), in the
same order, so fp32 results equal the reference's bit for bit. A level's
senders (children) and receivers (parents) are disjoint: receivers fold
first, reading the children's rows before any identity fold touches them
(an early identity fold would turn a child's -0.0 into +0.0). Each
substep is one step span, the reference's one permute.

Across processes (``span``: the rank axis of a 1-D mesh, one rank a
process) ``h`` is this process's row, and each substep is one
``_exchange.permute_rows`` of its pairs: a child ships its row, a parent
folds it where the one-process schedule reads the child's row (or lands
it, going down), and a rank that receives nothing folds the identity by
the same rule.
"""

from __future__ import annotations

import torch

from rocnrdma_tpu_torch.collectives._exchange import permute_rows
from rocnrdma_tpu_torch.collectives._steps import step_span
from rocnrdma_tpu_torch.collectives.reduce_op import finalize, fold_, fold_identity_
from rocnrdma_tpu_torch.collectives.schedule import dbtree_parents, dbtree_up_levels


def _dst_gate(n: int, pairs) -> list[bool]:
    """Is each rank a destination of this substep?"""
    mask = [False] * n
    for _, d in pairs:
        mask[d] = True
    return mask


def fold_level(h: torch.Tensor, level, op: str, tag: str, span=None) -> None:
    """One up level of a reduction tree on the rank rows of ``h``, in
    place: substep by substep, each substep's receivers fold their child's
    row and the level's other receivers the op's identity; after the last
    substep every rank that received nothing folds the identity once.
    Each substep is one step span named after ``tag``. ``span``: the rank
    axis across processes, ``h`` this process's row."""
    n = h.shape[0] if span is None else span.size
    senders = [dict((d, s) for s, d in pairs) for pairs in level]
    receivers = [r for r in range(n) if any(r in m for m in senders)]
    held = range(n) if span is None else (span.index,)
    for k, (pairs, m) in enumerate(zip(level, senders)):
        with step_span(f"{tag} substep {k}"):
            if span is None:
                for r in receivers:
                    if r in m:
                        fold_(h[r], h[m[r]], op)
                    else:
                        fold_identity_(h[r], op)
            else:
                recvd = permute_rows(h, pairs, span)  # None: not a receiver here
                if recvd is not None:
                    fold_(h[0], recvd[0], op)
                elif span.index in receivers:
                    fold_identity_(h[0], op)
            if k == len(senders) - 1:
                # the children's rows have all been read: now they (and
                # every other rank that received nothing) fold the identity
                for i, r in enumerate(held):
                    if r not in receivers:
                        fold_identity_(h[i], op)


def broadcast_down(h: torch.Tensor, down, tag: str, span=None) -> None:
    """The down phase of a tree, in place: each substep's children copy
    their parent's row (one step span per substep under ``tag``).
    ``span``: as in ``fold_level``."""
    for k, pairs in enumerate(down):
        with step_span(f"{tag} substep {k}"):
            if span is None:
                for p, c in pairs:
                    h[c].copy_(h[p])
                continue
            recvd = permute_rows(h, pairs, span)
            if recvd is not None:
                h.copy_(recvd)


def dbtree_allreduce(x: torch.Tensor, op: str = "sum", span=None) -> torch.Tensor:
    """Allreduce of rank-major ``x`` via the double binary tree (``op``:
    sum/prod/max/min/avg). ``span``: the rank axis across processes,
    ``x`` this process's row."""
    rows = x.shape[0]
    n = rows if span is None else span.size
    if n == 1:
        return finalize(x.clone(), op, 1)
    flat = x.reshape(rows, -1)
    size = flat.shape[1]
    half = -(-size // 2)
    buf = flat.new_zeros((rows, 2 * half))
    buf[:, :size] = flat
    for t, parents in enumerate(dbtree_parents(n)):
        h = buf[:, t * half:(t + 1) * half]
        up_levels, down = dbtree_up_levels(parents)
        for lv, level in enumerate(up_levels):
            fold_level(h, level, op, tag=f"dtree tree{t} up level {lv}", span=span)
        broadcast_down(h, down, tag=f"dtree tree{t} down", span=span)
    return finalize(buf[:, :size].reshape(x.shape), op, n)
