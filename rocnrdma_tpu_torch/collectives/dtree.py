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
"""

from __future__ import annotations

import torch

from rocnrdma_tpu_torch.collectives._steps import step_span
from rocnrdma_tpu_torch.collectives.reduce_op import finalize, fold_, fold_identity_
from rocnrdma_tpu_torch.collectives.schedule import dbtree_parents, dbtree_up_levels


def _dst_gate(n: int, pairs) -> list[bool]:
    """Is each rank a destination of this substep?"""
    mask = [False] * n
    for _, d in pairs:
        mask[d] = True
    return mask


def fold_level(h: torch.Tensor, level, op: str, tag: str) -> None:
    """One up level of a reduction tree on the rank rows of ``h``, in
    place: substep by substep, each substep's receivers fold their child's
    row and the level's other receivers the op's identity; after the last
    substep every rank that received nothing folds the identity once.
    Each substep is one step span named after ``tag``."""
    n = h.shape[0]
    senders = [dict((d, s) for s, d in pairs) for pairs in level]
    receivers = [r for r in range(n) if any(r in m for m in senders)]
    for k, m in enumerate(senders):
        with step_span(f"{tag} substep {k}"):
            for r in receivers:
                if r in m:
                    fold_(h[r], h[m[r]], op)
                else:
                    fold_identity_(h[r], op)
            if k == len(senders) - 1:
                # the children's rows have all been read: now they (and
                # every other rank that received nothing) fold the identity
                for r in range(n):
                    if r not in receivers:
                        fold_identity_(h[r], op)


def broadcast_down(h: torch.Tensor, down, tag: str) -> None:
    """The down phase of a tree, in place: each substep's children copy
    their parent's row (one step span per substep under ``tag``)."""
    for k, pairs in enumerate(down):
        with step_span(f"{tag} substep {k}"):
            for p, c in pairs:
                h[c].copy_(h[p])


def dbtree_allreduce(x: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """Allreduce of rank-major ``x`` via the double binary tree (``op``:
    sum/prod/max/min/avg)."""
    n = x.shape[0]
    if n == 1:
        return finalize(x.clone(), op, 1)
    flat = x.reshape(n, -1)
    size = flat.shape[1]
    half = -(-size // 2)
    buf = flat.new_zeros((n, 2 * half))
    buf[:, :size] = flat
    for t, parents in enumerate(dbtree_parents(n)):
        h = buf[:, t * half:(t + 1) * half]
        up_levels, down = dbtree_up_levels(parents)
        for lv, level in enumerate(up_levels):
            fold_level(h, level, op, tag=f"dtree tree{t} up level {lv}")
        broadcast_down(h, down, tag=f"dtree tree{t} down")
    return finalize(buf[:, :size].reshape(x.shape), op, n)
