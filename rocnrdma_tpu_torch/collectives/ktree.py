"""k-ary tree allreduce, the ``ktree`` arm: one heap-shaped reduction tree
of arity ``KTREE_ARITY`` (parent of i = (i-1)//arity), each interior node
folding up to ``arity`` child rows into its own in one level, then a
broadcast back down. Any rank count.

Counterpart of ``rocnrdma_tpu/collectives/ktree.py``, with the same
substep tables (``kary_levels``). As in ``dtree.py``, ranks that receive
nothing in a substep fold the op's identity, so fp32 results equal the
reference's bit for bit; ``sim_kary_allreduce`` is the numpy oracle.
Across processes (``span``: the rank axis of a 1-D mesh, one rank a
process) each substep is one ``_exchange.permute_rows``, as in
``dtree.py``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from rocnrdma_tpu_torch.collectives.dtree import broadcast_down, fold_level
from rocnrdma_tpu_torch.collectives.reduce_op import finalize

# the registry arity, as in the reference (its widest useful fold there)
KTREE_ARITY = 8


@functools.lru_cache(maxsize=None)
def kary_levels(n: int, arity: int):
    """(up, down) substep tables for the heap-shaped arity-ary tree.

    ``up``: levels ordered deepest-first; each level is a tuple of
    substeps, one per child slot, each a tuple of (child, parent) pairs.
    ``down`` mirrors them shallowest-first with pairs flipped.
    """
    if arity < 2:
        raise ValueError(f"ktree needs arity >= 2, got {arity}")
    depth = [0] * n
    for i in range(1, n):
        depth[i] = depth[(i - 1) // arity] + 1
    up = []
    for d in range(max(depth), 0, -1):
        substeps = []
        for j in range(1, arity + 1):
            pairs = tuple((p * arity + j, p) for p in range(n)
                          if depth[p] == d - 1 and p * arity + j < n)
            if pairs:
                substeps.append(pairs)
        up.append(tuple(substeps))
    down = tuple(tuple(tuple((p, c) for c, p in sub) for sub in level)
                 for level in reversed(up))
    return tuple(up), down


def kary_tree_allreduce(x: torch.Tensor, arity: int = KTREE_ARITY,
                        op: str = "sum", span=None) -> torch.Tensor:
    """Allreduce of rank-major ``x`` via one arity-ary reduction tree and a
    broadcast (``op``: sum/prod/max/min/avg). ``span``: the rank axis
    across processes, ``x`` this process's row."""
    n = x.shape[0] if span is None else span.size
    if n == 1:
        return finalize(x.clone(), op, 1)
    up, down = kary_levels(n, arity)
    h = x.clone()
    for lv, substeps in enumerate(up):  # toward the root, deepest level first
        fold_level(h, substeps, op, tag=f"ktree up level {lv}", span=span)
    broadcast_down(h, [p for level in down for p in level], tag="ktree down",
                   span=span)
    return finalize(h, op, n)


def sim_kary_allreduce(xs: list, arity: int = KTREE_ARITY) -> list:
    """Pure-numpy oracle walking the same substep tables (sum)."""
    n = len(xs)
    if n == 1:
        return [np.asarray(xs[0])]
    hs = [np.asarray(x).copy() for x in xs]
    up, down = kary_levels(n, arity)
    for substeps in up:
        arrivals = [np.zeros_like(hs[0]) for _ in range(n)]
        fold = [False] * n
        for pairs in substeps:
            for c, p in pairs:
                arrivals[p] = arrivals[p] + hs[c]
                fold[p] = True
        for i in range(n):
            if fold[i]:
                hs[i] = hs[i] + arrivals[i]
    for substeps in down:
        for pairs in substeps:
            for p, c in pairs:
                hs[c] = hs[p].copy()
    return hs
