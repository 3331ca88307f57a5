"""Chunk-pipelined double binary tree allreduce, the ``ptree`` arm.

Counterpart of ``rocnrdma_tpu/collectives/ptree.py``. Each half of the
buffer (one per tree of ``schedule.dbtree_parents``) is cut into C chunks
that stream through its tree: at up-tick T a child at depth d sends chunk
``T - depth_max + d`` to its parent, which folds both children's arrivals
of that chunk into its own; the down ticks stream the reduced chunks back
(``schedule.ptree_ticks``, tabled per rank by ``_tick_tables``).

In the reference every substep is a partial ``lax.ppermute``: a rank that
receives nothing folds the op's identity into chunk 0. The port does the
same, in the same order, so fp32 results equal the reference's bit for
bit. Within a tick a rank sends one chunk and receives another, so rows
update in place; receivers fold first, reading the senders' chunks before
any identity fold touches them. Loops run substep-outer, one step span per
substep (the reference's one permute), in its order: tick, tree, substep.

This is a Python loop over (C + depth - 1) ticks x 2 trees x the ranks,
one small tensor op each: at C = 64 (``ptree_auto_chunks`` above 1 MiB a
rank) a call launches thousands of them.
"""

from __future__ import annotations

import functools

import torch

from rocnrdma_tpu_torch.collectives._steps import step_span
from rocnrdma_tpu_torch.collectives.reduce_op import finalize, fold_, fold_identity_
from rocnrdma_tpu_torch.collectives.schedule import dbtree_parents, ptree_ticks

PTREE_CHUNKS = 8  # the reference's fixed depth before it scaled with size

# size-scaled pipeline depth: as many chunks as keep each at least
# PTREE_MIN_CHUNK_ELEMS, capped so the tick tables stay small
PTREE_MIN_CHUNK_ELEMS = 4096
PTREE_MAX_CHUNKS = 64


def ptree_auto_chunks(size_elems: int) -> int:
    """Pipeline depth C for a buffer of ``size_elems`` elements a rank: as
    many chunks as keep each >= ``PTREE_MIN_CHUNK_ELEMS``, in [1, 64]. It
    follows the element count, so a bf16 buffer gets the depth of an fp32
    buffer with as many elements, not as many bytes."""
    half = -(-max(1, size_elems) // 2)
    return max(1, min(PTREE_MAX_CHUNKS, half // PTREE_MIN_CHUNK_ELEMS))


@functools.lru_cache(maxsize=None)
def _tick_tables(n: int, chunks: int):
    """Per tree, (up, down): per tick a list of substeps, each a dict
    receiver -> (sender, chunk the sender sends = chunk the receiver
    lands)."""
    trees = []
    for parents in dbtree_parents(n):
        phases = []
        for table in ptree_ticks(parents, chunks):
            phases.append([[{d: (s, i) for s, d, i in sub} for sub in tick]
                           for tick in table])
        trees.append(tuple(phases))
    return trees


def ptree_allreduce(x: torch.Tensor, op: str = "sum",
                    chunks: int | None = None) -> torch.Tensor:
    """Allreduce of rank-major ``x`` via the chunk-pipelined double binary
    tree (``op``: sum/prod/max/min/avg). ``chunks``: pipeline depth C,
    default ``ptree_auto_chunks`` of a rank's element count."""
    n = x.shape[0]
    if n == 1:
        return finalize(x.clone(), op, 1)
    flat = x.reshape(n, -1)
    size = flat.shape[1]
    if chunks is None:
        chunks = ptree_auto_chunks(size)
    if chunks < 1:
        raise ValueError(f"ptree needs chunks >= 1, got {chunks}")
    half = -(-size // 2)
    csize = -(-half // chunks)
    halves = [flat.new_zeros((n, chunks, csize)) for _ in range(2)]
    halves[0].view(n, -1)[:, :half] = flat[:, :half]
    halves[1].view(n, -1)[:, :size - half] = flat[:, half:]
    trees = _tick_tables(n, chunks)

    for t in range(len(trees[0][0])):  # up: reduce toward the roots
        for ti, ((up, _), h) in enumerate(zip(trees, halves)):
            subs = up[t]
            if not subs:
                continue
            receivers = sorted(set().union(*subs))
            # both of a tick's arrivals at r carry the same chunk
            idx = {r: next(m[r][1] for m in subs if r in m) for r in receivers}
            for k, m in enumerate(subs):
                with step_span(f"ptree{ti} up tick {t} substep {k}"):
                    for r in receivers:
                        if r in m:
                            fold_(h[r, idx[r]], h[m[r][0], idx[r]], op)
                        else:
                            fold_identity_(h[r, idx[r]], op)
                    if k == len(subs) - 1:  # every send of the tick is read
                        for r in range(n):
                            if r not in receivers:
                                fold_identity_(h[r, 0], op)
    for t in range(len(trees[0][1])):  # down: stream the totals back
        for ti, ((_, down), h) in enumerate(zip(trees, halves)):
            for k, m in enumerate(down[t]):
                with step_span(f"ptree{ti} down tick {t} substep {k}"):
                    for c, (p, i) in m.items():
                        h[c, i] = h[p, i]

    out = torch.cat([halves[0].view(n, -1)[:, :half],
                     halves[1].view(n, -1)[:, :size - half]], dim=1)
    return finalize(out.reshape(x.shape), op, n)
