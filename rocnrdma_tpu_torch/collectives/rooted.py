"""Rooted collectives: broadcast, reduce, gather and scatter over binomial
trees (the ``binomial`` arm of each rooted verb).

Counterpart of ``rocnrdma_tpu/collectives/rooted.py``: ceil(log2 n) steps
each, over virtual ranks ``v = (r - root) mod n`` so any root reuses the
root-0 schedule. Where the reference ships a buffer with ``lax.ppermute``,
a step here copies (or folds) rank rows of one rank-major tensor, for the
pairs ``schedule.bcast_pairs`` / ``schedule.gather_pairs`` give; senders
and receivers of one step are disjoint, so rows update in place.

- Each step of broadcast and reduce runs in one step span (``trace.py``
  traces those two).
- Reduce folds ``combine(mine, recvd)`` in the reference's order, so fp32
  results equal the reference's bit for bit; broadcast, gather and
  scatter only move data.
- Only root's input is read by scatter; off-root rows of reduce and
  gather are zeroed, as in the reference (RCCL leaves them undefined).
- Gather and scatter keep slot buffers in virtual-rank order, so each
  binomial subtree is a contiguous slot range, padded to the next power of
  two (``schedule.pow2_pad``) so wrap-around subtrees stay in range.
- Across processes (``span``: the rank axis of a 1-D mesh, one rank a
  process) ``x`` is this process's row and each step is one
  ``_exchange.permute_rows`` of its pairs; the sender ships the slot
  range its receiver lands, which both can compute from the vranks.
"""

from __future__ import annotations

import torch

from rocnrdma_tpu_torch.collectives._exchange import permute_rows
from rocnrdma_tpu_torch.collectives._steps import step_span
from rocnrdma_tpu_torch.collectives.reduce_op import finalize, fold_
from rocnrdma_tpu_torch.collectives.schedule import (
    bcast_pairs,
    binomial_masks,
    gather_pairs,
    pow2_pad,
)


def _vranks(n: int, root: int) -> list[int]:
    return [(r - root) % n for r in range(n)]


def _ranks(x: torch.Tensor, span) -> tuple[int, range]:
    """The axis's rank count and the ranks whose rows ``x`` holds."""
    if span is None:
        return x.shape[0], range(x.shape[0])
    return span.size, range(span.index, span.index + 1)


def _own_slots(v: list[int], held: range, device) -> tuple:
    """Index of every held rank's own slot (its row, slot vrank r)."""
    return (torch.arange(len(held), device=device),
            torch.tensor([v[r] for r in held], device=device))


def _partner_pair(pairs, me: int):
    """The (src, dst) pair this rank is in, or None."""
    return next(((s, d) for s, d in pairs if me in (s, d)), None)


def binomial_broadcast(x: torch.Tensor, root: int = 0, span=None) -> torch.Tensor:
    """Every row becomes row ``root``: recursive doubling, whole-row
    messages. ``span``: the rank axis across processes, ``x`` this
    process's row."""
    n, _ = _ranks(x, span)
    out = x.clone()
    for m in binomial_masks(n):
        with step_span(f"broadcast mask {m}"):
            pairs = bcast_pairs(n, m, root)
            if span is None:
                for src, dst in pairs:
                    out[dst].copy_(out[src])
                continue
            recvd = permute_rows(out, pairs, span)
            if recvd is not None:
                out = recvd
    return out


def binomial_reduce(x: torch.Tensor, root: int = 0,
                    op: str = "sum", span=None) -> torch.Tensor:
    """Row ``root`` becomes the ``op``-reduction of all rows, the others
    zero: the broadcast tree run in reverse, descending masks, each
    receiver folding what its partner sends. ``span``: as in
    ``binomial_broadcast``."""
    n, held = _ranks(x, span)
    buf = x.clone()
    if n == 1:
        return finalize(buf, op, 1)
    for m in reversed(binomial_masks(n)):
        with step_span(f"reduce mask {m}"):
            pairs = bcast_pairs(n, m, root)  # reversed flow: (recv, send)
            if span is None:
                for recv, send in pairs:
                    fold_(buf[recv], buf[send], op)
                continue
            recvd = permute_rows(buf, [(s, r) for r, s in pairs], span)
            if recvd is not None:
                fold_(buf[0], recvd[0], op)
    for i, r in enumerate(held):
        if r == root:
            buf[i] = finalize(buf[i], op, n)
        else:
            buf[i].zero_()
    return buf


def binomial_gather(x: torch.Tensor, root: int = 0, span=None) -> torch.Tensor:
    """(n, ...) -> (n, n, ...): row ``root`` holds every rank's row in rank
    order, the others zero. At step m, vranks = m (mod 2m) ship their
    m-slot subtree to vrank - m. ``span``: as in ``binomial_broadcast``."""
    n, held = _ranks(x, span)
    if n == 1:
        return x.unsqueeze(1).clone()
    v = _vranks(n, root)
    slot = x.new_zeros((len(held), pow2_pad(n)) + tuple(x.shape[1:]))
    slot[_own_slots(v, held, x.device)] = x
    for m in binomial_masks(n):
        pairs = gather_pairs(n, m, root)
        if span is None:
            for src, dst in pairs:
                # the sender's subtree starts at its own vrank, which is
                # where the receiver (vrank - m) stores it
                s = v[src]
                slot[dst, s:s + m] = slot[src, s:s + m]
            continue
        pair = _partner_pair(pairs, span.index)
        s = v[pair[0]] if pair else 0
        recvd = permute_rows(slot[:, s:s + m], pairs, span)
        if recvd is not None:
            slot[0, s:s + m] = recvd[0]
    out = torch.zeros_like(slot[:, :n])
    # vrank slot s holds true rank (s + root) mod n: emit true-rank order
    for i, r in enumerate(held):
        if r == root:
            out[i] = slot[i, [v[t] for t in range(n)]]
    return out


def binomial_scatter(x: torch.Tensor, root: int = 0, span=None) -> torch.Tensor:
    """Row ``root`` (flattening to n*c) is split n ways; row r of the
    result is its chunk r. Halving: at step m (descending) vranks = 0
    (mod 2m) ship the upper half of their 2m-slot block to vrank + m.
    ``span``: as in ``binomial_broadcast``."""
    n, held = _ranks(x, span)
    flat = x.reshape(len(held), -1)
    if n == 1:
        return flat.clone()
    if flat.shape[1] % n:
        raise ValueError(f"scatter buffer ({flat.shape[1]} elems) must divide "
                         f"by axis size {n}")
    v = _vranks(n, root)
    # root's chunks, rotated into vrank slot order (slot s = chunk s+root),
    # padded to a power of two; the other ranks start zeroed
    slot = flat.new_zeros((len(held), pow2_pad(n), flat.shape[1] // n))
    for i, r in enumerate(held):
        if r == root:
            slot[i, :n] = flat[i].reshape(n, -1)[[(s + root) % n for s in range(n)]]
    for m in reversed(binomial_masks(n)):
        pairs = gather_pairs(n, m, root)  # reversed flow: (recv, send)
        if span is None:
            for recv, send in pairs:
                # upper half of the sender's 2m-aligned block: its payload
                # and the receiver's landing slots
                up = (v[recv] // (2 * m)) * (2 * m) + m
                slot[recv, up:up + m] = slot[send, up:up + m]
            continue
        pair = _partner_pair(pairs, span.index)
        up = (v[pair[0]] // (2 * m)) * (2 * m) + m if pair else 0
        recvd = permute_rows(slot[:, up:up + m], [(s, r) for r, s in pairs], span)
        if recvd is not None:
            slot[0, up:up + m] = recvd[0]
    return slot[_own_slots(v, held, x.device)]
