"""Rooted collectives: broadcast, reduce, gather and scatter over binomial
trees (the ``binomial`` arm of each rooted verb).

Counterpart of ``rocnrdma_tpu/collectives/rooted.py``: ceil(log2 n) steps
each, over virtual ranks ``v = (r - root) mod n`` so any root reuses the
root-0 schedule. Where the reference ships a buffer with ``lax.ppermute``,
a step here copies (or folds) rank rows of one rank-major tensor, for the
pairs ``schedule.bcast_pairs`` / ``schedule.gather_pairs`` give; senders
and receivers of one step are disjoint, so rows update in place.

- Reduce folds ``combine(mine, recvd)`` in the reference's order, so fp32
  results equal the reference's bit for bit; broadcast, gather and
  scatter only move data.
- Only root's input is read by scatter; off-root rows of reduce and
  gather are zeroed, as in the reference (RCCL leaves them undefined).
- Gather and scatter keep slot buffers in virtual-rank order, so each
  binomial subtree is a contiguous slot range, padded to the next power of
  two (``schedule.pow2_pad``) so wrap-around subtrees stay in range.
"""

from __future__ import annotations

import torch

from rocnrdma_tpu_torch.collectives.reduce_op import finalize, fold_
from rocnrdma_tpu_torch.collectives.schedule import (
    bcast_pairs,
    binomial_masks,
    gather_pairs,
    pow2_pad,
)


def _vranks(n: int, root: int) -> list[int]:
    return [(r - root) % n for r in range(n)]


def _own_slots(n: int, v: list[int], device) -> tuple:
    """Index of every rank's own slot (row r, slot vrank r)."""
    return torch.arange(n, device=device), torch.tensor(v, device=device)


def binomial_broadcast(x: torch.Tensor, root: int = 0) -> torch.Tensor:
    """Every row becomes row ``root``: recursive doubling, whole-row
    messages."""
    out = x.clone()
    for m in binomial_masks(x.shape[0]):
        for src, dst in bcast_pairs(x.shape[0], m, root):
            out[dst].copy_(out[src])
    return out


def binomial_reduce(x: torch.Tensor, root: int = 0,
                    op: str = "sum") -> torch.Tensor:
    """Row ``root`` becomes the ``op``-reduction of all rows, the others
    zero: the broadcast tree run in reverse, descending masks, each
    receiver folding what its partner sends."""
    n = x.shape[0]
    buf = x.clone()
    if n == 1:
        return finalize(buf, op, 1)
    for m in reversed(binomial_masks(n)):
        for recv, send in bcast_pairs(n, m, root):  # reversed flow
            fold_(buf[recv], buf[send], op)
    buf[root] = finalize(buf[root], op, n)
    for r in range(n):
        if r != root:
            buf[r].zero_()
    return buf


def binomial_gather(x: torch.Tensor, root: int = 0) -> torch.Tensor:
    """(n, ...) -> (n, n, ...): row ``root`` holds every rank's row in rank
    order, the others zero. At step m, vranks = m (mod 2m) ship their
    m-slot subtree to vrank - m."""
    n = x.shape[0]
    if n == 1:
        return x.unsqueeze(1).clone()
    v = _vranks(n, root)
    slot = x.new_zeros((n, pow2_pad(n)) + tuple(x.shape[1:]))
    slot[_own_slots(n, v, x.device)] = x
    for m in binomial_masks(n):
        for src, dst in gather_pairs(n, m, root):
            # the sender's subtree starts at its own vrank, which is where
            # the receiver (vrank - m) stores it
            s = v[src]
            slot[dst, s:s + m] = slot[src, s:s + m]
    out = torch.zeros_like(slot[:, :n])
    # vrank slot s holds true rank (s + root) mod n: emit true-rank order
    out[root] = slot[root, [v[t] for t in range(n)]]
    return out


def binomial_scatter(x: torch.Tensor, root: int = 0) -> torch.Tensor:
    """Row ``root`` (flattening to n*c) is split n ways; row r of the
    result is its chunk r. Halving: at step m (descending) vranks = 0
    (mod 2m) ship the upper half of their 2m-slot block to vrank + m."""
    n = x.shape[0]
    flat = x.reshape(n, -1)
    if n == 1:
        return flat.clone()
    if flat.shape[1] % n:
        raise ValueError(f"scatter buffer ({flat.shape[1]} elems) must divide "
                         f"by axis size {n}")
    v = _vranks(n, root)
    chunks = flat[root].reshape(n, -1)
    # root's chunks, rotated into vrank slot order (slot s = chunk s+root),
    # padded to a power of two; the other ranks start zeroed
    slot = flat.new_zeros((n, pow2_pad(n), chunks.shape[1]))
    slot[root, :n] = chunks[[(s + root) % n for s in range(n)]]
    for m in reversed(binomial_masks(n)):
        for recv, send in gather_pairs(n, m, root):  # reversed flow
            # upper half of the sender's 2m-aligned block: its payload and
            # the receiver's landing slots
            up = (v[recv] // (2 * m)) * (2 * m) + m
            slot[recv, up:up + m] = slot[send, up:up + m]
    return slot[_own_slots(n, v, x.device)]
