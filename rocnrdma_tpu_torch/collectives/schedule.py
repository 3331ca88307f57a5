"""Ring and alltoall schedule indices and their numpy simulators.

Copied from ``rocnrdma_tpu/collectives/schedule.py`` (the port imports
nothing of the JAX package); the tests pin these equal to the reference's.

**Ring allreduce.** Each rank's buffer is split into n chunks. Phase 1,
reduce-scatter, n-1 steps: at step s rank r sends chunk ``(r - s) mod n``
to rank ``(r+1) mod n`` and adds the chunk it receives. After n-1 steps
rank r holds the fully reduced chunk ``(r + 1) mod n``. Phase 2, allgather,
n-1 steps: at step s rank r sends chunk ``(r + 1 - s) mod n``. Traffic per
rank: ``2 (n-1)/n * S``, the busbw factor in metrics.py.
"""

from __future__ import annotations

import numpy as np


def ring_permutation(n: int, shift: int = 1) -> list[tuple[int, int]]:
    """The (src, dst) pairs of a rotate-by-``shift`` step."""
    return [(r, (r + shift) % n) for r in range(n)]


def ring_rs_send_chunk(n: int, step: int, rank: int) -> int:
    """Chunk index ``rank`` transmits at reduce-scatter step ``step``."""
    return (rank - step) % n


def ring_rs_recv_chunk(n: int, step: int, rank: int) -> int:
    """Chunk index ``rank`` receives (and accumulates) at RS step ``step``."""
    return (rank - step - 1) % n


def ring_owned_chunk(n: int, rank: int) -> int:
    """Chunk fully reduced on ``rank`` after the n-1 reduce-scatter steps."""
    return (rank + 1) % n


def ring_ag_send_chunk(n: int, step: int, rank: int) -> int:
    """Chunk index ``rank`` transmits at allgather step ``step``."""
    return (rank + 1 - step) % n


def ring_ag_recv_chunk(n: int, step: int, rank: int) -> int:
    return (rank - step) % n


def sim_ring_allreduce(bufs: np.ndarray) -> np.ndarray:
    """Simulate the ring schedule on a (n, n*chunk) array, one row per rank."""
    n = bufs.shape[0]
    bufs = bufs.reshape(n, n, -1).copy()  # (rank, chunk, elems)
    for step in range(n - 1):
        sent = {r: bufs[r, ring_rs_send_chunk(n, step, r)].copy() for r in range(n)}
        for src, dst in ring_permutation(n):
            bufs[dst, ring_rs_recv_chunk(n, step, dst)] += sent[src]
    for step in range(n - 1):
        sent = {r: bufs[r, ring_ag_send_chunk(n, step, r)].copy() for r in range(n)}
        for src, dst in ring_permutation(n):
            bufs[dst, ring_ag_recv_chunk(n, step, dst)] = sent[src]
    return bufs.reshape(n, -1)


# ---------------------------------------------------------------------------
# Alltoall rotation: n-1 steps; at step s every rank ships the chunk destined
# s ranks ahead along a shift-by-s ring permutation.


def a2a_send_chunk(n: int, step: int, rank: int) -> int:
    """Chunk index ``rank`` transmits at rotation step ``step`` (1-based)."""
    return (rank + step) % n


def a2a_recv_slot(n: int, step: int, rank: int) -> int:
    """Slot where ``rank`` stores the chunk received at rotation step ``step``."""
    return (rank - step) % n


def sim_alltoall(bufs: np.ndarray) -> np.ndarray:
    """Simulate the rotation alltoall on a (n, n*chunk) array: out[j, i] = in[i, j]."""
    n = bufs.shape[0]
    bufs = bufs.reshape(n, n, -1)
    out = bufs.copy()
    for step in range(1, n):
        sent = {r: bufs[r, a2a_send_chunk(n, step, r)].copy() for r in range(n)}
        for src, dst in ring_permutation(n, shift=step):
            out[dst, a2a_recv_slot(n, step, dst)] = sent[src]
    return out.reshape(n, -1)


# ---------------------------------------------------------------------------
# Bruck alltoall (log-step; latency-optimal for small messages)


def bruck_phases(n: int) -> list[int]:
    """Shift distances 1, 2, 4, ... < n. Works for any n (not just 2^k)."""
    out, k = [], 1
    while k < n:
        out.append(k)
        k <<= 1
    return out


def bruck_mask(n: int, k: int) -> list[int]:
    """Chunk positions exchanged at phase k: indices with bit k set."""
    return [i for i in range(n) if i & k]


def sim_bruck_alltoall(bufs: np.ndarray) -> np.ndarray:
    """Simulate Bruck on a (n, n*chunk) array: same transpose semantics as
    the rotation algorithm in (n-1) -> ceil(log2 n) steps, at the cost of
    moving each chunk up to log2(n) times ((n/2)*log2(n) total traffic)."""
    n = bufs.shape[0]
    x = bufs.reshape(n, n, -1)
    # phase 0: local upward rotation so each rank's self-chunk sits at 0
    buf = np.stack([np.roll(x[r], -r, axis=0) for r in range(n)])
    for k in bruck_phases(n):
        idx = bruck_mask(n, k)
        sent = {r: buf[r, idx].copy() for r in range(n)}
        for src, dst in ring_permutation(n, shift=k):
            buf[dst, idx] = sent[src]
    # final: chunk i on rank r came from rank (r - i) mod n
    out = np.empty_like(buf)
    for r in range(n):
        for i in range(n):
            out[r, (r - i) % n] = buf[r, i]
    return out.reshape(n, -1)
