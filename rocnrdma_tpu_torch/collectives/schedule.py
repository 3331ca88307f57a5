"""Ring schedule indices and the numpy ring simulator.

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
