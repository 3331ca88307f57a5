"""Alltoall, the MoE dispatch/combine primitive, as explicit PyTorch
schedules on rank-major tensors.

Counterpart of ``rocnrdma_tpu/collectives/alltoall.py``. Input ``x`` has
shape ``(n, n, c...)``: ``x[r, d]`` is rank r's chunk destined for rank d.
The output has the same shape, ``out[r, j]`` = what rank j sent rank r
(the global transpose). Where the reference rotates chunks with
``lax.ppermute``, a shift-by-s step here is ``torch.roll`` over the rank
axis: rank r receives the row rank r-s sent. These arms only copy, so they
equal the reference bit for bit in every dtype.

- ``rotation_alltoall``: n-1 steps (the ``ring`` arm of alltoall);
- ``bruck_alltoall``: ceil(log2 n) steps, each chunk relayed up to log2 n
  times (the ``bruck`` arm);
- ``ragged_mask`` and ``fused_alltoallv``: the ragged alltoallv on a static
  capacity, masked at the receiver.
"""

from __future__ import annotations

import torch

from rocnrdma_tpu_torch.collectives.fused import alltoall_ranks, fused_alltoall
from rocnrdma_tpu_torch.collectives.schedule import bruck_mask, bruck_phases


def rotation_alltoall(x: torch.Tensor) -> torch.Tensor:
    """Alltoall in n-1 rotation steps: at step s rank r ships chunk
    ``(r+s) mod n`` to rank r+s, which stores it in slot ``(r+s) - s = r``."""
    n = alltoall_ranks(x)
    if n == 1:
        return x.clone()
    r = torch.arange(n, device=x.device)
    out = x.clone()
    for s in range(1, n):
        chunk = x[r, (r + s) % n]                  # a2a_send_chunk
        recvd = torch.roll(chunk, shifts=s, dims=0)  # rank r gets r-s's
        out[r, (r - s) % n] = recvd                # a2a_recv_slot
    return out


def bruck_alltoall(x: torch.Tensor) -> torch.Tensor:
    """Alltoall in ceil(log2 n) exchange steps (Bruck's algorithm), with
    the reference's phase order and index masks."""
    n = alltoall_ranks(x)
    if n == 1:
        return x.clone()
    r = torch.arange(n, device=x.device)
    i = torch.arange(n, device=x.device)
    # phase 0: local rotation so the chunk destined to self sits at index 0
    buf = x[r[:, None], (i[None, :] + r[:, None]) % n]
    # log-phases: positions with bit k set travel k ranks forward
    for k in bruck_phases(n):
        idx = torch.tensor(bruck_mask(n, k), device=x.device)
        buf[:, idx] = torch.roll(buf[:, idx], shifts=k, dims=0)
    # final: chunk i on rank r arrived from rank (r - i) mod n
    return buf[r[:, None], (r[:, None] - i[None, :]) % n]


def ragged_mask(out: torch.Tensor, counts) -> tuple[torch.Tensor, torch.Tensor]:
    """Receiver-side masking of a ragged alltoall: zero the rows of
    ``out[me, src]`` at positions >= ``counts[src, me]``; return
    ``(masked, recv_counts)`` with ``recv_counts[me] = counts[:, me]``.
    ``out``: (n, n, max_count, ...); ``counts``: the (n, n) element-count
    matrix every rank knows (the MPI alltoallv contract)."""
    n = out.shape[0]
    counts = torch.as_tensor(counts, device=out.device)
    if tuple(counts.shape) != (n, n):
        raise ValueError(f"counts must be ({n}, {n}), got {tuple(counts.shape)}")
    recv_counts = counts.transpose(0, 1).contiguous()
    row = torch.arange(out.shape[2], device=out.device)
    mask = row[None, None, :] < recv_counts[:, :, None]   # (n, n, max_count)
    mask = mask.reshape(mask.shape + (1,) * (out.dim() - 3))
    return torch.where(mask, out, torch.zeros((), dtype=out.dtype,
                                              device=out.device)), recv_counts


def fused_alltoallv(x: torch.Tensor, counts) -> tuple[torch.Tensor, torch.Tensor]:
    """Ragged alltoall on the library path: the full static capacity moves
    every time (one transpose), then the receiver masks to the counts.
    ``x``: (n, n, max_count, ...), chunk ``x[r, d]`` carries
    ``counts[r, d]`` valid rows for rank d. Returns ``(out, recv_counts)``."""
    return ragged_mask(fused_alltoall(x), counts)
