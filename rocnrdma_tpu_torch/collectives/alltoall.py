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
- ``rotation_rows`` / ``bruck_rows``: the same for B meshes in lockstep
  (the hierarchical alltoall's phases), one step span a step;
- ``ragged_mask`` and ``fused_alltoallv``: the ragged alltoallv on a static
  capacity, masked at the receiver.
"""

from __future__ import annotations

import torch

from rocnrdma_tpu_torch.collectives._steps import step_span
from rocnrdma_tpu_torch.collectives.fused import alltoall_ranks, fused_alltoall
from rocnrdma_tpu_torch.collectives.schedule import bruck_mask, bruck_phases


def rotation_alltoall(x: torch.Tensor) -> torch.Tensor:
    """Alltoall in n-1 rotation steps: at step s rank r ships chunk
    ``(r+s) mod n`` to rank r+s, which stores it in slot ``(r+s) - s = r``."""
    alltoall_ranks(x)
    return rotation_rows(x[None])[0]


def rotation_rows(xb: torch.Tensor, tag: str = "rotation") -> torch.Tensor:
    """The rotation alltoall of B meshes at once: (B, n, n, c...), one step
    span a step."""
    n = xb.shape[1]
    if n == 1:
        return xb.clone()
    r = torch.arange(n, device=xb.device)
    out = xb.clone()
    # the rank and chunk axes lead, so a step indexes them first
    src, dst = xb.movedim(0, 2), out.movedim(0, 2)
    for s in range(1, n):
        with step_span(f"{tag} a2a step {s - 1}"):
            chunk = src[r, (r + s) % n]                  # a2a_send_chunk
            recvd = torch.roll(chunk, shifts=s, dims=0)  # rank r gets r-s's
            dst[r, (r - s) % n] = recvd                  # a2a_recv_slot
    return out


def bruck_alltoall(x: torch.Tensor) -> torch.Tensor:
    """Alltoall in ceil(log2 n) exchange steps (Bruck's algorithm), with
    the reference's phase order and index masks."""
    alltoall_ranks(x)
    return bruck_rows(x[None])[0]


def bruck_rows(xb: torch.Tensor) -> torch.Tensor:
    """Bruck's alltoall of B meshes at once: (B, n, n, c...), one step span
    a phase."""
    n = xb.shape[1]
    if n == 1:
        return xb.clone()
    r = torch.arange(n, device=xb.device)
    i = torch.arange(n, device=xb.device)
    # phase 0: local rotation so the chunk destined to self sits at index 0;
    # the rank and chunk axes lead, so each step indexes them first
    buf = xb.movedim(0, 2)[r[:, None], (i[None, :] + r[:, None]) % n]
    # log-phases: positions with bit k set travel k ranks forward
    for k in bruck_phases(n):
        with step_span(f"bruck phase {k}"):
            idx = torch.tensor(bruck_mask(n, k), device=xb.device)
            buf[:, idx] = torch.roll(buf[:, idx], shifts=k, dims=0)
    # final: chunk i on rank r arrived from rank (r - i) mod n
    return buf[r[:, None], (r[:, None] - i[None, :]) % n].movedim(2, 0)


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
