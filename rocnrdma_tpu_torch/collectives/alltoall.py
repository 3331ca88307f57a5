"""Alltoall, the MoE dispatch/combine primitive, as explicit PyTorch
schedules on rank-major tensors.

Counterpart of ``rocnrdma_tpu/collectives/alltoall.py``. Input ``x`` has
shape ``(n, n, c...)``: ``x[r, d]`` is rank r's chunk destined for rank d.
The output has the same shape, ``out[r, j]`` = what rank j sent rank r
(the global transpose). Where the reference rotates chunks with
``lax.ppermute``, a shift-by-s step here is ``_exchange.shift_rows`` over
the rank axis (``torch.roll``, or across processes a send and a receive):
rank r receives the row rank r-s sent. These arms only copy, so they
equal the reference bit for bit in every dtype.

- ``rotation_alltoall``: n-1 steps (the ``ring`` arm of alltoall);
- ``bruck_alltoall``: ceil(log2 n) steps, each chunk relayed up to log2 n
  times (the ``bruck`` arm);
- ``rotation_rows`` / ``bruck_rows``: the same for B meshes in lockstep
  (the hierarchical alltoall's phases), one step span a step;
- ``ragged_mask`` and ``fused_alltoallv``: the ragged alltoallv on a static
  capacity, masked at the receiver.

Each also runs over a rank axis that spans processes (``span``: the rank
axis of a 1-D mesh or the slice axis of a 2-D one), ``x`` then this
process's row ``(1, n, c...)``.
"""

from __future__ import annotations

import torch

from rocnrdma_tpu_torch.collectives._exchange import (
    ring_positions,
    shift_rows,
    spanning_fused_alltoall,
)
from rocnrdma_tpu_torch.collectives._steps import step_span
from rocnrdma_tpu_torch.collectives.fused import alltoall_ranks, fused_alltoall
from rocnrdma_tpu_torch.collectives.schedule import bruck_mask, bruck_phases


def _axis(x: torch.Tensor, span) -> None:
    """Check an alltoall input: (n, n, c...), or across processes this
    process's row (1, n, c...)."""
    if span is None:
        alltoall_ranks(x)
    elif x.dim() < 2 or x.shape[0] != 1 or x.shape[1] != span.size:
        raise ValueError(f"expected this process's row (1, {span.size}, ...), "
                         f"got {tuple(x.shape)}")


def rotation_alltoall(x: torch.Tensor, span=None) -> torch.Tensor:
    """Alltoall in n-1 rotation steps: at step s rank r ships chunk
    ``(r+s) mod n`` to rank r+s, which stores it in slot ``(r+s) - s = r``."""
    _axis(x, span)
    return rotation_rows(x[None], span=span)[0]


def rotation_rows(xb: torch.Tensor, tag: str = "rotation",
                  span=None) -> torch.Tensor:
    """The rotation alltoall of B meshes at once: (B, n, n, c...), one step
    span a step. With ``span`` the rank axis is the slice axis across
    processes: (B, 1, n, c...), this process's rank."""
    n = xb.shape[2]
    if n == 1:
        return xb.clone()
    rows, r = ring_positions(n, span, xb.device)
    out = xb.clone()
    # the rank and chunk axes lead, so a step indexes them first
    src, dst = xb.movedim(0, 2), out.movedim(0, 2)
    for s in range(1, n):
        with step_span(f"{tag} a2a step {s - 1}"):
            chunk = src[rows, (r + s) % n]               # a2a_send_chunk
            recvd = shift_rows(chunk, s, 0, span)        # rank r gets r-s's
            dst[rows, (r - s) % n] = recvd               # a2a_recv_slot
    return out


def bruck_alltoall(x: torch.Tensor, span=None) -> torch.Tensor:
    """Alltoall in ceil(log2 n) exchange steps (Bruck's algorithm), with
    the reference's phase order and index masks."""
    _axis(x, span)
    return bruck_rows(x[None], span=span)[0]


def bruck_rows(xb: torch.Tensor, span=None) -> torch.Tensor:
    """Bruck's alltoall of B meshes at once: (B, n, n, c...), one step span
    a phase. With ``span`` the rank axis is the slice axis across
    processes: (B, 1, n, c...), this process's rank; each phase's masked
    block goes k ranks forward through ``_exchange.shift_rows``."""
    n = xb.shape[2]
    if n == 1:
        return xb.clone()
    rows, r = ring_positions(n, span, xb.device)
    i = torch.arange(n, device=xb.device)
    # phase 0: local rotation so the chunk destined to self sits at index 0;
    # the rank and chunk axes lead, so each step indexes them first
    buf = xb.movedim(0, 2)[rows[:, None], (i[None, :] + r[:, None]) % n]
    # log-phases: positions with bit k set travel k ranks forward
    for k in bruck_phases(n):
        with step_span(f"bruck phase {k}"):
            idx = torch.tensor(bruck_mask(n, k), device=xb.device)
            buf[:, idx] = shift_rows(buf[:, idx], k, 0, span)
    # final: chunk i on rank r arrived from rank (r - i) mod n
    return buf[rows[:, None], (r[:, None] - i[None, :]) % n].movedim(2, 0)


def ragged_mask(out: torch.Tensor, counts,
                span=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Receiver-side masking of a ragged alltoall: zero the rows of
    ``out[me, src]`` at positions >= ``counts[src, me]``; return
    ``(masked, recv_counts)`` with ``recv_counts[me] = counts[:, me]``.
    ``out``: (n, n, max_count, ...), or across processes (``span``) this
    process's row (1, n, max_count, ...) and its row of ``recv_counts``;
    ``counts``: the (n, n) element-count matrix every rank knows (the MPI
    alltoallv contract)."""
    n = out.shape[1]
    counts = torch.as_tensor(counts, device=out.device)
    if tuple(counts.shape) != (n, n):
        raise ValueError(f"counts must be ({n}, {n}), got {tuple(counts.shape)}")
    recv_counts = counts.transpose(0, 1).contiguous()
    if span is not None:
        recv_counts = recv_counts[span.index:span.index + 1]
    row = torch.arange(out.shape[2], device=out.device)
    mask = row[None, None, :] < recv_counts[:, :, None]   # (n, n, max_count)
    mask = mask.reshape(mask.shape + (1,) * (out.dim() - 3))
    return torch.where(mask, out, torch.zeros((), dtype=out.dtype,
                                              device=out.device)), recv_counts


def fused_alltoallv(x: torch.Tensor, counts,
                    span=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Ragged alltoall on the library path: the full static capacity moves
    every time (one transpose, or across processes one
    ``all_to_all_single``), then the receiver masks to the counts. ``x``:
    (n, n, max_count, ...), chunk ``x[r, d]`` carries ``counts[r, d]``
    valid rows for rank d. Returns ``(out, recv_counts)``."""
    if span is None:
        return ragged_mask(fused_alltoall(x), counts)
    _axis(x, span)
    return ragged_mask(spanning_fused_alltoall(x, (span.size, 1), span), counts, span)
