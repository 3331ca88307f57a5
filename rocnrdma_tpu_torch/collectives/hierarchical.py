"""Hierarchical schedules over a 2-D ``('slice', 'intra')`` mesh: the
allreduce that reduce-scatters within each slice, allreduces the shard
across slices and allgathers within each slice, and the alltoall that
crosses slices once per chunk.

Counterpart of ``rocnrdma_tpu/collectives/hierarchical.py``. The input is
rank-major over the flattened mesh, rank ``s * per_slice + i``; a phase
over the intra axis runs the 1-D schedule on each slice's rows, a phase
over the slice axis on each intra index's rows. Each phase is the port's
schedule of the same name, so fp32 results equal the reference's bit for
bit where the phases' do (the ``ring`` and ``khd`` intra phases and the
``ring`` cross phase; ``fused`` is torch's order of summation). With every
rank on one device, "across slices" is the same memory as "within".
"""

from __future__ import annotations

import torch

from rocnrdma_tpu_torch.collectives.alltoall import bruck_alltoall, rotation_alltoall
from rocnrdma_tpu_torch.collectives.fused import fused_alltoall
from rocnrdma_tpu_torch.collectives.khd import khd_allgather, khd_reduce_scatter
from rocnrdma_tpu_torch.collectives.reduce_op import finalize, fused_reduce
from rocnrdma_tpu_torch.collectives.ring import (
    ring_allgather,
    ring_allreduce,
    ring_reduce_scatter,
)


def _dtype(spec) -> torch.dtype | None:
    if spec is None or isinstance(spec, torch.dtype):
        return spec
    return getattr(torch, str(spec))


def hierarchical_allreduce(x: torch.Tensor, mesh_shape, *,
                           intra_algo: str = "ring", cross_algo: str = "ring",
                           cross_dtype=None, op: str = "sum") -> torch.Tensor:
    """Allreduce of ``x`` (rank-major over the flattened ``mesh_shape =
    (slices, per_slice)`` mesh) in three phases.

    ``intra_algo``: ``ring`` or ``khd`` (mixed-radix, bidirectional) for the
    two intra-slice phases. ``cross_algo``: ``ring`` or ``fused`` for the
    cross-slice phase. ``cross_dtype``: the dtype of the cross-slice phase
    only (the shard is cast down before it and back after; sum/avg only).
    ``op``: sum/prod/max/min/avg; ``avg`` sums both levels and divides
    once, at the end."""
    m, n = mesh_shape
    inner = "sum" if op == "avg" else op  # a single finalize at the end
    shape = x.shape
    flat = x.reshape(m * n, -1)
    size = flat.shape[1]
    pad = (-size) % n
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))

    wire = _dtype(cross_dtype)
    if wire is not None and wire != x.dtype and inner != "sum":
        raise ValueError(
            f"cross_dtype only composes with op sum/avg, got op={op!r}")
    if m == 1:
        wire = None  # nothing crosses slices: casting would only round

    if intra_algo == "khd":
        rs = lambda v: khd_reduce_scatter(v, op=inner)
        ag = lambda v: khd_allgather(v).reshape(n, -1)
    elif intra_algo == "ring":
        rs = lambda v: ring_reduce_scatter(v, op=inner)
        ag = ring_allgather
    else:
        raise ValueError(f"intra_algo must be ring|khd, got {intra_algo!r}")

    g = flat.reshape(m, n, -1)
    shard = torch.stack([rs(g[s]) for s in range(m)])  # (m, n, L/n)
    orig = shard.dtype
    if wire is not None and wire != orig:
        shard = shard.to(wire)
    if cross_algo == "fused":
        red = torch.stack([fused_reduce(shard[:, i], inner) for i in range(n)])
        shard = red.unsqueeze(0).expand(shard.shape)
    elif cross_algo == "ring":
        shard = torch.stack([ring_allreduce(shard[:, i].contiguous(), op=inner)
                             for i in range(n)], dim=1)
    else:  # the same fail-fast as intra_algo: a typo must not silently ring
        raise ValueError(f"cross_algo must be ring|fused, got {cross_algo!r}")
    if wire is not None and wire != orig:
        shard = shard.to(orig)
    full = torch.stack([ag(shard[s]) for s in range(m)]).reshape(m * n, -1)
    return finalize(full[:, :size].reshape(shape), op, m * n)


def _alltoall_1d(x: torch.Tensor, algo: str) -> torch.Tensor:
    if algo == "fused":
        return fused_alltoall(x)
    if algo == "rotation":
        return rotation_alltoall(x)
    if algo == "bruck":
        return bruck_alltoall(x)
    raise ValueError(f"unknown per-axis alltoall algo {algo!r}")


def hierarchical_alltoall(x: torch.Tensor, mesh_shape, *,
                          intra_algo: str = "fused",
                          cross_algo: str = "fused") -> torch.Tensor:
    """Global alltoall of ``x`` (rank-major over the flattened mesh, shape
    ``(N, N, c...)`` with N = slices * per_slice; chunk g of a rank is for
    global rank g), in two phases: an intra-slice alltoall of bundles by
    destination intra index, then a cross-slice alltoall of bundles by
    destination slice between ranks of the same intra index. Every chunk
    crosses slices once. ``intra_algo`` / ``cross_algo``: ``fused``
    (default), ``rotation`` or ``bruck``."""
    m, n = mesh_shape
    if x.dim() < 2 or x.shape[1] != m * n:
        raise ValueError(f"leading dim {x.shape[1] if x.dim() > 1 else None} "
                         f"!= mesh size {m * n}")
    rest = tuple(x.shape[2:])
    # b[s, i, t, j]: rank (s, i)'s block for rank (t, j)
    b = x.reshape((m, n, m, n) + rest)
    # phase 1, within each slice: rank (s, i) sends its blocks for intra j,
    # bundled [j, t], to (s, j); it ends with [src intra i', dest slice t]
    in1 = b.transpose(2, 3)
    out1 = torch.stack([_alltoall_1d(in1[s], intra_algo) for s in range(m)])
    # phase 2, across slices: rank (s, i) sends its [dest slice t] bundles
    # to (t, i); it ends with [src slice t', src intra i']
    in2 = out1.transpose(2, 3)
    out2 = torch.stack([_alltoall_1d(in2[:, i], cross_algo) for i in range(n)],
                       dim=1)
    return out2.reshape(x.shape)
