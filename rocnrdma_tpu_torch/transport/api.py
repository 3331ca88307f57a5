"""The Transport interface: rank-major collectives over a rank mesh.

Counterpart of ``rocnrdma_tpu/transport/api.py`` for the data-plane verbs
allreduce, reduce_scatter, allgather, alltoall and alltoallv. Data layout
contract: the leading tensor dim is the rank axis, ``x[r]`` is rank r's
buffer, and the result keeps that layout: every row the reduction
(allreduce), row r the reduced shard r (reduce_scatter, ``(n, S/n)``),
every row the concatenation (allgather, ``(n, n*c)``), row r's chunk j
what rank j sent rank r (alltoall, ``(n, n, c)``). In this slice every
rank lives on the mesh's one device.

Algorithms (``SCHEDULES``):

- ``"fused"`` - one library call over the rank axis (XLA's collectives in
  the reference).
- ``"ring"`` / ``"ring_bidir"`` - the explicit PyTorch ring schedules; for
  alltoall ``"ring"`` is the rotation schedule.
- ``"bruck"`` - the log-step alltoall.
- ``"cuda_ring"`` - the hand-written CUDA kernels (``pallas_ring`` in the
  reference): the ring kernel for allreduce, reduce_scatter and allgather,
  the direct alltoall kernel for alltoall(v). Allreduce and reduce_scatter
  are sum-only. The ring verbs take the tile policy below: one tile while
  a chunk (a rank's buffer over n; for allgather the rank's buffer) fits
  in one ``CUDA_RING_TILE_BYTES`` tile, else the fewest tiles of at most
  that size. Allreduce runs its tiled tier
  (``ring_cuda.hbm_ring_allreduce``) on a copy, so the caller's tensor is
  never changed.
- ``"auto"`` - ``RNR_ALGO`` when set and supported, else ``fused``.

``RNR_DEBUG=1`` logs one stderr line per verb dispatch.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from rocnrdma_tpu_torch import collectives as C
from rocnrdma_tpu_torch.collectives.reduce_op import REDUCE_OPS
from rocnrdma_tpu_torch.metrics import MiB
from rocnrdma_tpu_torch.ops import alltoall_cuda, ring_cuda
from rocnrdma_tpu_torch.runtime.mesh import RankMesh, detect_topology, rank_mesh

_DEBUG_LOG = os.environ.get("RNR_DEBUG", "") not in ("", "0")

ALGOS = ("auto", "fused", "ring", "ring_bidir", "bruck", "cuda_ring")

# The largest tile of the cuda_ring arm. The kernel pays ~19 us a
# (step, tile) hop on the H100, so time falls with the tile count until a
# tile carries a few MiB; 16 MiB tiles were as fast as any at 256 MiB and
# 1 GiB per rank (bench/bench_ring_tiles.py, PERF.md) and bound the comm
# slots at two tiles a rank.
CUDA_RING_TILE_BYTES = 16 * MiB


def cuda_ring_tile_rows(x: torch.Tensor, verb: str = "allreduce") -> int | None:
    """The ``tile_rows`` the ``cuda_ring`` arm of ``verb`` runs rank-major
    ``x`` with: None (one tile) while a chunk fits in one tile, else the
    rows of the fewest tiles of at most ``CUDA_RING_TILE_BYTES`` that cover
    it. A chunk is a rank's buffer over n, for allgather the rank's buffer."""
    n = x.shape[0]
    chunk = x[0].numel() if verb == "allgather" else -(-x[0].numel() // n)
    rows = -(-chunk // ring_cuda.LANES)
    tiles = -(-rows * ring_cuda.LANES * x.element_size() // CUDA_RING_TILE_BYTES)
    return None if tiles <= 1 else -(-rows // tiles)


def _cuda_ring_allreduce(x: torch.Tensor) -> torch.Tensor:
    tile_rows = cuda_ring_tile_rows(x)
    if tile_rows is None:
        return ring_cuda.ring_allreduce(x)
    return ring_cuda.hbm_ring_allreduce(x.clone(), tile_rows=tile_rows)


def _cuda_ring_reduce_scatter(x: torch.Tensor) -> torch.Tensor:
    return ring_cuda.ring_reduce_scatter(
        x, tile_rows=cuda_ring_tile_rows(x, "reduce_scatter"))


def _sum_only(verb: str, kernel):
    """A schedule running ``kernel``, which sums, that refuses other ops."""
    def schedule(x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        if op != "sum":
            raise ValueError(f"cuda_ring {verb} is sum-only, got op={op!r}")
        return kernel(x)
    return schedule


# THE (op, algo) table, consumed by Transport and by the bench runner's
# algo filter. Each entry maps a rank-major tensor through the schedule;
# every entry takes ``op`` and the data-moving verbs ignore it.
SCHEDULES = {
    "allreduce": {
        "fused": lambda x, op="sum": C.fused_allreduce(x, op=op),
        "ring": lambda x, op="sum": C.ring_allreduce(x, op=op),
        "ring_bidir": lambda x, op="sum": C.ring_allreduce(x, bidir=True, op=op),
        "cuda_ring": _sum_only("allreduce", _cuda_ring_allreduce),
    },
    "reduce_scatter": {
        "fused": lambda x, op="sum": C.fused_reduce_scatter(x, op=op),
        "ring": lambda x, op="sum": C.ring_reduce_scatter(x, op=op),
        "cuda_ring": _sum_only("reduce_scatter", _cuda_ring_reduce_scatter),
    },
    "allgather": {
        "fused": lambda x, op="sum": C.fused_allgather(x),
        "ring": lambda x, op="sum": C.ring_allgather(x),
        "cuda_ring": lambda x, op="sum": ring_cuda.ring_allgather(
            x, tile_rows=cuda_ring_tile_rows(x, "allgather")),
    },
    "alltoall": {
        # "ring" selects the rotation schedule; "bruck" the log-step one
        "fused": lambda x, op="sum": C.fused_alltoall(x),
        "ring": lambda x, op="sum": C.rotation_alltoall(x),
        "bruck": lambda x, op="sum": C.bruck_alltoall(x),
        # direct writes, one per chunk, no relay
        "cuda_ring": lambda x, op="sum": alltoall_cuda.alltoall(x),
    },
}

# alltoallv's algorithms (it has no schedule of its own: the dense
# alltoall's fused or cuda_ring wire, masked at the receiver)
ALLTOALLV_ALGOS = ("fused", "cuda_ring")


def supports(op: str, algo: str) -> bool:
    """Does ``(op, algo)`` resolve on a 1-D rank mesh?"""
    return algo == "auto" or algo in SCHEDULES.get(op, {})


class Transport:
    """Collectives over a rank mesh (default: one rank per GPU)."""

    def __init__(self, mesh: RankMesh | None = None):
        self.mesh = mesh if mesh is not None else rank_mesh(detect_topology().n_devices)
        self.n_ranks = self.mesh.n_ranks
        self.device = self.mesh.device
        # per-(verb, algo) dispatch counts and input bytes, read via stats()
        self._stats: dict[tuple, dict] = {}

    # -- policy ------------------------------------------------------------

    @staticmethod
    def _forced_algo() -> str:
        """The ``RNR_ALGO`` env override (the NCCL_ALGO habit), or ""; an
        unknown name raises."""
        forced = os.environ.get("RNR_ALGO", "").strip().lower()
        if forced and forced not in ALGOS:
            raise ValueError(f"RNR_ALGO={forced!r} is not an algorithm; "
                             f"know {ALGOS}")
        return forced

    def _resolve(self, algo: str, op: str) -> str:
        if op not in SCHEDULES:
            raise ValueError(f"unknown op {op!r}")
        if algo not in ALGOS:
            raise ValueError(f"unknown algo {algo!r}; know {ALGOS}")
        if algo == "auto":
            # RNR_ALGO replaces only the policy default, and only where the
            # op supports it, so one env var doesn't break unrelated verbs
            forced = self._forced_algo()
            if forced and supports(op, forced):
                algo = forced
        if algo == "auto":
            algo = "fused"
        if not supports(op, algo):
            raise ValueError(f"op {op!r} has no {algo!r} schedule; compatible "
                             f"here: {list(SCHEDULES[op])}")
        return algo

    def _count(self, verb: str, algo: str, x: torch.Tensor) -> None:
        s = self._stats.setdefault((verb, algo), {"calls": 0, "bytes": 0})
        nbytes = x.numel() * x.element_size()
        s["calls"] += 1
        s["bytes"] += nbytes
        if _DEBUG_LOG:  # the NCCL_DEBUG=INFO analogue (env RNR_DEBUG=1)
            print(f"# rnr {verb} algo={algo} bytes={nbytes} "
                  f"ranks={self.n_ranks} device={self.device}", file=sys.stderr)

    def stats(self) -> dict:
        """Per-(verb, algo) dispatch counts and cumulative input bytes of the
        verb methods (bare ``jit_fn`` callables are not counted)."""
        return {f"{v}/{a}": dict(s) for (v, a), s in sorted(self._stats.items())}

    def format_stats(self) -> str:
        rows = [f"{'verb/algo':<28} {'calls':>8} {'MiB':>12}"]
        for key, s in self.stats().items():
            rows.append(f"{key:<28} {s['calls']:>8} {s['bytes'] / 2**20:>12.2f}")
        return "\n".join(rows)

    def shard(self, x, dtype: torch.dtype | None = None) -> torch.Tensor:
        """Place a global buffer (numpy or tensor, ``x[r]`` = rank r's buffer)
        on the mesh as one rank-major tensor, optionally cast to ``dtype``
        on the device."""
        t = torch.from_numpy(np.ascontiguousarray(x)) if isinstance(x, np.ndarray) else x
        if t.dim() < 1 or t.shape[0] != self.n_ranks:
            raise ValueError(f"leading dim must be the {self.n_ranks} ranks, "
                             f"got shape {tuple(t.shape)}")
        t = t.to(self.device)
        return t if dtype is None else t.to(dtype)

    # -- verbs -------------------------------------------------------------

    def _dispatch(self, verb: str, x: torch.Tensor, algo: str, **knobs):
        algo = self._resolve(algo, verb)
        fn = self._jit(verb, algo, **knobs)  # validates knobs first:
        self._count(verb, algo, x)           # rejected calls don't count
        return fn(x)

    def allreduce(self, x: torch.Tensor, algo: str = "auto",
                  op: str = "sum") -> torch.Tensor:
        """(ranks, ...) -> same shape; every rank row = elementwise ``op``
        reduction (sum/prod/max/min/avg)."""
        return self._dispatch("allreduce", x, algo, op=op)

    def reduce_scatter(self, x: torch.Tensor, algo: str = "auto",
                       op: str = "sum") -> torch.Tensor:
        """(ranks, S) -> (ranks, S/n); rank r keeps the ``op``-reduced r-th
        shard."""
        return self._dispatch("reduce_scatter", x, algo, op=op)

    def allgather(self, x: torch.Tensor, algo: str = "auto") -> torch.Tensor:
        """(ranks, c) -> (ranks, n*c); every rank ends with the
        concatenation in rank order."""
        return self._dispatch("allgather", x, algo)

    def alltoall(self, x: torch.Tensor, algo: str = "auto") -> torch.Tensor:
        """(ranks, n, c) -> same shape, the global transpose of the rank and
        chunk dims."""
        return self._dispatch("alltoall", x, algo)

    def alltoallv(self, x: torch.Tensor, counts,
                  algo: str = "auto") -> tuple[torch.Tensor, torch.Tensor]:
        """Ragged alltoall (the ``ncclAllToAllv`` verb, device plane).

        ``x``: ``(ranks, n, max_count, ...)``; rank r's chunk d carries
        ``counts[r, d]`` valid rows destined for rank d (rows past the count
        are don't-care). ``counts``: the (n, n) element-count matrix every
        rank knows. Returns ``(out, recv_counts)``: ``out[r, j]`` holds the
        first ``counts[j, r]`` rows rank j sent r (tail zeroed) and
        ``recv_counts[r] = counts[:, r]``. The wire always ships
        ``max_count`` rows a chunk. ``algo``: ``fused`` (one transpose) or
        ``cuda_ring`` (the direct alltoall kernel); ``auto`` is ``fused``
        unless ``RNR_ALGO`` names one of the two."""
        if algo == "auto":
            forced = self._forced_algo()
            algo = forced if forced in ALLTOALLV_ALGOS else "fused"
        if algo not in ALLTOALLV_ALGOS:
            raise ValueError(f"alltoallv knows algos {'|'.join(ALLTOALLV_ALGOS)}, "
                             f"got {algo!r}")
        self._check_rank_major(x)
        fn = C.fused_alltoallv if algo == "fused" else alltoall_cuda.alltoallv
        out = fn(x, torch.as_tensor(counts, device=self.device))
        self._count("alltoallv", algo, x)
        return out

    def jit_fn(self, verb: str, algo: str = "auto", **knobs):
        """The callable the benches time. PyTorch runs eagerly, so this is
        the schedule bound to its knobs, with the input checks in front."""
        return self._jit(verb, self._resolve(algo, verb), **knobs)

    def _jit(self, verb: str, algo: str, op: str = "sum"):
        if op not in REDUCE_OPS:
            raise ValueError(f"unknown reduce op {op!r}; know {REDUCE_OPS}")
        schedule = SCHEDULES[verb][algo]

        def run(x: torch.Tensor) -> torch.Tensor:
            self._check_rank_major(x)
            return schedule(x, op=op)
        return run

    def _check_rank_major(self, x: torch.Tensor) -> None:
        if x.dim() < 1 or x.shape[0] != self.n_ranks:
            raise ValueError(f"expected a rank-major tensor with {self.n_ranks} "
                             f"rows, got shape {tuple(x.shape)}")
        if x.device != self.device:
            raise ValueError(f"tensor is on {x.device}; the mesh is on {self.device}")
