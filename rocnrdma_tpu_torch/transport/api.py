"""The Transport interface: rank-major collectives over a rank mesh.

Counterpart of ``rocnrdma_tpu/transport/api.py``: the verbs allreduce,
reduce_scatter, allgather, alltoall, alltoallv, broadcast, reduce, gather,
scatter and sendrecv, every explicit schedule of the reference, grouped
launch (``group()``) and custom schedules (``program_fn``). Data layout
contract: the leading tensor dims are the mesh; on a 1-D mesh ``x[r]`` is
rank r's buffer, on a 2-D ``('slice', 'intra')`` mesh ``x[s, i]`` is the
buffer of rank (slice s, intra i), flat rank ``s * per_slice + i``. The
result keeps that layout: every rank's row the reduction (allreduce), row
r the reduced shard r (reduce_scatter, ``(n, S/n)``), every row the
concatenation (allgather, ``(n, n*c)``), row r's chunk j what rank j sent
rank r (alltoall, ``(n, n, c)``), every row root's (broadcast), root's row
the reduction and the others zero (reduce), root's row the concatenation
and the others zero (gather, ``(n, n*c)``), row r root's chunk r
(scatter, ``(n, c)``), row r what rank r - shift sent (sendrecv). Every
rank of a process lives on the mesh's one device.

A 2-D mesh may span processes (``slice_mesh(..., group=g)``; each process
one slice). A tensor on it is this process's rows, ``x[0, i]`` the buffer
of rank (``span.index``, i), leading dims ``(1, per_slice)``, and so is the
result: the rows ``[s]`` of the one-process mesh's result. Every (verb,
algo) pair that ``supports(..., is_2d=True)`` admits runs there, ``auto``
and ``model`` resolve as there, and what a 2-D mesh refuses is refused
with the same error.

A 1-D mesh may span processes too (``rank_mesh(n, group=g)``; each
process one rank). A tensor on it is this process's row, leading dim
``(1,)``, and so is the result: row ``[index:index + 1]`` of the
one-process mesh's result. Every (verb, algo) pair of a 1-D mesh runs
there but ``cuda_ring``, whose kernels read every rank's row on one card
(refused by name; ``auto``, ``model``, ``RNR_ALGO`` and a tuning table
never pick it there, and otherwise resolve as on a one-process mesh);
what a 1-D mesh refuses is refused with the same error.

On either, the leading axis's exchanges cross processes on the span's
cross group (``collectives._exchange``), and ``stats()`` counts them under
``cross/<backend>`` with the bytes and host seconds staged each way.

Algorithms (``SCHEDULES``; the reference's names, except that its
``pallas_ring`` is ``cuda_ring`` here):

- ``"fused"`` - one library call over the rank axis (XLA's collectives in
  the reference).
- ``"ring"`` / ``"ring_bidir"`` - the explicit ring schedules; for
  alltoall ``"ring"`` is the rotation schedule. ``"bruck"`` - the log-step
  alltoall.
- ``"tree"`` (halving-doubling), ``"khd"`` (mixed-radix halving-doubling,
  bidirectional), ``"dtree"`` (double binary tree), ``"ptree"`` (its
  chunk-pipelined form), ``"ktree"`` (k-ary tree): the explicit 1-D
  schedules. ``khd`` without ``digits``/``max_radix`` runs the radix
  ladder's pick at the message size (``Transport.khd_model_digits``, the
  cost model's ``tuner.khd_model_digits``), as the reference does.
- ``"khd2d"`` and ``"hierarchical"`` - the 2-D mesh schedules.
- ``"binomial"`` - the rooted verbs' binomial trees.
- ``"cuda_ring"`` - the hand-written CUDA kernels: the ring kernel for
  allreduce, reduce_scatter and allgather, the direct alltoall kernel for
  alltoall(v). Allreduce and reduce_scatter are sum-only. The ring verbs
  take the tile policy below: one tile while a chunk (a rank's buffer over
  n; for allgather the rank's buffer) fits in one ``CUDA_RING_TILE_BYTES``
  tile, else the fewest tiles of at most that size. Allreduce runs its
  tiled tier out of place (the result of ``ring_cuda.hbm_ring_allreduce``),
  so the caller's tensor is never changed.
- ``"auto"`` - ``RNR_ALGO`` when set and supported; else the tuning
  table's arm at this message size when a table is attached
  (``Transport(tuning=...)`` or ``RNR_TUNING``) and names one this mesh
  supports; else ``hierarchical`` for allreduce and alltoall on a 2-D
  mesh, ``fused`` otherwise.
- ``"model"`` - the cost model's cheapest arm at this message size
  (``tuner.model_pick``, with this device's constants); ``cuda_ring``
  competes only on a CUDA device.

Knobs, with the reference's validation: ``op``, ``root``, ``shift``,
``acc`` (accumulate in a wider dtype, cast back), ``premul`` (scale every
contribution before a sum), ``donate`` (write the result into the input's
storage and return the input; refused on verbs whose output shape differs),
``cross_dtype`` / ``intra_algo`` (hierarchical allreduce), ``chunks``
(ptree), ``digits`` / ``max_radix`` (khd). ``RNR_DEBUG=1`` logs one stderr
line per verb dispatch.
"""

from __future__ import annotations

import math
import os
import sys

import numpy as np
import torch

from rocnrdma_tpu_torch import collectives as C
from rocnrdma_tpu_torch.collectives import _exchange as X
from rocnrdma_tpu_torch.collectives.reduce_op import REDUCE_OPS
from rocnrdma_tpu_torch.collectives.schedule import khd_digits
from rocnrdma_tpu_torch.metrics import MiB
from rocnrdma_tpu_torch.ops import alltoall_cuda, ring_cuda
from rocnrdma_tpu_torch.runtime.mesh import (
    INTRA_AXIS,
    RANK_AXIS,
    SLICE_AXIS,
    RankMesh,
    detect_topology,
    rank_mesh,
)

_DEBUG_LOG = os.environ.get("RNR_DEBUG", "") not in ("", "0")

ALGOS = ("auto", "fused", "ring", "ring_bidir", "tree", "khd", "khd2d",
         "dtree", "ptree", "ktree", "hierarchical", "cuda_ring", "bruck",
         "binomial")

# The largest tile of the cuda_ring arm. The ring kernel folds each chunk in
# one direct pass, so tiles no longer set its time: they set only the
# padding of a chunk to whole tiles, which for allreduce decides which chunk
# an element lies in and so its fold order. The value keeps the arm's
# results those of the reference's tiled tier at 16 MiB tiles.
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
    return ring_cuda._tiled_allreduce(x, tile_rows)


def _cuda_ring_reduce_scatter(x: torch.Tensor) -> torch.Tensor:
    return ring_cuda.ring_reduce_scatter(
        x, tile_rows=cuda_ring_tile_rows(x, "reduce_scatter"))


def _sum_only(verb: str, kernel):
    """A schedule running ``kernel``, which sums, that refuses other ops."""
    def schedule(x: torch.Tensor, shape, op: str = "sum", root: int = 0) -> torch.Tensor:
        if op != "sum":
            raise ValueError(f"cuda_ring {verb} is sum-only, got op={op!r}")
        return kernel(x)
    return schedule


def _khd(digits) -> dict:
    return {} if digits is None else {"digits": digits}


# THE (op, algo) table, consumed by Transport and by the bench runner's
# algo filter. Each entry maps a rank-major tensor ``x`` of shape (n, ...),
# the mesh's ranks flattened, through the schedule; ``shape`` is the mesh
# shape (the 2-D schedules read it). Keyword knobs: ``op`` (the reduction,
# ignored by the verbs that only move data), ``root`` (the rooted verbs),
# ``shift`` (sendrecv) and the schedule-specific ones. Every pair but
# ``cuda_ring`` also takes ``span``: the mesh's ProcessSpan where its
# leading axis spans processes, ``x`` then this process's rows (a 1-D
# mesh's ``shape`` is then ``(n, 1)``: the ``spanning_fused_*`` verbs see
# n slices of one rank).
SCHEDULES = {
    "allreduce": {
        "fused": lambda x, shape, op="sum", root=0, span=None:
            C.fused_allreduce(x, op=op) if span is None
            else X.spanning_fused_allreduce(x, shape, span, op=op),
        "ring": lambda x, shape, op="sum", root=0, span=None:
            C.ring_allreduce(x, op=op, span=span),
        "ring_bidir": lambda x, shape, op="sum", root=0, span=None:
            C.ring_allreduce(x, bidir=True, op=op, span=span),
        "tree": lambda x, shape, op="sum", root=0, span=None:
            C.hd_allreduce(x, op=op, span=span),
        # the registered khd runs bidir: a part's halves ride opposite
        # rotations where the split is real (collectives/khd.py)
        "khd": lambda x, shape, op="sum", root=0, digits=None, span=None:
            C.khd_allreduce(x, op=op, bidir=True, span=span, **_khd(digits)),
        # digits = the mesh shape, round t within mesh axis t
        "khd2d": lambda x, shape, op="sum", root=0, span=None:
            C.khd2d_allreduce(x, shape, op=op, bidir=True, span=span),
        "dtree": lambda x, shape, op="sum", root=0, span=None:
            C.dbtree_allreduce(x, op=op, span=span),
        # ``chunks`` overrides the pipeline depth
        "ptree": lambda x, shape, op="sum", root=0, chunks=None, span=None:
            C.ptree_allreduce(x, op=op, chunks=chunks, span=span),
        "ktree": lambda x, shape, op="sum", root=0, span=None:
            C.kary_tree_allreduce(x, op=op, span=span),
        # ``intra_algo``: ring|khd for the two intra-slice phases
        "hierarchical": lambda x, shape, op="sum", root=0, cross_dtype=None,
                               intra_algo=None, span=None:
            C.hierarchical_allreduce(x, shape, op=op, cross_dtype=cross_dtype,
                                     intra_algo=intra_algo or "ring", span=span),
        "cuda_ring": _sum_only("allreduce", _cuda_ring_allreduce),
    },
    "reduce_scatter": {
        "fused": lambda x, shape, op="sum", root=0, span=None:
            C.fused_reduce_scatter(x, op=op) if span is None
            else X.spanning_fused_reduce_scatter(x, shape, span, op=op),
        "ring": lambda x, shape, op="sum", root=0, span=None:
            C.ring_reduce_scatter(x, op=op, span=span),
        "khd": lambda x, shape, op="sum", root=0, digits=None, span=None:
            C.khd_reduce_scatter(x, op=op, span=span, **_khd(digits)),
        "khd2d": lambda x, shape, op="sum", root=0, span=None:
            C.khd2d_reduce_scatter(x, shape, op=op, span=span),
        "cuda_ring": _sum_only("reduce_scatter", _cuda_ring_reduce_scatter),
    },
    "allgather": {
        "fused": lambda x, shape, op="sum", root=0, span=None:
            C.fused_allgather(x) if span is None
            else X.spanning_fused_allgather(x, shape, span),
        "ring": lambda x, shape, op="sum", root=0, span=None:
            C.ring_allgather(x, span=span),
        "khd": lambda x, shape, op="sum", root=0, digits=None, span=None:
            C.khd_allgather(x, span=span, **_khd(digits)).reshape(x.shape[0], -1),
        "khd2d": lambda x, shape, op="sum", root=0, span=None:
            C.khd2d_allgather(x, shape, span=span).reshape(x.shape[0], -1),
        "cuda_ring": lambda x, shape, op="sum", root=0: ring_cuda.ring_allgather(
            x, tile_rows=cuda_ring_tile_rows(x, "allgather")),
    },
    "alltoall": {
        # "ring" selects the rotation schedule; "bruck" the log-step one
        "fused": lambda x, shape, op="sum", root=0, span=None:
            C.fused_alltoall(x) if span is None
            else X.spanning_fused_alltoall(x, shape, span),
        "ring": lambda x, shape, op="sum", root=0, span=None:
            C.rotation_alltoall(x, span=span),
        "bruck": lambda x, shape, op="sum", root=0, span=None:
            C.bruck_alltoall(x, span=span),
        # 2-D mesh only: within slices, then one crossing per chunk
        "hierarchical": lambda x, shape, op="sum", root=0, span=None:
            C.hierarchical_alltoall(x, shape, span=span),
        # direct writes, one per chunk, no relay
        "cuda_ring": lambda x, shape, op="sum", root=0: alltoall_cuda.alltoall(x),
    },
    # The rooted verbs; off-root rows of reduce/gather are zeroed.
    "broadcast": {
        "fused": lambda x, shape, op="sum", root=0, span=None:
            C.fused_broadcast(x, root=root) if span is None
            else X.spanning_fused_broadcast(x, shape, span, root=root),
        "binomial": lambda x, shape, op="sum", root=0, span=None:
            C.binomial_broadcast(x, root=root, span=span),
    },
    "reduce": {
        "fused": lambda x, shape, op="sum", root=0, span=None:
            C.fused_rooted_reduce(x, root=root, op=op) if span is None
            else X.spanning_fused_rooted_reduce(x, shape, span, root=root, op=op),
        "binomial": lambda x, shape, op="sum", root=0, span=None:
            C.binomial_reduce(x, root=root, op=op, span=span),
    },
    "gather": {
        "fused": lambda x, shape, op="sum", root=0, span=None:
            (C.fused_gather(x, root=root) if span is None
             else X.spanning_fused_gather(x, shape, span, root=root))
            .reshape(x.shape[0], -1),
        "binomial": lambda x, shape, op="sum", root=0, span=None:
            C.binomial_gather(x, root=root, span=span).reshape(x.shape[0], -1),
    },
    "scatter": {
        "fused": lambda x, shape, op="sum", root=0, span=None:
            C.fused_scatter(x, root=root) if span is None
            else X.spanning_fused_scatter(x, shape, span, root=root),
        "binomial": lambda x, shape, op="sum", root=0, span=None:
            C.binomial_scatter(x, root=root, span=span),
    },
    # Point to point: rank r sends to r + shift (mod n). One step is the
    # whole schedule, so there is no explicit-vs-fused split.
    "sendrecv": {
        "fused": lambda x, shape, shift=1, span=None:
            C.fused_sendrecv(x, shift=shift, span=span),
    },
}

# alltoallv's algorithms (it has no schedule of its own: the dense
# alltoall's fused or cuda_ring wire, masked at the receiver)
ALLTOALLV_ALGOS = ("fused", "cuda_ring")


# why a 1-D mesh across processes refuses cuda_ring
CUDA_RING_ACROSS = (
    "cuda_ring is refused on a 1-D mesh that spans processes: its kernels "
    "read every rank's row on one card, and the kernels across processes "
    "over CUDA IPC are not ported yet (ROADMAP Queue 1, item 1); use ring, "
    "khd or fused")


def supports(op: str, algo: str, is_2d: bool = False, spans: bool = False) -> bool:
    """Does ``(op, algo)`` resolve on a mesh of this dimensionality?
    ``spans``: the mesh's leading axis spans processes (then a 1-D mesh
    has no ``cuda_ring``: ``CUDA_RING_ACROSS``)."""
    if algo == "auto":
        return True
    if algo not in SCHEDULES.get(op, {}):
        return False
    if algo == "cuda_ring" and spans:
        return False
    if algo in ("hierarchical", "khd2d"):
        return is_2d
    if op == "sendrecv":
        return not is_2d  # a shift permutation is only defined on one ring
    if algo == "fused":
        return True
    return not is_2d  # every explicit schedule rings a 1-D rank mesh



def _dtype(spec) -> torch.dtype:
    """A torch dtype from a torch dtype, a numpy dtype or scalar type, or a
    name ("bfloat16")."""
    if isinstance(spec, torch.dtype):
        return spec
    name = spec if isinstance(spec, str) else (
        getattr(spec, "name", None) or getattr(spec, "__name__", None))
    dt = getattr(torch, name, None) if isinstance(name, str) else None
    if not isinstance(dt, torch.dtype):
        raise TypeError(f"not a dtype: {spec!r}")
    return dt


def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).removeprefix("torch.")


def _unflatten(out: torch.Tensor, shape: tuple) -> torch.Tensor:
    """A schedule's (n, ...) result back to the mesh's leading dims."""
    return out.reshape(shape + out.shape[1:])


class Transport:
    """Collectives over a rank mesh (default: one rank per GPU). Build one
    per mesh; the callables of each (verb, algo, knobs) are cached."""

    def __init__(self, mesh: RankMesh | None = None, tuning=None, dcn=None):
        self.mesh = mesh if mesh is not None else rank_mesh(detect_topology().n_devices)
        self.axes = self.mesh.axis_names
        if self.axes not in ((RANK_AXIS,), (SLICE_AXIS, INTRA_AXIS)):
            raise ValueError(f"mesh axes {self.axes} unsupported; use "
                             f"runtime.rank_mesh() or runtime.slice_mesh()")
        self.n_ranks = self.mesh.n_ranks
        self.is_2d = len(self.axes) == 2
        self._lead = tuple(self.mesh.shape)  # the mesh shape
        # the leading dims of a tensor on it in this process
        self._local = tuple(self.mesh.local_shape)
        self._rows = math.prod(self._local)
        self.span = self.mesh.span  # the leading axis across processes, or None
        self._spans = self.span is not None
        self.device = self.mesh.device
        on_card = self.device.type == "cuda"
        # the tuning-table platform (detect_topology's) and the cost
        # model's device kind
        self.platform = "gpu" if on_card else "cpu"
        self.device_kind = torch.cuda.get_device_name(self.device) if on_card else "cpu"
        cards = len(set(self.mesh.devices))
        # this process's ranks on its card, times the processes of a
        # spanning mesh that share the card
        self.ranks_per_card = (len(self.mesh.devices) // cards
                               * (self.span.per_card if self.span is not None else 1))
        # ``dcn``: does the slice axis cross the network? None = only when
        # the ranks span more than one device or process; explicit
        # True/False overrides. It sets the cost model's constants only.
        spans = cards > 1 or self.span is not None
        self.dcn = bool(spans if dcn is None else dcn) and self.is_2d
        if tuning is None:
            # RNR_TUNING (the NCCL_TUNER_PLUGIN habit): a saved table for
            # every Transport of the process; an explicit ``tuning=`` wins
            tuning = os.environ.get("RNR_TUNING", "").strip() or None
        if isinstance(tuning, str):
            from rocnrdma_tpu_torch.transport.tuner import TuningTable
            tuning = TuningTable.load(tuning)
        self.tuning = tuning
        self._cache: dict = {}  # (verb, algo, knobs) -> callable
        # per-(verb, algo) dispatch counts and input bytes, read via stats()
        self._stats: dict[tuple, dict] = {}
        # re-rooting hook: an int or zero-arg callable naming the root that
        # grouped rooted verbs take when the caller passes none (None = 0)
        self.root_hint = None

    def _default_root(self) -> int:
        """Resolve :attr:`root_hint` for a grouped rooted verb issued with
        no explicit root (0 when unset)."""
        hint = self.root_hint
        if hint is None:
            return 0
        return int(hint() if callable(hint) else hint)

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

    def _constants(self, verb: str) -> tuple[float, float, float]:
        """The cost model's (alpha, beta, hbm_beta) for ``verb`` on this
        mesh's device and layout (``tuner.constants_for``)."""
        from rocnrdma_tpu_torch.transport.tuner import constants_for
        return constants_for(self.device_kind, verb, self.ranks_per_card)

    def _resolve(self, algo: str, op: str, nbytes: int | None = None,
                 itemsize: int = 4) -> str:
        if op not in SCHEDULES:
            raise ValueError(f"unknown op {op!r}")
        if algo == "model":
            # the cost model's pick among the arms this mesh supports; the
            # kernel arm only on a CUDA device (on the CPU it runs its plain
            # version, which the model does not price)
            from rocnrdma_tpu_torch.transport.tuner import dcn_constants_for, model_pick
            cands = [a for a in SCHEDULES[op]
                     if supports(op, a, self.is_2d, self._spans)
                     and (self.platform == "gpu" or a != "cuda_ring")]
            alpha, beta, hbm_beta = self._constants(op)
            picked = (model_pick(op, self.n_ranks, nbytes, candidates=cands,
                                 alpha=alpha, beta=beta, hbm_beta=hbm_beta,
                                 mesh_shape=self._lead if self.is_2d else None,
                                 dcn=(dcn_constants_for(self.device_kind)
                                      if self.dcn else None),
                                 device_kind=self.device_kind, itemsize=itemsize)
                      if nbytes is not None else None)
            algo = picked or "auto"
        if algo not in ALGOS:
            raise ValueError(f"unknown algo {algo!r}; know {ALGOS} + 'model'")
        if algo == "auto":
            # RNR_ALGO replaces only the policy default, and only where the
            # op supports it, so one env var doesn't break unrelated verbs
            forced = self._forced_algo()
            if forced and supports(op, forced, self.is_2d, self._spans):
                algo = forced
        if algo == "auto" and self.tuning is not None and nbytes is not None:
            tuned = self.tuning.lookup(op, nbytes, self.n_ranks, len(self.axes),
                                       self.platform)
            if tuned is not None and supports(op, tuned, self.is_2d, self._spans):
                algo = tuned
        if algo == "auto":
            # 2-D mesh: the two-level schedules are the default for the
            # verbs that have one
            algo = ("hierarchical"
                    if self.is_2d and op in ("allreduce", "alltoall")
                    else "fused")
        if algo == "cuda_ring" and self._spans and not self.is_2d:
            raise ValueError(f"op {op!r}: {CUDA_RING_ACROSS}")
        if not supports(op, algo, self.is_2d, self._spans):
            raise ValueError(
                f"op {op!r} has no {algo!r} schedule on a "
                f"{'2-D' if self.is_2d else '1-D'} mesh; compatible here: "
                f"{[a for a in SCHEDULES[op] if supports(op, a, self.is_2d, self._spans)]}")
        return algo

    def _msg_bytes(self, verb: str, x: torch.Tensor) -> int:
        """Message size S, the tuning table's and the model's size key (the
        bench sweeps' ``size_bytes``): for allgather and gather the input
        row is already the S/n chunk, so S is every rank's input (where
        the mesh spans processes, this process's times the slices); every
        other verb's row is the full S."""
        nbytes = x.numel() * x.element_size()
        if verb in ("allgather", "gather"):
            return max(1, nbytes * self.n_ranks // self._rows)
        return max(1, nbytes // self._rows)

    def _count(self, verb: str, algo: str, x: torch.Tensor) -> None:
        s = self._stats.setdefault((verb, algo), {"calls": 0, "bytes": 0})
        nbytes = x.numel() * x.element_size()
        s["calls"] += 1
        s["bytes"] += nbytes
        if _DEBUG_LOG:  # the NCCL_DEBUG=INFO analogue (env RNR_DEBUG=1)
            print(f"# rnr {verb} algo={algo} bytes={nbytes} "
                  f"ranks={self.n_ranks} mesh={'2d' if self.is_2d else '1d'} "
                  f"device={self.device}", file=sys.stderr)

    def stats(self) -> dict:
        """Per-(verb, algo) dispatch counts and cumulative input bytes of the
        verb methods and grouped launches (bare ``jit_fn`` callables are not
        counted). On a mesh that spans processes, also ``cross/<backend>``:
        the slice axis's exchanges (``calls``), the bytes this process sent
        in them and their host seconds (``wire_s``), whether they are
        staged through the host, and the bytes and host seconds staged
        each way (``d2h_*``, ``h2d_*``)."""
        out = {f"{v}/{a}": dict(s) for (v, a), s in sorted(self._stats.items())}
        if self.span is not None:
            st = self.span.stats
            out[f"cross/{self.span.backend}"] = {
                "calls": st["exchanges"], "bytes": st["bytes"],
                "staged": self.span.staged,
                **{k: st[k] for k in ("wire_s", "d2h_bytes", "d2h_s",
                                      "h2d_bytes", "h2d_s")}}
        return out

    def format_stats(self) -> str:
        rows = [f"{'verb/algo':<28} {'calls':>8} {'MiB':>12}"]
        for key, s in self.stats().items():
            rows.append(f"{key:<28} {s['calls']:>8} {s['bytes'] / 2**20:>12.2f}")
        return "\n".join(rows)

    def shard(self, x, dtype: torch.dtype | None = None) -> torch.Tensor:
        """Place a global buffer (numpy or tensor, leading dims the mesh
        shape) on the mesh as one rank-major tensor, optionally cast to
        ``dtype`` on the device. On a mesh that spans processes the result
        is this process's rows, ``(1, per_slice, ...)``: from a global
        buffer its slice's rows are taken, and a buffer of this process's
        rows alone is taken whole."""
        t = torch.from_numpy(np.ascontiguousarray(x)) if isinstance(x, np.ndarray) else x
        lead = self._lead
        if self.span is not None:
            if t.shape[:len(lead)] == lead:
                t = t[self.span.index:self.span.index + 1]
            lead = self._local
        if t.shape[:len(lead)] != lead:
            what = (f"the {self.n_ranks} ranks" if not self.is_2d
                    else f"the mesh shape {lead}")
            raise ValueError(f"leading dim must be {what}, got shape "
                             f"{tuple(t.shape)}")
        t = t.to(self.device)
        return t if dtype is None else t.to(dtype)

    # -- verbs -------------------------------------------------------------

    @staticmethod
    def _force_algo(algo: str, **knobs) -> str:
        """Schedule-specific knobs force their schedule under ``auto`` and
        ``model``: the knob is the algorithm choice. An explicit algo
        resolves normally and is validated in ``_build``."""
        if algo in ("auto", "model"):
            if (knobs.get("cross_dtype") is not None
                    or knobs.get("intra_algo") is not None):
                return "hierarchical"
            if knobs.get("chunks") is not None:
                return "ptree"
            if (knobs.get("digits") is not None
                    or knobs.get("max_radix") is not None):
                return "khd"
        return algo

    def khd_model_digits(self, verb: str, nbytes: int) -> tuple[int, ...]:
        """The digits ``algo="khd"`` dispatches for ``verb`` at message size
        ``nbytes`` when the caller gives none: the radix ladder's pick with
        this mesh's constants, the same the cost model prices."""
        from rocnrdma_tpu_torch.transport.tuner import khd_model_digits
        alpha, beta, hbm_beta = self._constants(verb)
        return khd_model_digits(verb, self.n_ranks, nbytes, alpha, beta,
                                hbm_beta, device_kind=self.device_kind)

    def _dispatch(self, verb: str, x: torch.Tensor, algo: str, **knobs):
        algo = self._force_algo(algo, **knobs)
        nbytes = self._msg_bytes(verb, x)
        algo = self._resolve(algo, verb, nbytes, x.element_size())
        if (algo == "khd" and knobs.get("digits") is None
                and knobs.get("max_radix") is None):
            # the radix is a modelled, size-dependent choice: resolved with
            # the function the cost model prices, so the program that runs
            # is the one priced
            knobs["digits"] = self.khd_model_digits(verb, nbytes)
        fn = self._jit(verb, algo, **knobs)  # validates knobs first:
        self._count(verb, algo, x)           # rejected calls don't count
        return fn(x)

    def allreduce(self, x: torch.Tensor, algo: str = "auto", op: str = "sum",
                  acc=None, premul=None, cross_dtype=None, intra_algo=None,
                  chunks=None, digits=None, max_radix=None,
                  donate: bool = False) -> torch.Tensor:
        """(ranks..., S) -> same shape; every rank row = elementwise ``op``
        reduction (sum/prod/max/min/avg). ``acc``: accumulate in this dtype
        and cast back (e.g. ``"float32"`` on bf16 buffers). ``premul``:
        scale every contribution by this scalar before summing (op='sum',
        float buffers). ``cross_dtype`` / ``intra_algo``: hierarchical only
        (the cross-slice phase's dtype; ring|khd for the intra phases).
        ``chunks``: ptree's pipeline depth. ``digits`` / ``max_radix``:
        khd's round radices, explicit or capped (default: the radix
        ladder's pick at this size, ``khd_model_digits``). Each
        schedule-specific knob forces its schedule under ``auto`` and
        ``model``. ``donate``: write the result into ``x`` and return it."""
        return self._dispatch("allreduce", x, algo, op=op, acc=acc,
                              premul=premul, cross_dtype=cross_dtype,
                              intra_algo=intra_algo, chunks=chunks,
                              digits=digits, max_radix=max_radix, donate=donate)

    def reduce_scatter(self, x: torch.Tensor, algo: str = "auto", op: str = "sum",
                       acc=None, premul=None, digits=None, max_radix=None,
                       donate: bool = False) -> torch.Tensor:
        """(ranks..., S) -> (ranks..., S/n); rank r keeps the ``op``-reduced
        r-th shard. ``digits``/``max_radix``: khd's round radices."""
        return self._dispatch("reduce_scatter", x, algo, op=op, acc=acc,
                              premul=premul, digits=digits,
                              max_radix=max_radix, donate=donate)

    def allgather(self, x: torch.Tensor, algo: str = "auto", digits=None,
                  max_radix=None, donate: bool = False) -> torch.Tensor:
        """(ranks..., c) -> (ranks..., n*c); every rank ends with the
        concatenation in rank order. ``digits``/``max_radix``: khd's
        round radices."""
        return self._dispatch("allgather", x, algo, digits=digits,
                              max_radix=max_radix, donate=donate)

    def alltoall(self, x: torch.Tensor, algo: str = "auto",
                 donate: bool = False) -> torch.Tensor:
        """(ranks..., n, c) -> same shape, the global transpose of the rank
        and chunk dims."""
        return self._dispatch("alltoall", x, algo, donate=donate)

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
        ``cuda_ring`` (the direct alltoall kernel); ``auto`` and ``model``
        are ``fused`` unless ``RNR_ALGO`` names one of the two this mesh
        runs. 1-D meshes only; across processes ``fused`` only
        (``CUDA_RING_ACROSS``), the result this process's row and its row
        of ``recv_counts``."""
        if self.is_2d:
            raise ValueError("alltoallv rings a 1-D rank mesh (use the "
                             "dense alltoall on 2-D meshes)")
        if algo in ("auto", "model"):
            forced = self._forced_algo()
            algo = (forced if forced in ALLTOALLV_ALGOS
                    and supports("alltoall", forced, spans=self._spans) else "fused")
        if algo not in ALLTOALLV_ALGOS:
            raise ValueError(f"alltoallv knows algos {'|'.join(ALLTOALLV_ALGOS)}, "
                             f"got {algo!r}")
        if algo == "cuda_ring" and self._spans:
            raise ValueError(f"op 'alltoallv': {CUDA_RING_ACROSS}")
        self._check_rank_major(x)
        counts = torch.as_tensor(counts, device=self.device)
        out = (C.fused_alltoallv(x, counts, span=self.span) if algo == "fused"
               else alltoall_cuda.alltoallv(x, counts))
        self._count("alltoallv", algo, x)
        return out

    def broadcast(self, x: torch.Tensor, algo: str = "auto", root: int = 0,
                  donate: bool = False) -> torch.Tensor:
        """(ranks..., S) -> same shape; every rank row = root's row."""
        return self._dispatch("broadcast", x, algo, root=root, donate=donate)

    def reduce(self, x: torch.Tensor, algo: str = "auto", root: int = 0,
               op: str = "sum", acc=None, premul=None,
               donate: bool = False) -> torch.Tensor:
        """(ranks..., S) -> same shape; root's row = the ``op`` reduction,
        the others zero."""
        return self._dispatch("reduce", x, algo, root=root, op=op, acc=acc,
                              premul=premul, donate=donate)

    def gather(self, x: torch.Tensor, algo: str = "auto", root: int = 0,
               donate: bool = False) -> torch.Tensor:
        """(ranks..., c) -> (ranks..., n*c); root's row = the concatenation
        in rank order, the others zero."""
        return self._dispatch("gather", x, algo, root=root, donate=donate)

    def scatter(self, x: torch.Tensor, algo: str = "auto", root: int = 0,
                donate: bool = False) -> torch.Tensor:
        """(ranks..., n*c) -> (ranks..., c); rank r's row = chunk r of
        root's row (only root's input is read)."""
        return self._dispatch("scatter", x, algo, root=root, donate=donate)

    def sendrecv(self, x: torch.Tensor, algo: str = "auto", shift: int = 1,
                 donate: bool = False) -> torch.Tensor:
        """(ranks, S) -> same shape; rank r's row = row (r - shift) mod n
        (every rank sends to r + shift, the ncclSend/ncclRecv pairwise
        exchange). 1-D rank mesh only."""
        return self._dispatch("sendrecv", x, algo, shift=shift, donate=donate)

    def jit_fn(self, verb: str, algo: str = "auto", **knobs):
        """The callable the benches time: the schedule bound to its knobs,
        with the input checks in front (PyTorch runs eagerly)."""
        algo = self._force_algo(algo, **knobs)
        return self._jit(verb, self._resolve(algo, verb), **knobs)

    def group(self):
        """Open an aggregation scope (the ncclGroupStart/End analogue): the
        verbs queued on the returned :class:`transport.group.Group` run at
        ``with``-exit, in order. See ``transport/group.py``."""
        from rocnrdma_tpu_torch.transport.group import Group
        return Group(self)

    def program_fn(self, prog):
        """A callable running a custom :class:`collectives.Program` (the
        MSCCL-analogue schedule IR) over this mesh's ranks, this process's
        row where the mesh spans processes. 1-D meshes only: a Program's
        perm speaks flat rank ids."""
        if self.is_2d:
            raise ValueError("custom programs run on a 1-D rank mesh")
        if prog.n_ranks != self.n_ranks:
            raise ValueError(
                f"program is for {prog.n_ranks} ranks, mesh has {self.n_ranks}")
        from rocnrdma_tpu_torch.collectives.program import execute, validate
        validate(prog)

        def run(x: torch.Tensor) -> torch.Tensor:
            self._check_rank_major(x)
            return execute(prog, x, span=self.span)
        return run

    # -- lowering ----------------------------------------------------------

    def _normalize_knobs(self, **knobs) -> dict:
        """Validate knobs and strip defaults so every caller (verb methods,
        bare jit_fn(), grouped calls) shares one callable per program."""
        root = knobs.get("root")
        if root is not None and not 0 <= root < self.n_ranks:
            raise ValueError(f"root {root} out of range for {self.n_ranks} ranks")
        if knobs.get("acc") is not None:
            # one spelling per dtype ("float32" / np.float32 / torch.float32)
            try:
                knobs["acc"] = _dtype_name(_dtype(knobs["acc"]))
            except TypeError as e:
                raise ValueError(f"bad acc dtype {knobs['acc']!r}: {e}") from None
        if knobs.get("premul") is not None:
            if knobs.get("op", "sum") != "sum":
                raise ValueError(
                    f"premul requires op='sum' (the ncclRedOpCreatePreMulSum "
                    f"semantics), got op={knobs['op']!r}")
            knobs["premul"] = float(knobs["premul"])  # one cache key per value
        if knobs.get("donate") is not None:
            knobs["donate"] = bool(knobs["donate"])
        if knobs.get("cross_dtype") is not None:
            try:
                dt = _dtype(knobs["cross_dtype"])
            except TypeError as e:
                raise ValueError(
                    f"bad cross_dtype {knobs['cross_dtype']!r}: {e}") from None
            if not dt.is_floating_point:
                # an int wire dtype would TRUNCATE the cross-slice partials
                # (0.5 -> 0), not just round them; the same rule as premul
                raise ValueError(
                    f"cross_dtype must be a float dtype, got {_dtype_name(dt)}")
            if knobs.get("op", "sum") not in ("sum", "avg"):
                raise ValueError(
                    f"cross_dtype only composes with op sum/avg (a coarser-"
                    f"dtype {knobs['op']} would change which element wins)")
            knobs["cross_dtype"] = _dtype_name(dt)
        if knobs.get("intra_algo") is not None:
            if knobs["intra_algo"] not in ("ring", "khd"):
                raise ValueError(f"intra_algo must be ring|khd, got "
                                 f"{knobs['intra_algo']!r}")
        if knobs.get("chunks") is not None:
            chunks = int(knobs["chunks"])
            if chunks < 1:
                raise ValueError(f"chunks must be >= 1, got {chunks}")
            knobs["chunks"] = chunks  # one cache entry per depth
        if knobs.get("max_radix") is not None:
            # canonicalize to digits (ONE cache key form for the khd shape)
            if knobs.get("digits") is not None:
                raise ValueError("give digits OR max_radix, not both")
            mr = int(knobs.pop("max_radix"))
            if mr < 2:
                raise ValueError(f"max_radix must be >= 2, got {mr}")
            knobs["digits"] = khd_digits(self.n_ranks, mr)
        if knobs.get("digits") is not None:
            digits = tuple(int(d) for d in knobs["digits"])
            prod = math.prod(digits)
            if any(d < 2 for d in digits) or prod != self.n_ranks:
                raise ValueError(
                    f"digits {digits} must each be >= 2 and multiply to "
                    f"the {self.n_ranks}-rank axis (product {prod})")
            knobs["digits"] = digits
        return {k: v for k, v in knobs.items()
                if not (k == "op" and v == "sum") and not (k == "root" and v == 0)
                and not (k == "shift" and v == 1) and not (k == "donate" and not v)
                and v is not None}

    # verbs whose output shape differs from the input: donating could not
    # hold the result in the input's storage
    _SHAPE_CHANGING = ("reduce_scatter", "allgather", "gather", "scatter")

    def _jit(self, verb: str, algo: str, **knobs):
        knobs = self._normalize_knobs(**knobs)
        if knobs.get("donate") and verb in self._SHAPE_CHANGING:
            raise ValueError(
                f"donate=True is useless on {verb!r}: its output shape "
                f"differs from the input, so nothing is reused but the "
                f"input buffer would still be invalidated")
        key = (verb, algo, tuple(sorted(knobs.items())))
        if key not in self._cache:
            self._cache[key] = self._build(verb, algo, **knobs)
        return self._cache[key]

    def _group_fn(self, sig: tuple):
        """One callable running every (verb, algo, knobs) in ``sig`` in
        order, on the current stream, cached per signature."""
        key = ("__group__", sig)
        if key not in self._cache:
            mapped = [self._jit(verb, algo, **dict(knobs))
                      for verb, algo, knobs in sig]
            self._cache[key] = lambda *xs: tuple(fn(x) for fn, x in zip(mapped, xs))
        return self._cache[key]

    def _build(self, verb: str, algo: str, **knobs):
        schedule = SCHEDULES[verb].get(algo)
        if schedule is None:
            raise ValueError(f"op {verb!r} has no {algo!r} schedule")
        if "cross_dtype" in knobs and (verb, algo) != ("allreduce",
                                                       "hierarchical"):
            raise ValueError(
                f"cross_dtype is a hierarchical-ALLREDUCE knob (the DCN "
                f"wire dtype); got ({verb!r}, algo {algo!r})")
        if "intra_algo" in knobs and (verb, algo) != ("allreduce",
                                                      "hierarchical"):
            raise ValueError(
                f"intra_algo is a hierarchical-ALLREDUCE knob (the ICI "
                f"phase schedule); got ({verb!r}, algo {algo!r})")
        if "chunks" in knobs and (verb, algo) != ("allreduce", "ptree"):
            raise ValueError(
                f"chunks is a PTREE-allreduce knob (the pipeline depth); "
                f"got ({verb!r}, algo {algo!r})")
        if "digits" in knobs and algo != "khd":
            raise ValueError(
                f"digits/max_radix is a KHD knob (the round radices); "
                f"got ({verb!r}, algo {algo!r})")
        if "op" in knobs and knobs["op"] not in REDUCE_OPS:
            raise ValueError(f"unknown reduce op {knobs['op']!r}; know {REDUCE_OPS}")
        donate = knobs.pop("donate", False)
        acc = knobs.pop("acc", None)
        premul = knobs.pop("premul", None)
        shape = self._lead
        if self.span is not None:
            knobs["span"] = self.span
            if not self.is_2d:
                shape += (1,)  # n slices of one rank (SCHEDULES)
        fn = lambda v: schedule(v, shape, **knobs)
        if premul is not None:
            # scale each rank's contribution before the sum: a
            # pre-transform, so it wraps any sum schedule
            def _premul(base):
                def wrapped(v):
                    if not v.dtype.is_floating_point:
                        # an int cast would truncate 0.25 to 0 and zero the sum
                        raise ValueError(f"premul requires a float buffer, "
                                         f"got {_dtype_name(v.dtype)}")
                    return base(v * torch.tensor(premul, dtype=v.dtype))
                return wrapped
            fn = _premul(fn)
        if acc is not None:
            acc_dtype = _dtype(acc)
            fn = (lambda base: lambda v: base(v.to(acc_dtype)).to(v.dtype))(fn)
        if self.is_2d:
            # the schedules take the ranks held here flattened: (n, ...) in
            # and out
            local = self._local
            fn = (lambda base: lambda v: _unflatten(
                base(v.reshape((self._rows,) + v.shape[2:])), local))(fn)

        def run(x: torch.Tensor) -> torch.Tensor:
            self._check_rank_major(x)
            out = fn(x)
            return x.copy_(out) if donate else out
        return run

    def _check_rank_major(self, x: torch.Tensor) -> None:
        lead = self._local
        if x.shape[:len(lead)] != lead:
            what = (f"{self.n_ranks} rows" if not self.is_2d
                    else f"leading dims {lead}")
            if self.span is not None and self.is_2d:
                what += (f" (this process's rows, slice {self.span.index} "
                         f"of a mesh {self._lead} that spans processes)")
            elif self.span is not None:
                what = (f"1 row (this process's row, rank {self.span.index} "
                        f"of a {self.n_ranks}-rank 1-D mesh that spans "
                        f"processes, one rank a process)")
            raise ValueError(f"expected a rank-major tensor with {what}, "
                             f"got shape {tuple(x.shape)}")
        if x.device != self.device:
            raise ValueError(f"tensor is on {x.device}; the mesh is on {self.device}")
