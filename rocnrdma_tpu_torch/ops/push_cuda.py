"""The kernels across processes of a 1-D mesh that spans processes, one
rank a process, which read this rank's row where the caller holds it and
store only remotely, into the peers' IPC workspace rows (``ops/ipc.py``):

- the push kernel (``ops/csrc/push_across.cu``): the allgather and the
  alltoall, counterpart of ``rocnrdma_tpu/ops/ring_pallas.py``'s
  ``pallas_ring_allgather`` and ``pallas_alltoall`` in that form. Rank r's
  blocks read its n pieces (piece d at d * stride vectors: stride 0 for
  allgather, one piece for alltoall), store piece d into rank d's output
  row at slot r, and drain what the peers pushed into rank r's own row into
  the caller's output, one sub-step behind its pushes. ``launch`` runs it;
  ``ring_cuda.ring_allgather_across`` and ``alltoall_cuda.alltoall_across``
  (and ``alltoallv_across``) stage, allocate and count.
- the reduce kernel (``ops/csrc/reduce_across.cu``): the allreduce and the
  reduce_scatter, counterpart of ``pallas_ring_allreduce``,
  ``pallas_ring_reduce_scatter`` and ``pallas_hbm_ring_allreduce``. Rank
  r's blocks store chunk d of its row into rank d's input row at slot r,
  fold chunk r where its operands landed in the ring's order, and for the
  allreduce store the sum into every peer's output row and drain theirs,
  each stage a sub-step behind the one before. ``launch_reduce`` runs it;
  ``ring_cuda``'s ``*_allreduce_across`` and ``ring_reduce_scatter_across``
  stage, allocate and count.

The geometry (``geometry``) is a pure function of (the kernel, n, vectors a
piece, the processes on the card, the card's SMs and its resident blocks),
so every process of a job on like cards computes the same one, which the
epoch-counted flags require; the workspace's header compare refuses a
mismatch. On a card of its own (``per_card == 1``) a rank's lanes come from
the blocks the card holds, ``blocks_per_sm`` an SM; on a card shared by
several processes every process's grid must be resident together, so the
lanes keep the one-process ring kernel's cap (about 4 blocks an SM over all
n ranks) and a lane is one sub-step: the contexts of a shared card run in
turns, and every pass that waits on a peer costs a round of their time
slices. On a card of its own a lane is cut into sub-steps of about
``step_bytes`` a piece, at most ``MAX_STEPS``. ``KNOBS`` holds each
kernel's (blocks an SM, vectors a thread, sub-step bytes).
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from rocnrdma_tpu_torch.ops import _build, ipc

VEC = 16  # bytes a vector
MAX_STEPS = ipc.MAX_STEPS
# each kernel's instantiations of vectors a thread (the reduce kernel's
# one: KNOBS's, each a build of 16 kernels)
VECS_CHOICES = {"push": (1, 2, 4, 8), "reduce": (4,)}
# the geometry a rank with its card to itself launches with, (blocks an SM,
# vectors a thread, sub-step bytes), from the 4-card sweep over 4 x 64 MiB
# and 4 x 1 GiB, both verbs of each kernel (bench_push_across --sweep,
# PERF.md). push: its best mean. reduce (4 vectors, the one built): one
# block an SM is all the card holds, so blocks an SM changes nothing; 32
# and 128 KiB sub-steps (8 at 1 GiB) lead at 1 GiB, 64 MiB is within the
# spread, and the split put 32 KiB ahead
KNOBS = {"push": (1, 8, 32 << 10), "reduce": (1, 4, 32 << 10)}
MIN_LANE_VECS = 64  # 1 KiB of a piece: below it a lane is all fixed cost
ALIGN_VECS = 32  # lanes and sub-steps in whole 512-byte runs of a warp


@dataclasses.dataclass(frozen=True)
class Geometry:
    """One launch's shape: ``lanes`` blocks of ``lane`` vectors a piece,
    each in ``steps`` sub-steps of ``step`` vectors, ``vecs`` vectors in
    flight a thread."""

    lanes: int
    lane: int
    steps: int
    step: int
    vecs: int


def _up(v: int, to: int) -> int:
    return -(-v // to) * to


def geometry(n: int, pv: int, per_card: int, sms: int, resident: int,
             blocks_per_sm: int | None = None, vecs: int | None = None,
             step_bytes: int | None = None, kernel: str = "push") -> Geometry:
    """The launch of ``kernel`` for n ranks of ``pv``-vector pieces (the
    reduce kernel: chunks) with ``per_card`` processes on a card of ``sms``
    SMs holding ``resident`` blocks of the kernel at once (module
    docstring); a knob left None is ``KNOBS[kernel]``'s."""
    knobs = [v if v is not None else d
             for v, d in zip((blocks_per_sm, vecs, step_bytes), KNOBS[kernel])]
    blocks_per_sm, vecs, step_bytes = knobs
    if n < 2 or pv < 1 or sms < 1 or resident < 1:
        raise ValueError(f"no {kernel} geometry for n={n}, {pv} vectors a piece, "
                         f"{sms} SMs, {resident} resident blocks")
    if vecs not in VECS_CHOICES[kernel]:
        raise ValueError(f"vecs must be one of {VECS_CHOICES[kernel]}, got {vecs}")
    cap = ipc.max_lanes(n, sms, per_card)[kernel]
    if per_card > 1:
        cap = min(cap, resident // n)
    else:
        cap = min(cap, blocks_per_sm * sms, resident)
    lanes = max(1, min(-(-pv // MIN_LANE_VECS), cap))
    lane = _up(-(-pv // lanes), ALIGN_VECS)
    steps = 1 if per_card > 1 else max(1, min(MAX_STEPS, lane * VEC // step_bytes))
    step = _up(-(-lane // steps), ALIGN_VECS)
    return Geometry(lanes=-(-pv // lane), lane=lane, steps=-(-lane // step), step=step,
                    vecs=vecs)


@functools.lru_cache(maxsize=64)
def _card(device: int, kernel: str, vecs: int, n: int, code: int) -> tuple[int, int]:
    """(SMs, resident blocks of ``kernel`` with ``vecs``, for the reduce
    kernel with n ranks of dtype ``code``) of ``device``."""
    if kernel == "push":
        lib, err = _build.load("push_across"), "rnr_push_error"
        resident = lib.rnr_push_resident(vecs, device)
    else:
        lib, err = _build.load("reduce_across"), "rnr_reduce_error"
        resident = lib.rnr_reduce_resident(n, code, vecs, device)
    _build.check(lib, err, min(resident, 0), f"{kernel} occupancy query")
    return torch.cuda.get_device_properties(device).multi_processor_count, resident


@functools.lru_cache(maxsize=256)
def geometry_for(device: int, n: int, pv: int, per_card: int, kernel: str = "push",
                 code: int = 0, **knobs) -> Geometry:
    """``geometry`` of ``kernel`` (the reduce kernel's for dtype ``code``)
    on ``device``'s card (its SMs and resident blocks queried once), cached
    per shape."""
    vecs = knobs.get("vecs") or KNOBS[kernel][1]
    card = _card(device, kernel, vecs, n, code if kernel == "reduce" else 0)
    return geometry(n, pv, per_card, *card, kernel=kernel, **knobs)


def launch(ws, geo: Geometry, src: torch.Tensor, stride: int, out: torch.Tensor,
           pv: int) -> None:
    """One launch of this rank's blocks on the current stream, through
    ``ws`` (``ipc.Workspace``, its output row already large enough): the n
    pieces of ``pv`` vectors at ``src`` (piece d at d * ``stride`` vectors)
    pushed to the peers, the result drained into ``out`` (n * ``pv``
    vectors). Both 16-byte aligned."""
    ws.launch("push", geo.lanes, _build.load("push_across"), "rnr_push_rank",
              src.data_ptr(), stride, out.data_ptr(), ws.n, pv, geo.lanes, geo.lane,
              geo.step, geo.steps, geo.vecs)


def launch_reduce(ws, geo: Geometry, src: torch.Tensor, out: torch.Tensor, pv: int,
                  code: int, mode: int) -> None:
    """One launch of this rank's blocks of the reduce kernel on the current
    stream, through ``ws`` (its rows already large enough): the n chunks of
    ``pv`` vectors at ``src`` of dtype ``code`` reduced in ``mode``
    (``ring_cuda.MODE_AR`` into the n chunks of ``out``, which may be
    ``src``; ``MODE_RS`` into ``out``'s one chunk). Both 16-byte aligned."""
    ws.launch("reduce", geo.lanes, _build.load("reduce_across"), "rnr_reduce_rank",
              src.data_ptr(), out.data_ptr(), ws.n, pv, geo.lanes, geo.lane, geo.step,
              geo.steps, geo.vecs, code, mode)
