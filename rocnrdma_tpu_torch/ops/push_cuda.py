"""The push kernel across processes (``ops/csrc/push_across.cu``): the
allgather and the alltoall of a 1-D mesh that spans processes, one rank a
process, counterpart of ``rocnrdma_tpu/ops/ring_pallas.py``'s
``pallas_ring_allgather`` and ``pallas_alltoall`` in that form.
``ring_cuda.ring_allgather_across`` and ``alltoall_cuda.alltoall_across``
(and ``alltoallv_across``) stage, allocate and count; ``launch`` runs one
launch of this rank's blocks.

Rank r's blocks read its n pieces where the caller holds them (piece d at
d * stride vectors: stride 0 for allgather, one piece for alltoall), store
piece d into rank d's IPC workspace output row at slot r (``ops/ipc.py``),
and drain what the peers pushed into rank r's own row into the caller's
output, one sub-step behind its pushes (the source's head note).

The geometry (``geometry``) is a pure function of (n, vectors a piece, the
processes on the card, the card's SMs and its resident blocks), so every
process of a job on like cards computes the same one, which the
epoch-counted flags require; the workspace's header compare refuses a
mismatch. On a card of its own (``per_card == 1``) a rank's lanes come from
the blocks the card holds, ``BLOCKS_PER_SM`` an SM; on a card shared by
several processes every process's grid must be resident together, so the
lanes keep the ring kernel's cap (about 4 blocks an SM over all n ranks).
A lane is cut into sub-steps of about ``STEP_BYTES`` a piece, at most
``MAX_STEPS``. The constants are the 4-card sweep's choice
(``bench/bench_push_across.py --sweep``, ``PERF.md``).
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from rocnrdma_tpu_torch.ops import _build, ipc

VEC = 16  # bytes a vector
MAX_STEPS = ipc.FLAG_WORDS["push"] - 1  # push_across.cu's RNR_PUSH_MAX_STEPS
VECS_CHOICES = (1, 2, 4, 8)  # push_across.cu's instantiations
# the geometry a rank with its card to itself launches with: the 4-card
# sweep's best mean over 4 x 64 MiB and 4 x 1 GiB, both verbs (PERF.md)
BLOCKS_PER_SM = 1
VECS = 8
STEP_BYTES = 32 << 10
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
             blocks_per_sm: int = BLOCKS_PER_SM, vecs: int = VECS,
             step_bytes: int = STEP_BYTES) -> Geometry:
    """The launch for n ranks of ``pv``-vector pieces with ``per_card``
    processes on a card of ``sms`` SMs holding ``resident`` blocks of the
    kernel at once (module docstring)."""
    if n < 2 or pv < 1 or sms < 1 or resident < 1:
        raise ValueError(f"no push geometry for n={n}, {pv} vectors a piece, "
                         f"{sms} SMs, {resident} resident blocks")
    if vecs not in VECS_CHOICES:
        raise ValueError(f"vecs must be one of {VECS_CHOICES}, got {vecs}")
    cap = ipc.max_lanes(n, sms, per_card)["push"]
    if per_card > 1:
        cap = min(cap, resident // n)
    else:
        cap = min(cap, blocks_per_sm * sms, resident)
    lanes = max(1, min(-(-pv // MIN_LANE_VECS), cap))
    lane = _up(-(-pv // lanes), ALIGN_VECS)
    steps = max(1, min(MAX_STEPS, lane * VEC // step_bytes))
    step = _up(-(-lane // steps), ALIGN_VECS)
    return Geometry(lanes=-(-pv // lane), lane=lane, steps=-(-lane // step), step=step,
                    vecs=vecs)


@functools.lru_cache(maxsize=64)
def _card(device: int, vecs: int) -> tuple[int, int]:
    """(SMs, resident blocks of the kernel with ``vecs``) of ``device``."""
    lib = _build.load("push_across")
    resident = lib.rnr_push_resident(vecs, device)
    _build.check(lib, "rnr_push_error", min(resident, 0), "push occupancy query")
    return torch.cuda.get_device_properties(device).multi_processor_count, resident


@functools.lru_cache(maxsize=256)
def geometry_for(device: int, n: int, pv: int, per_card: int, **knobs) -> Geometry:
    """``geometry`` on ``device``'s card (its SMs and resident blocks
    queried once), cached per shape."""
    return geometry(n, pv, per_card, *_card(device, knobs.get("vecs", VECS)), **knobs)


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
