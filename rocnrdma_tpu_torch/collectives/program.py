"""A declarative schedule IR and its executor, the MSCCL analogue.

Counterpart of ``rocnrdma_tpu/collectives/program.py``:

- :class:`Program`: a pure-data schedule, ``n_ranks``, ``n_chunks`` and a
  sequence of :class:`Step` s, each a permutation plus per-rank send/recv
  chunk tables and a combine mode.
- :func:`execute`: runs a Program on a rank-major tensor. Where the
  reference moves each step's chunks with ``lax.ppermute``, a step here
  gathers every sender's outgoing chunk first (senders may also receive in
  the same step) and then lands them: overwrite, or ``combine(landing,
  incoming)``, the reference's order, so fp32 results equal it bit for bit.
  Across processes (``span``: the rank axis of a 1-D mesh, one rank a
  process) a step is one ``_exchange.permute_rows`` of its ``perm``: each
  sender ships its send chunk, each receiver lands it the same way.
- :func:`sim_program`: the numpy oracle.
- Builders expressing stock schedules in the IR (ring allreduce and
  allgather, binomial broadcast) from ``schedule.py``'s index functions.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rocnrdma_tpu_torch.collectives import schedule as S
from rocnrdma_tpu_torch.collectives._exchange import permute_rows
from rocnrdma_tpu_torch.collectives.reduce_op import combine_fn

WRITE = "write"
REDUCE = "reduce"
_PROGRAM_OPS = ("sum", "prod", "max", "min")


@dataclasses.dataclass(frozen=True)
class Step:
    """One communication round.

    ``perm`` — the (src, dst) pairs this step moves data along.
    ``send_chunk[r]`` — chunk index rank r puts on the wire (used only for
    ranks appearing as a src in ``perm``).
    ``recv_chunk[r]`` — chunk index rank r lands the incoming data in (used
    only for ranks appearing as a dst).
    ``combine`` — ``"write"`` (overwrite the landing chunk) or ``"reduce"``
    (merge with the landing chunk through the program's reduce op).
    """

    perm: tuple
    send_chunk: tuple
    recv_chunk: tuple
    combine: str = WRITE


@dataclasses.dataclass(frozen=True)
class Program:
    """A complete schedule over ``n_ranks`` ranks and ``n_chunks`` buffer
    chunks. ``op`` names the reduction (reduce_op registry) used by every
    REDUCE step."""

    name: str
    n_ranks: int
    n_chunks: int
    steps: tuple
    op: str = "sum"   # one of _PROGRAM_OPS ("avg" excluded — see validate)


class ProgramError(ValueError):
    pass


def validate(p: Program) -> None:
    """Static checks: every table sized n_ranks, chunk indices in range,
    no rank double-sends/double-receives within one step, combine known."""
    if p.n_ranks < 1 or p.n_chunks < 1:
        raise ProgramError(f"{p.name}: need n_ranks/n_chunks >= 1")
    if p.op not in _PROGRAM_OPS:
        # "avg" is deliberately excluded: how many contributions each chunk
        # accumulates is schedule-dependent, so a final global divide is not
        # well-defined for arbitrary programs — author the scale explicitly.
        raise ProgramError(
            f"{p.name}: op {p.op!r} not usable in programs; know {_PROGRAM_OPS}")
    for i, st in enumerate(p.steps):
        where = f"{p.name} step {i}"
        if st.combine not in (WRITE, REDUCE):
            raise ProgramError(f"{where}: unknown combine {st.combine!r}")
        if len(st.send_chunk) != p.n_ranks or len(st.recv_chunk) != p.n_ranks:
            raise ProgramError(
                f"{where}: chunk tables must have length n_ranks={p.n_ranks}")
        for c in (*st.send_chunk, *st.recv_chunk):
            if not 0 <= c < p.n_chunks:
                raise ProgramError(f"{where}: chunk index {c} out of range "
                                   f"[0, {p.n_chunks})")
        srcs = [s for s, _ in st.perm]
        dsts = [d for _, d in st.perm]
        for r in (*srcs, *dsts):
            if not 0 <= r < p.n_ranks:
                raise ProgramError(f"{where}: rank {r} out of range")
        if len(set(srcs)) != len(srcs):
            raise ProgramError(f"{where}: a rank sends twice in one step")
        if len(set(dsts)) != len(dsts):
            raise ProgramError(f"{where}: a rank receives twice in one step")


# --------------------------------------------------------------------------
# Execution
# --------------------------------------------------------------------------


def execute(p: Program, x: torch.Tensor, span=None) -> torch.Tensor:
    """Run ``p`` on rank-major ``x`` (row r = rank r's buffer, any shape,
    flattened to ``n_chunks`` equal chunks, padded as needed). Returns the
    same shape. ``span``: the rank axis across processes, ``x`` this
    process's row."""
    validate(p)
    rows = x.shape[0]
    n = rows if span is None else span.size
    if n != p.n_ranks:
        raise ProgramError(f"{p.name}: program is for {p.n_ranks} ranks, "
                           f"tensor has {n}")
    combine = combine_fn(p.op)
    flat = x.reshape(rows, -1)
    size = flat.shape[1]
    chunk = -(-size // p.n_chunks)
    buf = flat.new_zeros((rows, p.n_chunks, chunk))
    buf.view(rows, -1)[:, :size] = flat

    for st in p.steps:
        if not st.perm:
            continue
        if span is None:
            srcs = [s for s, _ in st.perm]
            dsts = [d for _, d in st.perm]
            outgoing = buf[srcs, [st.send_chunk[s] for s in srcs]]  # a copy
            landing = (dsts, [st.recv_chunk[d] for d in dsts])
        else:
            me = span.index
            outgoing = permute_rows(buf[:, st.send_chunk[me]], st.perm, span)
            if outgoing is None:
                continue
            landing = ([0], [st.recv_chunk[me]])
        if st.combine == REDUCE:
            buf[landing] = combine(buf[landing], outgoing)
        else:
            buf[landing] = outgoing

    return buf.view(rows, -1)[:, :size].reshape(x.shape)


# --------------------------------------------------------------------------
# Simulator (numpy oracle, device-free)
# --------------------------------------------------------------------------


def sim_program(p: Program, bufs: np.ndarray) -> np.ndarray:
    """Oracle: ``bufs[r]`` is rank r's buffer. Same chunking/padding rules
    as :func:`execute`; same result layout."""
    validate(p)
    n = bufs.shape[0]
    assert n == p.n_ranks, f"bufs rows {n} != n_ranks {p.n_ranks}"
    flat = bufs.reshape(n, -1).astype(bufs.dtype)
    elems = flat.shape[1]
    chunk = -(-elems // p.n_chunks)
    state = np.zeros((n, p.n_chunks, chunk), flat.dtype)
    state.reshape(n, -1)[:, :elems] = flat

    red = {"sum": np.add, "prod": np.multiply, "max": np.maximum,
           "min": np.minimum}[p.op]
    for st in p.steps:
        staged = {d: state[s, st.send_chunk[s]].copy() for s, d in st.perm}
        for d, payload in staged.items():
            c = st.recv_chunk[d]
            if st.combine == REDUCE:
                state[d, c] = red(state[d, c], payload)
            else:
                state[d, c] = payload
    return state.reshape(n, -1)[:, :elems].reshape(bufs.shape)


# --------------------------------------------------------------------------
# Stock schedules expressed in the IR
# --------------------------------------------------------------------------


def prog_ring_allreduce(n: int, op: str = "sum") -> Program:
    """The chunked ring (RS phase then AG phase), chunk tables straight from
    ``schedule.py``'s index functions (the ring arm's source of truth)."""
    steps = []
    perm = tuple(S.ring_permutation(n))
    for s in range(n - 1):
        steps.append(Step(
            perm=perm,
            send_chunk=tuple(S.ring_rs_send_chunk(n, s, r) for r in range(n)),
            recv_chunk=tuple(S.ring_rs_recv_chunk(n, s, r) for r in range(n)),
            combine=REDUCE))
    for s in range(n - 1):
        steps.append(Step(
            perm=perm,
            send_chunk=tuple(S.ring_ag_send_chunk(n, s, r) for r in range(n)),
            recv_chunk=tuple(S.ring_ag_recv_chunk(n, s, r) for r in range(n)),
            combine=WRITE))
    return Program(f"ring_allreduce_{n}", n, n, tuple(steps), op)


def prog_ring_allgather(n: int) -> Program:
    """Allgather over an n-chunk buffer: rank r starts owning chunk r (the
    caller lays its shard into chunk r; other chunks are zero) and every
    rank ends with all n chunks."""
    perm = tuple(S.ring_permutation(n))
    steps = tuple(
        Step(perm=perm,
             send_chunk=tuple((r - s) % n for r in range(n)),
             recv_chunk=tuple((r - s - 1) % n for r in range(n)),
             combine=WRITE)
        for s in range(n - 1))
    return Program(f"ring_allgather_{n}", n, n, steps)


def prog_binomial_broadcast(n: int, root: int = 0) -> Program:
    """log2(n) doubling rounds, pairs from ``schedule.bcast_pairs`` —
    single-chunk buffers (chunk tables are all zeros)."""
    zeros = tuple(0 for _ in range(n))
    steps = tuple(
        Step(perm=tuple(S.bcast_pairs(n, mask, root)),
             send_chunk=zeros, recv_chunk=zeros, combine=WRITE)
        for mask in S.binomial_masks(n))
    return Program(f"binomial_broadcast_{n}_root{root}", n, 1, steps)
