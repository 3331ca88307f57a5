"""Host-side process groups — the ``torch.distributed``(gloo) analogue.

The reference stack is consumed through a process-group API: N processes
call ``init_process_group`` with a master address, then issue collectives
on host tensors; RCCL (device) or gloo (host) carries them. This module is
that front door for the host plane here: rendezvous through the
:mod:`transport.bootstrap` store (rank 0 doubles as the master), a TCP
queue-pair ring wired by ``bootstrap_ring``, and numpy-array collectives
riding the net-plugin verbs (`transport/plugin.py`) underneath — the same
stack order as torch→gloo→TCP.

Usage (each of N processes, possibly on different machines)::

    from rocnrdma_tpu_torch import distributed as dist

    pg = dist.init_process_group(rank=r, world_size=n,
                                 master_addr="10.0.0.1", master_port=29500)
    total = pg.all_reduce(my_grads)            # sum by default
    parts = pg.all_gather(my_shard)            # (n, *shard.shape)
    pg.barrier()
    pg.destroy()

With no explicit arguments, ``init_process_group()`` reads the standard
environment: ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT`` —
drop-in for launchers that already export them.

Device-plane collectives (rank-major tensors on the card) live on
:class:`transport.Transport`; this API is for host buffers (optimizer
state, metrics, checkpoint shards) and for machines with no GPU at all.

Tensors: every verb that takes an array also takes a ``torch.Tensor`` on
the CPU or the card and returns tensors on that device, in that dtype
(the tensor front door at the end of this module). A CUDA tensor is
staged through pinned host memory. A ``torch.bfloat16``,
``torch.float8_e4m3fn`` or ``torch.float8_e5m2`` tensor rides as its bits
and folds as the reference's ``ml_dtypes`` arrays fold (widened to float32
an op, rounded to nearest even); the fnuz fp8 dtypes raise
:class:`HostPlaneDtypeError`. Importing this module loads no torch::

    x = torch.randn(1 << 20, device="cuda")
    y = pg.all_reduce(x)                       # a CUDA tensor
"""

from __future__ import annotations

import os
import threading
import time
import weakref

import numpy as np

from rocnrdma_tpu_torch import lockwitness as _lockwitness
from rocnrdma_tpu_torch.metrics import (
    CONF as _CONF,
    STORE as _STORE_OPS,
    VERBS as _VERB_LAT,
    WIRE as _WIRE,
    ConformanceCounters,
)
from rocnrdma_tpu_torch.obs import FLIGHT as _FLIGHT, postmortem as _postmortem
from rocnrdma_tpu_torch.obs import conformance as _conformance
from rocnrdma_tpu_torch.obs import fleet as _fleet
from rocnrdma_tpu_torch.obs import trace as _trace
from rocnrdma_tpu_torch.transport import (
    HostQPNet,
    TCPNet,
    bootstrap,
    plugin,
)
from rocnrdma_tpu_torch.transport import keyspace as _keyspace
from rocnrdma_tpu_torch.transport import lanes as _lanes

_PLANES = {"tcp": TCPNet, "shm": HostQPNet}

# p2p stream-resume control frame (reserved wire tag, next to the host
# nets' LG tags — see the reservation note at HostQPNet._LG_REQ_TAG):
# ``tag(4) | seq(4) | acked_frames(4) | chan(4)``, sent by the RECEIVER
# of an interrupted stream over the re-established connection to name
# the fence-acknowledged cursor the sender must resume from. The frame
# itself always rides CHANNEL 0 (control, like the LG protocol); the
# trailing chan field names the LANE of the stream being resumed — two
# tenants' streams may share a user tag, and the cursor must reach the
# right one.
_P2P_RESUME_TAG = 0xFFFFFF04


def _check_transport(transport: str) -> None:
    if transport not in ("msg", "rdma"):
        raise ValueError(f"unknown transport {transport!r}; "
                         f"know ('msg', 'rdma')")


# ---------------------------------------------------------------------------
# The reshard policy (retry widening for world-size-shaped verbs).
#
# A verb whose INPUTS are shaped by the current world size (alltoall rows,
# the ragged v-counts, scatter's root block) cannot transparently retry on
# a changed membership — but it CAN retry once the membership delta is
# applied to its inputs. The policy, documented in DESIGN.md §5f:
#
# - the delta must be a pure SHRINK (every current member was a member of
#   the aborted attempt — heal only removes ranks or promotes a spare
#   into a dead slot, never invents one); anything else refuses, named;
# - rows/segments/counts addressed to (or contributed by) dead ranks are
#   DROPPED — the surviving selector is the prev-rank index of each
#   current member, in current-rank order, so the retried exchange is
#   exactly the collective the surviving membership would have issued;
# - a promotion-only heal (world size unchanged, a spare adopted the dead
#   slot's identity) is a no-op delta: the retry re-runs unresharded;
# - ONE resharded retry per call: a second abort re-raises (the caller
#   re-issues with shapes for the then-current world), and the heal-level
#   commit-divergence rule carries over unchanged — diverged survivors
#   refuse before any retry, resharded or not.
# ---------------------------------------------------------------------------


def _survivor_rows(pg: "ProcessGroup", prev: list) -> list:
    """Prev-current-rank index of every CURRENT member, in current rank
    order — the row/column/segment selector every reshard policy applies
    to the aborted attempt's world-shaped inputs."""
    return [prev.index(g) for g in pg._ranks]


def _reshard_alltoall(pg, args, kw, prev):
    (x,) = args
    keep = _survivor_rows(pg, prev)
    return (np.ascontiguousarray(np.asarray(x)[keep]),), kw


def _reshard_alltoallv(pg, args, kw, prev):
    segments, counts = args
    keep = _survivor_rows(pg, prev)
    segs = [segments[i] for i in keep]
    return (segs, np.asarray(counts)[np.ix_(keep, keep)]), kw


def _reshard_allgatherv(pg, args, kw, prev):
    x, counts = args
    keep = _survivor_rows(pg, prev)
    return (x, np.asarray(counts).ravel()[keep]), kw


def _reshard_reduce_scatter_v(pg, args, kw, prev):
    x, counts = args
    counts = np.asarray(counts).ravel()
    bounds = np.concatenate([[0], np.cumsum(counts)])
    keep = _survivor_rows(pg, prev)
    flat = np.asarray(x).ravel()
    parts = [flat[bounds[i]:bounds[i + 1]] for i in keep]
    return (np.concatenate(parts), counts[keep]), kw


def _reshard_scatter(pg, args, kw, prev):
    # only the root's input is world-shaped (an (n, ...) block matrix);
    # non-root templates are one row and pass through. Runs AFTER the
    # rooted remap, so kw["root"] is the root's CURRENT index.
    (x,) = args
    x = np.asarray(x)
    if pg.rank == kw.get("root"):
        x = np.ascontiguousarray(x[_survivor_rows(pg, prev)])
    return (x,), kw


# ---------------------------------------------------------------------------
# The node-aware hierarchical host plane (DESIGN.md §5l).
#
# A node map (explicit ``node_of`` at init_process_group, store-published
# and agreed) splits the group into per-node sub-rings over the fast
# intra-node plane (shm by default) plus cross-node rings over the slow
# plane the group was built on. The allreduce schedule is the classic
# two-level decomposition: node-local reduce-scatter -> cross-node
# allreduce -> node-local allgather. When every node has the SAME size
# the cross-node phase is SHARD-PARALLEL — local rank j of every node
# forms one inter-node ring carrying only shard j, so the slow legs run
# concurrently in separate processes and each moves 1/ln of the buffer.
# When heal leaves the nodes unequal (a shrunk node), the schedule
# degrades to the leader relay: chain-reduce the whole buffer onto each
# node's leader (the lowest surviving ORIGINAL rank — re-election is
# exactly "rebuild from the healed member list"), leaders ring the full
# buffer, chain-broadcast back out. Every leg is an existing ring
# collective riding the ``_RingWire.stream`` frame engine, so lanes,
# QoS credits, wire codecs, tracing spans, and the epoch fence apply
# unchanged per leg — and because each leg resolves its codec from ITS
# net's committed wire model, a lane opened with ``codec="auto"``
# compresses ONLY the slow cross-node hop (the per-leg
# arbitration) while the shm legs stay fp32.
# ---------------------------------------------------------------------------

# joiners admitted past the agreed node map get SINGLETON nodes keyed
# safely above any user node id (original ranks are bounded by the
# orig high-water mark, far below this)
_JOINER_NODE_BASE = 1 << 40


class _Hier:
    """One built generation of the hierarchy: the per-leg nets/wires of
    this rank for (epoch, membership). Torn down and rebuilt from the
    CURRENT member list whenever the epoch moves (heal/grow/promotion)
    — which is the whole repair story: a dead node leader re-elects by
    lowest surviving original rank simply because leaders are a pure
    function of the healed membership."""

    __slots__ = ("epoch", "gen", "nodes", "node_idx", "n_nodes",
                 "local_rank", "local_n", "uniform", "is_leader",
                 "local_net", "local_send", "local_recv", "local_client",
                 "inter_net", "inter_send", "inter_recv", "inter_client")

    def __init__(self, epoch, nodes, node_idx, local_rank, uniform):
        self.epoch = epoch
        self.gen = 0                    # rendezvous generation (see _hier_build)
        self.nodes = nodes              # [(node_id, [orig ranks asc])...]
        self.node_idx = node_idx
        self.n_nodes = len(nodes)
        self.local_rank = local_rank
        self.local_n = len(nodes[node_idx][1])
        self.uniform = uniform
        self.is_leader = local_rank == 0
        self.local_net = self.local_send = self.local_recv = None
        self.local_client = None
        self.inter_net = self.inter_send = self.inter_recv = None
        self.inter_client = None

    @property
    def cross_wired(self) -> bool:
        """Whether this rank participates in a cross-node ring (every
        rank on the uniform fast path; leaders only on the relay
        path)."""
        return self.inter_send is not None

    def mirror_lane(self, lane) -> None:
        """Open ``lane`` on every sub-net (idempotent): each net
        resolves lanes from its own registry, and a lane's QoS knobs
        must mean the same thing on every leg. The CODEC knob is the
        per-leg exception — it binds to the CROSS leg only (the slow
        fabric it exists for, ``codec="auto"``'s arbitrated verdict
        made structural): an intra leg honoring an explicit codec
        would quantize the node-local RS partial sums with NO error
        feedback anywhere (the flat path's input-stage EF is the
        group wire's, and the HIER_XLEG residual covers only the
        cross shard), silently degrading convergence. Every rank
        mirrors identically, so both ends of each leg still agree."""
        for net, codec in ((self.local_net, None),
                           (self.inter_net, lane.codec)):
            if net is not None and lane.id != 0:
                net.open_lane(lane.name, priority=lane.priority,
                              credit_bytes=lane.credit_bytes,
                              codec=codec)

    def close(self) -> None:
        """Best-effort teardown (heal-path discipline: a peer may be
        the dead rank; closing cannot make it worse than closed)."""
        for client in (self.local_client, self.inter_client):
            if client is not None:
                try:
                    client.close()
                except (OSError, TimeoutError):
                    pass
        for net in (self.local_net, self.inter_net):
            if net is not None:
                try:
                    net.close()
                except (OSError, TimeoutError):
                    pass


def _hier_bounds(size: int, parts: int) -> list:
    """The ONE shard layout of the hierarchical schedule: floor-balanced
    element bounds over ``parts`` — identical on every rank of every
    node (the same formula as the flat ring chunks), which is what lets
    local rank j's cross-node ring carry exactly the j-th shard of
    every node's partial sum."""
    return [size * i // parts for i in range(parts + 1)]


def hier_allreduce(pg, h: _Hier, x: np.ndarray, op: str = "sum",
                   timeout_s: float = 30.0) -> np.ndarray:
    """The node-aware allreduce schedule over a built :class:`_Hier`
    (see the section comment): local reduce-scatter (leg 1) ->
    cross-node allreduce (leg 2, shard-parallel when uniform, leaders'
    full buffer otherwise) -> local allgather (leg 3). Sum reductions
    on a codec-bearing lane feed the cross leg's re-encode error into
    the group's ResidualStore (the RS-phase partial-sum error feedback
    — ``transport.codec.HIER_XLEG_VERB``), committed only when the
    whole schedule commits. Raises named on any leg failure with a
    ``hier-abort`` flight event, tearing the hierarchy down so the
    healed retry rebuilds it from the new membership."""
    from rocnrdma_tpu_torch.transport import codec as _codec_mod
    x = np.asarray(x)
    shape = np.shape(x)
    flat = x.ravel()
    try:
        # leg 1: node-local reduce-scatter over the intra-node plane
        if h.local_n > 1:
            with _trace.leg(1):
                if h.uniform:
                    shard = plugin.ring_reduce_scatter_over_net(
                        h.local_net, h.local_send, h.local_recv, flat,
                        h.local_rank, h.local_n, op=op,
                        timeout_s=timeout_s)
                else:
                    shard = plugin.ring_chain_reduce_over_net(
                        h.local_net, h.local_send, h.local_recv, flat,
                        h.local_rank, h.local_n, op=op,
                        timeout_s=timeout_s)
        else:
            shard = np.array(flat, copy=True)
        # leg 2: cross-node allreduce of this rank's shard (uniform:
        # every local index's ring runs concurrently; relay: leaders
        # carry the whole node sum). The RS-phase partial sum meets
        # the wire codec HERE — its re-encode error is fed back.
        commit_residual = None
        if h.cross_wired and h.n_nodes > 1 and shard.size:
            shard_wire = shard
            if op == "sum":
                shard_wire, commit_residual = pg._codec_feedback(
                    _codec_mod.HIER_XLEG_VERB, shard, op, "msg",
                    net=h.inter_net, world=h.n_nodes)
            with _trace.leg(2):
                shard = plugin.ring_allreduce_over_net(
                    h.inter_net, h.inter_send, h.inter_recv, shard_wire,
                    h.node_idx, h.n_nodes, op=op, timeout_s=timeout_s)
        # leg 3: node-local allgather of the globally-reduced shards
        if h.local_n > 1:
            with _trace.leg(3):
                if h.uniform:
                    bounds = _hier_bounds(flat.size, h.local_n)
                    counts = [bounds[i + 1] - bounds[i]
                              for i in range(h.local_n)]
                    segs = plugin.ring_allgatherv_over_net(
                        h.local_net, h.local_send, h.local_recv,
                        shard.ravel(), counts, h.local_rank, h.local_n,
                        timeout_s=timeout_s)
                    out = np.concatenate([np.asarray(s).ravel()
                                          for s in segs])
                else:
                    out = plugin.ring_chain_bcast_over_net(
                        h.local_net, h.local_send, h.local_recv,
                        shard.ravel() if h.is_leader else flat,
                        h.local_rank, h.local_n, timeout_s=timeout_s)
        else:
            out = shard.ravel()
        if commit_residual is not None:
            commit_residual()
        _WIRE.hier()
        return out.reshape(shape)
    except (TimeoutError, OSError, RuntimeError) as e:
        # record-and-reraise (the analyzer's hier abort rule): the
        # failed leg's story must reach the postmortem, and the
        # hierarchy tears down so the healed retry rebuilds it from
        # the post-heal membership (a dead leader re-elects here)
        _FLIGHT.record("hier-abort", epoch=pg.epoch, verb="allreduce",
                       error=type(e).__name__)
        pg._hier_burn(h)
        pg._hier_invalidate()
        raise


def hier_reduce_scatter(pg, h: _Hier, x: np.ndarray, rank: int, n: int,
                        op: str = "sum",
                        timeout_s: float = 30.0) -> np.ndarray:
    """Node-aware reduce-scatter: the hierarchical allreduce schedule
    followed by the flat verb's floor-balanced slice for ``rank`` (the
    shm allgather leg re-distributes the full buffer, which on the
    fast intra-node plane costs less than the cross-node bytes the
    hierarchy saves; a slice-early variant is a follow-on). Abort
    semantics as :func:`hier_allreduce`; the handler here names THIS
    verb on the timeline next to the inner leg's record."""
    try:
        total = hier_allreduce(pg, h, x, op=op, timeout_s=timeout_s)
    except (TimeoutError, OSError, RuntimeError) as e:
        _FLIGHT.record("hier-abort", epoch=pg.epoch,
                       verb="reduce_scatter", error=type(e).__name__)
        raise
    flat = total.ravel()
    bounds = _hier_bounds(flat.size, n)
    return np.array(flat[bounds[rank]:bounds[rank + 1]], copy=True)


def hier_allgather(pg, h: _Hier, x: np.ndarray,
                   timeout_s: float = 30.0) -> np.ndarray:
    """Node-aware allgather: node-local allgather over shm (leg 1),
    cross-node exchange of the node blocks (leg 2), then a pure-index
    reorder into GLOBAL current-rank row order (node blocks
    concatenate in node order, which interleaved node maps do not
    share with rank order). On the uniform fast path each per-index
    cross ring carries only ITS floor-balanced SHARD of the node block
    (the rings run concurrently, so the slow fabric moves each node's
    block exactly once in total — every ring carrying the whole block
    would duplicate the cross-node bytes local_n times) and a second
    local allgather (leg 3) reassembles the shards; the unequal-node
    path runs the leaders' ragged allgatherv + chain broadcast."""
    x = np.asarray(x)
    row = np.shape(x)
    try:
        n = sum(len(mem) for _, mem in h.nodes)
        # leg 1: the node block (local_n rows, local-rank order)
        if h.local_n > 1:
            with _trace.leg(1):
                block = plugin.ring_allgather_over_net(
                    h.local_net, h.local_send, h.local_recv, x,
                    h.local_rank, h.local_n, timeout_s=timeout_s)
        else:
            block = np.asarray(x)[None]
        # leg 2: node blocks cross nodes
        if h.n_nodes > 1:
            if h.uniform:
                bf = np.ascontiguousarray(block).ravel()
                b = _hier_bounds(bf.size, h.local_n)
                shard = np.ascontiguousarray(
                    bf[b[h.local_rank]:b[h.local_rank + 1]])
                with _trace.leg(2):
                    # (n_nodes, shard) in node order — shard sizes are
                    # identical across a ring (same local index, equal
                    # blocks), so the dense verb carries it
                    pieces = plugin.ring_allgather_over_net(
                        h.inter_net, h.inter_send, h.inter_recv, shard,
                        h.node_idx, h.n_nodes, timeout_s=timeout_s)
                if h.local_n > 1:
                    counts = [h.n_nodes * (b[i + 1] - b[i])
                              for i in range(h.local_n)]
                    with _trace.leg(3):
                        segs = plugin.ring_allgatherv_over_net(
                            h.local_net, h.local_send, h.local_recv,
                            np.ascontiguousarray(pieces).ravel(),
                            counts, h.local_rank, h.local_n,
                            timeout_s=timeout_s)
                    # segs[i] is node-major (n_nodes, shard_i):
                    # reassemble each node's block from its shards
                    rows_flat = np.empty(h.n_nodes * bf.size, bf.dtype)
                    for i in range(h.local_n):
                        piece = np.asarray(segs[i]).reshape(
                            h.n_nodes, -1)
                        for k in range(h.n_nodes):
                            rows_flat[k * bf.size + b[i]:
                                      k * bf.size + b[i + 1]] = piece[k]
                    rows = rows_flat.reshape((n,) + tuple(row))
                else:
                    rows = np.asarray(pieces).reshape((n,) + tuple(row))
            else:
                counts = [len(mem) * int(np.prod(row, dtype=np.int64))
                          for _, mem in h.nodes]
                if h.cross_wired:
                    with _trace.leg(2):
                        segs = plugin.ring_allgatherv_over_net(
                            h.inter_net, h.inter_send, h.inter_recv,
                            block.ravel(), counts, h.node_idx,
                            h.n_nodes, timeout_s=timeout_s)
                    rows = np.concatenate(
                        [np.asarray(s).ravel() for s in segs])
                else:
                    rows = np.empty(n * int(np.prod(row, dtype=np.int64)),
                                    dtype=np.asarray(x).dtype)
                # leg 3 (relay only): leaders broadcast the assembled
                # node-order rows to their node
                if h.local_n > 1:
                    with _trace.leg(3):
                        rows = plugin.ring_chain_bcast_over_net(
                            h.local_net, h.local_send, h.local_recv,
                            np.asarray(rows).ravel(), h.local_rank,
                            h.local_n, timeout_s=timeout_s)
                rows = np.asarray(rows).reshape((n,) + tuple(row))
        else:
            rows = block
        # node-order -> global current-rank order (pure index math)
        members = [g for _, mem in h.nodes for g in mem]
        out = np.empty_like(rows)
        for i, g in enumerate(members):
            out[pg._ranks.index(g)] = rows[i]
        _WIRE.hier()
        return out
    except (TimeoutError, OSError, RuntimeError) as e:
        _FLIGHT.record("hier-abort", epoch=pg.epoch, verb="allgather",
                       error=type(e).__name__)
        pg._hier_burn(h)
        pg._hier_invalidate()
        raise


class P2PHandle:
    """An in-flight :meth:`ProcessGroup.isend`/:meth:`~ProcessGroup.irecv`
    (the torch ``Work``/request handle). ``wait()`` blocks to completion
    and, for a receive, returns the array; it is idempotent. A handle whose
    ``wait()`` RAISED leaves its (peer, tag) stream undefined — tear the
    group down rather than retry (the sequence slot was claimed at post
    time, unlike blocking ``recv``)."""

    def __init__(self, wait_fn):
        self._wait_fn = wait_fn
        self._done = False
        self._result = None

    def wait(self):
        if not self._done:
            self._result = self._wait_fn()
            self._done = True
        return self._result


class ChannelHandle:
    """One QoS lane's verb surface over an existing :class:`ProcessGroup`
    (returned by :meth:`ProcessGroup.channel`; see there for the lane
    model). Every verb enters the lane's thread-local context, so every
    framed message under the call — ring frames, LG descriptors, p2p
    frames — carries this lane's channel id and lands in its stash on
    the peer.

    Concurrency contract: DIFFERENT handles' collectives may run
    concurrently from separate threads over one group (that is the
    point); ONE handle serializes its own collectives under a per-lane
    mutex — a lane is one ordered stream of collectives, like a CUDA
    stream. Each verb's wall latency is observed into the per-verb
    histograms as ``lane:<name>:<verb>``, so ``fleet_stats()`` reports
    per-lane P50/P99 merged bucket-exact across ranks.

    The ASYNC half (``*_async`` verbs returning
    :class:`transport.coalesce.Future`) rides the lane's coalescer:
    same-(verb, dtype, op) submissions pack into one fused frame
    stream flushed by size/time/barrier triggers (DESIGN.md §5i) —
    the bucket commits as ONE collective on this lane, so heal/retry,
    credit accounting, and op tracing all see a single op."""

    def __init__(self, pg: "ProcessGroup", lane,
                 bucket_bytes: int | None = None,
                 bucket_timeout_s: float | None = None):
        self._pg = pg
        self._lane = lane
        self._mutex = _lockwitness.make_lock(
            "distributed.py::ChannelHandle._mutex")
        self._bucket_bytes = bucket_bytes
        self._bucket_timeout_s = bucket_timeout_s
        self._coalescer = None
        self._coalescer_lock = _lockwitness.make_lock(
            "distributed.py::ChannelHandle._coalescer_lock")

    @property
    def name(self) -> str:
        return self._lane.name

    @property
    def channel_id(self) -> int:
        return self._lane.id

    @property
    def priority(self) -> int:
        return self._lane.priority

    @property
    def credit_bytes(self) -> int | None:
        return self._lane.credit_bytes

    def _run(self, verb: str, call):
        t0 = time.perf_counter()
        # the busy bracket is the priority signal lower lanes throttle
        # on while this lane is mid-collective (LaneGate.busy_enter)
        gate = getattr(self._pg._net, "_lane_gate", None)
        if gate is not None:
            gate.busy_enter(self._lane.id)
        try:
            with self._mutex, _lanes.lane_context(self._lane.id):
                out = call()
        finally:
            if gate is not None:
                gate.busy_exit(self._lane.id)
        _VERB_LAT.observe(f"lane:{self._lane.name}:{verb}",
                          time.perf_counter() - t0)
        return out

    def all_reduce(self, x, op: str = "sum", transport: str = "msg",
                   timeout_s: float | None = None,
                   algorithm: str | None = None) -> np.ndarray:
        return self._run("all_reduce", lambda: self._pg.all_reduce(
            x, op=op, transport=transport, timeout_s=timeout_s,
            algorithm=algorithm))

    def reduce_scatter(self, x, op: str = "sum", transport: str = "msg",
                       timeout_s: float | None = None,
                       algorithm: str | None = None) -> np.ndarray:
        return self._run("reduce_scatter", lambda: self._pg.reduce_scatter(
            x, op=op, transport=transport, timeout_s=timeout_s,
            algorithm=algorithm))

    def all_gather(self, x, transport: str = "msg",
                   timeout_s: float | None = None,
                   algorithm: str | None = None) -> np.ndarray:
        return self._run("all_gather", lambda: self._pg.all_gather(
            x, transport=transport, timeout_s=timeout_s,
            algorithm=algorithm))

    def broadcast(self, x, src: int = 0,
                  timeout_s: float | None = None) -> np.ndarray:
        return self._run("broadcast", lambda: self._pg.broadcast(
            x, src=src, timeout_s=timeout_s))

    def all_to_all(self, x, timeout_s: float | None = None) -> np.ndarray:
        return self._run("all_to_all",
                         lambda: self._pg.all_to_all(x, timeout_s=timeout_s))

    # p2p on the lane: the POST side runs under the lane context (frames
    # stamp this channel; the in-flight registration captures it, so a
    # heal-time resume re-sends/re-posts under the same lane); returned
    # handles' wait() needs no context — their receives were posted
    # here, and the resume protocol reads the registered channel
    def send(self, x, dst: int, tag: int = 0,
             timeout_s: float = 60.0) -> None:
        with _lanes.lane_context(self._lane.id):
            return self._pg.send(x, dst, tag=tag, timeout_s=timeout_s)

    def recv(self, x_like, src: int, tag: int = 0,
             timeout_s: float = 60.0) -> np.ndarray:
        with _lanes.lane_context(self._lane.id):
            return self._pg.recv(x_like, src, tag=tag, timeout_s=timeout_s)

    def isend(self, x, dst: int, tag: int = 0,
              timeout_s: float = 60.0) -> P2PHandle:
        with _lanes.lane_context(self._lane.id):
            return self._pg.isend(x, dst, tag=tag, timeout_s=timeout_s)

    def irecv(self, x_like, src: int, tag: int = 0,
              timeout_s: float = 60.0) -> P2PHandle:
        with _lanes.lane_context(self._lane.id):
            return self._pg.irecv(x_like, src, tag=tag, timeout_s=timeout_s)

    def batch_isend_irecv(self, ops, timeout_s: float = 60.0) -> list:
        with _lanes.lane_context(self._lane.id):
            return self._pg.batch_isend_irecv(ops, timeout_s=timeout_s)

    # -- async verbs (the coalescer surface, transport/coalesce.py) ---------

    def _set_bucket_knobs(self, bucket_bytes: int | None,
                          bucket_timeout_s: float | None) -> None:
        """Adopt a later ``channel()`` call's coalescer knobs: an unset
        knob takes the first stated value; restating the same value is
        a no-op; a CONFLICTING restatement — or any change once the
        coalescer is live (its bucket_bytes is baked in) — refuses,
        the same contract as the lane QoS knobs."""
        with self._coalescer_lock:
            changes = [
                ("bucket_bytes", "_bucket_bytes", bucket_bytes),
                ("bucket_timeout_s", "_bucket_timeout_s", bucket_timeout_s),
            ]
            # validate EVERY knob before adopting ANY: a refusal on the
            # second knob must not leave the first half-applied (a
            # later restatement would then conflict against a value no
            # call ever successfully stated)
            for label, attr, val in changes:
                cur = getattr(self, attr)
                if val is None or val == cur:
                    continue
                if cur is not None or self._coalescer is not None:
                    raise ValueError(
                        f"lane {self._lane.name!r} already open with "
                        f"bucket_bytes={self._bucket_bytes} "
                        f"bucket_timeout_s={self._bucket_timeout_s}"
                        + (" (coalescer active)"
                           if self._coalescer is not None else "")
                        + f"; conflicting re-open of {label} refused")
            for _label, attr, val in changes:
                if val is not None:
                    setattr(self, attr, val)

    @property
    def coalescer(self):
        """This lane's coalescer, created on first use with the
        channel's flush knobs (``bucket_bytes`` defaults to the tuner's
        model pick for this world size)."""
        with self._coalescer_lock:
            if self._coalescer is None:
                from rocnrdma_tpu_torch.transport import coalesce as _coalesce
                from rocnrdma_tpu_torch.transport import tuner as _tuner
                nbytes = self._bucket_bytes
                if nbytes is None:
                    # the pick reads THIS plane's committed wire model
                    # (consolidation: the coalescer and the
                    # frame picks share one fitted alpha/beta source)
                    model = getattr(self._pg._net, "wire_model", None)
                    nbytes = _tuner.pick_bucket_bytes(
                        self._pg.world_size, model=model)
                    # verdict-only conformance coverage:
                    # bucket sizing runs at coalescer construction,
                    # outside any op span — counted, never ratioed
                    _conformance.note_pick(
                        getattr(model, "plane", "?"), "bucket",
                        size_key=nbytes, world=self._pg.world_size,
                        version=getattr(model, "version", None),
                        sched=f"{nbytes // 1024}K")
                self._coalescer = _coalesce.Coalescer(
                    self, nbytes, self._bucket_timeout_s)
            return self._coalescer

    def allreduce_async(self, x, op: str = "sum",
                        timeout_s: float | None = None):
        """Queue an allreduce onto this lane's coalescer; returns a
        :class:`transport.coalesce.Future` resolving to the same value
        ``all_reduce`` would return (a zero-copy view of the fused
        landing buffer). May flush inline when the submit fires the
        size/age trigger — ``timeout_s`` bounds that fused collective."""
        return self.coalescer.submit("allreduce", x, op=op,
                                     timeout_s=timeout_s)

    def allgather_async(self, x, timeout_s: float | None = None):
        """Queue an allgather onto the coalescer (see
        :meth:`allreduce_async`); the future resolves to the
        ``(world_size, *x.shape)`` rows."""
        return self.coalescer.submit("allgather", x, timeout_s=timeout_s)

    def reduce_scatter_async(self, x, op: str = "sum",
                             timeout_s: float | None = None):
        """Queue a reduce-scatter onto the coalescer (see
        :meth:`allreduce_async`); the future resolves to this rank's
        flat floor-balanced shard, exactly ``reduce_scatter``'s value."""
        return self.coalescer.submit("reduce_scatter", x, op=op,
                                     timeout_s=timeout_s)

    def flush(self, timeout_s: float | None = None) -> int:
        """Force-flush the lane's pending buckets (the barrier
        trigger); returns the bucket count flushed — 0 when nothing is
        pending (the empty no-op: no collective runs, nothing
        commits)."""
        with self._coalescer_lock:
            c = self._coalescer
        if c is None:
            return 0
        return c.flush(timeout_s=timeout_s)


class _PostedRecv:
    """One irecv's posted requests (``(offset, nbytes, Request)``), which
    the group's blocking sends and waits, on any thread, test
    (``_p2p_progress``) until a ``wait()`` claims them. ``lock`` makes each
    round of those tests and the claim exclusive, so no request is tested
    by two threads at once, whichever thread waits on the handle."""

    __slots__ = ("reqs", "lock", "claimed")

    def __init__(self, reqs):
        self.reqs = reqs
        self.lock = _lockwitness.make_lock("distributed.py::_PostedRecv.lock")
        self.claimed = False

    def test(self) -> None:
        # never blocks a send: a round that finds the lock held by a
        # claim is skipped, and a claimed entry is never tested again
        if self.lock.acquire(blocking=False):
            try:
                if not self.claimed:
                    for _, _, r in self.reqs:
                        r.test()
            finally:
                self.lock.release()

    def claim(self) -> None:
        with self.lock:
            self.claimed = True


# group -> [_PostedRecv, ...], weakly keyed by the group object: the
# entries go with their group, and a later group never sees them
_P2P_POSTED = weakref.WeakKeyDictionary()
_P2P_POSTED_LOCK = _lockwitness.make_lock("distributed.py::_P2P_POSTED_LOCK")


def _posted_p2p_recvs(pg) -> list:
    """The posted, unclaimed p2p receives on ``pg``, whichever thread
    posted them: a wait on one thread must return the credit of receives
    another thread posted, or a peer whose sends outlast this rank's waits
    for credit only this rank's finished sends would have returned."""
    with _P2P_POSTED_LOCK:
        return _P2P_POSTED.setdefault(pg, [])


class ProcessGroup:
    """N ranks wired in a TCP ring with a shared rendezvous store.

    ``group_name`` namespaces this group's store keys; distinct groups
    sharing one long-lived sidecar store MUST use distinct names (the
    store's keys and barrier counters persist for its lifetime).
    """

    def __init__(self, rank: int, world_size: int, store_handle: str,
                 server: "bootstrap.BootstrapServer | None",
                 timeout_s: float = 30.0, group_name: str = "default",
                 plane: str = "tcp", fault_schedule=None,
                 self_heal: bool = False, standby: str | None = None,
                 node_of=None, intra_plane: str = "shm"):
        self.rank = rank
        self.world_size = world_size
        self.group_name = group_name
        self.plane = plane
        self.timeout_s = timeout_s  # the group's default op deadline
        # elastic-recovery state: the group generation (bumped by every
        # heal; stamped on every wire frame and asserted at the vtable
        # boundary), the current-rank -> ORIGINAL-rank map (identity is
        # the construction-time rank forever — heals re-rank, the oracle
        # keys by who a survivor originally was), and the opt-in flag
        # that lets _ring heal-and-retry instead of raising on a
        # confirmed-dead peer
        self.epoch = 0
        self.last_op_epoch = 0      # epoch the last collective COMMITTED on
        self._op_seq = 0            # collectives COMMITTED (heal divergence
        #                             check: every survivor must agree on
        #                             which op the retry re-executes)
        # multi-tenant lanes: commit bookkeeping moves under a lock
        # (concurrent ChannelHandle verbs commit from their own
        # threads), and at most ONE lane may drive the recovery
        # machinery at a time — a second lane whose collective aborted
        # into the same failure waits here, re-checks the epoch, and
        # retries on the already-healed group instead of double-healing
        self._op_lock = _lockwitness.make_lock(
            "distributed.py::ProcessGroup._op_lock")
        self._recovery_lock = _lockwitness.make_rlock(
            "distributed.py::ProcessGroup._recovery_lock")
        # lane handles are cached ONE per name under their own lock: two
        # threads opening the same lane concurrently must get the SAME
        # handle (the per-lane mutex IS the one-collective-per-lane
        # contract — two handles would be two mutexes, and same-lane
        # collectives would tag-collide on the wire)
        self._channels_lock = _lockwitness.make_lock(
            "distributed.py::ProcessGroup._channels_lock")
        self._channels: dict[str, "ChannelHandle"] = {}
        # quantized-wire error feedback: per-(lane, verb,
        # shape, dtype) residuals carried across rounds by the codec
        # lanes' sum reductions; epoch-scoped (a heal's generation bump
        # deterministically resets a key on first post-heal use)
        from rocnrdma_tpu_torch.transport import codec as _codec_mod
        self._codec_residuals = _codec_mod.ResidualStore()
        # collectives committed per lane (channel id -> count), next to
        # the _op_seq total: the heal/grow divergence check must compare
        # the PER-LANE split — with concurrent lanes, two survivors can
        # agree on the total while disagreeing on which lane's op
        # committed, which is exactly the mixed-retry case the check
        # exists to refuse, named
        self._lane_ops: dict[int, int] = {}
        self._ranks = list(range(world_size))
        self._self_heal = bool(self_heal)
        self._heals = 0
        self._grow_no = 0           # grows issued (namespaces each grow's keys)
        # elasticity bookkeeping: the highest ORIGINAL rank id ever handed
        # out (grow assigns joiners past it — a dead rank's id is never
        # reused, so oracles keyed by original rank stay unambiguous), and
        # the per-slot incarnation counter (bumped when a spare/joiner
        # takes a slot over: p2p stream state from the previous process
        # behind that identity must not resume into the new one)
        self._orig_hwm = world_size
        self._incarnation: dict[int, int] = {}
        self._watchdog_params = None  # (interval_s, timeout_s) when running
        # standby mode: "spare" (bootstrap + pre-listen + heartbeat, sits
        # out of collectives until a heal promotes it) or "joiner"
        # (registers for the next grow()); None = ordinary member
        self._standby = standby
        self._sid = None            # standby slot id in the store registry
        self._standby_listener = None
        # predictive straggler evasion: the armed policy
        # engine (transport/evasion.py), None until enable_evasion().
        # The engine SCORES on rank 0 only; every tick broadcasts the
        # decision + full engine state and all ranks adopt it, so the
        # strike history survives promotions and reshapes in lockstep.
        self._evasion = None
        self._server = server  # only rank 0 (or an external sidecar) owns one
        # the node-aware hierarchy (DESIGN.md §5l): the agreed
        # ORIGINAL-rank -> node-id map (None = flat-only group), the
        # intra-node plane its local sub-rings ride, and the lazily
        # built per-epoch _Hier (one build lock — concurrent lanes'
        # first hierarchical collectives must share one rendezvous)
        self._node_of = None
        if intra_plane not in _PLANES:
            raise ValueError(f"unknown intra_plane {intra_plane!r}; "
                             f"know {sorted(_PLANES)}")
        self._intra_plane = intra_plane
        self._hier: "_Hier | None" = None
        self._hier_lock = _lockwitness.make_lock(
            "distributed.py::ProcessGroup._hier_lock")
        self._hier_stale = False       # deferred-invalidate marker
        self._hier_sizes = None        # (epoch, node-sizes tuple) cache
        if plane not in _PLANES:
            raise ValueError(f"unknown plane {plane!r}; know {sorted(_PLANES)}")
        self._net = _PLANES[plane]()
        if fault_schedule is not None:
            # chaos harness hook: the same group, over a wire that
            # misbehaves on schedule (transport/faults.py)
            from rocnrdma_tpu_torch.transport.faults import FaultNet
            self._net = FaultNet(self._net, fault_schedule)
        self._net.init()
        # the group-level progress hook every _RingWire on this net runs
        # inside its blocking loops: a rank blocked in a COLLECTIVE must
        # still serve its interrupted p2p streams' resume protocol, or a
        # post-heal round can deadlock — peer A drains a resumed receive
        # (bounded) while peer B, whose service alone can re-send the
        # tail, sits in the next collective waiting for A (observed: the
        # lane chaos run lost a ring frame to exactly this cycle when
        # B's last verb-entry service turn missed A's RESUME ack by
        # 0.2 ms). One bool check when nothing is pending.
        self._net._progress_hook = self._resume_progress
        try:
            if standby is not None:
                self._client = bootstrap.BootstrapClient(
                    store_handle, None, timeout_s,
                    scope=f"pg/{group_name}/ring")
                self._send = self._recv = None
                self._register_standby(timeout_s)
            elif world_size > 1:
                # the main store client consults the same fault schedule
                # as the wire (store_conn_drop_ops — the store plane's
                # op_fault analogue); an empty schedule costs one None
                # check per RPC
                self._send, self._recv, self._client = bootstrap.bootstrap_ring(
                    self._net, store_handle, rank, world_size, timeout_s,
                    ns=f"pg/{group_name}/ring",
                    fault_schedule=fault_schedule)
            else:
                self._send = self._recv = self._client = None
            if node_of is not None and standby is None:
                # node-map agreement: every member publishes its
                # topology set-if-absent (first writer wins) and
                # VERIFIES the winner matches its own — a rank holding
                # a different topology than the group agreed on would
                # wire sub-rings nobody else joins, so the mismatch
                # refuses HERE, named, not as a rendezvous timeout
                # later. The intra plane is PART of the agreed
                # topology: the algorithm pick prices intra legs on
                # its model, and a rank pricing them on a different
                # plane could resolve a split flat-vs-hier verdict for
                # the same collective (the exact hazard this check
                # exists to refuse). Standbys pass no map; they read
                # the published one at promotion (_node_map).
                import json as _json
                nm = [int(v) for v in node_of]
                if len(nm) != world_size:
                    raise ValueError(
                        f"node_of must map every rank: got {len(nm)} "
                        f"entries for world_size {world_size}")
                mine = {"node_of": nm, "intra_plane": intra_plane}
                if self._client is not None:
                    winner = _json.loads(self._client.set_if_absent(
                        f"pg/{group_name}/nodemap",
                        _json.dumps(mine, sort_keys=True)))
                    if winner != mine:
                        raise ValueError(
                            f"node map disagreement: rank {rank} passed "
                            f"{mine} but the group agreed on {winner} — "
                            f"every rank must pass the same node_of and "
                            f"intra_plane")
                self._node_of = nm
        except BaseException as e:
            # a failed rendezvous must not leak the net plane (or, via
            # init_process_group, rank 0's master-port listener), nor a
            # standby's pre-published listener (shm: a qp the net does
            # not track); the abort leaves a flight event (analyzer
            # abort-path rule)
            _FLIGHT.record("group-abort", group=group_name, rank=rank,
                           error=type(e).__name__)
            if self._standby_listener is not None:
                bootstrap._close_quietly(self._standby_listener)
            self._net.close()
            raise
        self._barrier_no = 0
        self._watchdog = None
        # guards the watchdog thread's shared health state (_dead,
        # _watchdog_failed): the thread writes, every verb's _check_alive
        # reads — the race-discipline lint (tools/analyze/races.py) holds
        # every touch of thread-written attributes to this lock
        self._health_lock = _lockwitness.make_lock(
            "distributed.py::ProcessGroup._health_lock")
        self._watchdog_failed = None
        self._dead: list[int] = []
        # the fleet plane's coarse health state (obs.fleet.HEALTH_STATES)
        # + the bounded transition log the telemetry snapshots carry.
        # Writes happen at PROTOCOL points on the verb-calling thread
        # (confirmed death, heal/grow entry/commit, admission), never on
        # a timer — so the transition sequence is a pure function of the
        # failure story and replays equal from a chaos seed (the FLEET
        # digest contract). The watchdog thread only READS (to publish),
        # under the same health lock.
        self._health = "resuming" if standby is not None else "ok"
        self._health_log: list = []
        # the per-rank telemetry publisher: the watchdog thread calls
        # publish() on its tick (piggybacking the liveness heartbeat);
        # publish_telemetry()/fleet_stats() are the explicit entries
        self._fleet_agent = _fleet.FleetAgent(self)
        # the telemetry tree's per-node aggregator role:
        # every rank holds one; tick() no-ops unless this rank is its
        # node's elected agent (lowest surviving original in the node
        # — the hier-ring leader's election, dead-set- and
        # heal-re-elected). Rides the watchdog tick after the per-rank
        # publish; strictly best-effort and bounded like it.
        self._node_agent = _fleet.NodeAgent(self)
        self._p2p: dict[tuple, "plugin._RingWire"] = {}  # (peer, dir) -> wire
        # sequence counters are keyed by the peer's ORIGINAL rank (via
        # _pstate): a heal/grow renumbers peers but an unbroken pair's
        # streams continue — the same identity discipline as the oracle
        self._p2p_seq: dict[int, dict] = {}     # orig -> (dir, tag) -> seq
        # in-flight p2p message registrations, (orig, dir, tag) -> state:
        # the stream-resume protocol's bookkeeping (tx keeps the payload
        # for re-queueing; rx keeps the destination + the landed-frame
        # cursor). One registration per stream: a second outstanding op
        # on one (peer, dir, tag) stream is not resume-covered (its
        # failure raises, as before the resume protocol existed).
        self._p2p_inflight: dict[tuple, dict] = {}
        self._p2p_resume_pending = False  # interrupted tx streams awaiting
        #                                   the receiver's RESUME cursor
        # serializes the resume SERVICE: the net-level progress hook
        # makes it reachable from every lane thread concurrently, and
        # two threads both dialing a peer's re-published listener would
        # clobber the (peer, "tx") wire — one re-dial per peer is the
        # protocol (the receiver accepts exactly one). Non-blocking
        # acquire: a progress hook must never block on a sibling's turn.
        self._p2p_service_lock = _lockwitness.make_lock(
            "distributed.py::ProcessGroup._p2p_service_lock")
        self._p2p_listen: dict | None = None    # peer -> listener, once used
        self._p2p_accepted: set[int] = set()
        self._split_no = 0
        self._shrink_no = 0
        # the cross-plane heal hook (DESIGN.md §5g): called with
        # (members, epoch) after every SUCCESSFUL membership change so
        # the device plane (the NCCL communicator, meshes, Transport
        # consumers) can restart on the agreed world — see
        # set_device_heal / _run_device_heal
        self._device_heal_hook = None
        self._destroyed = False
        self._postmortemed = False  # one watchdog flight dump per group
        self._store_handle = store_handle
        # the survivable store (DESIGN.md §5n): replica handles armed on
        # every store client this group creates from now on (main client,
        # watchdog client, split/shrink children adopt at their own init),
        # the local replica/proxy servers this RANK hosts (closed on
        # destroy), and the per-node proxy handle this rank's CLIENTS
        # should prefer for high-rate control traffic (heartbeats,
        # telemetry) once a proxy is adopted
        self._store_failover: list = []
        self._store_replica_server = None
        self._node_proxy = None
        self._store_proxy_handle = None

    # -- collectives (numpy in, numpy out) ---------------------------------

    def _ring(self, fn, *args, timeout_s=None, _reshard=None, **kw):
        # every wire wait under this call is bounded by ONE deadline: the
        # per-call override, else the group default from init — a stalled
        # peer surfaces as a named TimeoutError, never a hang. Rank and
        # world size are injected HERE (not at the verb call sites) so a
        # heal-and-retry re-executes on the post-heal numbering;
        # ``_reshard`` marks verbs whose INPUTS are shaped by the current
        # world size (alltoall rows, ragged counts, scatter's root block):
        # after a membership-changing heal their inputs are re-sharded
        # ONCE through the named policy (see the module-level reshard
        # block) and the retry runs on the new-world shapes — a second
        # abort, or a delta the policy cannot express, refuses named.
        #
        # Exactly-once under retry: every ring_* collective copies its
        # input at entry (np.array(local, copy=True)), so an aborted
        # attempt can only have corrupted ITS OWN working copy — the
        # caller's buffer is preserved until commit, the retry re-reads
        # it, and the epoch fence guarantees no frame of the aborted
        # attempt (whose hop/frame tags the retry REUSES) can leak into
        # the re-execution. The epoch the result committed on is
        # recorded in last_op_epoch.
        t = self.timeout_s if timeout_s is None else timeout_s
        # each attempt either heals (removing >= 1 rank or burning >= 1
        # spare on a promotion) or raises; world size bounds the shrinks,
        # the +2 absorbs a promotion round and one failed-heal re-triage
        attempts = 2 * self.world_size + 2
        reshard_left = 1
        heal_retry_left = 1
        for _ in range(max(1, attempts)):
            # the attempt's generation and membership, captured BEFORE
            # the collective runs: with concurrent lanes another lane's
            # heal may land mid-attempt, and the retry decisions below
            # (skip-the-second-heal, root remap, reshard) must compare
            # against the world THIS attempt's inputs were shaped for
            epoch0 = self.epoch
            prev = list(self._ranks)
            # the attempt's causal-trace identity: the op number this
            # collective will COMMIT as on its lane (one collective per
            # lane at a time — the per-lane mutex — so the pre-commit
            # count IS the op being executed), plus the attempt's epoch
            # and lane chan. A sampled op's span collects the wire's
            # frame/wait events into one per-rank op record (obs.trace);
            # a retried attempt re-opens the span under the new epoch.
            chan = _lanes.current_channel()
            with self._op_lock:
                op_no = self._lane_ops.get(chan, 0)
            try:
                self._check_alive()  # fail fast instead of hanging on the dead
                if self.world_size > 1 and (self._send is None
                                            or self._recv is None):
                    # a FAILED heal can leave the ring half-rewired (a
                    # dial toward a dead promotion target never came up):
                    # route straight back into the heal instead of
                    # handing a dead edge to the collective
                    raise OSError("ring wiring torn by a failed repair; "
                                  "re-healing")
                with _trace.op_span(epoch0, chan, op_no,
                                    getattr(fn, "__name__", "collective"),
                                    self.rank):
                    out = fn(self._net, self._send, self._recv, *args,
                             self.rank, self.world_size, timeout_s=t, **kw)
            except (TimeoutError, OSError, RuntimeError) as e:
                # CLEAN-ABORT: the collective died with a named error —
                # on the flight timeline either way; with self-healing
                # on, a CONFIRMED-dead peer triggers heal + transparent
                # retry, anything else (slow peer, watchdog suicide,
                # exhausted retries) re-raises to the caller
                _FLIGHT.record("collective-abort", epoch=self.epoch,
                               error=type(e).__name__)
                if not self._self_heal:
                    raise
                try:
                    # one lane at a time drives recovery: a concurrent
                    # lane whose collective aborted into the SAME
                    # failure blocks here, sees the advanced epoch, and
                    # goes straight to its retry on the healed group —
                    # two lanes can never heal (or propose epochs)
                    # concurrently on one rank
                    with self._recovery_lock:
                        if self.epoch == epoch0:
                            self._heal_for(e, t)
                except (TimeoutError, OSError) as he:
                    # a FAILED heal — e.g. the promoted spare died before
                    # wiring, stranding the wired barrier. The heal's
                    # failure path re-armed the watchdog, so one
                    # re-triage is sound: the next attempt fails fast on
                    # _check_alive and heals again (the dead spare is
                    # burned — its admit record exists — so the re-heal
                    # shrinks instead). One retry only; "slow, not dead"
                    # verdicts (heal re-raising the ORIGINAL error) and a
                    # second heal failure propagate.
                    if he is e or heal_retry_left == 0:
                        raise
                    heal_retry_left -= 1
                    _FLIGHT.record("heal-retry", epoch=self.epoch,
                                   error=type(he).__name__)
                    continue
                root_kw = next((k for k in ("root",) if k in kw), None)
                if root_kw is not None:
                    # rooted verbs name a rank: follow the ROOT's identity
                    # through the re-ranking (a retried broadcast must
                    # still source the same original rank) — a spare
                    # promoted into the dead root's identity satisfies
                    # this (the slot is still a member); only a root that
                    # died with NO spare to take its place refuses
                    gid = prev[kw[root_kw]]
                    if gid not in self._ranks:
                        raise RuntimeError(
                            f"{getattr(fn, '__name__', 'collective')}: "
                            f"the root (original rank {gid}) died; a "
                            f"rooted collective cannot retry without its "
                            f"root — re-issue with a surviving root"
                        ) from e
                    kw[root_kw] = self._ranks.index(gid)
                if _reshard is not None and list(self._ranks) != prev:
                    # world-size-shaped inputs meet a changed membership:
                    # apply the reshard policy once; refuse (named) a
                    # second delta or one that is not a pure shrink
                    if reshard_left == 0 or not set(self._ranks) <= set(prev):
                        raise RuntimeError(
                            f"{getattr(fn, '__name__', 'collective')}: "
                            f"membership changed again after the one "
                            f"resharded retry (or grew mid-retry) — "
                            f"re-issue with shapes for the current world "
                            f"size") from e
                    reshard_left -= 1
                    args, kw = _reshard(self, args, kw, prev)
                    _FLIGHT.record(
                        "reshard-retry", epoch=self.epoch,
                        verb=getattr(fn, "__name__", "collective"),
                        dropped=len(prev) - self.world_size)
                continue
            with self._op_lock:
                self.last_op_epoch = self.epoch
                self._op_seq += 1
                self._lane_ops[chan] = self._lane_ops.get(chan, 0) + 1
            return out
        raise RuntimeError(
            f"self-heal retry budget exhausted for group "
            f"{self.group_name!r} (epoch {self.epoch})")

    def _heal_for(self, exc, timeout_s: float) -> None:
        """A collective just aborted: wait (briefly) for the failure
        detector's verdict, then heal if a peer is confirmed dead, else
        re-raise ``exc`` — slow is not dead, and healing away a live
        rank on a timeout alone would be the split-brain this protocol
        exists to prevent."""
        wd = self._watchdog_params
        verdict_wait = (wd[0] + wd[1] + 1.0) if wd is not None else 2.0
        silence_s = wd[1] + wd[0] if wd is not None else max(timeout_s, 15.0)
        deadline = time.monotonic() + verdict_wait
        from rocnrdma_tpu_torch.transport.backoff import poll_backoff
        back = poll_backoff()
        while True:
            suspects = set(self.dead_ranks())
            if not suspects:
                try:
                    # with a watchdog running every rank heartbeats the
                    # store each tick, so store silence past one watchdog
                    # timeout IS the dead-vs-slow verdict; without one,
                    # the long floor keeps a jit-compiling rank alive
                    suspects = set(self._client.dead_ranks(
                        self.world_size, max_age_s=silence_s))
                except (OSError, TimeoutError):
                    suspects = set()
            suspects &= set(range(self.world_size))
            if suspects:
                break
            if time.monotonic() >= deadline:
                raise exc
            back.pause()
        # the verdict is in: a confirmed death moves health to degraded
        # BEFORE the heal flips it to healing — the same transition (and
        # the same cause string) whether _check_alive or this triage saw
        # it first, so the fleet transition sequence replays equal
        self._set_health("degraded", cause="peer-dead")
        self.heal(timeout_s=timeout_s, _suspects=suspects)

    def all_reduce(self, x, op: str = "sum", transport: str = "msg",
                   timeout_s: float | None = None,
                   algorithm: str | None = None) -> np.ndarray:
        """Elementwise reduction across ranks (op: sum/prod/max/min/avg);
        every rank gets the result, shape preserved. ``transport``:
        ``"msg"`` (two-sided send/recv ring) or ``"rdma"`` (one-sided
        put-based ring — data written straight into peer MRs with doorbell
        flags, no posted receives on the data path).

        On a lane opened with a wire ``codec`` (``channel(name,
        codec=...)``) the msg-path frames ride the wire quantized and a
        sum reduction additionally runs under ERROR FEEDBACK: the
        carried residual folds into this round's input, the
        quantization-committed value rides the wire, and the new
        residual commits only when the collective does (DESIGN.md
        §5k).

        ``algorithm``: ``"ring"`` — the flat ring over the
        group's plane — or ``"hier"`` — the node-aware two-level
        schedule (local reduce-scatter over the intra-node plane,
        cross-node allreduce, local allgather; needs a ``node_of`` map
        at init). None (default) lets the committed wire models pick
        (``tuner.pick_algorithm``) on node-mapped groups and keeps the
        flat ring otherwise; the verdict lands on the negotiation
        gauge either way."""
        x = np.asarray(x)
        _check_transport(transport)  # validate even at world size 1
        wire_op = self._avg_wire_op(x, op, "all_reduce")
        if self.world_size == 1:
            return x.copy()
        if self._pick_wire_algorithm(x, transport, algorithm) == "hier":
            # the hierarchical schedule runs its OWN error feedback on
            # the cross-node leg (the partial sum is what quantizes) —
            # the flat input-stage EF deliberately does not run
            out = self._ring(self._hier_fn("allreduce"), x, op=wire_op,
                             timeout_s=timeout_s)
            return self._avg_finalize(out, x, op)
        fn = (plugin.ring_allreduce_rdma if transport == "rdma"
              else plugin.ring_allreduce_over_net)
        x_wire, commit_residual = self._codec_feedback(
            "all_reduce", x, wire_op, transport)
        out = self._ring(fn, x_wire, op=wire_op, timeout_s=timeout_s)
        if commit_residual is not None:
            commit_residual()
        return self._avg_finalize(out, x, op)

    def reduce_scatter(self, x, op: str = "sum", transport: str = "msg",
                       timeout_s: float | None = None,
                       algorithm: str | None = None) -> np.ndarray:
        """Reduce across ranks (op: sum/prod/max/min/avg); rank r keeps the
        r-th of n floor-balanced element ranges of the flattened buffer.
        ``transport``: ``"msg"`` (send/recv ring) or ``"rdma"`` (one-sided
        put-based ring, as in :meth:`all_reduce`). Quantized-lane sum
        reductions run under error feedback like :meth:`all_reduce`;
        ``algorithm`` picks flat-vs-hierarchical like
        :meth:`all_reduce` too."""
        x = np.asarray(x)
        _check_transport(transport)
        wire_op = self._avg_wire_op(x, op, "reduce_scatter")
        if self.world_size == 1:
            return x.ravel().copy()
        if self._pick_wire_algorithm(x, transport, algorithm,
                                     verb="reduce_scatter") == "hier":
            out = self._ring(self._hier_fn("reducescatter"), x,
                             op=wire_op, timeout_s=timeout_s)
            return self._avg_finalize(out, x, op)
        fn = (plugin.ring_reduce_scatter_rdma if transport == "rdma"
              else plugin.ring_reduce_scatter_over_net)
        x_wire, commit_residual = self._codec_feedback(
            "reduce_scatter", x, wire_op, transport)
        out = self._ring(fn, x_wire, op=wire_op, timeout_s=timeout_s)
        if commit_residual is not None:
            commit_residual()
        return self._avg_finalize(out, x, op)

    def _codec_feedback(self, verb: str, x: np.ndarray, wire_op: str,
                        transport: str, net=None,
                        world: int | None = None):
        """The error-feedback entry of the quantized reducing verbs:
        ``(x_wire, commit)`` — the value to put on the wire and the
        residual-commit callback to run AFTER the collective commits
        (None when the call does not quantize: no lane codec, a
        non-msg transport, a non-sum reduction — max/min/prod have no
        accumulating bias to feed back — or a non-floating dtype,
        which passes through the wire uncompressed anyway).

        ``x_wire = x + residual`` quantization-committed through the
        codec's roundtrip; the residual is EXACTLY what quantization
        dropped this round (the codec's power-of-two scales make the
        committed value ride hop 0 losslessly). Keys are (lane, verb,
        shape, dtype); epoch discipline — a healed rank's residual
        resets deterministically — lives in the store
        (``transport.codec.ResidualStore``). An aborted attempt never
        commits, so heal-and-retry is exactly-once for the residual
        too (the retry re-reads the same ``x_wire``).

        ``net``/``world``: the hierarchical schedule's
        cross-node leg runs the SAME feedback against the inter-node
        sub-net's committed model and ring size (verb
        ``codec.HIER_XLEG_VERB`` — the RS-phase partial sum is what
        quantizes there); default is the group's own net and world."""
        from rocnrdma_tpu_torch.transport import codec as _codec
        net = self._net if net is None else net
        n = self.world_size if world is None else int(world)
        allreduce_shaped = verb in ("all_reduce", _codec.HIER_XLEG_VERB)
        if transport != "msg" or wire_op != "sum":
            return x, None
        reg = getattr(net, "lanes", None)
        chan = _lanes.current_channel()
        lane = reg.get(chan) if reg is not None else None
        name = lane.codec if lane is not None else None
        if name is None:
            return x, None
        if not _codec.WireCodec.supports(x.dtype):
            return x, None
        if name == "auto":
            # THE pure pick the wire's stream negotiation will run —
            # the size_key comes from the ONE shared definition
            # (plugin.allreduce_size_key), so the EF verdict and the
            # wire's frame-level verdict can never disagree (per LEG:
            # the hierarchical cross leg resolves against the inter
            # plane's model, exactly as its own stream will)
            model = getattr(net, "wire_model", None)
            if model is None:
                return x, None
            if allreduce_shaped:
                size_key = plugin.allreduce_size_key(
                    model, x.size, x.dtype.itemsize, n,
                    credit_bytes=lane.credit_bytes)
            else:  # reduce_scatter: the generic schedule's max chunk
                size_key = max(x.size * (i + 1) // n - x.size * i // n
                               for i in range(n)) * x.dtype.itemsize
            name = model.pick_codec(size_key, x.dtype.itemsize, world=n)
            # verdict-only conformance coverage: the codec
            # arbitration's verdict, recorded where it resolves
            _conformance.note_pick(
                model.plane, "codec", size_key=size_key, world=n,
                version=model.version, sched=name or "off")
            if name is None:
                return x, None
        codec = _codec.get(name)
        key = (chan, verb, tuple(np.shape(x)), str(x.dtype))
        epoch0 = self.epoch
        if allreduce_shaped:
            q, res, payload = self._codec_residuals.feedback(
                key, x, epoch0, codec, want_payload=True)
        else:
            # reduce_scatter's hop-0 send is a chunk, never the whole
            # buffer — don't pay the EF pass's fused payload emit for
            # a stash nothing could consume
            q, res = self._codec_residuals.feedback(key, x, epoch0, codec)
            payload = None
        # the wire may skip the exchange-and-fold image commit: q is
        # already on the quantization grid (consumed at stream entry);
        # when the EF pass emitted the exact wire payload, a matching
        # single-frame hop-0 send also skips its re-encode (only the
        # allreduce exchange-and-fold sends the WHOLE buffer as hop 0
        # — any other shape mismatches and drops the stash harmlessly)
        _codec.mark_input_committed()
        if payload is not None and allreduce_shaped:
            _codec.stash_payload(x.nbytes, x.dtype, payload)

        def commit():
            # q's buffer becomes the key's reusable scratch (the ring
            # copied it at entry; nothing references it past commit)
            self._codec_residuals.commit(key, epoch0, res, q=q)
        return q, commit

    def all_gather(self, x, transport: str = "msg",
                   timeout_s: float | None = None,
                   algorithm: str | None = None) -> np.ndarray:
        """Every rank contributes ``x`` (same shape everywhere); returns
        ``(world_size, *x.shape)`` in rank order. ``transport`` as in
        :meth:`all_reduce`; ``algorithm`` picks flat-vs-hierarchical
        like :meth:`all_reduce` (node blocks gather locally, cross
        nodes once, and reorder into rank order)."""
        x = np.asarray(x)
        _check_transport(transport)
        if self.world_size == 1:
            return x[None].copy()
        if self._pick_wire_algorithm(x, transport, algorithm,
                                     verb="allgather") == "hier":
            return self._ring(self._hier_fn("allgather"), x,
                              timeout_s=timeout_s)
        fn = (plugin.ring_allgather_rdma if transport == "rdma"
              else plugin.ring_allgather_over_net)
        return self._ring(fn, x, timeout_s=timeout_s)

    def broadcast(self, x, src: int = 0,
                  timeout_s: float | None = None) -> np.ndarray:
        """Every rank returns rank ``src``'s buffer (non-src inputs size the
        receive buffer)."""
        x = np.asarray(x)
        plugin._check_root(src, self.world_size)
        if self.world_size == 1:
            return x.copy()
        return self._ring(plugin.ring_broadcast_over_net, x, root=src,
                          timeout_s=timeout_s)

    def all_to_all(self, x, timeout_s: float | None = None) -> np.ndarray:
        """``x`` is ``(world_size, ...)``; row j goes to rank j. Returns the
        rows addressed to this rank, in source-rank order."""
        x = np.asarray(x)
        if self.world_size == 1:
            return x.copy()
        return self._ring(plugin.ring_alltoall_over_net, x,
                          timeout_s=timeout_s, _reshard=_reshard_alltoall)

    def all_to_all_v(self, segments: list, counts, dtype="float32",
                     timeout_s: float | None = None) -> list:
        """Variable-count alltoall (the RCCL ``ncclAllToAllv`` extension):
        ``segments[j]`` (``counts[self.rank, j]`` elements) goes to rank j;
        returns the n received segments in source order. ``counts`` is the
        full (n, n) element-count matrix, identical on every rank.
        ``dtype`` is the wire dtype and MUST be passed explicitly when not
        float32 — inferring it per rank from the segments would let ranks
        disagree on itemsize (an empty list infers float64) and desync the
        exchange byte counts."""
        # world_size == 1 still routes through the plugin so counts/segment
        # validation behaves identically to multi-rank runs
        return self._ring(plugin.ring_alltoallv_over_net, segments,
                          np.asarray(counts), dtype=dtype,
                          timeout_s=timeout_s, _reshard=_reshard_alltoallv)

    def all_gather_v(self, x, counts,
                     timeout_s: float | None = None) -> list:
        """Ragged allgather (gloo/MPI ``allgatherv``): rank r contributes
        ``counts[r]`` elements; every rank returns the n segments in rank
        order. ``counts`` is the length-n vector every rank knows (the MPI
        contract). Completes the ragged family next to
        :meth:`all_to_all_v`."""
        x = np.asarray(x)
        counts = np.asarray(counts)
        if self.world_size == 1:
            # still routes validation through the plugin convention: one
            # segment, counts[0] must match
            return plugin.ring_allgatherv_over_net(
                None, None, None, x, counts, 0, 1)
        return self._ring(plugin.ring_allgatherv_over_net, x, counts,
                          timeout_s=timeout_s, _reshard=_reshard_allgatherv)

    def reduce_scatter_v(self, x, counts, op: str = "sum",
                         timeout_s: float | None = None) -> np.ndarray:
        """Ragged reduce-scatter (MPI ``Reduce_scatter`` with recvcounts):
        ``x`` is the concatenation of n chunks sized by ``counts`` (same
        layout everywhere); rank r returns the reduction of every rank's
        chunk r (op: sum/prod/max/min/avg)."""
        x = np.asarray(x)
        counts = np.asarray(counts)
        wire_op = self._avg_wire_op(x, op, "reduce_scatter_v")
        if self.world_size == 1:
            out = plugin.ring_reduce_scatter_v_over_net(
                None, None, None, x, counts, 0, 1, op=wire_op)
        else:
            out = self._ring(plugin.ring_reduce_scatter_v_over_net, x,
                             counts, op=wire_op, timeout_s=timeout_s,
                             _reshard=_reshard_reduce_scatter_v)
        return self._avg_finalize(out, x, op)

    def _avg_wire_op(self, x, op: str, verb: str) -> str:
        """Shared avg handling: validate the dtype, map avg to a sum on the
        wire (finalized by :meth:`_avg_finalize`), and reject unknown ops —
        identically at EVERY world size, so a script debugged at world size
        1 cannot silently pass a knob that explodes at world size N."""
        if op == "avg":
            if not np.issubdtype(x.dtype, np.floating):
                raise ValueError(
                    f"{verb} op='avg' needs a float dtype, got {x.dtype} "
                    f"(an integer average would silently truncate)")
            return "sum"
        plugin._NET_REDUCE_OPS[op]  # KeyError = unknown op, caller's bug
        return op

    def _avg_finalize(self, out, x, op: str):
        if out is not None and op == "avg":
            out = (out / self.world_size).astype(x.dtype)
        return out

    def reduce(self, x, dst: int = 0, op: str = "sum",
               timeout_s: float | None = None) -> np.ndarray | None:
        """Rooted reduction: every rank contributes ``x``; only rank ``dst``
        returns the reduced array (others return None, torch semantics).
        Pipelined chain reduce toward the root under the hood."""
        x = np.asarray(x)
        wire_op = self._avg_wire_op(x, op, "reduce")
        plugin._check_root(dst, self.world_size)
        if self.world_size == 1:
            return x.copy()
        out = self._ring(plugin.ring_reduce_over_net, x, root=dst,
                         op=wire_op, timeout_s=timeout_s)
        return self._avg_finalize(out, x, op)

    def gather(self, x, dst: int = 0,
               timeout_s: float | None = None) -> np.ndarray | None:
        """Rooted gather: every rank contributes ``x`` (same shape
        everywhere); rank ``dst`` returns ``(world_size, *x.shape)`` in rank
        order, others return None."""
        x = np.asarray(x)
        plugin._check_root(dst, self.world_size)
        if self.world_size == 1:
            return x[None].copy()
        return self._ring(plugin.ring_gather_over_net, x, root=dst,
                          timeout_s=timeout_s)

    def scatter(self, x, src: int = 0,
                timeout_s: float | None = None) -> np.ndarray:
        """Rooted scatter: rank ``src`` passes ``(world_size, ...)`` — row j
        goes to rank j; every OTHER rank passes a template of one row's
        shape/dtype (contents ignored, it sizes the receive). Every rank
        returns its row."""
        x = np.asarray(x)
        plugin._check_root(src, self.world_size)
        if self.world_size == 1:
            if x.shape[0] != 1:
                raise ValueError(f"scatter root wants (1, ...), got {x.shape}")
            return x[0].copy()
        return self._ring(plugin.ring_scatter_over_net, x, root=src,
                          timeout_s=timeout_s, _reshard=_reshard_scatter)

    # -- the node-aware hierarchy (DESIGN.md §5l) -----------------

    def _node_map(self, timeout_s: float) -> list:
        """The agreed ORIGINAL-rank -> node-id map. Members carry it
        from construction; a promoted spare/joiner reads the published
        copy (its adopted identity indexes the same map, and the
        published intra plane is adopted with it — part of the agreed
        topology)."""
        if self._node_of is None:
            import json
            if self._client is None:
                raise RuntimeError(
                    "hierarchical collective without a node map: pass "
                    "node_of= at init_process_group")
            raw = self._client.try_get(f"pg/{self.group_name}/nodemap",
                                       timeout_s=timeout_s)
            if raw is None:
                raise RuntimeError(
                    "hierarchical collective without a node map: the "
                    "group published none (pass node_of= at "
                    "init_process_group on every member)")
            agreed = json.loads(raw)
            self._intra_plane = str(agreed["intra_plane"])
            self._node_of = [int(v) for v in agreed["node_of"]]
        return self._node_of

    def _hier_nodes(self, node_of: list) -> list:
        """The CURRENT membership split into nodes: ``[(node_id,
        [original ranks ascending]), ...]`` ordered by each node's
        lowest original rank — a pure function of (members, map), so
        every rank (and every post-heal rebuild) derives the same
        topology, leaders included (leader = the node's first entry =
        the lowest SURVIVING original rank: re-election is free)."""
        by_node: dict = {}
        for g in self._ranks:
            nid = node_of[g] if g < len(node_of) else _JOINER_NODE_BASE + g
            by_node.setdefault(nid, []).append(g)
        nodes = [(nid, sorted(mem)) for nid, mem in by_node.items()]
        nodes.sort(key=lambda kv: kv[1][0])
        return nodes

    def _hier_node_sizes(self) -> tuple:
        """Per-node member counts of the current membership (node-order
        tuple) — ``tuner.pick_algorithm``'s topology input. Cached per
        epoch: the auto pick runs this on EVERY node-mapped collective,
        and the split is a pure function of (epoch, membership) —
        membership only ever changes with an epoch bump (heal/grow/
        promotion), so the epoch key alone invalidates it."""
        cached = self._hier_sizes
        if cached is not None and cached[0] == self.epoch:
            return cached[1]
        node_of = self._node_map(self.timeout_s)
        sizes = tuple(len(mem) for _, mem in self._hier_nodes(node_of))
        self._hier_sizes = (self.epoch, sizes)
        return sizes

    def _pick_wire_algorithm(self, x: np.ndarray, transport: str,
                             algorithm: str | None,
                             verb: str = "allreduce") -> str:
        """Resolve the flat-vs-hierarchical verdict for one reducing/
        gathering collective: the caller's explicit override, else —
        on a node-mapped msg-path group — the committed models'
        ``tuner.pick_algorithm`` (pure, so every rank resolves the
        same schedule; the gauge pins the verdict on the record).
        ``verb`` prices the schedule actually being run — the three
        verbs' flat wire patterns differ (see the pick's docstring)."""
        if algorithm is not None and algorithm not in ("ring", "hier"):
            raise ValueError(f"unknown algorithm {algorithm!r}; "
                             f"know ('ring', 'hier')")
        if algorithm == "hier" and transport != "msg":
            raise ValueError(
                "algorithm='hier' rides the msg wire; the rdma "
                "put-path keeps the flat ring")
        if algorithm is None:
            if (self._node_of is None or transport != "msg"
                    or self.world_size < 2):
                return "ring"
            from rocnrdma_tpu_torch.transport import tuner as _tuner
            model = getattr(self._net, "wire_model", None)
            if model is None:
                return "ring"
            reg = getattr(self._net, "lanes", None)
            lane = (reg.get(_lanes.current_channel())
                    if reg is not None else None)
            algorithm = _tuner.pick_algorithm(
                x.nbytes, self._hier_node_sizes(), flat=model,
                intra=_tuner.host_wire_model(self._intra_plane),
                credit_bytes=lane.credit_bytes
                if lane is not None else None, verb=verb)
            # verdict-only conformance coverage: the hier
            # arbitration's verdict on the flat plane's model — the
            # chosen schedule's stream prices itself downstream
            _conformance.note_pick(
                model.plane, "algorithm", size_key=x.nbytes,
                world=self.world_size, version=model.version,
                sched=algorithm)
        if self._node_of is not None or algorithm == "hier":
            _WIRE.algorithm_picked(algorithm)
        return algorithm

    def _hier_fn(self, verb: str):
        """The ``_ring``-shaped wrapper of the hierarchical schedule:
        resolves the hierarchy PER ATTEMPT (a healed retry rebuilds it
        from the post-heal membership — the repair path) and runs the
        module-level ``hier_*`` schedule on it."""
        pg = self

        def run(net, send, recv, x, rank, n, timeout_s=30.0, op="sum"):
            h = pg._hier_ensure(timeout_s)
            if verb == "allreduce":
                return hier_allreduce(pg, h, x, op=op,
                                      timeout_s=timeout_s)
            if verb == "reducescatter":
                return hier_reduce_scatter(pg, h, x, rank, n, op=op,
                                           timeout_s=timeout_s)
            return hier_allgather(pg, h, x, timeout_s=timeout_s)

        run.__name__ = f"hier_{verb}"
        return run

    def hierarchy(self, timeout_s: float | None = None) -> dict:
        """Build (or fetch) this epoch's hierarchy and describe it:
        the node split of the CURRENT membership (original ranks), the
        per-node leaders, this rank's place, and whether the
        shard-parallel fast path applies (uniform node sizes). Blocks
        on the group-wide sub-ring rendezvous when a build is needed —
        every member must call a hierarchical verb (or this) for the
        build to complete."""
        t = self.timeout_s if timeout_s is None else timeout_s
        h = self._hier_ensure(t)
        return {"epoch": h.epoch,
                "nodes": {str(nid): list(mem) for nid, mem in h.nodes},
                "leaders": [mem[0] for _, mem in h.nodes],
                "node_idx": h.node_idx,
                "local_rank": h.local_rank,
                "local_n": h.local_n,
                "uniform": h.uniform,
                "is_leader": h.is_leader,
                "cross_wired": h.cross_wired,
                "intra_plane": self._intra_plane,
                "inter_plane": self.plane}

    def _hier_ensure(self, timeout_s: float) -> "_Hier":
        """The current epoch's hierarchy, building it when the epoch
        moved (or nothing was built yet). One build at a time per rank
        (concurrent lanes share the rendezvous); the namespace is
        epoch-qualified, so post-heal rebuilds can never pair with a
        dead generation's listeners."""
        deadline = time.monotonic() + timeout_s
        with self._hier_lock:
            h = self._hier
            if (h is not None and h.epoch == self.epoch
                    and not self._hier_stale):
                return h
            if h is not None:
                self._hier = None
                if h.epoch == self.epoch:
                    # a same-epoch discard (deferred invalidate after an
                    # abort): its rendezvous generation was consumed —
                    # mark it so the rebuild probes past it (old-epoch
                    # namespaces are never revisited, no burn needed)
                    self._hier_burn(h)
                h.close()
            while True:
                self._hier_stale = False
                h = self._hier_build(max(0.1,
                                         deadline - time.monotonic()))
                # a heal/grow that landed MID-build may have bumped the
                # epoch and rewired the membership after the build
                # snapshotted them (its _hier_invalidate defers against
                # our held lock, setting only the stale flag) — a torn
                # result (new epoch over old members, or vice versa)
                # must never be accepted as current
                if (not self._hier_stale and h.epoch == self.epoch
                        and set(g for _, mem in h.nodes for g in mem)
                        == set(self._ranks)):
                    self._hier = h
                    return h
                if h.epoch == self.epoch:
                    # same-epoch discard: its generation's rendezvous
                    # keys point at the listeners the close below
                    # retires — burn it or the retry redials them
                    self._hier_burn(h)
                h.close()
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        "hier build: membership kept changing under "
                        "the build until the deadline")

    def _hier_invalidate(self, wait_s: float = 0.2) -> None:
        """Tear the hierarchy down (heal/grow/promotion, an aborted
        hierarchical collective, destroy): sub-ring state is a pure
        function of (epoch, membership) and is rebuilt from scratch by
        the next hierarchical collective — which is exactly how a dead
        node leader re-elects (the rebuild's node split of the healed
        member list puts the lowest surviving original rank first).

        Bounded acquire: a concurrent lane's IN-FLIGHT build holds the
        lock for a group-wide rendezvous that may itself be hanging on
        the dead member this invalidation's heal is removing — a heal
        fence parked behind it would burn its own deadline funding the
        doomed build. When the lock is busy, teardown is DEFERRED to
        the next ``_hier_ensure`` via the ``_hier_stale`` marker: the
        heal-path case closes there on the epoch check, and a SAME-
        epoch abort (self_heal off / unconfirmed failure) closes on
        the marker — without it the retry would reuse sub-ring comms
        still holding the aborted leg's mid-stream frames.

        A deferral is self-cleaning even when no later collective
        runs (destroy): the lock holder is mid-``_hier_ensure``, whose
        loop closes any result the stale marker condemns and whose
        build is itself deadline-bounded — ``wait_s`` only trades how
        long THIS caller waits before handing off (destroy passes a
        longer bound so the common case tears down inline; heal keeps
        the short one so a fence never funds a doomed build)."""
        self._hier_stale = True
        if not self._hier_lock.acquire(timeout=wait_s):
            _FLIGHT.record("hier-invalidate-deferred", epoch=self.epoch)
            return
        try:
            h, self._hier = self._hier, None
        finally:
            self._hier_lock.release()
        if h is not None:
            h.close()

    def _hier_burn(self, h: "_Hier") -> None:
        """Mark ``h``'s rendezvous generation CONSUMED on the store
        (best-effort, bounded): ``_hier_build``'s exchange keys are
        set-then-get with no generation fence of their own, so a retry
        at an UNCHANGED epoch rebuilding under the same namespace would
        fetch the aborted build's (closed) listener handles and redial
        them until deadline. Every rank burns the generation it used
        before rebuilding, so the rebuild's probe lands past it in
        lockstep. A failed burn is absorbed: the peers' (idempotent)
        burns cover it, and a store broken enough to drop ALL of them
        fails the rebuild named anyway."""
        if self._client is None:
            return
        try:
            self._client.set(
                f"pg/{self.group_name}/hier/e{h.epoch}/g{h.gen}/burned",
                "1", timeout_s=2.0)
        except (OSError, TimeoutError):
            _FLIGHT.record("hier-burn-abort", epoch=h.epoch, gen=h.gen)

    def _hier_mirror_lane(self, lane) -> None:
        """Mirror a newly opened lane onto the live hierarchy's
        sub-nets (under the build lock, so a lane opened while a build
        is in flight is either in the registry snapshot the build
        mirrors, or mirrored here after the build publishes)."""
        with self._hier_lock:
            if self._hier is not None:
                self._hier.mirror_lane(lane)

    def _hier_build(self, timeout_s: float) -> "_Hier":
        """Wire this epoch's hierarchy: per-node sub-rings over the
        intra plane plus the cross-node ring(s) over the group's own
        plane, rendezvoused through epoch-qualified store namespaces
        (``pg/<g>/hier/e<N>/...``) with the same publish-before-dial
        and backoff discipline as every ring here
        (``bootstrap.bootstrap_ring``). Chaos-transparent: sub-nets
        wrap in the SAME FaultNet schedule as the group net, so
        injected faults (and the op-keyed kill) land on hierarchical
        legs deterministically. ``timeout_s`` is ONE deadline shared
        by every stage (node-map read, generation probe, each
        sub-ring's wiring, the ready barrier) — the `_ring` contract;
        granting each sequential stage a fresh budget would let a
        dead peer stretch the caller's bound severalfold."""
        deadline = time.monotonic() + timeout_s
        rem = lambda: max(0.1, deadline - time.monotonic())
        node_of = self._node_map(rem())
        nodes = self._hier_nodes(node_of)
        g = self._ranks[self.rank]
        node_idx = next(i for i, (_nid, mem) in enumerate(nodes)
                        if g in mem)
        members = nodes[node_idx][1]
        lrank = members.index(g)
        sizes = [len(mem) for _, mem in nodes]
        uniform = len(set(sizes)) == 1
        # ONE epoch snapshot for the whole build: the _Hier stamp, the
        # rendezvous namespace, and every sub-net's fence must agree —
        # re-reading self.epoch at each site would let a concurrent
        # heal/grow tear them (the ensure loop then discards any result
        # whose stamp or membership went stale mid-build)
        epoch = self.epoch
        h = _Hier(epoch, nodes, node_idx, lrank, uniform)
        sched = getattr(self._net, "schedule", None)

        def mk_net(plane):
            net = _PLANES[plane]()
            if sched is not None:
                from rocnrdma_tpu_torch.transport.faults import FaultNet
                net = FaultNet(net, sched)
            net.init()
            net.set_epoch(epoch)
            # a rank blocked in a hierarchical leg must still serve
            # its interrupted p2p streams' resume protocol (the
            # progress-hook lesson) — every leg's blocking loops run
            # the group hook like the main ring's do
            net._progress_hook = self._resume_progress
            return net

        # Rendezvous namespace: epoch-qualified AND generation-qualified.
        # The epoch covers heal/grow rebuilds; the generation covers a
        # retry at an UNCHANGED epoch (an aborted collective with
        # self_heal off): the first build's exchange keys and barrier
        # arrivals are already populated, so reusing them would hand the
        # rebuild the dead generation's closed listener handles. Probe
        # for the first generation no rank has burned (every rank burns
        # the generation it used before rebuilding — _hier_burn — so the
        # probe converges in lockstep; almost always g0, one store read).
        ns_epoch = f"pg/{self.group_name}/hier/e{epoch}"
        gen = 0
        if self._client is not None:
            while self._client.try_get(
                    f"{ns_epoch}/g{gen}/burned",
                    timeout_s=rem()) is not None:
                gen += 1
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        "hier build: rendezvous-generation probe "
                        f"exhausted its deadline at g{gen}")
        h.gen = gen
        ns = f"{ns_epoch}/g{gen}"
        try:
            if h.local_n > 1:
                h.local_net = mk_net(self._intra_plane)
                (h.local_send, h.local_recv,
                 h.local_client) = bootstrap.bootstrap_ring(
                    h.local_net, self._store_handle, lrank, h.local_n,
                    rem(), ns=f"{ns}/n{node_idx}",
                    failover=tuple(self._store_failover))
            if h.n_nodes > 1 and (uniform or lrank == 0):
                # uniform: local index j's ring carries shard j across
                # nodes (members: each node's j-th rank, node order);
                # relay: one leaders' ring
                h.inter_net = mk_net(self.plane)
                (h.inter_send, h.inter_recv,
                 h.inter_client) = bootstrap.bootstrap_ring(
                    h.inter_net, self._store_handle, node_idx,
                    h.n_nodes, rem(),
                    ns=f"{ns}/x{lrank if uniform else 0}",
                    failover=tuple(self._store_failover))
            # lanes opened before (or during) the build: mirror the
            # registry snapshot so every leg resolves the same QoS
            # credit and codec knob (later channel() calls mirror
            # through _hier_mirror_lane under the same lock)
            for lane in self._net.lanes.snapshot():
                h.mirror_lane(lane)
            # one group-wide barrier re-marks the clock sync for EVERY
            # member (the sub-ring wired barriers marked only their
            # own subsets, which would skew the trace alignment
            # between leaders and non-leaders)
            if self._client is not None and self.world_size > 1:
                self._client.barrier(f"{ns}/ready", self.world_size,
                                     rem())
                _FLIGHT.mark_sync(ns=ns, rank=self.rank)
            # the sub-rings' bootstrap clients served only the wiring:
            # close them NOW. Each open store connection is a server-
            # side thread polling its recv at sub-ms cadence, and the
            # hierarchy would otherwise park 2 per rank on the store
            # host for its lifetime — the reference measured it slowing
            # every collective the store-hosting rank (and whoever
            # pairs with it) runs. Heal-time rebuilds dial fresh ones.
            for attr in ("local_client", "inter_client"):
                c = getattr(h, attr)
                if c is not None:
                    setattr(h, attr, None)
                    try:
                        c.close()
                    except (OSError, TimeoutError):
                        pass
        except BaseException as e:
            # a half-built hierarchy must not leak its nets/clients
            # (bootstrap_ring already tore down its own half-wired
            # endpoints); the abort leaves a flight event for the
            # postmortem before propagating
            _FLIGHT.record("hier-abort", epoch=epoch,
                           verb="build", error=type(e).__name__)
            self._hier_burn(h)  # half-populated keys: never reused
            h.close()
            raise
        _FLIGHT.record("hier-built", epoch=epoch,
                       nodes=h.n_nodes, local=h.local_n,
                       uniform=uniform, leader=h.is_leader)
        return h

    # -- multi-tenant lanes (concurrent QoS-scheduled collectives) ----

    def channel(self, name: str, priority: int | None = None,
                credit_bytes: int | None = None,
                bucket_bytes: int | None = None,
                bucket_timeout_s: float | None = None,
                codec: str | None = None) -> "ChannelHandle":
        """Open (or fetch) the named QoS lane on this group and return a
        :class:`ChannelHandle` whose collective verbs run on it — MANY
        handles' collectives may be in flight CONCURRENTLY over the one
        comm (each from its own thread), because every framed message
        carries the lane's channel id next to ``tag|epoch`` and the
        receive stash matches per ``(chan, tag)``.

        ``priority`` (higher = more urgent) and ``credit_bytes`` (pacing
        budget; None = unpaced) feed the send-admission gate
        (``transport.lanes.LaneGate``): a bulk lane with a credit posts
        in credit-capped quanta, yields the wire every credit of posted
        bytes (a genuine GIL-releasing sleep while a higher-priority
        lane is mid-collective), keeps the tcp tx backlog under its
        credit, and defers outright behind any higher-priority post
        waiting at the gate — the QoS that keeps a 1 GiB checkpoint
        stream from starving a 64 KiB inference allreduce on the same
        ring (and is a throttle, not a hard block, in the other
        direction: the bulk tenant slows but always progresses). The
        channel id is a stable hash of
        ``name``, so every rank derives the same wire identity with no
        rendezvous — open the same lane names (same settings) on every
        rank. ``channel("default")`` is lane 0: exactly the group's own
        verbs.

        Lanes compose with the recovery machinery: the epoch fence drops
        a stale frame whatever lane it rides (counted per lane in
        ``wire_stats()['channel_frames_fenced']``), one lane at a time
        drives heal-and-retry (the others retry on the healed epoch),
        and FaultNet's per-channel knobs inject against lane names.

        ``bucket_bytes`` / ``bucket_timeout_s`` are the lane's COALESCER
        flush knobs (the ``*_async`` verb surface, DESIGN.md §5i): a
        bucket flushes when its pending payload reaches ``bucket_bytes``
        (default: the tuner's model pick,
        ``transport.tuner.pick_bucket_bytes``) or — opt-in — when a
        submit finds it older than ``bucket_timeout_s`` (wall-clock
        triggers are off by default so chaos replays stay seed-pure);
        an explicit :meth:`ChannelHandle.flush` or ``Future.wait``
        forces the rest. Like the QoS knobs, a conflicting restatement
        on an already-open handle refuses.

        ``codec`` is the lane's WIRE COMPRESSION knob
        (DESIGN.md §5k): ``"int8"`` / ``"fp8"`` quantize the lane's
        streaming-collective frames to one byte per element under a
        per-frame scale header (decoded-and-folded straight out of the
        wire buffer on the other end), ``"auto"`` lets the committed
        wire model pick per (plane, size) — off where beta is cheap
        (shm), on for the slow tcp leg — and None (default) keeps the
        fp32 wire. Sum reductions on a codec lane additionally run
        under per-rank error feedback, so training convergence is
        preserved. Every rank must open the lane with the same codec
        (the same no-rendezvous contract as the channel id); unknown
        or unavailable codec names refuse HERE, not mid-collective.

        Fetch semantics: ``channel(name)`` with NO QoS arguments returns
        the already-open handle as-is (a consumer module need not — and
        must not have to — restate the opener's settings); restating
        arguments re-runs the conflict check, so a mismatched re-open
        still raises."""
        from rocnrdma_tpu_torch.transport import codec as _codec_mod
        codec = _codec_mod.validate_name(codec)
        with self._channels_lock:
            ch = self._channels.get(name)
            if ch is None:
                lane = self._net.open_lane(
                    name, priority=0 if priority is None else priority,
                    credit_bytes=credit_bytes, codec=codec)
                ch = self._channels[name] = ChannelHandle(
                    self, lane, bucket_bytes=bucket_bytes,
                    bucket_timeout_s=bucket_timeout_s)
                # a live hierarchy's sub-nets resolve lanes from their
                # own registries: mirror the fresh lane per leg (QoS
                # credit and codec must mean the same thing on every
                # leg a laned collective rides)
                self._hier_mirror_lane(lane)
                return ch
            if priority is not None or credit_bytes is not None \
                    or codec is not None:
                # restating SOME lane knobs re-runs the registry's
                # conflict check with the UNSTATED ones adopted from
                # the open lane — a partial restatement must conflict
                # only on what the caller actually said (a
                # default-priority re-open against a prioritized lane,
                # or a codec-less restatement against a codec lane,
                # would otherwise refuse on values the caller never
                # stated — the same adopt-while-unset contract as the
                # bucket knobs). Bucket-only restatements still never
                # reach open_lane.
                cur = ch._lane
                self._net.open_lane(
                    name,
                    priority=cur.priority if priority is None
                    else priority,
                    credit_bytes=cur.credit_bytes if credit_bytes is None
                    else credit_bytes,
                    codec=cur.codec if codec is None else codec)
            if bucket_bytes is not None or bucket_timeout_s is not None:
                ch._set_bucket_knobs(bucket_bytes, bucket_timeout_s)
            return ch

    # -- object collectives (pickled python values, torch-style) -----------
    #
    # For small control-plane payloads (configs, vocab maps, shapes) among
    # MUTUALLY TRUSTED ranks — pickle is executed on receipt, exactly the
    # torch.distributed object-collective trust model. Two-phase: fixed
    # 8-byte size exchange, then the payload ride on the array verbs.

    def broadcast_object(self, obj=None, src: int = 0):
        """Every rank returns rank ``src``'s ``obj`` (non-src args ignored)."""
        import pickle
        payload = (np.frombuffer(pickle.dumps(obj), np.uint8)
                   if self.rank == src else np.empty(0, np.uint8))
        size = self.broadcast(np.array([payload.size], np.int64), src=src)
        buf = payload if self.rank == src else np.empty(int(size[0]), np.uint8)
        out = self.broadcast(buf, src=src)
        if self.rank == src:  # keep the original (torch semantics), skip a
            return obj        # deserialize + deep copy of a large payload
        return pickle.loads(out.tobytes())

    def tune_wire(self, timeout_s: float | None = None) -> dict:
        """Close the host wire's measure→model→pick loop at a PROTOCOL
        point: rank 0 reads the windowed five-bucket stall
        attribution from :meth:`trace_stats` (the causal tracer's
        {compute-fold, wire, credit-stall, lane-admit, recv-wait}),
        derives a refit of this plane's committed wire model
        (``tuner.HostWireModel.refit_attribution`` — credit-stall-
        dominant windows bias picks toward deeper pipelines and
        frame-path frames, recv-wait-dominant windows toward smaller
        frames), and BROADCASTS the proposal so every rank commits the
        same parameters against the same base version in lockstep.
        Every later pick is then a pure function of (inputs, the new
        committed version) on every rank — frame tags cannot diverge,
        which is why the refit must ride a collective rather than each
        rank fitting its own window.

        Like heal/grow, tune_wire is a PROTOCOL POINT: callers must
        quiesce concurrent lane collectives around it (the per-lane
        mutex serializes each lane, but a lane collective STRADDLING
        the commit could see the old version on one rank and the new on
        another — the exact skew the lockstep commit exists to prevent;
        the post-commit barrier below fences everything issued after).

        Returns the committed ``tuner`` block (``committed=False`` when
        the proposal went stale against a concurrent epoch fence — the
        named drop, not an error). A no-op dict on nets without a wire
        model (the device plane)."""
        t = self.timeout_s if timeout_s is None else timeout_s
        model = getattr(self._net, "wire_model", None)
        if model is None:
            return {"committed": False, "reason": "no wire model"}
        from rocnrdma_tpu_torch.transport import tuner as _tuner
        proposal = None
        if self.rank == 0:
            shares = self._stall_shares(t)
            params = model.refit_attribution(shares)
            # stage against the current version: an epoch fence landing
            # between here and the commit drops the pending proposal
            # AND invalidates the base token on every rank
            base = model.propose(params, "tune_wire")
            # the refit TRIGGER signal: rank 0's merged
            # conformance table names every (plane, verb, size-bucket)
            # cell whose median predicted/measured ratio left the
            # committed band — computed once here and broadcast with
            # the proposal, so every rank records the identical
            # tuner-drift events (TUNERLOG replay-equality holds)
            drift = _conformance.drift_report()
            proposal = (params.to_dict(), base, shares, drift)
        if self.world_size > 1:
            proposal = self.broadcast_object(proposal, src=0)
        params_d, base, shares, drift = proposal
        for cell, ratio in drift:
            # the drifted plane+bucket, named in the TUNERLOG event
            # stream (the cell key is "plane|verb|lgK"; the ratio is
            # timing-shaped and stays off the structural projection)
            _FLIGHT.record("tuner-drift", plane=cell.split("|", 1)[0],
                           bucket=cell, epoch=self.epoch,
                           version=model.version)
        new = model.commit(
            _tuner.PlaneParams.from_dict(params_d), base,
            note="tune_wire: " + ",".join(
                f"{k}={v:.2f}" for k, v in sorted(shares.items())))
        if self.world_size > 1:
            # no rank leaves the protocol point until every rank has
            # committed: collectives issued AFTER tune_wire returns pick
            # on the new version everywhere
            self.barrier(timeout_s=t)
        out = model.block()
        out["committed"] = new is not None
        # the trigger's verdict on the returned block: which cells
        # demanded this refit (empty = a routine window-driven refit)
        out["drift"] = [[cell, ratio] for cell, ratio in drift]
        return out

    def _stall_shares(self, timeout_s: float) -> dict:
        """The attribution window a refit reads: every assembled sampled
        op's five buckets summed across ranks, as fractions of the total
        attributed wall (empty window → all-zero shares, a refit that
        only clears stale biases)."""
        from rocnrdma_tpu_torch.obs.trace import BUCKETS
        totals = {b: 0.0 for b in BUCKETS}
        for op in self.trace_stats(timeout_s=timeout_s)["ops"]:
            for info in op.get("ranks", {}).values():
                for b, s in info.get("attribution", {}).items():
                    totals[b] = totals.get(b, 0.0) + s
        wall = sum(totals.values())
        if wall <= 0:
            return {b: 0.0 for b in totals}
        return {b: s / wall for b, s in totals.items()}

    def all_gather_object(self, obj) -> list:
        """Every rank contributes any picklable ``obj``; returns the n
        objects in rank order (sizes may differ — padded on the wire to the
        max, truncated per-rank on receipt)."""
        import pickle
        mine = np.frombuffer(pickle.dumps(obj), np.uint8)
        sizes = self.all_gather(np.array([mine.size], np.int64))[:, 0]
        cap = int(sizes.max())
        padded = np.zeros(cap, np.uint8)
        padded[:mine.size] = mine
        rows = self.all_gather(padded)
        return [pickle.loads(rows[r, :int(sizes[r])].tobytes())
                for r in range(self.world_size)]

    # -- point-to-point ----------------------------------------------------
    #
    # Wiring rule (deadlock-freedom): a rank's FIRST p2p op — before it
    # blocks on anything — creates one listener per peer and publishes every
    # handle. Each direction then gets its own connection: sending to peer j
    # dials j's pair-listener; receiving from j accepts on ours. The only
    # blocking points left are (a) a sender waiting for its peer to START
    # doing p2p at all (publish happens first, so any set of first contacts
    # — including cycles like every rank send((r+1)%n) then recv((r-1)%n) —
    # resolves), and (b) a recv waiting for its matching send, which is just
    # blocking-receive semantics.

    def _p2p_ns(self, peer: int) -> str:
        # epoch-qualified: a heal tears the p2p plane down and renumbers
        # peers, so post-heal wiring must rendezvous on FRESH keys — a
        # dial that read a dead generation's listener handle would race
        # the republish (and desynchronize the deterministic chaos
        # replay with spurious failed connects)
        lo, hi = min(self.rank, peer), max(self.rank, peer)
        return f"pg/{self.group_name}/e{self.epoch}/p2p/{lo}-{hi}"

    def _p2p_publish(self) -> None:
        """First p2p op on this rank: listen + publish for EVERY peer."""
        if self._p2p_listen is not None:
            return
        self._p2p_listen = {}
        for peer in range(self.world_size):
            if peer == self.rank:
                continue
            handle, listener = self._net.listen()
            self._p2p_listen[peer] = listener
            self._client.set(f"{self._p2p_ns(peer)}/h/{self.rank}", handle)

    def _pstate(self, peer: int) -> dict:
        """The (dir, tag) -> seq counter dict for ``peer`` (a CURRENT
        rank), keyed internally by the peer's ORIGINAL rank so an
        unbroken pair's streams keep their numbering across heals/grows
        (the renumbering is a property of the group, not the stream)."""
        return self._p2p_seq.setdefault(self._ranks[peer], {})

    def _inc(self, orig: int) -> int:
        """The incarnation of original-rank slot ``orig``: bumped when a
        spare or joiner takes the slot over — stream state from the
        previous process behind that identity must not resume into the
        new one (its data died with the process)."""
        return self._incarnation.get(orig, 0)

    def _p2p_progress(self) -> None:
        """The p2p progress engine, hooked into every send's backpressure
        and flush loops: poll-accept pending inbound dials and pump every
        wired rx comm. This is what keeps SYMMETRIC (or cyclic) large sends
        alive — two ranks mid-send can only drain each other if each pulls
        the peer's inbound bytes off the wire while its own tx is stalled;
        without it, payloads beyond kernel/ring buffering wedge both sides
        (the reference stack solves this the same way: the net plugin's
        progress engine runs inside every blocking verb)."""
        for peer, listener in (self._p2p_listen or {}).items():
            if peer not in self._p2p_accepted:
                try:
                    comm = self._net.accept(listener, timeout_s=0.0)
                except (TimeoutError, OSError):
                    continue
                self._p2p_accepted.add(peer)
                self._p2p[(peer, "rx")] = plugin._RingWire(
                    self._net, comm, comm, peers=(peer, peer))
                self._pstate(peer)
        # pump EVERY wired comm, both directions: rx pumps deliver inbound
        # frames; tx pumps drive queued user-space tx (an irecv wait issued
        # before a send handle's flush must still make the outbound tail
        # progress, or symmetric large batches wedge on full kernel buffers).
        # Large-message arena announces also flow through these pumps: a
        # peer blocked in a big send posts a _LG_REQ frame, and the pump
        # answers it with an on-demand ensure+announce (plugin._HostComm.
        # _pump) — on demand, not eagerly, so small-message workloads
        # never pay k x LG_ARENA of MR capacity.
        for (peer, d), wire in list(self._p2p.items()):
            comm = wire.recv_comm if d == "rx" else wire.send_comm
            comm._pump()
        # consume the landed posted receives: a pump only stashes a
        # put-path descriptor, and its arena credit returns to the sender
        # when the receive is tested. A batch of sends that waits for
        # credit on every rank at once (a ring shift bigger than the
        # arena's free tail) would otherwise wait on peers that are
        # themselves in their sends, never in the receives' waits
        for entry in list(_posted_p2p_recvs(self)):
            entry.test()
        if self.epoch > 0 and self._p2p_inflight:
            self._p2p_resume_service()

    def _p2p_resume_service(self) -> int:
        """Sender-side half of the stream-resume protocol, driven from the
        progress engine: while this rank blocks in some OTHER p2p wait
        (typically resuming its own inbound), its interrupted outbound
        streams must still make progress — a ring of ranks each waiting
        on its inbound first would otherwise deadlock, every receiver
        waiting for a sender that has not reached its own send wait yet.
        For each interrupted outbound stream: dial the peer once it has
        re-published its pair listener (publish-before-dial, so the only
        refusals are injected ones — attempt counts stay schedule-driven
        and chaos replay-equal), consume the receiver's RESUME frame, and
        re-queue the tail from the fence-acknowledged cursor. Returns the
        number of interrupted outbound streams still unserved (the
        _check_alive hook — and the ring wires' net-level progress hook —
        keep calling until it hits zero). One thread serves at a time:
        a concurrent caller returns immediately, reporting "still
        pending" so its own polling continues."""
        if not self._p2p_service_lock.acquire(blocking=False):
            return 1  # a sibling lane thread is serving right now
        try:
            return self._p2p_resume_service_locked()
        finally:
            self._p2p_service_lock.release()

    def _p2p_resume_service_locked(self) -> int:
        pending = 0
        for key, info in list(self._p2p_inflight.items()):
            orig, d, chan, tag = key
            if d != "tx" or info.get("state") == "resumed":
                continue
            if info["epoch"] >= self.epoch:
                continue  # not interrupted by a membership change
            if orig not in self._ranks or self._inc(orig) != info["inc"]:
                continue  # peer process gone: its wait will raise, named
            pending += 1
            cur = self._ranks.index(orig)
            wire = self._p2p.get((cur, "tx"))
            if wire is None:
                try:
                    handle = self._client.try_get(
                        f"{self._p2p_ns(cur)}/h/{cur}")
                except (OSError, TimeoutError):
                    continue
                if handle is None:
                    continue  # peer has not re-published yet
                try:
                    comm = self._net.connect(0, handle, min(5.0,
                                                            self.timeout_s))
                except (ConnectionRefusedError, ConnectionResetError,
                        TimeoutError, OSError):
                    continue  # injected refusal/flake: next service call
                wire = plugin._RingWire(self._net, comm, comm,
                                        timeout_s=self.timeout_s,
                                        peers=(cur, cur))
                self._p2p[(cur, "tx")] = wire
            acked = self._take_resume_ack(wire.send_comm, chan, tag,
                                          info["seq"])
            if acked is None:
                continue
            _FLIGHT.record("p2p-resume", dir="tx", tag=tag, chan=chan,
                           seq=info["seq"], acked=acked)
            # the tail re-queues under the STREAM's lane, whatever lane
            # context this service call happens to run in — the
            # receiver's re-posted tail receives match on (chan, tag)
            with _lanes.lane_context(chan):
                wire.queue_send(info["data"], info["hop"],
                                first_frame=acked)
            info["state"] = "resumed"
            pending -= 1
        return pending

    def _take_resume_ack(self, comm, chan: int, tag: int,
                         seq: int) -> int | None:
        """Pop the RESUME control frame for stream (chan, tag, seq) from
        ``comm``'s stash, if it has arrived; returns the receiver's
        fence-acknowledged frame cursor. Frames for OTHER streams stay
        stashed for their own senders' waits. RESUME frames ride wire
        channel 0 (control); the stream's lane is in the payload."""
        key = (0, _P2P_RESUME_TAG)
        with comm._lock:
            frames = comm._unexpected.get(key)
            if not frames:
                comm._pump()
                frames = comm._unexpected.get(key)
            for i, p in enumerate(frames or ()):
                if (int.from_bytes(p[:4], "little") == tag
                        and int.from_bytes(p[4:8], "little") == seq
                        and int.from_bytes(p[12:16], "little") == chan):
                    frames.pop(i)
                    if not frames:
                        del comm._unexpected[key]
                    return int.from_bytes(p[8:12], "little")
        return None

    def _p2p_resume_accept(self, cur: int, timeout_s: float):
        """Accept the re-dial of an interrupted INBOUND stream's sender,
        interleaved with the tx resume SERVICE — a ring of ranks all
        resuming their inbound first would otherwise deadlock, each
        blocked in a plain accept while the dial it waits for can only
        come from a peer's service that never gets to run. Publishes this
        rank's pair listeners first (the sender's service dials only a
        published handle, so connect attempts stay schedule-driven)."""
        self._check_alive()
        wire = self._p2p.get((cur, "rx"))
        if wire is not None:
            wire.timeout_s = timeout_s
            return wire
        self._p2p_publish()
        deadline = time.monotonic() + timeout_s
        while True:
            self._p2p_resume_service()  # keep OUR outbound resumes moving
            try:
                comm = self._net.accept(self._p2p_listen[cur],
                                        timeout_s=0.25)
                break
            except (ConnectionRefusedError, ConnectionResetError,
                    TimeoutError, OSError):
                if time.monotonic() >= deadline:
                    _FLIGHT.record("p2p-resume-abort", dir="rx", peer=cur,
                                   error="TimeoutError")
                    raise TimeoutError(
                        f"p2p resume: peer rank {cur} never re-dialed "
                        f"within {timeout_s}s") from None
        try:
            wire = plugin._RingWire(self._net, comm, comm,
                                    timeout_s=timeout_s, peers=(cur, cur))
        except BaseException as e:
            _FLIGHT.record("p2p-resume-abort", dir="rx", peer=cur,
                           error=type(e).__name__)
            self._net.close_comm(comm)
            raise
        self._p2p_accepted.add(cur)
        self._p2p[(cur, "rx")] = wire
        return wire

    def _raise_if_interrupted(self, key: tuple | None,
                              epoch0: int) -> None:
        """A tx flush that 'succeeded' on a dead comm proves nothing: shm
        comms have no user-space tx queue, so ``_flush_tx`` no-ops even
        though the queued frames went out under the OLD epoch and were
        fenced on arrival. An interrupted, not-yet-resumed stream must
        take the resume path regardless — raised here, into the caller's
        resume handler. ``epoch0`` is the epoch captured at op entry: an
        UNCOVERED op (second outstanding on its stream, ``key`` None)
        has no registration to compare against, but a silent success
        after a fence is still data loss — it raises too, just without
        resume coverage."""
        info = self._p2p_inflight.get(key) if key is not None else None
        if info is not None:
            if (info.get("state") != "resumed"
                    and self.epoch > info["epoch"]):
                raise OSError("p2p stream interrupted by a membership "
                              "change (frames fenced); resuming")
        elif self.epoch > epoch0:
            raise OSError("p2p stream interrupted by a membership change "
                          "(frames fenced); op was not resume-covered "
                          "(another op owns the stream's resume slot) — "
                          "the stream is undefined")

    def _p2p_resumable(self, info: dict | None, orig: int) -> bool:
        """A stream continuation is legal iff the group healed/grew SINCE
        the op posted (the wire's frames were epoch-fenced, not lost),
        the peer slot is still a member, and the PROCESS behind it is the
        same incarnation (a promoted spare or joiner under the same
        identity never saw the stream)."""
        return (self._self_heal and info is not None
                and orig in self._ranks
                and self._inc(orig) == info["inc"]
                and self.epoch > info["epoch"])

    def _p2p_resume_tx(self, key: tuple, exc, timeout_s: float) -> None:
        """Resume an interrupted OUTBOUND stream from the receiver's
        fence-acknowledged cursor (or re-raise ``exc`` when the stream is
        not resumable). The receiver drives: its RESUME frame names the
        cursor; this side re-queues the tail and flushes."""
        info = self._p2p_inflight.get(key)
        orig, _, chan, tag = key
        if not self._p2p_resumable(info, orig):
            raise exc
        cur = self._ranks.index(orig)
        deadline = time.monotonic() + timeout_s
        wire = self._p2p_wire(cur, "tx", timeout_s)
        if info.get("state") != "resumed":
            from rocnrdma_tpu_torch.transport.backoff import poll_backoff
            back = poll_backoff()
            # the progress-engine SERVICE may take the RESUME frame and
            # re-queue the tail while this loop polls (it runs inside
            # _p2p_progress below) — re-check the stream state every
            # iteration or the frame this loop waits for is already gone
            while info.get("state") != "resumed":
                acked = self._take_resume_ack(wire.send_comm, chan, tag,
                                              info["seq"])
                if acked is not None:
                    _FLIGHT.record("p2p-resume", dir="tx", tag=tag,
                                   chan=chan, seq=info["seq"], acked=acked)
                    with _lanes.lane_context(chan):
                        wire.queue_send(info["data"], info["hop"],
                                        progress=self._p2p_progress,
                                        first_frame=acked)
                    info["state"] = "resumed"
                    break
                self._p2p_progress()
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"p2p resume: no RESUME cursor from rank {cur} "
                        f"(original {orig}, tag {tag}) within "
                        f"{timeout_s}s — peer never resumed its "
                        f"receive") from exc
                back.pause()
        plugin._flush_tx(wire.send_comm,
                         max(0.1, deadline - time.monotonic()),
                         extra_pump=self._p2p_progress,
                         what="p2p resume: peer stopped draining")

    def _p2p_resume_rx(self, key: tuple, exc, timeout_s: float) -> None:
        """Resume an interrupted INBOUND stream: re-wire, tell the sender
        the fence-acknowledged cursor (frames already landed in the
        destination before the epoch fence), and re-post only the
        missing tail — same frame indices, so wire tags line up with the
        sender's resumed ``queue_send``."""
        info = self._p2p_inflight.get(key)
        orig, _, chan, tag = key
        if not self._p2p_resumable(info, orig):
            raise exc
        cur = self._ranks.index(orig)
        _FLIGHT.record("p2p-resume", dir="rx", tag=tag, chan=chan,
                       seq=info["seq"], acked=info["acked"])
        wire = self._p2p_resume_accept(cur, timeout_s)
        ack = (tag.to_bytes(4, "little") + info["seq"].to_bytes(4, "little")
               + info["acked"].to_bytes(4, "little")
               + chan.to_bytes(4, "little"))
        # the RESUME frame itself is control: wire channel 0, whatever
        # lane the interrupted stream rode (the payload names the lane)
        self._net.isend(wire.recv_comm,
                        self._net.reg_mr(wire.recv_comm, ack),
                        tag=_P2P_RESUME_TAG, timeout_s=timeout_s,
                        progress=self._p2p_progress, channel=0)
        # the re-posted tail receives match the sender's re-queued tail
        # on (chan, tag): post them under the STREAM's lane
        with _lanes.lane_context(chan):
            reqs = wire.post_recvs(info["nbytes"], info["hop"],
                                   into=info["got"],
                                   first_frame=info["acked"])
        self._drain_p2p_recvs(wire, reqs, info, timeout_s, resumed=True)

    def _drain_p2p_recvs(self, wire, reqs, info: dict, timeout_s: float,
                         resumed: bool = False) -> None:
        """Drain posted p2p frame receives in order, advancing the
        stream's fence-acknowledged cursor per completed frame (the
        in-order count IS the resume cursor: a later frame stuck in the
        stash when the epoch fence falls is dropped with it, so anything
        beyond the first incomplete frame cannot be acknowledged)."""
        for off, nb, r in reqs:
            payload = r.wait(timeout_s=timeout_s,
                             progress=self._p2p_progress)
            if payload is not None:  # legacy plane: stage the copy
                info["got"][off:off + nb] = np.frombuffer(payload, np.uint8)
                _WIRE.copied(nb)
            info["acked"] += 1
            if resumed:
                _WIRE.resumed()

    def _p2p_wire(self, peer: int, direction: str, timeout_s: float = 30.0):
        """The cached one-way wire to/from ``peer`` (``direction``: "tx" dials
        the peer's pair-listener, "rx" accepts on ours)."""
        if not 0 <= peer < self.world_size or peer == self.rank:
            raise ValueError(f"bad peer {peer} for rank {self.rank} "
                             f"(world_size {self.world_size})")
        self._check_alive()
        wire = self._p2p.get((peer, direction))
        if wire is None:
            from rocnrdma_tpu_torch.transport.backoff import retry_with_backoff
            self._p2p_publish()
            if direction == "tx":
                handle = self._client.get(f"{self._p2p_ns(peer)}/h/{peer}",
                                          timeout_s)
                # refused/flaky dials retry under the shared backoff —
                # same discipline as the ring wiring (a FaultNet flake,
                # or a peer re-binding across a heal, is transient);
                # per-attempt timeouts also retry, so a peer that is
                # merely SLOW to accept still gets the caller's full
                # timeout_s, as before the retry wrapper
                comm = retry_with_backoff(
                    lambda: self._net.connect(0, handle,
                                              min(5.0, timeout_s)),
                    timeout_s, f"p2p dial to rank {peer}",
                    retry_on=(ConnectionRefusedError, ConnectionResetError,
                              TimeoutError))
                # sends pump the whole p2p plane (see _p2p_progress)
                wire = plugin._RingWire(self._net, comm, comm,
                                        progress=self._p2p_progress,
                                        timeout_s=timeout_s,
                                        peers=(peer, peer))
            else:
                def _accept_once():
                    # interleave the resume SERVICE with the blocking
                    # accept: a first-contact accept after a heal can
                    # otherwise starve a peer blocked in its own resume
                    # handshake waiting for THIS rank's service to dial
                    # — the same cycle _p2p_resume_accept breaks. Short
                    # attempts keep the service cadence; refused/timed
                    # out attempts retry under the caller's full budget.
                    if self.epoch > 0 and self._p2p_inflight:
                        self._p2p_resume_service()
                    return self._net.accept(self._p2p_listen[peer],
                                            min(0.5, timeout_s))
                comm = retry_with_backoff(
                    _accept_once, timeout_s,
                    f"p2p accept from rank {peer}",
                    retry_on=(ConnectionRefusedError, ConnectionResetError,
                              TimeoutError))
                self._p2p_accepted.add(peer)
                # one comm plays both _RingWire roles: receives probe their
                # own comm, the flush of an (empty) tx queue is harmless
                wire = plugin._RingWire(self._net, comm, comm,
                                        timeout_s=timeout_s,
                                        peers=(peer, peer))
            self._p2p[(peer, direction)] = wire
            self._pstate(peer)
        wire.timeout_s = timeout_s  # per-call deadline on a cached wire
        return wire

    @staticmethod
    def _p2p_hop(tag: int, seq: int) -> int:
        # the wire's tag field gives hops 16 bits; split them 6/10 between
        # user tag and a wrapping per-direction sequence. The wrap is safe
        # because p2p here is blocking and FIFO per pair — a tag can only
        # collide with a message 1024 sends earlier, long since consumed.
        if not 0 <= tag < 64:
            raise ValueError(f"p2p tag must be in [0, 64), got {tag}")
        return (tag << 10) | (seq % 1024)

    def _register_inflight(self, orig: int, d: str, chan: int, tag: int,
                           state: dict) -> tuple | None:
        """Register an in-flight p2p message for the stream-resume
        protocol (one registration per (peer, dir, chan, tag) stream — a
        second outstanding op on the same stream is not resume-covered:
        its failure raises, exactly the pre-resume contract). ``chan``
        is the lane the stream rides — part of the stream identity, and
        what the resume paths re-send/re-post under."""
        key = (orig, d, chan, tag)
        if self._p2p_inflight.get(key) is not None:
            # the stream's resume slot is owned by an outstanding op —
            # including one a heal interrupted whose wait() has not run
            # yet. A second op must NOT steal it: overwriting would let
            # the interrupted op's wait() read the new registration's
            # current epoch and report success while its fenced frames
            # were never re-sent. The new op runs uncovered instead.
            return None
        state.setdefault("inc", self._inc(orig))
        state.setdefault("epoch", self.epoch)
        state.setdefault("chan", chan)
        self._p2p_inflight[key] = state
        return key

    def send(self, x, dst: int, tag: int = 0,
             timeout_s: float = 60.0) -> None:
        """Blocking point-to-point send of ``x`` to rank ``dst``. Messages
        between a pair are delivered in send order; ``tag`` (0..63)
        disambiguates concurrent streams, torch-style. ``timeout_s`` bounds
        every wait (first-contact rendezvous, backpressure, flush) — raise
        it for slow-consumer peers; blocking semantics are only as patient
        as this deadline.

        Failure semantics: under ``self_heal``, a send interrupted by a
        membership change (the wire died, the group healed/grew, the peer
        PROCESS survived) RESUMES — the receiver names its last
        fence-acknowledged frame and only the tail is re-sent, so the
        stream continues instead of tearing down. Any other raising send
        leaves the (peer, tag) stream undefined (standard
        failed-blocking-send semantics) — tear down the group rather
        than retry. A timed-out recv, by contrast, is cleanly
        retryable."""
        x = np.asarray(x)
        data = plugin._as_bytes(x)
        orig = self._ranks[dst]
        chan = _lanes.current_channel()
        st = self._pstate(dst)
        # counters are per-(direction, lane, tag): tag streams are
        # independently ordered, so a receiver may drain tag 7 before
        # tag 0 (the verbs layer tag-matches out of order; see
        # _HostComm._unexpected), and two lanes sharing a user tag are
        # still independent streams (frames match on (chan, tag))
        seq = st.get(("tx", chan, tag), 0)
        st[("tx", chan, tag)] = seq + 1
        hop = self._p2p_hop(tag, seq)
        key = self._register_inflight(orig, "tx", chan, tag,
                                      {"seq": seq, "data": data,
                                       "hop": hop})
        epoch0 = self.epoch
        try:
            wire = self._p2p_wire(dst, "tx", timeout_s)
            wire.queue_send(data, hop, progress=self._p2p_progress)
            plugin._flush_tx(wire.send_comm, timeout_s,
                             extra_pump=self._p2p_progress,
                             what="p2p send: peer stopped draining")
            self._raise_if_interrupted(key, epoch0)
        except (TimeoutError, OSError, RuntimeError) as e:
            if key is None:
                raise
            _FLIGHT.record("p2p-abort", dir="tx", tag=tag,
                           error=type(e).__name__)
            self._p2p_resume_tx(key, e, timeout_s)
        finally:
            if key is not None:
                self._p2p_inflight.pop(key, None)

    def recv(self, x_like, src: int, tag: int = 0,
             timeout_s: float = 60.0) -> np.ndarray:
        """Blocking point-to-point receive from rank ``src``; ``x_like``
        supplies the expected shape/dtype (the recvbuff role). Returns the
        received array. ``timeout_s`` bounds the wait for the matching send
        — raise it for slow producers. Interrupted-by-heal receives
        resume like :meth:`send` (the landed head frames are kept, only
        the fenced tail is re-requested)."""
        template = np.asarray(x_like)
        orig = self._ranks[src]
        chan = _lanes.current_channel()
        st = self._pstate(src)
        seq = st.get(("rx", chan, tag), 0)
        hop = self._p2p_hop(tag, seq)
        got = np.empty(template.nbytes, np.uint8)
        key = self._register_inflight(orig, "rx", chan, tag,
                                      {"seq": seq, "got": got, "hop": hop,
                                       "nbytes": template.nbytes,
                                       "acked": 0})
        info = self._p2p_inflight.get(key) if key is not None else None
        try:
            wire = self._p2p_wire(src, "rx", timeout_s)
            reqs = wire.post_recvs(template.nbytes, hop, into=got)
            if info is not None:
                self._drain_p2p_recvs(wire, reqs, info, timeout_s)
            else:  # second outstanding op on the stream: plain drain
                self._drain_p2p_recvs(wire, reqs,
                                      {"got": got, "acked": 0}, timeout_s)
        except (TimeoutError, OSError, RuntimeError) as e:
            if key is None:
                raise
            _FLIGHT.record("p2p-abort", dir="rx", tag=tag,
                           error=type(e).__name__)
            try:
                self._p2p_resume_rx(key, e, timeout_s)
            except BaseException as e2:
                # an unresumable timeout stays cleanly retryable at the
                # SAME sequence number (the pre-resume contract): drop
                # the registration so the retry re-registers fresh
                _FLIGHT.record("p2p-resume-abort", dir="rx", tag=tag,
                               error=type(e2).__name__)
                self._p2p_inflight.pop(key, None)
                raise
        # advance only on success: a timed-out recv put nothing on the wire,
        # so a retry (with a longer timeout) must re-post the SAME sequence
        # number or the stream is permanently off by one
        if key is not None:
            self._p2p_inflight.pop(key, None)
        st[("rx", chan, tag)] = seq + 1
        return got.view(template.dtype).reshape(template.shape)

    def isend(self, x, dst: int, tag: int = 0,
              timeout_s: float = 60.0) -> P2PHandle:
        """Non-blocking send: frames are queued on the wire immediately
        (pumping the p2p plane under backpressure); ``wait()`` flushes the
        tx queue. Shares the (peer, tag) sequence space with :meth:`send`,
        so blocking and non-blocking calls interleave coherently. A
        ``wait()`` interrupted by a heal/grow resumes the stream like
        :meth:`send` (the handle keeps the payload for the tail
        re-send)."""
        x = np.asarray(x)
        data = plugin._as_bytes(x)
        orig = self._ranks[dst]
        chan = _lanes.current_channel()
        wire = self._p2p_wire(dst, "tx", timeout_s)
        st = self._pstate(dst)
        seq = st.get(("tx", chan, tag), 0)
        hop = self._p2p_hop(tag, seq)  # validates tag before any claim
        self._claim_outstanding(orig, "tx", chan, tag)
        st[("tx", chan, tag)] = seq + 1
        key = self._register_inflight(orig, "tx", chan, tag,
                                      {"seq": seq, "data": data,
                                       "hop": hop})
        epoch0 = self.epoch
        try:
            wire.queue_send(data, hop, progress=self._p2p_progress)
        except BaseException as e:
            # a queue-time failure produced no handle whose wait() owns
            # the cleanup: drop the registration and the outstanding
            # claim, or every later op on the stream runs uncovered and
            # a later heal resume-resends a payload whose isend the
            # caller watched FAIL
            _FLIGHT.record("p2p-abort", dir="tx", tag=tag,
                           error=type(e).__name__)
            if key is not None:
                self._p2p_inflight.pop(key, None)
            self._release_outstanding(orig, "tx", chan, tag)
            raise

        def wait():
            try:
                plugin._flush_tx(wire.send_comm, timeout_s,
                                 extra_pump=self._p2p_progress,
                                 what="isend: peer stopped draining")
                self._raise_if_interrupted(key, epoch0)
            except (TimeoutError, OSError, RuntimeError) as e:
                if key is None:
                    raise
                _FLIGHT.record("p2p-abort", dir="tx", tag=tag,
                               error=type(e).__name__)
                self._p2p_resume_tx(key, e, timeout_s)
            finally:
                if key is not None:
                    self._p2p_inflight.pop(key, None)
            self._release_outstanding(orig, "tx", chan, tag)

        return P2PHandle(wait)

    def irecv(self, x_like, src: int, tag: int = 0,
              timeout_s: float = 60.0) -> P2PHandle:
        """Non-blocking receive: posts the frame receives now (claiming the
        next sequence slot of the (peer, tag) stream — outstanding irecvs
        on one stream match sends in post order); ``wait()`` drains them
        and returns the array shaped like ``x_like``. FIRST contact with a
        peer blocks wiring the receive connection until that peer dials
        (i.e. first sends) — for symmetric first-contact exchanges, issue
        through :meth:`batch_isend_irecv`, which orders the wiring so
        cycles resolve. A ``wait()`` interrupted by a heal/grow resumes
        from the last fence-acknowledged frame like :meth:`recv`."""
        template = np.asarray(x_like)
        orig = self._ranks[src]
        chan = _lanes.current_channel()
        wire = self._p2p_wire(src, "rx", timeout_s)
        st = self._pstate(src)
        seq = st.get(("rx", chan, tag), 0)
        hop = self._p2p_hop(tag, seq)  # validates tag before any claim
        self._claim_outstanding(orig, "rx", chan, tag)
        st[("rx", chan, tag)] = seq + 1
        nbytes = template.nbytes
        # the destination is allocated at POST time so recv_into-capable
        # nets land every frame straight into it (zero staging copies);
        # legacy planes still hand payloads back through wait()
        got = np.empty(nbytes, np.uint8)
        key = self._register_inflight(orig, "rx", chan, tag,
                                      {"seq": seq, "got": got, "hop": hop,
                                       "nbytes": nbytes, "acked": 0})
        try:
            reqs = wire.post_recvs(nbytes, hop, into=got)
        except BaseException as e:
            # no handle exists yet to own the cleanup: the registration
            # and outstanding claim must not outlive the failed post
            _FLIGHT.record("p2p-abort", dir="rx", tag=tag,
                           error=type(e).__name__)
            if key is not None:
                self._p2p_inflight.pop(key, None)
            self._release_outstanding(orig, "rx", chan, tag)
            raise
        # until a wait() claims them, this thread's blocking sends test
        # the posted receives (_p2p_progress): see _PostedRecv
        entry = _PostedRecv(reqs)
        posted = _posted_p2p_recvs(self)
        posted.append(entry)

        def wait():
            # claimed first: from here on only this wait tests the
            # requests, on whichever thread it runs
            entry.claim()
            if entry in posted:
                posted.remove(entry)
            info = (self._p2p_inflight.get(key) if key is not None
                    else None) or {"got": got, "acked": 0}
            try:
                # _p2p_progress pumps every wired comm BOTH ways, so queued
                # isend tx keeps draining while this recv blocks
                self._drain_p2p_recvs(wire, reqs, info, timeout_s)
            except (TimeoutError, OSError, RuntimeError) as e:
                if key is None:
                    raise
                _FLIGHT.record("p2p-abort", dir="rx", tag=tag,
                               error=type(e).__name__)
                self._p2p_resume_rx(key, e, timeout_s)
            finally:
                if key is not None:
                    self._p2p_inflight.pop(key, None)
            self._release_outstanding(orig, "rx", chan, tag)
            return got.view(template.dtype).reshape(template.shape)

        return P2PHandle(wait)

    def _claim_outstanding(self, orig: int, d: str, chan: int,
                           tag: int) -> None:
        # the 10-bit seq wrap in _p2p_hop is only safe while fewer than
        # 1024 ops are outstanding per (peer, direction, lane, tag)
        # stream: op k+1024 would reuse op k's wire tags while its
        # frames are still in flight — a silent mismatch, so it is
        # refused here. Keyed by ORIGINAL rank: a handle's wait (and so
        # its release) may run after a heal renumbered the peer.
        key = ("out", d, chan, tag)
        st = self._p2p_seq.setdefault(orig, {})
        n = st.get(key, 0)
        if n >= 1023:
            raise RuntimeError(
                f"too many outstanding p2p ops on (original rank {orig}, "
                f"{d}, lane {chan}, tag {tag}): wait() some handles first "
                f"(seq wrap window)")
        st[key] = n + 1

    def _release_outstanding(self, orig: int, d: str, chan: int,
                             tag: int) -> None:
        key = ("out", d, chan, tag)
        st = self._p2p_seq.setdefault(orig, {})
        st[key] = max(0, st.get(key, 1) - 1)

    def batch_isend_irecv(self, ops, timeout_s: float = 60.0) -> list:
        """Issue a batch of p2p ops together (the torch
        ``batch_isend_irecv`` shape): ``ops`` is a list of
        ``("send", array, peer[, tag])`` / ``("recv", array_like, peer[,
        tag])`` tuples. Returns the handles in input order. Issue order
        inside the batch: every send's OUTBOUND connection is wired first
        (a dial never waits on the peer's progress), then receives post,
        then sends — so a batch-shaped cycle of first contacts (the ring
        exchange every rank runs in pipeline parallelism) can neither
        stall on unwired receive connections nor on unposted buffers.
        Call ``wait()`` on every handle."""
        parsed = []
        for op in ops:
            kind, arr, peer = op[0], op[1], op[2]
            tag = op[3] if len(op) > 3 else 0
            if kind not in ("send", "recv"):
                raise ValueError(f"batch op kind must be send/recv, "
                                 f"got {kind!r}")
            parsed.append((kind, arr, peer, tag))
        for kind, _, peer, _ in parsed:  # dial every send target up front:
            if kind == "send":           # unblocks the peers' rx accepts
                self._p2p_wire(peer, "tx", timeout_s)
        handles: dict[int, P2PHandle] = {}
        for i, (kind, arr, peer, tag) in enumerate(parsed):
            if kind == "recv":
                handles[i] = self.irecv(arr, peer, tag, timeout_s)
        for i, (kind, arr, peer, tag) in enumerate(parsed):
            if kind == "send":
                handles[i] = self.isend(arr, peer, tag, timeout_s)
        return [handles[i] for i in range(len(parsed))]

    def _barrier_key(self, kind: str) -> str:
        """Epoch-qualified barrier key. Survivors abort a collective at
        DIFFERENT points (one mid-allreduce, one mid-barrier), so their
        ``_barrier_no`` counters desynchronize across a heal; the heal
        resets the counter and the epoch in the key keeps every
        generation's arrival sets disjoint — a dead rank's pre-heal
        arrival can never release a post-heal barrier early."""
        return f"pg/{self.group_name}/e{self.epoch}/{kind}{self._barrier_no}"

    def barrier(self, timeout_s: float = 30.0) -> None:
        """Block until every rank arrives."""
        if self.world_size == 1:
            return
        self._check_alive()
        self._barrier_no += 1
        self._client.barrier(self._barrier_key("b"),
                             self.world_size, timeout_s)

    def monitored_barrier(self, timeout_s: float = 30.0) -> None:
        """Barrier that NAMES the absent ranks on timeout (the failure-
        detection barrier; torch's monitored_barrier). Each rank publishes
        its arrival under its own store key, so the raised TimeoutError
        reports exactly which ranks never showed up — the difference between
        'something hung' and 'rank 3 is dead'."""
        if self.world_size == 1:
            return
        self._barrier_no += 1
        key = self._barrier_key("mb")
        self._client.set(f"{key}/{self.rank}", "1")
        deadline = time.monotonic() + timeout_s
        # one blocking get at a time (get() itself polls at 10 ms), so the
        # aggregate store load stays O(world_size), not O(world_size^2)
        for r in range(self.world_size):
            try:
                self._client.get(
                    f"{key}/{r}",
                    timeout_s=max(0.0, deadline - time.monotonic()))
            except TimeoutError:
                try:  # one naming sweep (try_get: a transport failure
                    # must not name a present rank as missing)
                    missing = [m for m in range(r, self.world_size)
                               if self._client.try_get(f"{key}/{m}") is None]
                except TimeoutError:
                    missing = list(range(r, self.world_size))  # store gone:
                    # every unconfirmed rank stays suspect, said so below
                # store-state triage of the missing: one that still talks
                # to the store is certainly alive (stuck or slow — keep
                # waiting); one silent for a long window is PROBABLY gone.
                # The silence window gets a floor well above the barrier
                # timeout: a rank deep in a long jit compile makes no
                # store RPCs either, and a 2 s barrier must not brand it
                # dead. This is evidence for the error message, not a
                # decision — nothing acts on it unilaterally.
                silence_s = max(timeout_s, 15.0)
                try:
                    silent = set(self._client.dead_ranks(
                        self.world_size, max_age_s=silence_s))
                except (OSError, TimeoutError):
                    silent = set()
                dead = sorted(set(missing) & silent)
                slow = sorted(set(missing) - silent)
                # the hang postmortem: the barrier just triaged a dead-vs-
                # slow rank, so dump this survivor's last wire events —
                # the hop/frame/verb the time went to — next to the triage
                _postmortem(
                    f"monitored_barrier: rank(s) {missing} missing "
                    f"(store-silent {dead}, store-live {slow}) on rank "
                    f"{self.rank} of group {self.group_name!r}")
                raise TimeoutError(
                    f"monitored_barrier: rank(s) {missing} missing after "
                    f"{timeout_s}s (group {self.group_name!r}, "
                    f"world_size {self.world_size}; "
                    f"store-silent>{silence_s:.0f}s {dead}, "
                    f"store-live {slow})") from None

    def split(self, color: int, timeout_s: float = 30.0) -> "ProcessGroup | None":
        """Partition the group into sub-groups by ``color`` (the
        ``ncclCommSplit`` analogue): ranks passing the same color form a new
        group, re-ranked by old rank order; a negative color opts out and
        returns None. Collective — every rank of this group must call it."""
        if self._destroyed:
            raise RuntimeError("cannot split a destroyed group")
        self._check_alive()  # exchange() can never complete with a dead rank
        self._split_no += 1
        if self.world_size == 1:
            return ProcessGroup(0, 1, None, None, timeout_s,
                                f"{self.group_name}/s{self._split_no}",
                                plane=self.plane) \
                if color >= 0 else None
        ns = f"pg/{self.group_name}/split{self._split_no}"
        colors = self._client.exchange(f"{ns}/c", str(color),
                                       self.world_size, timeout_s)
        members = [r for r, c in enumerate(colors) if int(c) == color]
        if color < 0:
            return None
        # the parent's store outlives the child (server=None); the child's
        # group_name namespaces its ring/barrier keys away from the parent's
        return ProcessGroup(
            members.index(self.rank), len(members), self._store_handle,
            None, timeout_s, f"{self.group_name}/s{self._split_no}c{color}",
            plane=self.plane)

    def shrink(self, grace_s: float = 2.0,
               timeout_s: float = 30.0) -> "ProcessGroup":
        """Elastic recovery: rebuild a working group from the SURVIVING
        ranks after a failure (typically after ``monitored_barrier`` raised
        naming the dead). Every survivor calls ``shrink``; each publishes
        liveness, waits the grace window, the lowest surviving rank
        proposes the member list, and a fresh re-ranked group is wired over
        the same store. Raises for a rank that arrives after the window
        closed (it must exit — the group has moved on). For repair IN
        PLACE — same group object, epoch-fenced wiring, transparent
        collective retry — use :meth:`heal` instead.

        The rendezvous store must still be reachable: run it as a sidecar
        (or on a rank you trust to live) if you need elasticity — losing
        the store host loses the group, the same root-of-bootstrap property
        the reference stack's NCCL-style rendezvous has. Destroy the old
        group afterwards with ``destroy(graceful=False)`` (a graceful
        destroy would wait on the dead)."""
        if self._destroyed:
            raise RuntimeError("cannot shrink a destroyed group")
        self._shrink_no += 1
        if self.world_size == 1 or self._client is None:
            raise RuntimeError("nothing to shrink: single-rank group")
        import json

        from rocnrdma_tpu_torch.transport.backoff import poll_backoff
        ns = f"pg/{self.group_name}/shrink{self._shrink_no}"
        self._client.set(f"{ns}/alive/{self.rank}", "1")
        # grace window, polled instead of blind-slept: the only EARLY exit
        # is every rank having posted (no one left to wait for — the
        # no-death fast path). Store liveness is deliberately NOT used to
        # cut the window short: it is circumstantial (a rank deep in
        # compute makes no RPCs), good for NAMING suspects in errors
        # (monitored_barrier's triage), too weak to justify unilaterally
        # excluding a rank the full grace would have admitted.
        members_key = f"{ns}/members"
        deadline = time.monotonic() + grace_s
        back = poll_backoff()
        while True:
            # try_get, not get(timeout_s=0): an alive-key lookup that fails
            # at the TRANSPORT must raise (named), never read as "rank is
            # gone" — a store-connection flake during the leader's final
            # poll must not get a live rank excluded from the member list
            alive = [r for r in range(self.world_size)
                     if self._client.try_get(f"{ns}/alive/{r}") is not None]
            if len(alive) == self.world_size:
                break
            if time.monotonic() >= deadline:
                break
            back.pause()
        if not alive:
            # we posted our own key and cannot read it back: the store is
            # unreachable — name it instead of crashing on min([])
            raise TimeoutError(
                f"shrink: no alive keys readable after {grace_s}s grace "
                f"(store unreachable? group {self.group_name!r})")
        if self.rank == min(alive):
            # first-writer-wins: with skewed entry two ranks can each think
            # themselves the minimum survivor; set-if-absent makes exactly
            # one proposal stick, and the loser adopts it (split-brain —
            # two ranks proceeding with different member lists — cannot
            # happen; a rank missing from the winning list raises below)
            self._client.set_if_absent(members_key, json.dumps(alive))
        members = json.loads(self._client.get(members_key, timeout_s))
        if self.rank not in members:
            raise RuntimeError(
                f"rank {self.rank} missed the shrink window; group "
                f"re-formed as {members} without it — exit")
        # in master mode this rank may own the store: hand it to the new
        # group, or destroying the old one would cut every survivor off
        server, self._server = self._server, None
        return ProcessGroup(
            members.index(self.rank), len(members), self._store_handle,
            server, timeout_s, f"{self.group_name}/shrunk{self._shrink_no}",
            plane=self.plane)

    # -- cross-plane heal hook (the device-plane restart, DESIGN.md §5g) ----

    def set_device_heal(self, hook) -> None:
        """Register the device-plane heal hook: ``hook(members, epoch)``
        runs on this rank after every SUCCESSFUL membership change —
        heal, grow, or this rank's own promotion/admission — with the
        agreed member list (original ranks, current-rank order) and the
        new epoch. The intended hook drives
        :func:`rocnrdma_tpu_torch.runtime.init.reinit_runtime` (coordinated
        communicator abort and re-create + mesh/Transport rebuild); the
        group itself stays torch-free either way.

        Failure contract: a raising hook surfaces as a named
        ``RuntimeError`` ("device-plane heal failed ...") to whoever
        triggered the membership change — the HOST plane is already
        healed and keeps serving collectives (watchdog re-armed, ring
        wired, epoch advanced); only the device plane is down. The
        error is recorded as a ``deviceheal-abort`` flight event and is
        never swallowed into another host-plane heal attempt."""
        self._device_heal_hook = hook

    def agree(self, key: str, value: str | None = None,
              timeout_s: float = 30.0) -> str:
        """First-writer-wins agreement under this group's store
        namespace — the proposal primitive ``heal()``/``grow()`` use for
        their member lists, exposed for cross-plane consumers (the
        device-plane heal elects its coordinator through it). With
        ``value``, propose set-if-absent and return the winning value
        (ours, or the incumbent's); with ``value=None``, block up to
        ``timeout_s`` for someone's proposal."""
        if self._client is None:
            raise RuntimeError("agree: this group has no store client "
                               "(single-rank group without a store)")
        full = f"pg/{self.group_name}/{key}"
        _keyspace.check_key(full)  # die at mint time, not as an orphan
        if value is not None:
            return self._client.set_if_absent(full, value)
        return self._client.get(full, timeout_s)

    def _run_device_heal(self, members: list) -> None:
        """Invoke the registered device-heal hook for a just-completed
        membership change. Runs AFTER the host-plane protocol is fully
        committed (epoch advanced, ring wired, watchdog re-armed), so a
        device-plane failure leaves a healthy host plane behind it."""
        hook = self._device_heal_hook
        if hook is None:
            return
        try:
            hook(list(members), self.epoch)
        except BaseException as e:
            _FLIGHT.record("deviceheal-abort", epoch=self.epoch,
                           error=type(e).__name__)
            if not isinstance(e, Exception):
                raise  # KeyboardInterrupt/SystemExit are not heal failures
            # the host plane is healthy but the device plane is down:
            # the fleet view must say so until the next successful
            # membership change (or hook run) flips it back
            self._set_health("degraded", cause="device-heal-failed")
            raise RuntimeError(
                f"device-plane heal failed on epoch {self.epoch} of "
                f"group {self.group_name!r} (host plane healthy; members "
                f"{members}): {e}") from e

    # -- self-healing (epoch-fenced in-place ring repair) -------------------

    @property
    def global_ranks(self) -> list:
        """Current members' ORIGINAL ranks in current-rank order — the
        stable identities a shrunk group's oracle (and its operator) key
        by. ``global_ranks[self.rank]`` is who this process originally
        was; before any heal it is ``list(range(world_size))``."""
        return list(self._ranks)

    @property
    def heals(self) -> int:
        """How many times this group has healed (== ``self.epoch``
        unless a future epoch consumer bumps differently)."""
        return self._heals

    def _seed_admissions(self, ns: str, epoch: int, members: list,
                         prop: dict, registry: str, slots: dict) -> None:
        """Leader-side: seed each admitted slot's PRE-published listener
        handle under the agreement ns and cut the admit record its
        claimant is polling. One schema for both admission shapes (spare
        promotion and grow join) — ``_complete_admission`` reads every
        field, so the two paths must never desync."""
        import json
        for slot, sid in slots.items():
            self._client.set_if_absent(f"{ns}/h/{slot}",
                                       prop["handles"][str(slot)])
            self._client.set(
                f"{_keyspace.registry_ns(self.group_name, registry)}"
                f"/admit/{sid}",
                json.dumps({"epoch": epoch, "members": members,
                            "slot": slot, "ops": int(prop["ops"]),
                            "lane_ops": prop.get("lane_ops", {}),
                            "hwm": int(prop["hwm"]), "ns": ns,
                            "grow_no": self._grow_no,
                            "watchdog": prop.get("watchdog")}))

    def heal(self, grace_s: float = 5.0, timeout_s: float | None = None,
             _suspects=None) -> list:
        """Elastic recovery IN PLACE — the self-healing half of the
        failure story (``shrink()`` is the build-a-new-group sibling;
        this one repairs the group object the training loop already
        holds, so the interrupted collective can transparently retry).
        Every survivor calls ``heal`` (the self-healing ``_ring`` path
        does it automatically on a confirmed death); the protocol:

        1. **Abort + fence.** The failed collective already raised a
           named error (CLEAN-ABORT). Survivors agree on the member list
           through the store (idempotent rank-keyed alive publication,
           grace window, first-writer-wins proposal by the lowest
           surviving original rank — the same split-brain-free shape as
           ``shrink``), then bump the group generation: every comm —
           kept wiring included — stamps the new epoch on outbound
           frames and FENCES inbound frames of any other generation at
           the vtable boundary, so the aborted attempt's in-flight
           frames (whose hop/frame tags the retry will reuse) can never
           corrupt a post-heal reduction.
        2. **Re-wire.** The surviving ring is repaired AROUND the dead:
           edges whose both endpoints stay ring-adjacent are KEPT (their
           stale traffic is epoch-fenced on arrival); only the gaps over
           dead ranks are re-dialed, through per-epoch store keys, with
           refused/flaky connects retried under the shared backoff
           (FaultNet-visible). P2P wiring is torn down (streams to a
           renumbered peer are meaningless); the store's liveness table
           is pruned of orphaned rank ids so the compacted numbering
           re-registers cleanly; barrier counters reset under the new
           epoch's namespace.
        3. **Re-arm.** The wired barrier doubles as the new epoch's
           clock-sync mark; the watchdog (if it was running) restarts on
           the new membership.

        **Warm spares.** When the group has registered spares
        (``init_process_group(spare=True)`` + ``wait_promotion``), a
        confirmed-dead slot is PROMOTED instead of shrunk: the lowest-sid
        live, unburned spare adopts the dead rank's original identity —
        the member list (and so world size, reshard shapes, and rooted
        roots) is preserved, and the only wire work on the critical path
        is dialing the spare's PRE-published listener and the spare's one
        dial to its successor. A spare is promotable at most once (its
        admit record burns it), so a spare that dies mid-promotion is
        deterministically skipped by the retried heal, which shrinks.

        Returns the new member list (original ranks). Raises for a rank
        that misses the window (it must exit — the group moved on), and
        keeps the same store-must-survive requirement as ``shrink``.
        ``_suspects`` (internal): current-rank ids the caller's triage
        already confirmed dead — lets the grace window close early."""
        if self._destroyed:
            raise RuntimeError("cannot heal a destroyed group")
        if self._standby is not None:
            raise RuntimeError("a spare/joiner cannot heal the group it "
                               "is waiting to enter (wait_promotion)")
        if self.world_size == 1 or self._client is None:
            raise RuntimeError("nothing to heal: single-rank group")
        import json

        from rocnrdma_tpu_torch.transport.backoff import poll_backoff
        t = self.timeout_s if timeout_s is None else timeout_s
        deadline = time.monotonic() + t + grace_s
        remaining = lambda: max(0.1, deadline - time.monotonic())
        epoch = self.epoch + 1
        g = self._ranks[self.rank]
        ns = f"pg/{self.group_name}/heal/e{epoch}"
        t_span = time.perf_counter()
        self._set_health("healing")
        _FLIGHT.record("heal-start", epoch=epoch, rank=g)
        with self._health_lock:
            wd_dead = list(self._dead)
        suspects = {self._ranks[r] for r in wd_dead
                    if 0 <= r < len(self._ranks)}
        suspects |= {self._ranks[r] for r in (_suspects or ())
                     if 0 <= r < len(self._ranks)}
        was_watching = self._watchdog_params
        self.stop_watchdog()
        try:
            members = self._heal_protocol(grace_s, epoch, g, ns, suspects,
                                          remaining, was_watching)
        except BaseException as e:
            # a FAILED heal (store flake, missed window, divergence) must
            # not leave failure detection silently off: the watchdog the
            # protocol stopped is re-armed before the error propagates,
            # so a later heal attempt — or async_error() — still sees
            # the world
            _FLIGHT.record("heal-abort", epoch=epoch,
                           error=type(e).__name__)
            self._set_health("degraded", cause="heal-failed")
            if was_watching is not None:
                self.start_watchdog(*was_watching)
            raise
        # the host plane is healed (epoch advanced, ring wired, watchdog
        # re-armed by the protocol); now follow it with the device plane.
        # A hook failure raises NAMED (RuntimeError — deliberately not in
        # _ring's heal-and-retry set, so it propagates to the caller
        # instead of burning another host heal) with the host plane
        # still serving.
        self._run_device_heal(members)
        # the membership-track span (obs.chrome renders member-* kinds
        # with dur as slices): heal entry -> committed membership, with
        # the epoch bump in the args. Deliberately OUTSIDE the heal-
        # digest prefix — dur is wall time and must never enter a
        # replay-equality contract.
        _FLIGHT.record("member-heal", epoch=epoch, world=len(members),
                       dur=time.perf_counter() - t_span)
        self._set_health("ok")
        return members

    def _heal_protocol(self, grace_s, epoch, g, ns, suspects,
                       remaining, was_watching) -> list:
        """The body of :meth:`heal` steps 1-3, run with the watchdog
        stopped — split out so heal's failure path can re-arm the
        detector around ANY exit (see the wrapper's except)."""
        import json

        from rocnrdma_tpu_torch.transport.backoff import poll_backoff
        # 1. idempotent rank-keyed alive publication + grace window. The
        # early exits: everyone posted (spurious heal), or every member
        # is accounted for — posted alive or triage-confirmed dead. A
        # merely-slow rank that posts inside the grace is admitted; one
        # that misses the window raises below and must exit (the same
        # contract shrink documents). The alive VALUE is this rank's
        # committed-collective stamp (total + per-lane split): the
        # divergence check below needs every survivor to agree on which
        # op — on WHICH LANE — a retry re-executes.
        self._client.set(f"{ns}/alive/{g}", self._commit_stamp())
        grace_deadline = time.monotonic() + grace_s
        back = poll_backoff()
        while True:
            alive = [m for m in self._ranks
                     if self._client.try_get(f"{ns}/alive/{m}") is not None]
            if len(alive) == len(self._ranks):
                break
            if alive and not (set(self._ranks) - set(alive) - suspects):
                break
            if time.monotonic() >= grace_deadline:
                break
            back.pause()
        if not alive:
            raise TimeoutError(
                f"heal: no alive keys readable after {grace_s}s grace "
                f"(store unreachable? group {self.group_name!r})")
        if g == min(alive):
            # spare promotion (the "heal without shrinking" half): every
            # confirmed-dead slot with a live, unburned warm spare keeps
            # its seat — the spare adopts the slot's ORIGINAL identity
            # (re-rank + epoch bump only; its listener was pre-published
            # at registration, so no cold listen/publish lands on this
            # critical path). Dead slots beyond the spare pool shrink as
            # before.
            dead_now = [m for m in self._ranks if m not in alive]
            promoted = self._assign_spares(dead_now, remaining)
            ops_total, lane_split = self._commit_counts()
            prop = {"members": [m for m in self._ranks
                                if m in alive or m in promoted],
                    "promoted": {str(s): sid
                                 for s, (sid, _) in promoted.items()},
                    "handles": {str(s): h
                                for s, (_, h) in promoted.items()},
                    "ops": ops_total,
                    "lane_ops": lane_split,
                    "hwm": self._orig_hwm,
                    "watchdog": was_watching}
            self._client.set_if_absent(f"{ns}/members", json.dumps(prop))
        prop = json.loads(self._client.get(f"{ns}/members", remaining()))
        members = list(prop["members"])
        promoted_slots = {int(k): v
                          for k, v in prop.get("promoted", {}).items()}
        if g not in members:
            raise RuntimeError(
                f"rank {g} missed the heal window; group re-formed as "
                f"{members} without it — exit")
        dead = sorted(set(self._ranks) - set(members))
        old_ranks, old_world = self._ranks, self.world_size
        new_rank, new_world = members.index(g), len(members)
        _FLIGHT.record("heal-members", epoch=epoch,
                       members=json.dumps(members), dead=json.dumps(dead),
                       promoted=json.dumps(promoted_slots, sort_keys=True))
        # divergence check: a death can straddle a commit boundary — a
        # survivor whose last inbound frames did not depend on the victim
        # COMMITS the interrupted collective while downstream survivors
        # abort it. Those two populations would retry DIFFERENT ops (with
        # reused tags, and with full- vs shrunk-group semantics for the
        # same round), which no fence can reconcile — so it must be a
        # NAMED failure, never a silent mix. Every survivor published its
        # committed count in its alive key; disagreement aborts the heal
        # on every rank (restart from the last application checkpoint).
        seqs = {m: self._client.try_get(f"{ns}/alive/{m}") for m in members}
        if len({v for v in seqs.values() if v is not None}) > 1:
            _FLIGHT.record("heal-diverged", epoch=epoch,
                           seqs=json.dumps(seqs, sort_keys=True))
            raise RuntimeError(
                f"heal: survivors diverged across the failed collective "
                f"(committed-op counts {seqs}); some ranks committed the "
                f"op others must retry — transparent retry is impossible, "
                f"restart the job from its last checkpoint")
        # promotion bookkeeping BEFORE the rewire: incarnations bump (the
        # process behind a promoted identity changed — p2p stream state
        # under it must not resume), and the leader seeds the promoted
        # slots' PRE-PUBLISHED listener handles under the heal ns plus
        # the admit records the spares are polling. Admits are written
        # only after the divergence check above: a diverged heal must
        # not burn (or wake) a spare.
        fresh = set(promoted_slots)
        for slot in sorted(fresh):
            self._incarnation[slot] = self._incarnation.get(slot, 0) + 1
            _FLIGHT.record("heal-promoted", epoch=epoch, slot=slot,
                           sid=promoted_slots[slot])
        if g == min(alive) and promoted_slots:
            self._seed_admissions(ns, epoch, members, prop, "spares",
                                  promoted_slots)
        # 2. the fence goes up BEFORE any rewiring: every comm (kept or
        # new) now stamps the new generation; stale stashed frames are
        # fenced+counted; LG credit and put-ring state reset. P2P wiring
        # drops but STREAM state survives for continuous peers (resume).
        # self.epoch advances WITH the fence, not after the rewire: a
        # heal that fails mid-rewire on one survivor but post-rewire on
        # another must leave every survivor proposing the SAME next
        # epoch (e+2), or the retried heals rendezvous in different
        # namespaces and split-brain into disjoint groups.
        self._net.set_epoch(epoch)
        self.epoch = epoch
        # the hierarchy is generation-bound state: tear it down with the
        # fence — the next hierarchical collective rebuilds it from the
        # HEALED member list (which is how a dead node leader re-elects
        # by lowest surviving original rank; sub-net frames of the old
        # generation die with their closed comms)
        self._hier_invalidate()
        self._suspend_p2p(members, fresh)
        self._rewire(members, new_rank, new_world, old_ranks, ns, remaining,
                     fresh=fresh)
        self.rank, self.world_size, self._ranks = new_rank, new_world, members
        self._barrier_no = 0
        self._postmortemed = False
        # the store identity follows the new numbering (liveness stamps,
        # barrier arrivals); the ORIGINAL identity lives on in _ranks
        self._client.rank = new_rank
        self._client.barrier(f"{ns}/wired", new_world, remaining())
        # every survivor has re-stamped under its new id at the barrier;
        # the leader prunes the ids the compaction orphaned — and the
        # promoted spares' prefixed store footprint — so nothing stale
        # can brand a live rank dead or collide with a later claimant
        # (satellite: bootstrap prune)
        if g == min(alive) and (new_world < old_world or promoted_slots):
            try:
                # the kv sweep drops the DEAD generations' device-plane
                # coordinator elections — per-epoch prefixes, strictly
                # below the epoch just minted: a promoted spare with the
                # minimum original id is the NEW epoch's election leader
                # and may write deviceheal/e<N>/coord the instant it
                # clears the wired barrier, racing this sweep (a whole-
                # namespace sweep here deleted its proposal and wedged
                # every other member's blocking agree)
                # the kv sweep also drops the dead generations' fleet
                # telemetry snapshots (pg/<g>/fleet/e<k>/ — same
                # strictly-below-the-minted-epoch rule: the new epoch's
                # publishes must survive the sweep), so healed-away
                # generations don't leak snapshot keys on a long-lived
                # sidecar store
                self._client.prune(range(new_world, old_world),
                                   prefix=f"pg/{self.group_name}/",
                                   spares=promoted_slots.values(),
                                   kv=tuple(
                                       f"pg/{self.group_name}/deviceheal/e{old_epoch}/"
                                       for old_epoch in range(epoch))
                                   + tuple(
                                       f"pg/{self.group_name}/fleet/e{old_epoch}/"
                                       for old_epoch in range(epoch))
                                   + tuple(
                                       f"pg/{self.group_name}/hier/e{old_epoch}/"
                                       for old_epoch in range(epoch)))
            except (OSError, TimeoutError):
                pass  # hygiene, not correctness: stale ids age out of use
        # the wired barrier doubles as the new epoch's clock handshake
        # (obs.chrome aligns rank timelines on the LAST sync mark)
        _FLIGHT.mark_sync(ns=ns, rank=new_rank)
        self._heals += 1
        if promoted_slots:
            _WIRE.promoted(len(promoted_slots))
        _FLIGHT.record("heal-done", epoch=epoch, world=new_world,
                       promoted=len(promoted_slots))
        if was_watching is not None:
            self.start_watchdog(*was_watching)
        return members

    def _rewire(self, members, new_rank, new_world, old_ranks, ns,
                remaining, fresh=frozenset()) -> None:
        """Repair the ring around the dead: keep edges whose endpoints
        stay ring-adjacent (stale frames on them are epoch-fenced), dial
        fresh connections across the gaps. Publish-before-dial ordering
        makes any pattern of gaps deadlock-free, exactly as in
        ``bootstrap_ring``. ``fresh``: original ranks whose PROCESS is
        new this epoch (promoted spares, grow joiners) — an edge touching
        one is never "kept" even when the identity adjacency matches,
        because the old connection went to a different process (the dead
        rank, or nowhere)."""
        from rocnrdma_tpu_torch.transport.backoff import retry_with_backoff

        def succ_of(gid, ring):
            return ring[(ring.index(gid) + 1) % len(ring)]

        g = old_ranks[self.rank]
        if new_world == 1:
            # the ring degenerates: this survivor is alone
            for comm in (self._send, self._recv):
                if comm is not None:
                    self._close_comm_quietly(comm)
            self._send = self._recv = None
            _FLIGHT.record("heal-rewire", kept_send=False, kept_recv=False)
            return
        succ_g = members[(new_rank + 1) % new_world]
        pred_g = members[(new_rank - 1) % new_world]
        keep_send = (succ_g not in fresh and succ_g in old_ranks
                     and succ_of(g, old_ranks) == succ_g)
        keep_recv = (pred_g not in fresh and pred_g in old_ranks
                     and succ_of(pred_g, old_ranks) == g)
        listener = send_comm = recv_comm = None
        try:
            if not keep_recv:
                handle, listener = self._net.listen()
                self._client.set(f"{ns}/h/{g}", handle)
            if not keep_send:
                if self._send is not None:
                    self._close_comm_quietly(self._send)
                    self._send = None
                peer_handle = self._client.get(f"{ns}/h/{succ_g}",
                                               remaining())
                send_comm = retry_with_backoff(
                    lambda: self._net.connect(0, peer_handle,
                                              min(5.0, remaining())),
                    remaining(),
                    f"heal rewire: connect to original rank {succ_g}",
                    retry_on=(ConnectionRefusedError, ConnectionResetError))
                self._send = send_comm
            if not keep_recv:
                if self._recv is not None:
                    self._close_comm_quietly(self._recv)
                    self._recv = None
                recv_comm = retry_with_backoff(
                    lambda: self._net.accept(listener,
                                             min(5.0, remaining())),
                    remaining(),
                    f"heal rewire: accept original rank {pred_g}",
                    retry_on=(ConnectionRefusedError, ConnectionResetError,
                              TimeoutError))
                self._recv = recv_comm
        except BaseException as e:
            # a failed repair must not leak the half-made endpoints (the
            # bootstrap_ring teardown discipline) and must leave a
            # flight event for the postmortem (self.epoch already
            # advanced with the fence)
            _FLIGHT.record("heal-abort", epoch=self.epoch,
                           error=type(e).__name__)
            if send_comm is not None:
                self._close_comm_quietly(send_comm)
                if self._send is send_comm:
                    # the retry's _ring fast-fail checks _send/_recv for
                    # None — a pointer at the just-closed comm would hand
                    # it to the next collective instead
                    self._send = None
            if recv_comm is None and listener is not None:
                bootstrap._close_quietly(listener)
            raise
        _FLIGHT.record("heal-rewire", kept_send=keep_send,
                       kept_recv=keep_recv)

    def _close_comm_quietly(self, comm) -> None:
        """Best-effort comm teardown on the heal path — the peer may be
        the dead rank itself; its half of the wire cannot make this
        worse than closed."""
        try:
            self._net.close_comm(comm)
        except Exception:
            pass

    def _suspend_p2p(self, members, fresh=frozenset()) -> None:
        """Drop all p2p WIRING at a heal/grow — peers renumber, so cached
        connections and published listeners are meaningless in the new
        epoch — but keep the STREAM state (sequence counters and
        in-flight registrations, keyed by original rank) for peers whose
        process continues into the new membership: those streams RESUME
        from the last fence-acknowledged frame (``_p2p_resume_rx``/
        ``_p2p_resume_tx``) instead of tearing down. State for dead
        slots — and for fresh incarnations (promoted spares, joiners)
        under a surviving identity — is dropped: the stream's data died
        with the process behind it."""
        for (peer, d), wire in list(self._p2p.items()):
            self._close_comm_quietly(wire.recv_comm if d == "rx"
                                     else wire.send_comm)
        self._p2p.clear()
        if self._p2p_listen and self.plane == "shm":
            # as in destroy(): never-accepted shm listeners hold segments
            # the net does not track
            for peer, listener in self._p2p_listen.items():
                if peer not in self._p2p_accepted:
                    bootstrap._close_quietly(listener)
        self._p2p_listen = None
        self._p2p_accepted = set()
        keep = set(members) - set(fresh)
        for orig in list(self._p2p_seq):
            if orig not in keep:
                del self._p2p_seq[orig]
        for key in list(self._p2p_inflight):
            if key[0] not in keep:
                del self._p2p_inflight[key]
            else:
                # re-arm: a tail re-queued by an EARLIER resume (state
                # "resumed") was just fenced again with this epoch bump —
                # clear the flag so the wait/service re-run the resume
                # protocol against the receiver's CURRENT cursor instead
                # of reporting a flush of fenced frames as success
                self._p2p_inflight[key].pop("state", None)
        # surviving outbound streams now await their receivers' RESUME
        # cursors; the service runs from the progress engine AND from
        # _check_alive (a sender that moved on to collectives must still
        # answer — see _p2p_resume_service)
        self._p2p_resume_pending = any(k[1] == "tx"
                                       for k in self._p2p_inflight)

    def _scan_standby_registry(self, sub: str, base: int, what: str,
                               remaining) -> list:
        """Walk the standby registry ``pg/<group>/<sub>`` for live,
        unburned registrations, ascending slot id — ``[(sid, handle),
        ...]``. Slot ids are claimed densely from 0 and consumed
        monotonically — ``prune`` keeps the ``slot``/``admit`` keys of
        promoted/burned slots precisely so this scan's
        first-missing-slot stop rule cannot hide a live standby at a
        higher sid. A registration is a candidate only when it is
        unburned (no admit record — an admit, even from a heal/grow
        that later failed, burns the slot; the decision is a function
        of store state, never of wall-clock races), has published its
        listener handle, and heartbeats within the liveness window."""
        try:
            ages = self._client.live_ages()
        except (OSError, TimeoutError):
            ages = {}
        # liveness window: a standby polls its admit key continuously, so
        # any healthy one's age is near zero; the generous floor only
        # guards against a scheduler stall branding a live standby dead
        window = 10.0
        reg = _keyspace.registry_ns(self.group_name, sub)
        out = []
        sid = 0
        while True:
            # both callers floor remaining() at 0.1 — compare against
            # that floor or an expired deadline never stops the scan
            if remaining() <= 0.1:
                raise TimeoutError(
                    f"{what}: standby registry scan ran out of deadline")
            if self._client.try_get(f"{reg}/slot/{sid}") is None:
                break
            if self._client.try_get(f"{reg}/admit/{sid}") is None:
                handle = self._client.try_get(f"{reg}/h/{sid}")
                age = ages.get(base + sid)
                if handle is not None and age is not None and age <= window:
                    out.append((sid, handle))
            sid += 1
        return out

    def _assign_spares(self, dead_slots, remaining) -> dict:
        """Heal-leader side of promotion: map confirmed-dead slots
        (ascending) to live, unburned spares (ascending slot id) from
        the store registry — a spare that died mid-promotion is
        deterministically skipped by the retried heal (see
        ``_scan_standby_registry``'s burn rule). Returns
        ``{slot: (sid, handle)}``."""
        if not dead_slots:
            return {}
        candidates = self._scan_standby_registry(
            "spares", bootstrap.SPARE_RANK_BASE, "heal", remaining)
        return dict(zip(sorted(dead_slots), candidates))

    # -- elastic grow (rank admission: the exact dual of heal) --------------

    def grow(self, grace_s: float = 5.0,
             timeout_s: float | None = None) -> list:
        """Elastic grow IN PLACE — the exact dual of :meth:`heal`:
        re-admit capacity instead of shrinking around its loss.

        Collective: every current member calls ``grow()`` at the same
        committed-op boundary (between collectives); joiners must already
        be registered through :func:`join_process_group`. The protocol
        mirrors heal step for step:

        1. **Agreement.** Members publish their committed-op counts under
           a per-grow namespace and verify they agree (the joiners adopt
           the agreed count, so a later heal's divergence rule keeps
           working on the widened group); the lowest original rank
           proposes the widened member list (first-writer-wins), with
           every live pending joiner assigned a fresh original id past
           the high-water mark — dead ids are never reused, so oracles
           keyed by original rank stay unambiguous.
        2. **Fence + splice.** ``set_epoch`` fences the old generation
           exactly as in heal; the ring is re-wired with the admitted
           ranks spliced in at the tail — surviving edges are KEPT
           (their stale tails fence on arrival), only the wrap edge and
           the joiner edges dial, through the grow namespace's
           publish-before-dial keys under the shared backoff. Joiners
           pre-published their listener handles at registration, so no
           cold listen/publish lands on this path.
        3. **Re-arm.** The wired barrier doubles as the new epoch's
           clock-sync mark; the watchdog restarts on the widened
           membership; p2p streams between continuing members resume
           (same contract as heal).

        Admitting zero joiners is a no-op (no epoch burn). Returns the
        new member list (original ranks)."""
        if self._destroyed:
            raise RuntimeError("cannot grow a destroyed group")
        if self._standby is not None:
            raise RuntimeError("a spare/joiner cannot grow the group it "
                               "is waiting to enter")
        if self._client is None:
            raise RuntimeError(
                "nothing to grow from: this group has no store client "
                "(single-rank groups must be created with a store_handle "
                "to be growable)")
        t = self.timeout_s if timeout_s is None else timeout_s
        deadline = time.monotonic() + t + grace_s
        remaining = lambda: max(0.1, deadline - time.monotonic())
        epoch = self.epoch + 1
        self._grow_no += 1
        g = self._ranks[self.rank]
        ns = f"pg/{self.group_name}/grow/g{self._grow_no}"
        t_span = time.perf_counter()
        self._set_health("healing")
        _FLIGHT.record("grow-start", epoch=epoch, rank=g)
        was_watching = self._watchdog_params
        self.stop_watchdog()
        try:
            members = self._grow_protocol(epoch, g, ns, remaining,
                                          was_watching)
        except BaseException as e:
            # a failed grow must not leave failure detection silently
            # off (the heal discipline): re-arm before propagating
            _FLIGHT.record("grow-abort", epoch=epoch,
                           error=type(e).__name__)
            self._set_health("degraded", cause="grow-failed")
            if was_watching is not None:
                self.start_watchdog(*was_watching)
            raise
        if self.epoch == epoch:
            # joiners were admitted (a zero-joiner grow burns no epoch
            # and changes nothing the device plane would care about):
            # the widened membership restarts the device plane too —
            # same failure contract as heal's hook
            self._run_device_heal(members)
        # the membership-track span (see heal's member-heal twin): grow
        # entry -> widened membership, outside every digest prefix
        _FLIGHT.record("member-grow", epoch=self.epoch,
                       world=len(members),
                       dur=time.perf_counter() - t_span)
        self._set_health("ok")
        return members

    def _grow_protocol(self, epoch, g, ns, remaining,
                       was_watching) -> list:
        import json

        from rocnrdma_tpu_torch.transport.backoff import poll_backoff
        # 1. member agreement: unlike heal there is no dead-exclusion —
        # grow is a deliberate op on a healthy group, so EVERY member
        # must arrive (a dead one is heal's problem, named here by the
        # deadline), and all must agree on the committed-op boundary
        # (total AND per-lane split — see _commit_stamp)
        self._client.set(f"{ns}/alive/{g}", self._commit_stamp())
        back = poll_backoff()
        while True:
            alive = [m for m in self._ranks
                     if self._client.try_get(f"{ns}/alive/{m}") is not None]
            if len(alive) == len(self._ranks):
                break
            if remaining() <= 0.1:
                raise TimeoutError(
                    f"grow: member(s) "
                    f"{sorted(set(self._ranks) - set(alive))} never "
                    f"arrived at the grow rendezvous (heal() first if "
                    f"one is dead)")
            back.pause()
        seqs = {m: self._client.try_get(f"{ns}/alive/{m}")
                for m in self._ranks}
        if len({v for v in seqs.values() if v is not None}) > 1:
            _FLIGHT.record("grow-diverged", epoch=epoch,
                           seqs=json.dumps(seqs, sort_keys=True))
            raise RuntimeError(
                f"grow: members disagree on the committed-op boundary "
                f"({seqs}); issue grow() between collectives, on every "
                f"rank")
        # 2. leader proposal: every live pending joiner is admitted,
        # assigned an original id past the high-water mark
        if g == min(self._ranks):
            joiners = self._pending_joiners(remaining)
            new_slots = {self._orig_hwm + i: sh
                         for i, sh in enumerate(joiners)}
            ops_total, lane_split = self._commit_counts()
            prop = {"members": list(self._ranks) + sorted(new_slots),
                    "joined": {str(s): sid
                               for s, (sid, _) in new_slots.items()},
                    "handles": {str(s): h
                                for s, (_, h) in new_slots.items()},
                    "ops": ops_total,
                    "lane_ops": lane_split,
                    "hwm": self._orig_hwm + len(new_slots),
                    "watchdog": was_watching}
            self._client.set_if_absent(f"{ns}/members", json.dumps(prop))
        prop = json.loads(self._client.get(f"{ns}/members", remaining()))
        members = list(prop["members"])
        joined = {int(k): v for k, v in prop.get("joined", {}).items()}
        old_ranks, old_world = self._ranks, self.world_size
        _FLIGHT.record("grow-members", epoch=epoch,
                       members=json.dumps(members),
                       joined=json.dumps(sorted(joined)))
        if not joined:
            # nothing to admit: the group is untouched (no epoch burn)
            _FLIGHT.record("grow-done", epoch=self.epoch,
                           world=self.world_size, joined=0)
            if was_watching is not None:
                self.start_watchdog(*was_watching)
            return list(self._ranks)
        new_rank, new_world = members.index(g), len(members)
        fresh = set(joined)
        for slot in sorted(fresh):
            self._incarnation[slot] = self._incarnation.get(slot, 0) + 1
        if g == min(old_ranks):
            self._seed_admissions(ns, epoch, members, prop, "join", joined)
        # 3. fence + splice: kept survivor edges fence their stale tails
        # on arrival exactly as in heal; only the wrap and joiner edges
        # dial (publish-before-dial through the grow ns). self.epoch
        # advances WITH the fence, not after the rewire — same invariant
        # as heal: a grow that fails mid-rewire on one member but
        # post-rewire on another must leave every member proposing the
        # SAME next epoch, or the retried repairs rendezvous in
        # different namespaces and split-brain.
        self._net.set_epoch(epoch)
        self.epoch = epoch
        self._hier_invalidate()  # rebuilt from the widened membership
        #                          (admitted joiners past the agreed map
        #                          run as singleton nodes)
        self._suspend_p2p(members, fresh)
        self._rewire(members, new_rank, new_world, old_ranks, ns, remaining,
                     fresh=fresh)
        self.rank, self.world_size, self._ranks = new_rank, new_world, members
        self._orig_hwm = int(prop["hwm"])
        self._barrier_no = 0
        self._postmortemed = False
        self._client.rank = new_rank
        self._client.barrier(f"{ns}/wired", new_world, remaining())
        if g == min(old_ranks):
            try:
                # the admitted joiners' prefixed store footprint (slot/
                # handle/admit keys, prefixed liveness, barrier arrivals)
                # is cleared so their slot ids are cleanly re-claimable;
                # the kv sweep retires the old generations' device-plane
                # coordinator elections exactly as in heal (per-epoch
                # prefixes below the minted epoch — the election leader
                # here is always this same rank, but the heal-side race
                # discipline is kept symmetric)
                self._client.prune((), prefix=f"pg/{self.group_name}/",
                                   joiners=joined.values(),
                                   kv=tuple(
                                       f"pg/{self.group_name}/deviceheal/e{old_epoch}/"
                                       for old_epoch in range(epoch))
                                   + tuple(
                                       f"pg/{self.group_name}/fleet/e{old_epoch}/"
                                       for old_epoch in range(epoch))
                                   + tuple(
                                       f"pg/{self.group_name}/hier/e{old_epoch}/"
                                       for old_epoch in range(epoch)))
            except (OSError, TimeoutError):
                pass  # hygiene, not correctness
        _FLIGHT.mark_sync(ns=ns, rank=new_rank)
        _WIRE.grew()
        _FLIGHT.record("grow-done", epoch=epoch, world=new_world,
                       joined=len(fresh))
        if was_watching is not None:
            self.start_watchdog(*was_watching)
        return members

    def _pending_joiners(self, remaining) -> list:
        """Grow-leader side: the live, unadmitted joiner registrations,
        ascending slot id — ``[(sid, handle), ...]`` (same scan and
        burn rule as spare promotion: ``_scan_standby_registry``)."""
        return self._scan_standby_registry(
            "join", bootstrap.JOINER_RANK_BASE, "grow", remaining)

    # -- standby ranks (warm spares / grow joiners) -------------------------

    def _register_standby(self, timeout_s: float) -> None:
        """Register this process in the store's standby registry: claim
        the lowest free slot id (set-if-absent — first writer wins),
        adopt the prefixed liveness identity, and PRE-publish a listener
        handle so promotion-time dials hit an already-listening endpoint
        (the no-cold-dial half of the warm-spare contract — the spare's
        would-be neighbours read this handle instead of waiting for a
        fresh listen+publish on the heal's critical path). Injected
        admission refusals (``FaultSchedule.join_refusals``) retry under
        the shared backoff like refused connects."""
        import uuid as _uuid

        from rocnrdma_tpu_torch.transport.backoff import retry_with_backoff
        sub = "spares" if self._standby == "spare" else "join"
        reg = _keyspace.registry_ns(self.group_name, sub)
        token = _uuid.uuid4().hex
        sched = getattr(self._net, "schedule", None)

        def claim() -> int:
            why = sched.join_fault() if sched is not None else None
            if why is not None:
                raise ConnectionRefusedError(f"faultnet: {why}")
            deadline = time.monotonic() + timeout_s
            sid = 0
            while True:
                if self._client.set_if_absent(f"{reg}/slot/{sid}",
                                              token) == token:
                    return sid
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"standby registration: no free {sub} slot "
                        f"within {timeout_s}s")
                sid += 1

        self._sid = retry_with_backoff(
            claim, timeout_s, f"{sub} admission",
            retry_on=(ConnectionRefusedError,))
        base = (bootstrap.SPARE_RANK_BASE if sub == "spares"
                else bootstrap.JOINER_RANK_BASE)
        self._client.rank = base + self._sid
        handle, listener = self._net.listen()
        self._standby_listener = listener
        self._client.set(f"{reg}/h/{self._sid}", handle)
        self._client.heartbeat()  # first stamp under the prefixed id
        _FLIGHT.record("standby-registered", role=self._standby,
                       sid=self._sid)

    def wait_promotion(self, timeout_s: float = 600.0) -> list:
        """Block until this standby rank is admitted, then wire in and
        become a full member; returns the member list (original ranks).

        For a SPARE: a heal with a confirmed-dead slot promotes the
        lowest-sid live spare into the dead rank's ORIGINAL identity —
        re-rank + epoch bump, world size unchanged; the interrupted
        collective's retry then runs on the full-width group with this
        process contributing in the dead rank's place. For a JOINER:
        the survivors' next :meth:`grow` admits it under a fresh
        original id (``join_process_group`` calls this internally).

        While waiting, every admit-key poll stamps the prefixed liveness
        id — the heartbeat the heal/grow leader's candidate scan reads.
        Collectives on a standby rank raise until this returns."""
        if self._standby is None:
            raise RuntimeError("wait_promotion: this rank is not a "
                               "spare/joiner (already a member?)")
        import json

        from rocnrdma_tpu_torch.transport.backoff import poll_backoff
        sub = "spares" if self._standby == "spare" else "join"
        admit_key = (f"{_keyspace.registry_ns(self.group_name, sub)}"
                     f"/admit/{self._sid}")
        deadline = time.monotonic() + timeout_s
        back = poll_backoff()
        kind = self._standby
        t_span = time.perf_counter()
        self._set_health("resuming")  # no-op for a fresh standby; a
        #                               re-entered wait after an aborted
        #                               admission transitions back
        try:
            while True:
                val = self._client.try_get(admit_key)
                if val is not None:
                    break
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"wait_promotion: no admission within {timeout_s}s "
                        f"({self._standby} {self._sid} of group "
                        f"{self.group_name!r})")
                back.pause()
            info = json.loads(val)
            sched = getattr(self._net, "schedule", None)
            if sched is not None:
                sched.promotion_fault()  # chaos: spare death mid-promotion
            _FLIGHT.record("promote-admit", epoch=info["epoch"],
                           slot=info["slot"], sid=self._sid, role=kind)
            self._complete_admission(info)
        except BaseException as e:
            # an aborted admission (missed window, store flake, the
            # admitting group dying mid-splice) must leave its story in
            # the flight ring — the postmortem for "the spare never
            # joined" starts here
            _FLIGHT.record("promote-abort", role=kind, sid=self._sid,
                           error=type(e).__name__)
            self._set_health("degraded", cause="promotion-failed")
            raise
        if kind == "spare":
            _WIRE.promoted()
        else:
            _WIRE.grew()
        _FLIGHT.record("promote-done", epoch=self.epoch, rank=self.rank,
                       world=self.world_size, role=kind)
        # this rank just became a member of the new epoch: its device
        # plane joins the membership's coordinated restart (the members'
        # own hooks run at the end of their heal/grow). Raises named on
        # failure with the host-plane admission already complete.
        self._run_device_heal(self._ranks)
        # the membership-track span: admission wait -> full membership
        # (outside the promote- digest prefix — dur is wall time)
        _FLIGHT.record("member-promotion", epoch=self.epoch, role=kind,
                       world=self.world_size,
                       dur=time.perf_counter() - t_span)
        self._set_health("ok")
        return list(self._ranks)

    def _complete_admission(self, info: dict) -> None:
        """Shared spare/joiner admission: adopt the assigned identity,
        epoch, and committed-op count; wire into the ring (accept the
        predecessor on the PRE-created listener whose handle the leader
        seeded, dial the successor's per-epoch handle); join the wired
        barrier that doubles as the new epoch's clock-sync mark."""
        from rocnrdma_tpu_torch.transport.backoff import retry_with_backoff
        ns = info["ns"]
        epoch = int(info["epoch"])
        members = list(info["members"])
        slot = int(info["slot"])
        deadline = time.monotonic() + self.timeout_s
        remaining = lambda: max(0.1, deadline - time.monotonic())
        self._net.set_epoch(epoch)
        self._hier_invalidate()  # a standby never built one; belt and
        #                          braces against re-admission paths
        # adopt the group's node map NOW (bounded read; None on
        # flat-only groups): the auto algorithm pick keys off
        # _node_of and never re-reads the store, so a promoted rank
        # left map-less would pick "ring" while the survivors pick
        # "hier" — a split verdict that strands the whole group in a
        # sub-ring rendezvous. An ABSENT key is a clean flat-only
        # verdict; a store FAILURE must fail the admission named
        # (the burn/shrink path then runs deterministically) — the
        # very next step dials the store anyway, so a broken store
        # was never a survivable admission.
        if self._node_of is None:
            raw = retry_with_backoff(
                lambda: self._client.try_get(
                    f"pg/{self.group_name}/nodemap", timeout_s=5.0),
                timeout_s=min(remaining(), 15.0),
                what=f"node-map adoption for {self.group_name!r}")
            if raw is not None:
                import json as _json
                agreed = _json.loads(raw)
                self._intra_plane = str(agreed["intra_plane"])
                self._node_of = [int(v) for v in agreed["node_of"]]
        self._ranks = members
        self.rank = members.index(slot)
        self.world_size = len(members)
        self.epoch = epoch
        self.last_op_epoch = epoch
        self._op_seq = int(info.get("ops", 0))
        # the per-lane split comes with the total: a later heal's
        # divergence stamp (_commit_stamp) must match the survivors',
        # or an adopted-total-only spare would spuriously "diverge"
        self._lane_ops = {int(k): int(v)
                          for k, v in (info.get("lane_ops") or {}).items()}
        self._orig_hwm = int(info.get("hwm", max(members) + 1))
        # adopt the group's grow counter: a later grow()'s rendezvous
        # namespace (grow/g<N>) is keyed by it, and a member admitted at
        # counter k that kept its own 0 would rendezvous in a split
        # namespace and deadlock the whole group
        self._grow_no = int(info.get("grow_no", 0))
        self._barrier_no = 0
        self._client.rank = self.rank
        listener = self._standby_listener
        send_comm = None
        try:
            if self.world_size > 1:
                succ_g = members[(self.rank + 1) % self.world_size]
                peer_handle = self._client.get(f"{ns}/h/{succ_g}",
                                               remaining())
                send_comm = retry_with_backoff(
                    lambda: self._net.connect(0, peer_handle,
                                              min(5.0, remaining())),
                    remaining(),
                    f"admission wiring: connect to original rank {succ_g}",
                    retry_on=(ConnectionRefusedError, ConnectionResetError))
                self._send = send_comm
                self._recv = retry_with_backoff(
                    lambda: self._net.accept(listener,
                                             min(5.0, remaining())),
                    remaining(),
                    "admission wiring: accept the predecessor",
                    retry_on=(ConnectionRefusedError, ConnectionResetError,
                              TimeoutError))
                # on the shm plane the listener IS the accepted comm's QP
                # (owned by the net from here); TCP listeners stay in the
                # net's listener registry until close — either way it is
                # no longer this rank's to tear down
                self._standby_listener = None
            self._client.barrier(f"{ns}/wired", self.world_size,
                                 remaining())
        except BaseException as e:
            _FLIGHT.record("promote-abort", epoch=epoch, slot=slot,
                           error=type(e).__name__)
            if send_comm is not None:
                self._close_comm_quietly(send_comm)
            raise
        _FLIGHT.mark_sync(ns=ns, rank=self.rank)
        self._standby = None
        wd = info.get("watchdog")
        if wd:
            self.start_watchdog(*wd)

    # -- predictive straggler evasion (DESIGN.md §5m) -------------
    #
    # The watchdog confirms DEATH; a degrading rank — slow-but-alive,
    # heartbeating on schedule — drags every ring collective's critical
    # path indefinitely without ever tripping it. The evasion engine
    # (transport/evasion.py) closes the ROADMAP's "act on the scoreboard
    # before the watchdog does" loop: the windowed straggler
    # scoreboard names the chronically cp-dominant rank, tier 1 rotates
    # it off the critical chain (epoch-fenced same-member rewire +
    # lane-credit cap + re-rooting), tier 2 drains it at an op boundary
    # and promotes a warm spare into its ORIGINAL identity before any
    # death confirmation. Decisions are a pure function of the trace
    # stream: the engine scores on rank 0 only and every tick broadcasts
    # decision + engine state for lockstep adoption (the tune_wire
    # commit shape), so same-seed chaos runs replay digest-equal.

    def enable_evasion(self, policy=None,
                       timeout_s: float | None = None) -> dict:
        """Arm predictive straggler evasion on this group. ``policy``:
        an :class:`~rocnrdma_tpu_torch.transport.evasion.EvasionPolicy`, a
        dict of its fields, or None for the committed defaults. A
        COLLECTIVE among members (the closing barrier pins that every
        rank is armed before anyone ticks); a standby spare arms
        locally only — its engine adopts the group's strike history
        from the first post-promotion tick's broadcast. Returns the
        armed policy constants as a dict."""
        import dataclasses as _dc

        from rocnrdma_tpu_torch.transport import evasion as _evasion
        t = self.timeout_s if timeout_s is None else timeout_s
        if self._destroyed:
            raise RuntimeError("cannot enable evasion on a destroyed group")
        pol = (policy if isinstance(policy, _evasion.EvasionPolicy)
               else _evasion.EvasionPolicy(**(policy or {})))
        self._evasion = _evasion.EvasionEngine(pol)
        _FLIGHT.record("evade-armed", window=pol.window_ops,
                       share=pol.share_threshold,
                       promote=pol.promote_threshold)
        if self._standby is None and self.world_size > 1:
            self.barrier(timeout_s=t)
        return _dc.asdict(pol)

    def evasion_tick(self, timeout_s: float | None = None) -> dict | None:
        """One evasion policy tick — a COLLECTIVE protocol point, like
        :meth:`tune_wire`: callers quiesce concurrent collectives around
        it. Rank 0 scores the windowed straggler scoreboard
        (:meth:`trace_stats`, last ``policy.window_ops`` assembled ops
        of THIS epoch) plus the live-spare count, broadcasts the
        decision and its full engine state, and every rank adopts both
        before acting — a promoted spare inherits the strike history
        instead of diverging. Returns the committed decision dict
        (``action``/``victim``) or None.

        After a tier-2 decision the VICTIM returns as a standby
        (``is_standby`` True — it drained and parked in a spare slot);
        survivors return with the warm spare already promoted into the
        victim's original identity, world size unchanged."""
        t = self.timeout_s if timeout_s is None else timeout_s
        if self._evasion is None:
            raise RuntimeError("evasion_tick: call enable_evasion() first")
        if self._standby is not None:
            raise RuntimeError("evasion_tick: a standby has no membership "
                               "to score (wait_promotion first)")
        eng = self._evasion
        proposal = None
        if self.rank == 0:
            try:
                stats = self.trace_stats(timeout_s=min(t, 5.0))
                board = _trace.scoreboard(stats["ops"],
                                          window=eng.policy.window_ops)
            except (OSError, TimeoutError):
                # a flaky store read scores nothing this tick — strikes
                # hold (the engine's empty-window rule), never invented
                board = {"ops": 0, "share": {}}
            try:
                spares = self.live_spares(timeout_s=min(t, 5.0))
            except (OSError, TimeoutError):
                spares = 0
            if os.environ.get("ROCNRDMA_EVADE_DEBUG"):
                print(f"EVADETICK {eng.tick + 1} ops={board.get('ops')} "
                      f"share={board.get('share')} spares={spares}",
                      flush=True)
            decision = eng.observe(board, list(self._ranks), spares)
            proposal = {"decision": decision, "state": eng.state()}
        if self.world_size > 1:
            proposal = self.broadcast_object(proposal, src=0)
        if self.rank != 0:
            eng.adopt(proposal["state"])
        decision = proposal["decision"]
        if decision is None:
            return None
        victim = int(decision["victim"])
        try:
            if decision["action"] == "reshape":
                self._evade_reshape(victim, t)
            else:
                self._evade_promote(victim, t)
        except BaseException as e:
            # an aborted action must leave its story on the timeline —
            # the postmortem for "the ring half-rotated" starts here
            _FLIGHT.record("evade-abort", epoch=self.epoch, victim=victim,
                           action=decision["action"],
                           error=type(e).__name__)
            raise
        return dict(decision)

    def _evade_reshape(self, victim: int, timeout_s: float) -> None:
        """Tier 1: rotate ``victim`` (an ORIGINAL rank) to the TAIL of
        the ring neighbour order, epoch-fenced through the exact heal
        steps on an UNCHANGED membership — fence, hier invalidate, p2p
        suspend (streams resume), permutation rewire (kept edges stay,
        moved edges re-dial through per-epoch store keys), barrier,
        watchdog re-arm. The victim additionally caps its OWN lane
        credits at the gate (``LaneRegistry.cap_credits`` — the lane
        shrink), and :meth:`preferred_root` re-roots rooted verbs away
        from it from here on. In-flight stragglers of the old epoch
        fence like a heal's."""
        deadline = time.monotonic() + timeout_s
        remaining = lambda: max(0.1, deadline - time.monotonic())
        old_ranks = list(self._ranks)
        if victim not in old_ranks:
            return
        epoch = self.epoch + 1
        members = [m for m in old_ranks if m != victim] + [victim]
        g = old_ranks[self.rank]
        new_rank = members.index(g)
        ns = f"pg/{self.group_name}/evade/e{epoch}"
        _FLIGHT.record("evade-reshape", epoch=epoch, victim=victim,
                       world=len(members))
        was_watching = self._watchdog_params
        self.stop_watchdog()
        try:
            self._net.set_epoch(epoch)
            self.epoch = epoch
            self._hier_invalidate()
            self._suspend_p2p(members, fresh=frozenset())
            self._rewire(members, new_rank, len(members), old_ranks, ns,
                         remaining, fresh=frozenset())
            self.rank = new_rank
            self._ranks = members
            self._barrier_no = 0
            self._postmortemed = False
            self._client.rank = new_rank
            if g == victim:
                reg = getattr(self._net, "lanes", None)
                if reg is not None:
                    cap = self._evasion.policy.credit_cap_bytes
                    _FLIGHT.record("evade-credit-cap",
                                   lanes=reg.cap_credits(cap), cap=cap)
            self._client.barrier(f"{ns}/wired", len(members), remaining())
        except BaseException as e:
            _FLIGHT.record("evade-abort", epoch=epoch, victim=victim,
                           action="reshape", error=type(e).__name__)
            if was_watching is not None:
                self.start_watchdog(*was_watching)
            raise
        _FLIGHT.mark_sync(ns=ns, rank=new_rank)
        _WIRE.evaded_reshape()
        if was_watching is not None:
            self.start_watchdog(*was_watching)

    def _evade_promote(self, victim: int, timeout_s: float) -> list | None:
        """Tier 2: retire ``victim`` (an ORIGINAL rank) BEFORE death
        confirmation. The victim drains itself to a standby slot
        (:meth:`drain`); every survivor runs the heal protocol with the
        victim pre-confirmed as the suspect — the grace window closes
        as soon as the survivors rendezvous, and the promotion
        path splices the lowest-sid live warm spare into the victim's
        ORIGINAL identity (world size, reshard shapes and rooted roots
        preserved). Cheaper than a post-mortem heal: no watchdog
        timeout is waited out, no collective has to abort first. If
        the warm spare died since rank 0 counted it, the heal's own
        assignment rule applies deterministically (the drained victim's
        fresh slot — or a shrink) — never a hang."""
        _FLIGHT.record("evade-promote", epoch=self.epoch + 1,
                       victim=victim)
        try:
            if self._ranks[self.rank] == victim:
                self.drain(timeout_s=timeout_s)
                return None
            victim_cur = self._ranks.index(victim)
            members = self.heal(grace_s=1.0, timeout_s=timeout_s,
                                _suspects={victim_cur})
        except BaseException as e:
            _FLIGHT.record("evade-abort", epoch=self.epoch, victim=victim,
                           action="promote", error=type(e).__name__)
            raise
        _WIRE.evaded_promotion()
        return members

    def drain(self, timeout_s: float | None = None) -> None:
        """Demote THIS member to a standby spare slot at an op boundary
        — the victim's half of tier-2 evasion, also callable directly
        for planned maintenance. Stops the watchdog, quiesces the ring
        and p2p wiring (survivors epoch-fence any stale frames), and
        registers in the spare registry under a fresh slot id (burned
        slots are never reused, so the scan order stays deterministic).
        Afterwards ``is_standby`` is True: collectives raise, and a
        later heal/grow may re-admit this process via
        :meth:`wait_promotion`."""
        t = self.timeout_s if timeout_s is None else timeout_s
        if self._destroyed:
            raise RuntimeError("cannot drain a destroyed group")
        if self._standby is not None:
            raise RuntimeError("drain: this rank is already a standby")
        g = self._ranks[self.rank] if self._ranks else -1
        _FLIGHT.record("evade-drain", epoch=self.epoch, rank=g)
        self.stop_watchdog()
        try:
            for comm in (self._send, self._recv):
                if comm is not None:
                    self._close_comm_quietly(comm)
            self._send = self._recv = None
            self._suspend_p2p(members=(), fresh=frozenset())
            self._hier_invalidate()
            self._standby = "spare"
            self._set_health("resuming", cause="drained")
            self._register_standby(t)
        except BaseException as e:
            _FLIGHT.record("evade-abort", epoch=self.epoch, rank=g,
                           action="drain", error=type(e).__name__)
            self._set_health("degraded", cause="drain-failed")
            raise
        _FLIGHT.record("evade-drained", rank=g, sid=self._sid)

    def evasion_state(self) -> dict:
        """The fleet-plane evasion summary this rank's telemetry
        snapshots carry (``{"armed": False}`` until
        :meth:`enable_evasion`): tick count, flagged original ranks,
        actions taken, and the structural decision-log digest — the
        EVASIONLOG the chaos replay check compares."""
        if self._evasion is None:
            return {"armed": False}
        e = self._evasion
        return {"armed": True, "tick": e.tick,
                "reshaped": sorted(e.reshaped),
                "promoted": sorted(e.promoted),
                "actions": len(e.log), "digest": e.digest()}

    def live_spares(self, timeout_s: float = 5.0) -> int:
        """Count of live, unburned warm spares in the standby registry
        right now — what gates a tier-2 promotion (evasion never
        shrinks the world). Public so a harness can hold at a start
        line until its spare's registration lands: the promote tick is
        then a pure function of the trace stream, not of process spawn
        order."""
        deadline = time.monotonic() + timeout_s
        remaining = lambda: max(0.1, deadline - time.monotonic())
        return len(self._scan_standby_registry(
            "spares", bootstrap.SPARE_RANK_BASE, "live_spares", remaining))

    def preferred_root(self) -> int:
        """The CURRENT rank rooted verbs should root at: the lowest
        original rank the evasion engine has NOT flagged as reshaped
        (a promoted slot runs fresh hardware and is eligible again).
        Rank 0's slot — today's default root — whenever nothing is
        flagged, so un-evaded groups see no change."""
        if self._evasion is None or not self._ranks:
            return 0
        avoid = self._evasion.reshaped
        for gid in sorted(self._ranks):
            if gid not in avoid:
                return self._ranks.index(gid)
        return 0

    def _commit_counts(self) -> tuple:
        """``(total, {str(chan): count})`` read atomically under the
        commit lock — a concurrent lane committing mid-read would
        otherwise resize the dict under an iterating heal leader (a
        crash, not a heal) or pair a pre-commit total with a
        post-commit split (a spurious divergence at the NEXT heal for
        whoever adopts the proposal)."""
        with self._op_lock:
            return self._op_seq, {str(k): v
                                  for k, v in self._lane_ops.items()}

    def _commit_stamp(self) -> str:
        """The committed-op identity a heal/grow rendezvous publishes in
        its alive key: the total AND the per-lane split, as one
        deterministic string (sorted JSON). String equality across
        survivors is then exactly "same total and same per-lane
        counts" — with concurrent lanes, two survivors can agree on the
        total while one committed the latency lane's op and the other
        the bulk lane's; those two would retry DIFFERENT collectives,
        the mixed-retry case the divergence rule exists to refuse."""
        import json
        total, lanes_split = self._commit_counts()
        return json.dumps({"ops": total, "lanes": lanes_split},
                          sort_keys=True)

    @property
    def committed_ops(self) -> int:
        """Collectives COMMITTED on this group (the exactly-once retry
        ledger). A promoted spare/joiner adopts the group's agreed count
        at admission, so a harness can resume its op loop at the right
        index."""
        return self._op_seq

    @property
    def is_standby(self) -> bool:
        """True while this rank is a spare/joiner sitting out of
        collectives (admission clears it)."""
        return self._standby is not None

    # -- fleet telemetry (the cross-rank counter plane, obs.fleet) ----------

    def _set_health(self, state: str, **why) -> None:
        """Move the fleet-plane health state (``ok|degraded|healing|
        resuming``); a no-op when unchanged, else the transition is
        appended to the bounded log the telemetry snapshots carry and
        recorded as a ``fleet-health`` flight event (with the epoch —
        the args are membership/epoch data only, so the event sequence
        is digestable for replay equality)."""
        with self._health_lock:
            prev = self._health
            if prev == state:
                return
            self._health = state
            self._health_log.append([prev, state, self.epoch])
            if len(self._health_log) > 16:
                del self._health_log[0]
        _FLIGHT.record("fleet-health", prev=prev, state=state,
                       epoch=self.epoch, **why)

    def health(self) -> str:
        """This rank's coarse fleet-plane health state."""
        with self._health_lock:
            return self._health

    def health_transitions(self) -> list:
        """The recent health transitions, oldest first, as
        ``[prev, state, epoch]`` triples (bounded — the last 16)."""
        with self._health_lock:
            return [list(t) for t in self._health_log]

    def confirmed_dead(self) -> list:
        """The watchdog's confirmed-dead peers as ORIGINAL rank ids
        (empty without a running watchdog) — the identity the telemetry
        tree's agent election keys on: a dead agent's node re-elects
        its next-lowest surviving original from these flags, without
        waiting for the heal."""
        with self._health_lock:
            dead = list(self._dead)
        return [self._ranks[p] for p in dead if p < len(self._ranks)]

    def publish_telemetry(self, timeout_s: float = 2.0) -> bool:
        """ONE explicit, bounded, best-effort publish of this rank's
        telemetry snapshot to the store (the watchdog tick does this
        automatically while running; harnesses and benches call this to
        flush a final snapshot before the leader aggregates). Returns
        False — never raises — when the store write failed or this rank
        has nothing to publish from (standby, no store)."""
        if self._client is None or self._standby is not None \
                or self._destroyed:
            return False
        ok = self._fleet_agent.publish(self._client, timeout_s=timeout_s)
        # the tree's aggregation pass rides the same explicit flush (a
        # no-op on every rank that is not its node's elected agent) —
        # best-effort: a failed tick degrades the node to direct
        # per-rank reads at the observer, never fails the publish
        if ok:
            self._node_agent.tick(self._client, timeout_s=timeout_s)
        return ok

    def fleet_stats(self, timeout_s: float = 5.0,
                    flat: bool = False) -> dict:
        """The LIVE fleet snapshot (``obs.fleet`` — wire counters
        summed field-wise, verb latency histograms added bucket-wise so
        the merged P50/P99 are bucket-exact, per-rank health and
        windowed throughput alongside). Any member may call it; the
        natural caller is the leader (or an operator via the
        ``python -m rocnrdma_tpu_torch.obs.fleet`` CLI, which reads the same
        keys without being a member).

        Read shape: the default path reads the telemetry
        tree's ROOT subtree digest first — O(log n) store traffic on a
        fleet whose node agents are publishing — and falls back to
        direct per-rank snapshot reads (plus this rank's fresh local
        telemetry) for exactly the members the digest does not cover:
        a fleet with no agents degrades to precisely the old flat
        read, and ``flat=True`` forces it (the escape hatch).

        Epoch fencing: only this generation's keys are read, and a
        payload stamped with another epoch is dropped and counted
        (``stale_dropped``) — stale-generation telemetry can no more
        reach a fleet view than a stale frame can reach a reduction.
        Reads are bounded by ``timeout_s`` overall — each fetch gets
        the REMAINING budget (reply wait included, via ``try_get``'s
        whole-call bound), so a rank whose snapshot cannot be fetched
        in time is reported ``missing``, not waited for; nothing here
        touches the collective hot path."""
        if self._standby is not None:
            raise RuntimeError(
                "fleet_stats: this rank is a standby (promotion pending); "
                "it has no membership to aggregate over")
        deadline = time.monotonic() + timeout_s
        root = None if flat else self._tree_root_digest(deadline)
        covers = (set(root.get("covers", ()))
                  if root is not None else set())
        members = list(self._ranks)
        me = members[self.rank] if members else -1
        uncovered = [m for m in members if m not in covers]
        snaps: list = ([self._fleet_agent.local_snapshot()]
                       if me in uncovered or not members else [])
        snaps += self._fetch_member_snapshots(
            max(0.0, deadline - time.monotonic()),
            origs=[m for m in uncovered if m != me])
        digest = _fleet.merge_digests(
            [root, _fleet.digest_of_snapshots(snaps, self.epoch,
                                              uncovered)],
            self.epoch)
        return _fleet._assemble(digest, self.epoch, members)

    def conformance_stats(self, timeout_s: float = 5.0,
                          flat: bool = False) -> dict:
        """The LIVE model-conformance view: every rank's
        predicted-vs-measured cells (``metrics.CONF``, joined by
        ``obs.conformance`` at op commit), merged EXACTLY across the
        fleet — the same O(log n) tree-root read with per-rank
        fallback as :meth:`fleet_stats` (``flat=True`` forces the
        per-rank read), the same epoch fencing, the same bounded
        ``timeout_s``. Returns the summarized table plus the drifting
        cell keys and the worst offender (``top`` names the plane and
        size bucket a refit should look at — the same cells
        :meth:`tune_wire`'s trigger fires on)."""
        if self._standby is not None:
            raise RuntimeError(
                "conformance_stats: this rank is a standby (promotion "
                "pending); it has no membership to aggregate over")
        deadline = time.monotonic() + timeout_s
        root = None if flat else self._tree_root_digest(deadline)
        covers = (set(root.get("covers", ()))
                  if root is not None else set())
        members = list(self._ranks)
        me = members[self.rank] if members else -1
        uncovered = [m for m in members if m not in covers]
        snaps: list = ([self._fleet_agent.local_snapshot()]
                       if me in uncovered or not members else [])
        snaps += self._fetch_member_snapshots(
            max(0.0, deadline - time.monotonic()),
            origs=[m for m in uncovered if m != me])
        digest = _fleet.merge_digests(
            [root, _fleet.digest_of_snapshots(snaps, self.epoch,
                                              uncovered)],
            self.epoch)
        conf = digest.get("conf_totals") or {"cells": {}, "aux": {}}
        summary = _conformance.summarize(conf)
        top = _conformance.top_drift(summary)
        return {
            "epoch": self.epoch,
            "members": members,
            "cells": conf.get("cells", {}),
            "aux": conf.get("aux", {}),
            "summary": summary,
            "drift": [k for k, v in summary.items() if v["drift"]],
            "top": ({"cell": top[0], "p50_ratio": top[1]["p50_ratio"],
                     "n": top[1]["n"]} if top else None),
        }

    def _tree_root_digest(self, deadline: float):
        """The telemetry tree's root subtree digest for THIS epoch, or
        None — the member-side wrapper of ``obs.fleet``'s ONE root
        fetch (same epoch fence, same flight event), classed as
        telemetry-read on the ledger. The caller falls back to
        per-rank fetches for whatever it does not cover."""
        if self._client is None:
            return None
        with bootstrap.store_traffic("telemetry-read"):
            return _fleet.fetch_root_digest(
                self._client, self.group_name, self.epoch,
                max(0.0, deadline - time.monotonic()))

    def _fetch_member_snapshots(self, timeout_s: float,
                                origs=None) -> list:
        """Published telemetry payloads for ``origs`` (default: every
        OTHER member), parsed — the member-side wrapper of
        ``obs.fleet``'s ONE per-rank fetch, shared by
        ``fleet_stats``/``trace_stats`` (their flat path, and the
        tree path's fallback for uncovered members). One overall
        deadline; a rank whose key cannot be read (or parsed) in time
        is simply absent, never waited for."""
        if self._client is None:
            return []
        deadline = time.monotonic() + timeout_s
        me = self._ranks[self.rank] if self._ranks else -1
        targets = (origs if origs is not None
                   else [g for g in self._ranks if g != me])
        with bootstrap.store_traffic("telemetry-read"):
            snaps = _fleet._fetch_snaps(
                self._client, self.group_name, self.epoch, targets,
                lambda: deadline - time.monotonic())
        return [s for s in snaps if s is not None]

    def trace_stats(self, timeout_s: float = 5.0,
                    flat: bool = False) -> dict:
        """The assembled causal traces of recent SAMPLED collectives:
        this rank's op records (``obs.trace.TRACE``) merged with every
        other member's latest published records (they ride the fleet
        telemetry snapshots AND the tree digests — same store channel,
        same bounded best-effort rules, same O(log n) root-digest read
        with per-rank fallback as ``fleet_stats``; ``flat=True`` forces
        the per-rank read) into per-op cross-rank span trees with
        their critical paths, plus the windowed straggler scoreboard.
        Only ops for which EVERY current member's record is present
        are assembled — a partial tree's critical path would blame
        whoever happened to publish. Reads are bounded by
        ``timeout_s`` overall; nothing here touches the collective hot
        path."""
        if self._standby is not None:
            raise RuntimeError(
                "trace_stats: this rank is a standby (promotion "
                "pending); it has no membership to aggregate over")
        # fenced like every fleet read: only THIS generation's records
        # assemble (local and remote alike) — a pre-heal op's tree
        # would pair ranks that no longer neighbour each other
        records = [r for r in _trace.TRACE.snapshot()
                   if r.get("epoch") == self.epoch]
        deadline = time.monotonic() + timeout_s
        root = None if flat else self._tree_root_digest(deadline)
        if root is not None:
            records.extend(r for r in root.get("trace", [])
                           if r.get("epoch") == self.epoch)
        covers = (set(root.get("covers", ()))
                  if root is not None else set())
        me = self._ranks[self.rank] if self._ranks else -1
        uncovered = [m for m in self._ranks
                     if m not in covers and m != me]
        for s in self._fetch_member_snapshots(
                max(0.0, deadline - time.monotonic()), origs=uncovered):
            if s.get("epoch") == self.epoch:
                records.extend(r for r in s.get("trace", [])
                               if r.get("epoch") == self.epoch)
        assembled = _trace.assemble(records, world=self.world_size)
        return {"epoch": self.epoch, "sample": _trace.sample_every(),
                "ops": assembled,
                "scoreboard": _trace.scoreboard(assembled)}

    # -- watchdog (the ProcessGroupNCCL watchdog / RCCL heartbeat analogue) --

    # -- survivable store (DESIGN.md §5n) ----------------------------------

    def host_store_replica(self, timeout_s: float = 10.0) -> str:
        """Called on the DETERMINISTIC SUCCESSOR rank (the agreed-a-priori
        next store host — by convention the lowest-ranked member not
        hosting the primary): start an EMPTY sidecar store and publish
        its handle under ``pg/<g>/store/replica``. The primary's host
        attaches it (``attach_store_replica``); from then on every
        replicated-namespace ack implies the replica holds the write (or
        the replica was declared dead and detached — flight-recorded),
        and survivors re-point to it when the primary dies."""
        if self._store_replica_server is None:
            self._store_replica_server = bootstrap.BootstrapServer(
                n_ranks=0)
        self._client.set(f"pg/{self.group_name}/store/replica",
                         self._store_replica_server.handle,
                         timeout_s=timeout_s)
        return self._store_replica_server.handle

    def attach_store_replica(self, timeout_s: float = 10.0) -> str | None:
        """Called on the rank hosting the primary (``self._server``): read
        the published replica handle and attach it — the server installs
        the live-replication pointer BEFORE snapshotting, so a mutation
        racing the attach forwards or lands in the snapshot (possibly
        both; the replica's merge-sync is non-destructive) — no ack can
        race past the attach unreplicated. Returns the attached handle,
        or None when this rank hosts no server or no replica is
        published."""
        if self._server is None:
            return None
        h = self._client.try_get(f"pg/{self.group_name}/store/replica",
                                 timeout_s=timeout_s)
        if h:
            self._server.attach_replica(h, timeout_s=timeout_s)
        return h or None

    def arm_store_failover(self, handles=None,
                           timeout_s: float = 5.0) -> list:
        """Arm the survivable-store rotation on THIS rank. With
        ``handles=None`` the published replica handle
        (``pg/<g>/store/replica``) is read and armed. The main client
        rotates on its next reconnect (the idempotent replay path);
        watchdog clients created after this call dial with the list from
        birth — re-arm the watchdog to take effect immediately. Returns
        the armed list (empty when nothing is published: arming is then
        a no-op, not an error — bring-up order must not matter)."""
        if handles is None:
            raw = self._client.try_get(
                f"pg/{self.group_name}/store/replica", timeout_s=timeout_s)
            handles = [raw] if raw else []
        handles = [h for h in handles if h]
        self._store_failover = list(handles)
        self._client.arm_failover(handles)
        return list(handles)

    def elect_store_primary(self, successor: int) -> str:
        """Convergent post-failover election: every survivor setnx-es the
        SAME deterministic value (the successor's rank — agreed a priori
        by the deterministic-successor rule, never a handle: ports are
        run-local and would poison replay digests) under the
        epoch-qualified election key. The winner is irrelevant — the
        durable record is the point, and the key lives in a replicated
        namespace so it survives the NEXT failover too."""
        key = f"pg/{self.group_name}/store/primary/e{self.epoch}"
        return self._client.set_if_absent(key, str(int(successor)))

    def host_node_proxy(self, node: int, flush_s: float = 0.25,
                        timeout_s: float = 10.0) -> str:
        """Called on a node's elected agent rank (election: the
        node's lowest live rank): start a ``NodeProxyStore`` terminating
        this node's heartbeats and telemetry snapshots locally —
        condensed epoch-qualified summaries upstream — and publish its
        handle under the epoch-qualified proxy key for node mates to
        adopt. The proxy inherits this group's armed failover list: a
        dead PRIMARY re-points the proxy's upstream while the node's
        ranks never move."""
        if self._node_proxy is None:
            self._node_proxy = bootstrap.NodeProxyStore(
                self._store_handle, node, flush_s=flush_s,
                timeout_s=timeout_s,
                failover=tuple(self._store_failover))
        self._client.set(
            f"pg/{self.group_name}/store/proxy/e{self.epoch}/{int(node)}",
            self._node_proxy.handle, timeout_s=timeout_s)
        self._store_proxy_handle = self._node_proxy.handle
        return self._node_proxy.handle

    def adopt_node_proxy(self, node: int,
                         timeout_s: float = 5.0) -> str | None:
        """Point this rank's HIGH-RATE control traffic (the watchdog's
        heartbeat + telemetry client) at its node's published proxy.
        Rendezvous and heal traffic stay on the primary: the proxy would
        forward them verbatim anyway, and the low-rate plane keeps one
        less hop. Takes effect on the next ``start_watchdog``. Returns
        the adopted handle, or None when the node published none."""
        h = self._client.try_get(
            f"pg/{self.group_name}/store/proxy/e{self.epoch}/{int(node)}",
            timeout_s=timeout_s)
        if h:
            self._store_proxy_handle = h
        return h or None

    def start_watchdog(self, interval_s: float = 1.0,
                       timeout_s: float = 5.0) -> None:
        """Asynchronous failure detection: a daemon thread publishes this
        rank's heartbeat and watches its nearest alive RIGHT NEIGHBOUR's
        (ring watching — O(1) store RPCs per rank per tick, the same
        aggregate-load discipline as ``monitored_barrier``, vs O(n^2) for
        full-mesh polling). A stalled — or never-published, same grace —
        neighbour is flagged under a shared death key every rank polls, the
        watcher re-targets the next alive rank (so adjacent deaths are
        flagged in sequence), and the NEXT collective/p2p call raises
        naming the dead instead of hanging to a wire timeout (the watchdog
        role of the reference stack's NCCL/RCCL process groups). Every
        rank should start its watchdog at about the same time: a rank that
        delays past ``timeout_s`` reads as dead to its left neighbour.

        The thread uses its OWN store connection (the RPC protocol is
        strict request->reply lockstep per connection, so sharing the main
        client across threads would interleave frames). If the thread
        itself dies (store unreachable), that is recorded and surfaced by
        the next verb — a broken detector must not masquerade as a quiet
        one."""
        if self.world_size == 1 or self._standby is not None:
            return  # standby ranks heartbeat via their admit-key polls
        if self._watchdog is not None and self._watchdog.is_alive():
            return
        self._watchdog_stop = threading.Event()
        with self._health_lock:
            self._watchdog_failed = None
            self._dead = []
        # remembered so heal() can re-arm the detector on the healed
        # membership with the same cadence; the hb namespace is epoch-
        # qualified — re-ranked ids must not read a dead generation's
        # beats (or death flags) as their own
        self._watchdog_params = (interval_s, timeout_s)
        ns = f"pg/{self.group_name}/hb/e{self.epoch}"

        def run():
            client = None
            try:
                # same liveness scope as the group's main client, so the
                # watchdog's RPCs stamp THIS group's table. The client's
                # OWN timeout bounds every round-trip (recv included) to
                # about one detection window: a merely-SLOW store must
                # cost this thread a bounded tick — heartbeat and
                # telemetry publish alike — never a default 30 s stall
                # that lands our beat after the neighbour's death grace
                # (the loop absorbs the TimeoutError and keeps ticking)
                # high-rate control traffic prefers the node's proxy when
                # one was adopted (adopt_node_proxy); rotation order is
                # proxy -> primary -> replica(s), so a dead PROXY
                # re-points only this node's ranks at the primary while
                # a dead PRIMARY re-points everyone at the replica (§5n)
                handle = self._store_proxy_handle or self._store_handle
                fail = list(self._store_failover)
                if handle != self._store_handle:
                    fail = [self._store_handle, *fail]
                client = bootstrap.BootstrapClient(
                    handle, self.rank,
                    timeout_s=interval_s + timeout_s,
                    scope=f"pg/{self.group_name}/ring",
                    traffic_class="heartbeat",
                    failover=tuple(fail),
                    tag=f"wd/{self.group_name}")
                beat = 0
                seen: dict[int, tuple] = {}  # target -> (value, stamp)
                dead: set[int] = set()
                last_event = None

                def get0(key):
                    try:
                        return client.get(key, timeout_s=0.0)
                    except TimeoutError:
                        return None

                publish_budget = min(1.0, max(0.1, float(interval_s)))
                # telemetry cadence: at most one publish per second (or
                # per tick when the interval is slower) — fast-ticking
                # chaos watchdogs (0.3 s) must not double the store
                # traffic of every tick for a feed nobody reads at 3 Hz
                publish_every = max(float(interval_s), 1.0)
                last_publish = 0.0
                while not self._watchdog_stop.is_set():
                    beat += 1
                    try:
                        client.set(f"{ns}/{self.rank}", str(beat))
                        # death-event key: one get per tick; a sweep of the
                        # per-victim keys only when its value changes
                        ev = get0(f"{ns}/dead_v")
                        if ev != last_event:
                            last_event = ev
                            for p in range(self.world_size):
                                if p != self.rank and p not in dead \
                                        and get0(f"{ns}/dead/{p}") is not None:
                                    dead.add(p)
                            with self._health_lock:
                                self._dead = sorted(dead)
                        # watch my nearest alive right neighbour
                        target = next(
                            (c for off in range(1, self.world_size)
                             for c in [(self.rank + off) % self.world_size]
                             if c not in dead), None)
                        if target is not None:
                            now = time.monotonic()
                            hv = get0(f"{ns}/{target}")
                            s = seen.get(target)
                            if s is None or s[0] != hv:
                                # first sight, or it beat: (re)stamp. A key
                                # that NEVER publishes keeps hv=None and
                                # times out below like any stalled beat.
                                seen[target] = (hv, now)
                            elif now - s[1] > timeout_s:
                                dead.add(target)
                                with self._health_lock:
                                    self._dead = sorted(dead)
                                client.set(f"{ns}/dead/{target}", "1")
                                client.set(f"{ns}/dead_v",
                                           f"{self.rank}:{beat}")
                        # the fleet telemetry snapshot piggybacks the
                        # heartbeat — AFTER the beat and the death scan
                        # (telemetry is best-effort; the beat is the
                        # failure detector's signal and must land
                        # first), bounded, rate-limited, absorbed-on-
                        # failure inside publish()
                        t_pub = time.monotonic()
                        if t_pub - last_publish >= publish_every:
                            last_publish = t_pub
                            self._fleet_agent.publish(
                                client, timeout_s=publish_budget)
                            # the telemetry tree's aggregation pass
                            # : a no-op on every rank that
                            # is not its node's elected agent; bounded
                            # and absorbed like the publish itself
                            self._node_agent.tick(
                                client, timeout_s=publish_budget)
                    except TimeoutError:
                        pass  # one slow store RPC: keep ticking, not die
                    self._watchdog_stop.wait(interval_s)
            except Exception as e:  # noqa: BLE001 — recorded, not swallowed
                with self._health_lock:
                    self._watchdog_failed = repr(e)
            finally:
                if client is not None:
                    client.close()

        self._watchdog = threading.Thread(target=run, daemon=True)
        self._watchdog.start()

    def wire_stats(self) -> dict:
        """THIS RANK's zero-copy wire counters (``metrics.WIRE`` snapshot:
        payload_bytes_copied / frames_streamed / frames_copied /
        frames_overlapped + the derived overlap_ratio), the wire's
        last-negotiated parameters (``frame_bytes`` / ``pipeline_depth``
        — what the streaming engine chose, so regressions are
        attributable to the frame choice), and the per-verb latency
        histograms (``verb_latency``: ``metrics.VERBS`` snapshot,
        log-bucketed). Host-plane ranks are OS processes, so cross-rank
        aggregation happens at the harness, like fault counters; the
        steady-state contract of the streaming collectives is a zero
        ``payload_bytes_copied`` delta across a measurement window (what
        ``bench_host --smoke`` gates)."""
        s = _WIRE.snapshot()
        s["overlap_ratio"] = round(_WIRE.overlap_ratio(), 4)
        s.update(_WIRE.negotiation())
        s["verb_latency"] = _VERB_LAT.snapshot()
        # the store-ops ledger: this rank's bootstrap-store
        # round-trips per traffic class — the control plane's own cost
        # next to the wire counters it exists to observe
        s["store_ops"] = _STORE_OPS.snapshot()
        # the recovery gauges: which group generation this rank runs on
        # (frames_fenced in the snapshot above counts the stale frames
        # the epoch fence dropped), and how many heals got it here
        s["epoch"] = self.epoch
        s["heals"] = self._heals
        s["health"] = self.health()  # the fleet plane's coarse state
        # the self-tuning wire's committed state: version,
        # per-plane coefficients, pins — next to the frame/depth gauges
        # above, so a pick change and the model that made it land on
        # the same record
        model = getattr(self._net, "wire_model", None)
        if model is not None:
            s["tuner"] = model.block()
        # the quantized wire's error-feedback state, as a stable digest
        # (keys, epochs, exact residual bytes): what the chaos harness
        # pins replay-equal — including the deterministic post-heal
        # resets — without shipping the arrays themselves
        s["codec_residual_digest"] = self._codec_residuals.digest()
        return s

    def dead_ranks(self) -> list:
        """Peers the watchdog currently considers dead (empty without a
        running watchdog)."""
        with self._health_lock:
            return list(self._dead)

    def async_error(self) -> str | None:
        """The ``ncclCommGetAsyncError`` habit: poll the group's background
        health WITHOUT raising — None when healthy, else a description of
        what the watchdog knows (dead peers, or its own demise). The next
        verb would raise the same condition; this is for schedulers that
        want to check between steps."""
        with self._health_lock:
            failed, dead = self._watchdog_failed, list(self._dead)
        if failed:
            return (f"watchdog thread died ({failed}); "
                    f"failure detection is OFF")
        if dead:
            return f"rank(s) {dead} stopped heartbeating"
        return None

    def _resume_progress(self) -> None:
        """The net-level progress hook (``_RingWire`` runs it in every
        blocking loop): give the p2p stream-resume service a turn while
        this rank blocks inside a collective. Without it, a sender whose
        interrupted stream awaits its receiver's RESUME cursor can only
        serve at verb ENTRY — and a receiver still draining its resumed
        tail (bounded) while the sender is already blocked in the next
        collective is a cycle nothing breaks. Cheap when idle: one bool
        read. The service runs OUTSIDE any active op span: its waits
        belong to the resumed stream, not to the sampled collective
        whose blocking loop gave it this turn."""
        if self._p2p_resume_pending:
            with _trace.suspended():
                self._p2p_resume_pending = self._p2p_resume_service() > 0

    def _check_alive(self) -> None:
        if self._p2p_resume_pending:
            # a sender that moved on to collectives must still answer its
            # receivers' RESUME cursors, or a resumed recv on the other
            # end starves to its (named) deadline — every verb entry
            # gives the service a turn until nothing is left unserved
            self._p2p_resume_pending = self._p2p_resume_service() > 0
        if self._standby is not None:
            # spares/joiners SIT OUT: no collective or p2p verb may run
            # until admission re-ranks this process into the group
            raise RuntimeError(
                f"this rank is a standby {self._standby} for group "
                f"{self.group_name!r}: it sits out of collectives until "
                f"promoted/admitted (wait_promotion)")
        with self._health_lock:
            failed, dead = self._watchdog_failed, list(self._dead)
        if failed:
            self._set_health("degraded", cause="watchdog-died")
            raise RuntimeError(
                f"watchdog thread died ({failed}); failure "
                f"detection is OFF for group {self.group_name!r} — "
                f"start_watchdog() again or destroy")
        if dead:
            self._set_health("degraded", cause="peer-dead")
            # the watchdog fired: dump this survivor's flight tail (what
            # the wire was doing when the peer went silent) before the
            # verb refuses — the other postmortem trigger point besides
            # monitored_barrier's triage and the ring wire's own stalls.
            # Once per group: every subsequent verb re-raises, and a
            # caller retrying into a dead group must not flood stderr.
            if not self._postmortemed:
                self._postmortemed = True
                _postmortem(
                    f"watchdog: rank(s) {dead} stopped heartbeating; rank "
                    f"{self.rank} of group {self.group_name!r} "
                    f"refusing verbs")
            raise RuntimeError(
                f"watchdog: rank(s) {dead} stopped heartbeating "
                f"(group {self.group_name!r}); shrink() or destroy "
                f"(a collective would hang on the dead)")

    def stop_watchdog(self) -> None:
        self._watchdog_params = None
        if self._watchdog is not None:
            self._watchdog_stop.set()
            self._watchdog.join(timeout=5.0)
            self._watchdog = None
            # the join is bounded: a wedged thread may still be alive, so
            # the reset must hold the same lock its writes do
            with self._health_lock:
                self._watchdog_failed = None
                self._dead = []

    # -- lifecycle ---------------------------------------------------------

    def destroy(self, graceful: bool = True) -> None:
        """Orderly teardown: every rank arrives at a final store barrier and
        says goodbye to the store BEFORE rank 0 closes it (otherwise a peer
        whose last barrier poll is still in flight gets its RPC cut — the
        classic master-exits-first shutdown race). ``graceful=False`` skips
        the barrier — for tearing down a group whose peers are known dead
        (after ``shrink``), where waiting would only burn the timeout."""
        if self._destroyed:
            return
        self._destroyed = True
        self.stop_watchdog()
        # serialize this rank's flight buffer on exit when
        # ROCNRDMA_FLIGHT_DUMP asks for it (best-effort, group-keyed so
        # re-ranked split/shrink subgroups can't clobber each other; the
        # on-demand half is obs.chrome.dump_rank itself)
        from rocnrdma_tpu_torch.obs import chrome
        chrome.dump_if_env(self.rank, group=self.group_name)
        if self._client is not None:
            if graceful and self._standby is None:
                # a standby rank never joins the members' destroy
                # barrier: it is not one of the world_size arrivals
                try:
                    self._client.barrier(f"pg/{self.group_name}/destroy",
                                         self.world_size, timeout_s=10.0)
                except (OSError, TimeoutError):
                    pass  # peers may have crashed; teardown must complete
            self._client.close()
        if self._standby_listener is not None:
            # a never-promoted standby still holds its pre-published
            # listener (on shm that is a queue pair owning a segment)
            bootstrap._close_quietly(self._standby_listener)
            self._standby_listener = None
        if self._p2p_listen and self.plane == "shm":
            # shm listeners ARE queue pairs: accepted ones became net comms
            # (closed by net.close()); never-accepted ones are invisible to
            # the net and must be closed here. TCP listeners are net-tracked
            # either way.
            for peer, listener in self._p2p_listen.items():
                if peer not in self._p2p_accepted:
                    try:
                        listener.close()
                    except OSError:
                        pass
        self._hier_invalidate(wait_s=2.0)
        self._net.close()
        if self._node_proxy is not None:
            # BEFORE the primary: the proxy's upstream client counts
            # against the primary's wait_idle (a rank hosting both would
            # otherwise wait on itself)
            self._node_proxy.close()
            self._node_proxy = None
        if self._server is not None:
            self._server.wait_idle()  # all clients gone -> safe to close
            self._server.close()      # detaches its replica link (bye)
        if self._store_replica_server is not None:
            # AFTER the primary: close() above said bye on the
            # replication link, so the sidecar winds down clean
            self._store_replica_server.close()
            self._store_replica_server = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.destroy()


def init_process_group(rank: int | None = None,
                       world_size: int | None = None,
                       master_addr: str | None = None,
                       master_port: int | None = None,
                       store_handle: str | None = None,
                       timeout_s: float = 30.0,
                       group_name: str = "default",
                       plane: str = "tcp",
                       fault_schedule=None,
                       self_heal: bool = False,
                       spare: bool = False,
                       node_of=None,
                       intra_plane: str = "shm") -> ProcessGroup:
    """Create this process's :class:`ProcessGroup`.

    Rendezvous: either pass ``store_handle`` (an already-running
    :class:`bootstrap.BootstrapServer`'s ``"host:port"``) — in which case
    distinct groups on that store need distinct ``group_name``s — or give
    ``master_addr``/``master_port`` and rank 0 will serve the store itself
    (the torch master semantics). Unset arguments fall back to the standard
    ``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` / ``MASTER_PORT`` env vars.

    ``plane``: the wire under the ring — ``"tcp"`` (cross-host; default) or
    ``"shm"`` (shared-memory queue pairs: the intra-node fast path, all
    ranks on one machine; the rendezvous store stays TCP either way).

    ``fault_schedule``: a ``transport.faults.FaultSchedule`` to wrap the
    net plane in a fault-injecting ``FaultNet`` — the chaos-testing hook
    (construct it with this rank, so streams stay per-rank).

    ``self_heal``: opt into elastic recovery — when a collective aborts
    on a CONFIRMED-dead peer (watchdog flag, or store silence past the
    watchdog window), the group heals in place (:meth:`ProcessGroup.heal`:
    epoch bump + ring repair around the dead) and transparently retries
    the collective on the survivors. Off by default: a shrunk-group
    result is a different answer than the full-group one, and the caller
    must have opted into that semantic.

    ``spare``: start this process as a WARM SPARE instead of a member —
    it bootstraps (store registration under a spare-prefixed liveness
    id, pre-published listener), sits out of collectives, and blocks in
    :meth:`ProcessGroup.wait_promotion` until a heal promotes it into a
    confirmed-dead rank's original identity (epoch bump + re-rank, world
    size preserved). Spares dial nothing cold on the promotion critical
    path; ``rank`` is ignored (identity is assigned at promotion). The
    group's store must already be running (pass ``store_handle``, or the
    master env/args of the group whose rank 0 serves it).

    ``node_of``: the hierarchical topology map — entry r is
    the NODE id of rank r (original ranks; every member must pass the
    same list, store-published and agreed first-writer-wins). A
    node-mapped group's reducing/gathering collectives may run the
    node-aware two-level schedule: node-local legs over ``intra_plane``
    (default ``"shm"`` — the fast fabric), cross-node legs over
    ``plane`` (the slow one), picked per call by the committed wire
    models (or forced via the verbs' ``algorithm=``). Spares need no
    map (they read the published one at promotion); grow joiners run
    as singleton nodes.
    """
    if spare:
        if store_handle is None:
            master_addr = master_addr or os.environ.get("MASTER_ADDR",
                                                        "127.0.0.1")
            master_port = (master_port if master_port is not None
                           else int(os.environ.get("MASTER_PORT", "29500")))
            store_handle = f"{master_addr}:{master_port}"
        try:
            return ProcessGroup(0, 0, store_handle, None, timeout_s,
                                group_name, plane,
                                fault_schedule=fault_schedule,
                                self_heal=self_heal, standby="spare")
        except BaseException as e:
            _FLIGHT.record("group-abort", group=group_name, rank=-1,
                           error=type(e).__name__)
            raise
    rank = int(os.environ["RANK"]) if rank is None else rank
    world_size = (int(os.environ["WORLD_SIZE"]) if world_size is None
                  else world_size)
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} out of range for world_size {world_size}")

    server = None
    if world_size > 1 and store_handle is None:
        master_addr = master_addr or os.environ.get("MASTER_ADDR", "127.0.0.1")
        master_port = (master_port if master_port is not None
                       else int(os.environ.get("MASTER_PORT", "29500")))
        if rank == 0:
            server = bootstrap.BootstrapServer(
                n_ranks=world_size, port=master_port, host=master_addr)
            store_handle = server.handle
        else:
            store_handle = f"{master_addr}:{master_port}"
    try:
        return ProcessGroup(rank, world_size, store_handle, server,
                            timeout_s, group_name, plane,
                            fault_schedule=fault_schedule,
                            self_heal=self_heal, node_of=node_of,
                            intra_plane=intra_plane)
    except BaseException as e:
        _FLIGHT.record("group-abort", group=group_name, rank=rank,
                       error=type(e).__name__)
        if server is not None:  # failed rendezvous must free the master port
            server.close()
        raise


def join_process_group(store_handle: str | None = None,
                       master_addr: str | None = None,
                       master_port: int | None = None,
                       group_name: str = "default",
                       plane: str = "tcp",
                       timeout_s: float = 300.0,
                       fault_schedule=None,
                       self_heal: bool = False) -> ProcessGroup:
    """Join a RUNNING group as a fresh rank — the joiner side of elastic
    grow. Registers in the store's join registry (joiner-prefixed
    liveness id, pre-published listener handle, injected admission
    refusals retried under the shared backoff) and blocks until the
    members' next :meth:`ProcessGroup.grow` admits this process under a
    fresh original rank id; returns the fully-wired member group.

    ``timeout_s`` bounds the WHOLE admission wait — size it to how long
    the members may reasonably take to decide to grow. The rendezvous
    arguments mirror :func:`init_process_group` (``store_handle``, or
    the master addr/port whose rank 0 serves the store)."""
    if store_handle is None:
        master_addr = master_addr or os.environ.get("MASTER_ADDR",
                                                    "127.0.0.1")
        master_port = (master_port if master_port is not None
                       else int(os.environ.get("MASTER_PORT", "29500")))
        store_handle = f"{master_addr}:{master_port}"
    pg = ProcessGroup(0, 0, store_handle, None, timeout_s, group_name,
                      plane, fault_schedule=fault_schedule,
                      self_heal=self_heal, standby="joiner")
    try:
        pg.wait_promotion(timeout_s)
    except BaseException as e:
        _FLIGHT.record("group-abort", group=group_name, rank=-1,
                       error=type(e).__name__)
        pg.destroy()
        raise
    return pg


# ---------------------------------------------------------------------------
# The tensor front door. The reference's verbs take ``np.asarray(x)``,
# which also fetches a device ``jax.Array`` to the host; here a
# ``torch.Tensor`` on the CPU or the card goes in and the result comes
# back as a tensor on the input's device, in the input's dtype. numpy in,
# numpy out stays the reference's path, bit for bit: a call that holds no
# tensor runs the verb untouched. torch is never imported here: a process
# that made a tensor has it in ``sys.modules`` already.
# ---------------------------------------------------------------------------


class HostPlaneDtypeError(TypeError):
    """A tensor whose dtype the host plane cannot carry (numpy has none,
    and the host plane has no fold of its own for it: the fnuz fp8 dtypes,
    ``torch.float8_e4m3fnuz`` and ``torch.float8_e5m2fnuz``) reached the
    front door. It is refused, with the call's ``front-door-abort`` flight
    event, never cast: cast it yourself (``x.float()``).
    ``torch.bfloat16``, ``torch.float8_e4m3fn`` and ``torch.float8_e5m2``
    ride as their bits (``plugin.BF16``, ``plugin.F8E4M3``,
    ``plugin.F8E5M2``), folded as ``ml_dtypes`` folds them; never through
    torch's fp8 cast, which saturates at +-448 where ``ml_dtypes`` gives
    NaN past +-464."""


# idle pinned staging buffers kept per size
_STAGING_KEEP = 4


class _Staging:
    """Pinned host buffers that stage CUDA tensors, cached by size. A
    buffer's event is recorded after the last device copy that reads it
    (a result's host-to-device copy); acquiring the buffer again waits on
    that event, so a buffer is never rewritten before its last copy is
    done. ``stats`` counts each direction's bytes and host seconds."""

    def __init__(self):
        self._lock = _lockwitness.make_lock("distributed.py::_Staging._lock")
        self._idle: dict = {}
        self.stats = {"d2h_bytes": 0, "d2h_s": 0.0,
                      "h2d_bytes": 0, "h2d_s": 0.0}

    def acquire(self, torch, nbytes: int) -> list:
        """-> a lease ``[pinned uint8 buffer, event or None]``."""
        with self._lock:
            idle = self._idle.get(nbytes)
            buf, event = idle.pop() if idle else (None, None)
        if buf is None:
            buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        if event is not None:
            event.synchronize()
        return [buf, None]

    def release(self, lease: list) -> None:
        buf, event = lease
        with self._lock:
            idle = self._idle.setdefault(buf.numel(), [])
            if len(idle) < _STAGING_KEEP:
                idle.append((buf, event))

    def count(self, direction: str, nbytes: int, seconds: float) -> None:
        with self._lock:
            self.stats[f"{direction}_bytes"] += nbytes
            self.stats[f"{direction}_s"] += seconds


_STAGING = _Staging()


def staging_stats() -> dict:
    """Bytes and host seconds the front door spent staging CUDA tensors:
    device-to-host (the copy and its completion) and host-to-device (the
    copy into pinned memory and the enqueue)."""
    return dict(_STAGING.stats)


def _bit_dtypes(torch) -> dict:
    """torch dtype -> (the host plane's bit dtype for it, the torch and
    numpy integer dtypes of its size): the dtypes numpy has not."""
    return {torch.bfloat16: (plugin.BF16, torch.int16, np.int16),
            torch.float8_e4m3fn: (plugin.F8E4M3, torch.uint8, np.uint8),
            torch.float8_e5m2: (plugin.F8E5M2, torch.uint8, np.uint8)}


def _numpy_dtype(torch, dtype, verb=None, device=None):
    bits = _bit_dtypes(torch).get(dtype)
    if bits is not None:
        return bits[0]
    try:
        return torch.empty(0, dtype=dtype).numpy().dtype
    except TypeError as e:
        # the refusal is this call's abort: one flight event, here (the
        # verb's own abort path does not record it again)
        _FLIGHT.record("front-door-abort", verb=verb, dtype=str(dtype),
                       device=str(device), error="HostPlaneDtypeError")
        raise HostPlaneDtypeError(
            f"{dtype} has no numpy dtype, and the host plane folds numpy "
            f"arrays: a {dtype} tensor is refused, not cast (cast it "
            f"first, e.g. x.float())") from e


def _host_array(torch, t, dtype):
    """The numpy array over host tensor ``t``'s memory, in the host plane's
    ``dtype`` for it (a bf16 or fp8 tensor's bits as its bit dtype)."""
    bits = _bit_dtypes(torch).get(t.dtype)
    if bits is not None:
        return t.view(bits[1]).numpy().view(dtype)
    return t.numpy()


def _tensor_of(torch, arr):
    """The tensor over numpy ``arr``'s memory (a bit dtype as its torch
    dtype: ``plugin.BF16`` as ``torch.bfloat16``, and so on)."""
    for tdt, (host, tint, nint) in _bit_dtypes(torch).items():
        if arr.dtype == host:
            return torch.from_numpy(arr.view(nint)).view(tdt)
    return torch.from_numpy(arr)


class _Door:
    """One verb call's staging: tensors in -> numpy for the verb, numpy
    results -> tensors on the inputs' one device. Leases on pinned
    buffers live until the verb (or every handle it returned) is done."""

    def __init__(self, torch, verb=None):
        self.torch = torch
        self.verb = verb
        self.device = None
        self.dtype = None  # the last tensor's, for the abort event
        self.leases: list = []
        self.pending = 0

    def _claim(self, t) -> None:
        self.dtype = t.dtype
        if self.device is None:
            self.device = t.device
        elif t.device != self.device:
            raise ValueError(f"tensors on {self.device} and {t.device} in "
                             f"one call; the result would have to change "
                             f"device")

    def record(self, e: BaseException) -> None:
        """The call's abort on the flight timeline (``front-door-abort``:
        verb, dtype, device, error), except a dtype refusal, which
        ``_numpy_dtype`` recorded."""
        if not isinstance(e, HostPlaneDtypeError):
            _FLIGHT.record("front-door-abort", verb=self.verb,
                           dtype=str(self.dtype), device=str(self.device),
                           error=type(e).__name__)

    def template(self, t):
        """A receive's shape/dtype template: no copy of its contents."""
        self._claim(t)
        return np.empty(tuple(t.shape),
                        _numpy_dtype(self.torch, t.dtype, self.verb, t.device))

    def stage(self, obj):
        torch = self.torch
        if isinstance(obj, torch.Tensor):
            self._claim(obj)
            dtype = _numpy_dtype(torch, obj.dtype, self.verb, obj.device)
            t = obj.detach().contiguous()
            if t.device.type != "cuda":
                return _host_array(torch, t, dtype)
            nbytes = t.numel() * t.element_size()
            if nbytes == 0:
                return np.empty(tuple(t.shape), dtype)
            t0 = time.perf_counter()
            lease = _STAGING.acquire(torch, nbytes)
            self.leases.append(lease)
            host = lease[0][:nbytes].view(t.dtype).view(t.shape)
            host.copy_(t)  # blocking: the host plane reads the buffer next
            _STAGING.count("d2h", nbytes, time.perf_counter() - t0)
            return _host_array(torch, host, dtype)
        if isinstance(obj, list):
            return [self.stage(o) for o in obj]
        if isinstance(obj, tuple):
            return tuple(self.stage(o) for o in obj)
        return obj

    def to_tensor(self, arr, device):
        torch = self.torch
        arr = np.ascontiguousarray(arr)
        if device.type != "cuda":
            return _tensor_of(torch, arr if arr.flags.writeable else arr.copy())
        dtype = _tensor_of(torch, np.empty(0, arr.dtype)).dtype
        out = torch.empty(arr.shape, dtype=dtype, device=device)
        if arr.nbytes == 0:
            return out
        t0 = time.perf_counter()
        lease = _STAGING.acquire(torch, arr.nbytes)
        host = lease[0][:arr.nbytes]
        np.copyto(host.numpy().view(arr.dtype).reshape(arr.shape), arr)
        out.copy_(host.view(dtype).view(arr.shape), non_blocking=True)
        lease[1] = torch.cuda.Event()
        lease[1].record(torch.cuda.current_stream(device))
        _STAGING.release(lease)
        _STAGING.count("h2d", arr.nbytes, time.perf_counter() - t0)
        return out

    def result(self, out, device=None):
        """Map a verb's result onto ``device`` (default: the inputs')."""
        from rocnrdma_tpu_torch.transport import coalesce as _coalesce
        device = device if device is not None else self.device
        if isinstance(out, np.ndarray):
            return self.to_tensor(out, device)
        if isinstance(out, list):
            return [self.result(o, device) for o in out]
        if isinstance(out, tuple):
            return tuple(self.result(o, device) for o in out)
        if isinstance(out, (P2PHandle, _coalesce.Future)):
            self.pending += 1
            return _TensorHandle(out, self, device)
        return out

    def finish(self, out):
        out = self.result(out)
        if not self.pending:
            self.done()
        return out

    def handle_done(self) -> None:
        self.pending -= 1
        if not self.pending:
            self.done()

    def done(self) -> None:
        leases, self.leases = self.leases, []
        for lease in leases:
            _STAGING.release(lease)


class _TensorHandle:
    """A :class:`P2PHandle` or coalescer ``Future`` whose result is a
    tensor on the call's device; the call's staging buffers are held
    until every handle the call returned has completed."""

    def __init__(self, inner, door: _Door, device):
        self._inner = inner
        self._door = door
        self._device = device
        self._done = False
        self._result = None
        self.verb = getattr(inner, "verb", None)

    def done(self) -> bool:
        return self._done or (hasattr(self._inner, "done")
                              and self._inner.done())

    def wait(self, *args, **kwargs):
        if not self._done:
            try:
                res = self._inner.wait(*args, **kwargs)
            except BaseException as e:
                self._door.record(e)
                self._done = True
                self._door.handle_done()
                raise
            self._result = (None if res is None
                            else self._door.result(res, self._device))
            self._done = True
            self._door.handle_done()
        return self._result


def _holds_tensor(torch, obj) -> bool:
    if isinstance(obj, torch.Tensor):
        return True
    if isinstance(obj, (list, tuple)):
        return any(_holds_tensor(torch, o) for o in obj)
    return False


def _front_door(fn, template: bool = False):
    """Wrap a verb that takes arrays; ``template``: its first argument
    only sizes a receive (``recv``/``irecv``'s ``x_like``)."""
    import functools
    import sys

    @functools.wraps(fn)
    def verb(self, *args, **kwargs):
        torch = sys.modules.get("torch")
        if torch is None or not _holds_tensor(
                torch, (args, tuple(kwargs.values()))):
            return fn(self, *args, **kwargs)
        door = _Door(torch, fn.__name__)
        try:
            if template and args and isinstance(args[0], torch.Tensor):
                args = (door.template(args[0]),) + door.stage(args[1:])
            else:
                if template and isinstance(kwargs.get("x_like"),
                                           torch.Tensor):
                    kwargs["x_like"] = door.template(kwargs["x_like"])
                args = door.stage(args)
            kwargs = {k: door.stage(v) for k, v in kwargs.items()}
            out = fn(self, *args, **kwargs)
        except BaseException as e:
            door.record(e)
            door.done()
            raise
        return door.finish(out)

    return verb


def _front_door_batch(fn):
    """Wrap ``batch_isend_irecv``: each op's tensor is staged (a receive's
    as a template only) and each handle resolves on its op's device."""
    import functools
    import sys

    @functools.wraps(fn)
    def verb(self, ops, *args, **kwargs):
        torch = sys.modules.get("torch")
        if torch is None or not _holds_tensor(torch, list(ops)):
            return fn(self, ops, *args, **kwargs)
        door = _Door(torch, fn.__name__)
        staged, devices = [], []
        try:
            for op in ops:
                arr = op[1]
                if isinstance(arr, torch.Tensor):
                    devices.append(arr.device)
                    arr = (door.template(arr) if op[0] == "recv"
                           else door.stage(arr))
                else:
                    devices.append(None)
                staged.append((op[0], arr) + tuple(op[2:]))
            handles = fn(self, staged, *args, **kwargs)
        except BaseException as e:
            door.record(e)
            door.done()
            raise
        out = [h if dev is None else door.result(h, dev)
               for h, dev in zip(handles, devices)]
        if not door.pending:
            door.done()
        return out

    return verb


# ProcessGroup's verbs that take arrays; ChannelHandle's blocking verbs
# call these, so only its async (coalescer) verbs are wrapped there
_ARRAY_VERBS = ("all_reduce", "reduce_scatter", "all_gather", "broadcast",
                "all_to_all", "all_to_all_v", "all_gather_v",
                "reduce_scatter_v", "reduce", "gather", "scatter", "send",
                "isend")
_TEMPLATE_VERBS = ("recv", "irecv")
_ASYNC_VERBS = ("allreduce_async", "allgather_async", "reduce_scatter_async")


def _install_front_door() -> None:
    for name in _ARRAY_VERBS:
        setattr(ProcessGroup, name, _front_door(getattr(ProcessGroup, name)))
    for name in _TEMPLATE_VERBS:
        setattr(ProcessGroup, name,
                _front_door(getattr(ProcessGroup, name), template=True))
    ProcessGroup.batch_isend_irecv = _front_door_batch(
        ProcessGroup.batch_isend_irecv)
    for name in _ASYNC_VERBS:
        setattr(ChannelHandle, name, _front_door(getattr(ChannelHandle, name)))


_install_front_door()
