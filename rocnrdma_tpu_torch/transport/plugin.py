"""The net-plugin vtable (component C8's plugin face; SURVEY.md §0, §2).

The reference exposes its transport through RCCL's external-network-plugin
ABI — an ``ncclNet_t``-compatible vtable: ``init / devices / getProperties /
listen / connect / accept / regMr / isend / irecv / test / close`` — so the
collective library can ride any wire that implements those verbs. This
module rebuilds that surface on the host and the card, with the same
two-plane split the reference had (NIC verbs under GPU collectives):

- :class:`HostQPNet` — the *host/control plane*: the vtable over the native
  shared-memory queue pairs (``rocnrdma_tpu_torch.native``, the ``ibv_*``
  analogue). Cross-process, byte-oriented, tag-matched. The gloo-analogue
  host collectives (:func:`ring_allreduce_over_net`) ride exactly these
  verbs, the way RCCL rides the plugin.
- :class:`DeviceMeshNet` — the *device data plane*: the same vtable shape
  over the port's rank-major layout (one tensor on the mesh's device, row
  r = rank r). ``regMr`` is device placement (the ``hipMemRegister``
  analogue: a buffer becomes transferable by being laid out on the mesh),
  ``isend``/``irecv`` enqueue one row copy, ``test`` is a CUDA event
  query.

SPMD caveat, stated rather than hidden: on the device plane a "send" and its
matching "recv" are one collective program — both calls return the same
in-flight transfer, and the payloads are arrays, not bytes. The two planes
therefore share the vtable's *shape* (same verbs, same Request/completion
discipline), not interchangeability: byte-oriented callers like
:func:`ring_allreduce_over_net` require a plane whose
``get_properties().byte_oriented`` is True, exactly as rccl-net callers
branch on ``ncclNetProperties_t``.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import threading
import time
import uuid

import numpy as np

from rocnrdma_tpu_torch import lockwitness as _lockwitness
from rocnrdma_tpu_torch.metrics import VERBS as _VERB_LAT, WIRE as _WIRE
from rocnrdma_tpu_torch.obs import FLIGHT as _FLIGHT, postmortem as _postmortem
from rocnrdma_tpu_torch.obs import conformance as _conformance
from rocnrdma_tpu_torch.obs import trace as _trace
from rocnrdma_tpu_torch.transport import codec as _wire_codec
from rocnrdma_tpu_torch.transport import lanes as _lanes
from rocnrdma_tpu_torch.transport.backoff import Backoff


@dataclasses.dataclass(frozen=True)
class NetProperties:
    """``getProperties`` result (the ``ncclNetProperties_t`` analogue)."""

    name: str
    plane: str            # "host" | "device"
    max_comms: int
    max_inflight: int     # queued WRs per comm before backpressure
    byte_oriented: bool   # host plane moves bytes; device plane moves arrays
    one_sided: bool = False  # alloc_mr/iwrite/iread supported (optional
                             # capability, like ncclNet's ptrSupport flags)
    recv_into: bool = False  # irecv_into supported: inbound frames land (or
                             # streaming-reduce) directly in a caller buffer
                             # — the zero-copy receive capability the
                             # pipelined ring collectives key off


@dataclasses.dataclass
class Request:
    """An in-flight isend/irecv (the ``ncclNet`` request handle)."""

    _test: object              # () -> (done, size)
    done: bool = False
    size: int = 0
    payload: object = None     # completed irecv: bytes (host) / array (device)

    def test(self):
        if not self.done:
            self.done, self.size, self.payload = self._test()
        return self.done, self.size

    def wait(self, timeout_s: float = 10.0, progress=None):
        """Block until done. ``progress``: extra per-cycle progress hook —
        callers whose own outbound must keep flowing while they wait (the
        ring hops pass their send comm's pump) supply it here."""
        deadline = time.monotonic() + timeout_s
        back = _Backoff()
        while not self.test()[0]:
            if progress is not None:
                progress()
            if time.monotonic() >= deadline:
                raise TimeoutError("net request timed out")
            back.pause()
        return self.payload


# the shared yield-first wait discipline (transport/backoff.py) — its
# default profile IS the old private _Backoff this module grew: sleep(0)
# for ~500 misses, then constant 0.2 ms; kept under the old name for the
# many wait loops here (and any out-of-tree user of the private class)
_Backoff = Backoff


# ---------------------------------------------------------------------------
# Flight-recorder verb instrumentation (rocnrdma_tpu_torch.obs). Every public
# blocking verb on the host-plane vtable records an entry event and a
# completion event + latency observation — the coverage invariant the
# tools/analyze 'obs' pass pins: a new blocking verb cannot ship
# unobservable. The helpers keep the hot path to one record() call and
# one perf_counter read per edge.
# ---------------------------------------------------------------------------


def _verb_entry(verb: str, **ctx) -> float:
    """Record a blocking verb's entry (``<verb>-post``); returns the
    entry timestamp the completion side measures latency from."""
    _FLIGHT.record(verb + "-post", **ctx)
    return time.perf_counter()


def _verb_done(verb: str, t0: float, **ctx) -> None:
    """Record a blocking verb's completion (``<verb>-done``, with the
    post->done span as ``dur`` so trace viewers render a slice) and feed
    the per-verb latency histogram."""
    dt = time.perf_counter() - t0
    _VERB_LAT.observe(verb, dt)
    _FLIGHT.record(verb + "-done", dur=dt, **ctx)


def _traced_request(verb: str, t0: float, req: Request, **ctx) -> Request:
    """Wrap an async verb's Request so its FIRST completed probe records
    the completion event/latency (the native planes' completion polls run
    underneath ``req.test()`` — no extra polling is added)."""
    def probe():
        done, size = req.test()
        if not done:
            return False, 0, None
        _verb_done(verb, t0, size=size, **ctx)
        return True, size, req.payload
    return Request(_test=probe)


# ---------------------------------------------------------------------------
# Host plane: the vtable over native shared-memory queue pairs
# ---------------------------------------------------------------------------


class _HostComm:
    """One connected endpoint; tag-matched messages over one QP.

    ``net``: back-reference to the owning vtable — used by ``_pump`` to
    answer a peer's large-message arena REQUEST (the peer is blocked in a
    big isend; this side may be doing nothing but pumping, so the ensure
    must run inside the pump — in the comm owner's thread, like every
    other comm mutation)."""

    def __init__(self, qp, net=None):
        self.qp = qp
        self._net = net
        # the group-generation (epoch) this comm stamps on every outbound
        # frame and requires on every inbound one: inherited from the
        # owning net at creation, advanced by the net's set_epoch verb.
        # A frame carrying any OTHER epoch is dropped at the vtable
        # boundary (_pump) — the fence that keeps late packets from
        # pre-heal wiring out of post-heal reductions.
        self.epoch = getattr(net, "_epoch", 0) if net is not None else 0
        # the comm's thread discipline: multi-tenant lanes run CONCURRENT
        # collectives over one comm from separate threads, so every slice
        # of work that touches comm/QP state — a pump, a post attempt, a
        # probe's stash pop — holds this lock. Re-entrant: a locked pump
        # may call back into _lg_ensure, which posts (and pumps) on the
        # same comm. Blocking waits NEVER hold it (each loop iteration
        # locks, releases, then pauses), and progress hooks are called
        # unlocked — two comms' locks are never held at once, so lane
        # threads pumping each other's comms cannot deadlock.
        self._lock = _lockwitness.make_rlock("plugin.py::_HostComm._lock")
        # (chan, tag) -> payloads; entries are ZERO-COPY memoryviews of
        # the posted receive buffers (poll_cq's contract) with the
        # 12-byte tag+epoch+chan header sliced off — a consumer that
        # lands/combines them in place (irecv_into) recycles the backing
        # bytearray via _recycle. The channel half of the key is the
        # lane fence: two collectives in flight on one comm match only
        # their own lane's frames.
        self._unexpected: dict[tuple, list] = {}
        self._posted = 0  # receive buffers posted but not yet completed
        # recycled frame buffers, one size class (MAX_FRAME + 8): the
        # steady state of the streaming ring collectives posts receives
        # from here instead of allocating — zero alloc, zero reg churn
        self._pool: list[bytearray] = []
        self._POOL_CAP = 8
        # completed iwrite/iread wr_ids awaiting their Request's probe.
        # Insertion-ordered and CAPPED: a fire-and-forget caller that never
        # tests its Requests must not grow this without bound, so beyond the
        # cap the oldest (necessarily never-probed) entries are evicted.
        self._onesided_done: dict[int, int | None] = {}  # wr -> err status
        self._ONESIDED_CAP = 4096
        # large-message rendezvous state (HostQPNet's LG protocol):
        self._lg_mr = None          # MY arena (I am the receiver side)
        self._lg_dead = False       # arena alloc failed; LG unavailable
        self._lg_announced = False  # announce queued this epoch (reset by
        #                             the fence; a peer's REQ re-queues)
        self._lg_peer = None        # (rkey, size) of the PEER's arena
        self._lg_head = 0           # my bump pointer into the peer arena
        self._lg_outstanding = 0    # bytes put but not yet ACKed back
        self._lg_ack_queue = []     # credit ACKs deferred on a full ring

    def _flush_lg_acks(self) -> None:
        """Post deferred large-message credit ACKs until the ring
        backpressures — never blocks. Lives on the COMM and runs at the
        top of every ``_pump`` (code-review r5: if only the irecv probe
        flushed, a receiver that stops probing this comm — e.g. it only
        sends from here on — would strand the peer's credit forever;
        every verb on the comm pumps, so every verb now drains the
        queue). ``close`` gives it one last bounded shot."""
        with self._lock:
            while self._lg_ack_queue:
                wr = self.qp.post_send(self._lg_ack_queue[0])
                if wr == -1:  # ring full: retry at the next pump
                    return
                if wr < -1:
                    raise RuntimeError("host net: connection died while "
                                       "returning large-message credit")
                self._lg_ack_queue.pop(0)

    def _hdr(self, tag: int, channel: int = 0) -> bytes:
        """The 12-byte wire header every framed message carries:
        ``tag(4) | epoch(4) | chan(4)``, all little-endian. One constructor
        so the send paths (isend, LG announce/credit/REQ/descriptor) can
        never disagree with the parser in ``_pump``. ``channel`` is the
        message's lane id (``transport.lanes``); LG protocol control
        rides channel 0 — the arena is comm-global state, not a
        tenant's."""
        return (tag.to_bytes(4, "little")
                + self.epoch.to_bytes(4, "little")
                + channel.to_bytes(4, "little"))

    def _label(self, channel: int) -> str:
        """The lane name behind a wire channel id (per-lane counters and
        fence events key by name, so telemetry reads "bulk", not a
        hash) — resolved through the owning net's registry when there
        is one, else the one shared fallback spelling."""
        reg = getattr(self._net, "lanes", None)
        if reg is not None:
            return reg.label(channel)
        return _lanes.fallback_label(channel)

    def _pump(self):
        # drain the wire; stash every arrived message by (chan, tag).
        # The whole drain holds the comm lock (lane threads pump
        # concurrently); _lg_ensure re-enters it safely.
        with self._lock:
            return self._pump_locked()

    def _pump_locked(self):
        if self._lg_ack_queue:
            self._flush_lg_acks()
        if self._posted < 4:
            self.qp.post_recv(HostQPNet.MAX_FRAME + HostQPNet.HDR,
                              buf=self._pool.pop() if self._pool else None)
            self._posted += 1
        got = False
        arena_requested = False
        from rocnrdma_tpu_torch import native
        for c, payload in self.qp.poll_cq():
            if c.opcode == native.OP_RECV:
                self._posted -= 1
                if c.status != native.OK:
                    raise OSError(
                        f"host net: truncated message "
                        f"(> {HostQPNet.MAX_FRAME + HostQPNet.HDR} B frame)")
                tag = int.from_bytes(payload[:4], "little")
                epoch = int.from_bytes(payload[4:8], "little")
                chan = int.from_bytes(payload[8:12], "little")
                if epoch != self.epoch:
                    # THE epoch fence: a frame from another group
                    # generation (pre-heal wiring, or an aborted
                    # collective's retry-colliding tags) is dropped at
                    # the vtable boundary — counted (per lane, so a
                    # postmortem can say WHOSE frames died with the
                    # generation), on the flight timeline, never
                    # delivered. The fence is lane-agnostic: every
                    # lane's stale frames drop the same way.
                    _WIRE.fenced(channel=self._label(chan))
                    _FLIGHT.record("epoch-fenced", tag=tag, chan=chan,
                                   frame_epoch=epoch, epoch=self.epoch,
                                   nbytes=len(payload) - HostQPNet.HDR)
                    self._recycle(payload[HostQPNet.HDR:])
                    continue
                if tag == HostQPNet._LG_REQ_TAG:
                    # peer blocked in a large send wants my arena announce;
                    # handled AFTER the poll loop (ensure posts a send and
                    # pumps — no mutation under the live CQ iteration)
                    arena_requested = True
                    continue
                self._unexpected.setdefault((chan, tag), []).append(
                    payload[HostQPNet.HDR:])
                got = True
            elif c.opcode in (native.OP_WRITE, native.OP_READ):
                self._onesided_done[c.wr_id] = (
                    None if c.status == native.OK else c.status)
                while len(self._onesided_done) > self._ONESIDED_CAP:
                    self._onesided_done.pop(next(iter(self._onesided_done)))
        if arena_requested and self._net is not None:
            # the peer explicitly asked: (re-)queue the announce — an
            # earlier one may have been dropped by the epoch fence on
            # either end. Non-blocking (deferred control queue), so
            # running it under the pump's lock is fine.
            self._net._lg_ensure(self, announce=True)
        return got

    def _recycle(self, payload) -> None:
        """Hand a fully-consumed frame payload's backing buffer back to the
        receive pool (``payload``: the ``_unexpected`` memoryview whose
        ``.obj`` is the posted bytearray). Only the one frame size class is
        pooled; anything else just drops to the GC as before."""
        buf = getattr(payload, "obj", None)
        if (isinstance(buf, bytearray)
                and len(buf) == HostQPNet.MAX_FRAME + HostQPNet.HDR):
            with self._lock:
                if len(self._pool) >= self._POOL_CAP:
                    return
                try:
                    payload.release()  # drop the export; post_recv re-borrows
                except BufferError:
                    return  # a live export still aliases it: GC's problem
                self._pool.append(buf)

    def close(self):
        # one bounded last shot at returning deferred credit: the peer's
        # in-flight isend should see its credit rather than a timeout.
        # _pump (not a bare flush): send-ring slots only free when the CQ
        # is polled, so a flush-only loop could spin its whole budget
        # against a full ring without ever making progress (code-review r5)
        deadline = time.monotonic() + 1.0
        try:
            while self._lg_ack_queue and time.monotonic() < deadline:
                before = len(self._lg_ack_queue)
                self._pump()  # polls the CQ (freeing ring slots) + flushes
                if len(self._lg_ack_queue) == before:
                    time.sleep(0.01)
        except Exception:
            # teardown must not leak the QP (or abort a net-level close
            # loop over sibling comms) because the peer died first — the
            # credit is moot once either side is gone
            pass
        self.qp.close()


class HostQPNet:
    """``ncclNet_t``-shaped vtable over the native QP library (host plane).

    One "device" (dev index 0): the shared-memory "NIC". Handles returned by
    :meth:`listen` are plain strings, exchangeable over any out-of-band
    channel (env, pipe, file) — the analogue of the OOB handle exchange the
    reference does during plugin bootstrap.
    """

    # The wire header every framed message carries: ``tag(4) | epoch(4)
    # | chan(4)`` — tag identity, the group-generation fence of the
    # self-healing process group, and the multi-tenant LANE the frame
    # rides (``transport.lanes``; 0 = the default lane every un-laned
    # verb stamps).
    HDR = 12

    # One message per posted recv buffer, minus the header. 512 KiB (it
    # was 64 KiB): at MiB message sizes the msg
    # plane's cost is per-FRAME Python work (tag pack, post, poll), so
    # 8x fewer frames is 8x less of it; the shm ring's default capacity
    # below holds several frames (pages are lazily allocated — an unused
    # ring costs nothing), and _pump's 4 posted buffers stay a modest
    # 2 MiB per comm. Messages past LG_MIN below no longer chunk at all
    # — see the large-message rendezvous.
    MAX_FRAME = (1 << 19) - 12

    # Large-message rendezvous: a message of
    # >= LG_MIN bytes on a one-sided-capable plane is routed INSIDE
    # isend/irecv over the put path instead of the frame ring — one
    # ``iwrite`` into a receiver-owned arena + a tiny descriptor frame,
    # replacing per-512-KiB-frame Python work (pack/post/poll/copy per
    # frame) with one native bulk copy. Protocol, all in-band on the
    # existing QP pair:
    #   1. the RECEIVER, on its first >= LG_MIN ``irecv``, allocates an
    #      ``LG_ARENA``-byte MR on its side of the comm and announces
    #      (rkey, size) in a reserved-tag frame;
    #   2. the SENDER, on a >= LG_MIN ``isend``, waits for that announce
    #      (pumping ``progress`` — same ordering requirement as the
    #      existing backpressure note: the peer must eventually post its
    #      irecv), bump-allocates a window in the arena (resetting to
    #      offset 0 whenever all prior bytes are ACKed — single writer
    #      per direction, so no races), waits for the put to complete,
    #      then sends a 32-byte descriptor frame under the ORIGINAL tag;
    #   3. the receiver's ``irecv`` probe recognizes the descriptor by
    #      magic (only on >= LG_MIN expectations — a genuine 32-byte
    #      payload for a >= 1 MiB posted receive cannot also carry the
    #      magic except by 2^-128 accident), copies the bytes out of its
    #      own arena, and ACKs the freed length on a second reserved tag.
    # Credit never exceeds the arena, so the put can never overwrite
    # unconsumed data; messages larger than the arena fall back to frame
    # chunking at the CALLER (reg_mr still enforces that cap).
    # auto-route threshold: anything that does not fit ONE frame rides the
    # put path (no gap — pre-r4 these sizes were a caller-must-chunk error)
    LG_MIN = MAX_FRAME + 1
    LG_ARENA = 16 << 20     # receiver-side arena — a quarter of listen's
    #                         64 MiB mr_capacity default, leaving room for
    #                         the put-ring's own slot MRs on a shared comm
    #                         (shm pages are lazy; an unused arena is free)
    _LG_MAGIC = bytes.fromhex("9b1f7c2ae84d06b35a90cd1e4f62b7d8")
    _LG_RKEY_TAG = 0xFFFFFF01   # arena announce (rkey, size)
    _LG_ACK_TAG = 0xFFFFFF02    # consumed-bytes credit return
    _LG_REQ_TAG = 0xFFFFFF03    # "announce your arena" (peer mid-isend)
    # 0xFFFFFF04 is reserved by the p2p stream-resume protocol
    # (distributed._P2P_RESUME_TAG): same collision exposure class as the
    # LG tags (hop 0xFFFF with a > 0xFF00 frame index), carried by the
    # ordinary isend/irecv verbs — no pump special-casing here
    # ring-collective hop chunk on LG-capable planes (_RingWire reads
    # this): 4 MiB >= LG_MIN, so every ring hop is ONE put + descriptor
    # instead of 8 frame posts; FOUR windows fit the 16 MiB arena, enough
    # that a hop's put overlaps the previous hop's consume (credit resets
    # need a full drain, so deeper pipelining would want a bigger arena)
    LG_CHUNK = 4 << 20

    # the plane key the self-tuning wire model is committed under
    # (tuner.host_wire_model): shm and tcp fit/pick independently —
    # their alphas and betas differ by an order of magnitude
    PLANE = "shm"

    def __init__(self):
        self._inited = False
        self._comms: list[_HostComm] = []
        self._epoch = 0  # the group generation new comms inherit
        # the multi-tenant lane table + admission gate (transport.lanes):
        # a net with only the default lane open pays one length check per
        # send — the single-tenant wire is untouched
        self.lanes = _lanes.LaneRegistry()
        self._lane_gate = _lanes.LaneGate(self.lanes)
        # the committed host wire model this plane's ring wires pick
        # frame_bytes/pipeline_depth from (process-wide per
        # plane, so every comm's picks and every tune_wire commit see
        # one version stream). Env knobs — disable, fitted-artifact
        # load, sweep pins — are resolved inside host_wire_model at
        # construction, never at pick time (the purity rule).
        from rocnrdma_tpu_torch.transport import tuner as _tuner
        self.wire_model = _tuner.host_wire_model(self.PLANE)

    # -- vtable ------------------------------------------------------------

    def init(self) -> None:
        from rocnrdma_tpu_torch import native
        if not native.available():
            raise OSError("native rqp library unavailable (no g++?)")
        self._inited = True

    def open_lane(self, name: str, priority: int = 0,
                  credit_bytes: int | None = None,
                  codec: str | None = None) -> "_lanes.Lane":
        """Open (or idempotently re-open) a named QoS lane on this net —
        the vtable half of ``ProcessGroup.channel``. The returned
        :class:`~rocnrdma_tpu_torch.transport.lanes.Lane` carries the wire
        channel id (a stable hash of the name — every rank derives the
        same id with no rendezvous), the scheduling ``priority``
        (higher preempts lower at the send-admission gate), the
        pacing ``credit_bytes`` (bytes the lane may post between
        yields; None = unpaced), and the wire ``codec`` the lane's
        streaming collectives quantize under ("int8"/"fp8"/"auto";
        None = uncompressed — ``transport.codec``). A conflicting
        re-open raises — two tenants silently disagreeing on a lane's
        priority (or its wire format) is a scheduling bug, not a
        merge."""
        return self.lanes.open(name, priority=priority,
                               credit_bytes=credit_bytes, codec=codec)

    def set_epoch(self, epoch: int) -> None:
        """Advance the group generation (the elastic-recovery fence,
        called by ``ProcessGroup.heal`` after a membership change): every
        comm — kept survivors' wiring included — stamps ``epoch`` on all
        future frames and DROPS inbound frames carrying any other epoch
        at the vtable boundary (counted in ``metrics.WIRE`` and recorded
        as ``epoch-fenced`` flight events). Stale frames already stashed
        unconsumed are fenced immediately, and per-comm protocol state
        that an aborted collective may have left dangling resets
        symmetrically on both ends (large-message arena credit, the
        put-ring doorbell cache) — the heal's wired barrier orders these
        resets before any new-epoch traffic."""
        self._epoch = int(epoch)
        # the tuner's epoch fence rides the same protocol point: a
        # pending (uncommitted) model refit computed under the old
        # generation mixes pre-heal wiring into its window — dropped,
        # named on the flight timeline (the committed model survives;
        # it was agreed at a protocol point)
        self.wire_model.fence_epoch(self._epoch)
        for comm in self._comms:
            self._fence_comm(comm)

    def _fence_comm(self, comm: _HostComm) -> None:
        # pump once before fencing: frames already DELIVERED to this
        # comm's ring but not yet polled (a p2p plane nothing pumped
        # during the aborted collective, a burst the consumer abandoned)
        # must be fenced NOW and counted — not discovered mid-retry. The
        # comm may be wired to the dead rank itself: a failing pump
        # cannot make it worse than dead, and the rewire replaces it.
        try:
            comm._pump()
        except Exception:
            pass
        with comm._lock:
            stale = sum(len(v) for v in comm._unexpected.values())
            if stale:
                # count the fence PER LANE: every lane's stale frames
                # drop with the generation, and the per-channel counter
                # is what lets a heal's postmortem name the tenant
                per_chan: dict[int, int] = {}
                for (chan, _tag), payloads in comm._unexpected.items():
                    per_chan[chan] = per_chan.get(chan, 0) + len(payloads)
                for chan, n in sorted(per_chan.items()):
                    _WIRE.fenced(n, channel=comm._label(chan))
                _FLIGHT.record("epoch-fenced", stashed=stale,
                               chans=len(per_chan), epoch=self._epoch)
                for payloads in comm._unexpected.values():
                    for payload in payloads:
                        comm._recycle(payload)
            comm._unexpected.clear()
            comm.epoch = self._epoch
            # LG sender-side credit restarts at offset 0 — safe because
            # the receiver's unconsumed stale puts are dead bytes (single
            # writer per direction + QP FIFO: any post-heal put
            # overwrites them before its own descriptor frame can be
            # consumed), and queued credit ACKs for stale consumption are
            # dropped with the epoch
            comm._lg_head = 0
            comm._lg_outstanding = 0
            comm._lg_ack_queue.clear()
            # a queued-but-unsent announce died with the queue: let the
            # next ensure (or a peer's REQ) re-queue it
            comm._lg_announced = False
            # the put-ring doorbell state (hop counters, slot MRs) is
            # generation-bound: drop the cache so the next rdma collective
            # re-registers fresh MRs (bump-allocated; stale doorbell
            # writes land in the abandoned regions, harmlessly)
            if getattr(comm, "_rdma_ring", None) is not None:
                comm._rdma_ring = None

    def devices(self) -> int:
        return 1

    def get_properties(self, dev: int = 0) -> NetProperties:
        return NetProperties(name="shm-qp", plane="host", max_comms=1 << 16,
                             max_inflight=1 << 10, byte_oriented=True,
                             one_sided=True, recv_into=True)

    def listen(self, dev: int = 0, capacity: int = 4 << 20,
               mr_capacity: int = 64 << 20):
        """-> (handle, listen_comm). Give ``handle`` to the connecting peer.

        ``capacity`` sizes the shm message ring — the default holds
        several MAX_FRAME messages so the bigger r3 frames never starve
        the pipeline. ``mr_capacity`` sizes each side's one-sided MR
        arena; the generous default matches the TCP plane's 64 MiB frame
        cap (shm pages are allocated lazily on first touch, so an unused
        ring/arena costs nothing) and keeps the put-based ring viable for
        multi-MB chunks."""
        from rocnrdma_tpu_torch import native
        assert self._inited, "call init() first"
        handle = f"/rqp_{uuid.uuid4().hex[:16]}"
        qp = native.QueuePair.listen(handle, capacity, mr_capacity=mr_capacity)
        return handle, qp

    def connect(self, dev: int, handle: str, timeout_s: float = 10.0) -> _HostComm:
        from rocnrdma_tpu_torch import native
        assert self._inited, "call init() first"
        t0 = _verb_entry("connect", plane="shm")
        qp = native.QueuePair.connect(handle, timeout_s)
        try:
            qp.accept(timeout_s)
        except BaseException as e:
            # the abort-path observability rule (tools/analyze/obs.py):
            # a teardown-and-reraise must leave a flight event, or the
            # postmortem is blind to exactly the failed wiring step
            _FLIGHT.record("connect-abort", plane="shm",
                           error=type(e).__name__)
            qp.close()  # a half-attached QP is not in _comms yet: nothing
            raise       # else would ever release its shm segment
        comm = _HostComm(qp, net=self)
        self._comms.append(comm)
        _verb_done("connect", t0, plane="shm")
        return comm

    def accept(self, listener, timeout_s: float = 10.0) -> _HostComm:
        t0 = _verb_entry("accept", plane="shm")
        listener.accept(timeout_s)
        comm = _HostComm(listener, net=self)
        self._comms.append(comm)
        _verb_done("accept", t0, plane="shm")
        return comm

    def reg_mr(self, comm: _HostComm, buffer) -> memoryview:
        """Register ``buffer`` (bytes/bytearray/ndarray) for transfer.
        Buffers past MAX_FRAME are legal up to the large-message arena
        size — ``isend`` routes those over the put path (LG rendezvous)
        instead of the frame ring."""
        view = memoryview(buffer).cast("B")
        if len(view) > self.LG_ARENA:
            raise ValueError(
                f"host net large-message limit is {self.LG_ARENA} B, got "
                f"{len(view)}; chunk at the caller (the collectives do)")
        return view

    def isend(self, comm: _HostComm, mr: memoryview, tag: int = 0,
              timeout_s: float = 10.0, progress=None,
              channel: int | None = None) -> Request:
        """Queue ``mr`` on ``comm``. ``progress`` is the verbs progress-engine
        hook: while the send ring backpressures, the caller's other comms
        must keep draining (data inbound to THIS rank arrives on a different
        QP than the one we are stuffing), or two mutually-sending ranks
        deadlock. Collectives pass the recv comm's pump here.

        ``channel`` is the message's QoS lane (``transport.lanes``); None
        reads the calling thread's lane context — 0 (the default lane)
        outside any ``ChannelHandle`` verb. The lane gate runs BEFORE
        the post: a paced lane yields per credit of posted bytes (a
        real sleep while a higher-priority lane is mid-collective) and
        keeps the shared tx backlog under its credit, and contending
        admits defer by priority — the admission control that keeps a
        bulk stream from starving a latency-bound lane on the shared
        ring/FIFO (see ``lanes.LaneGate.admit`` for the exact bounds).

        Messages of >= LG_MIN bytes route over the one-sided put path (the
        LG rendezvous — see the class docstring block at LG_MIN): the peer
        must have posted (or concurrently post) a matching >= LG_MIN
        ``irecv``, the same liveness requirement the frame path already
        has under backpressure.
        """
        chan = _lanes.current_channel() if channel is None else int(channel)
        size = len(mr)
        t0 = _verb_entry("isend", tag=tag, nbytes=size, chan=chan)
        self._lane_gate.admit(comm, chan, size, timeout_s=timeout_s,
                              progress=progress)
        if size >= self.LG_MIN:
            req = self._lg_isend(comm, mr, tag, timeout_s, progress, chan)
            _verb_done("isend", t0, tag=tag, nbytes=size)
            return req
        # scatter-gather post: the native layer prepends the 12-byte
        # tag+epoch+chan header inside its one ring/queue memcpy, so the
        # payload is borrowed zero-copy instead of being serialized twice
        hdr = comm._hdr(tag, chan)
        self._post_backpressured(comm, lambda: comm.qp.post_send2(hdr, mr),
                                 "send ring full", timeout_s, progress)
        # drain our own CQ so send completions don't pile up in the native
        # deque over a long-lived comm (poll is the only thing that frees them)
        comm._pump()
        _verb_done("isend", t0, tag=tag, nbytes=size)
        return Request(_test=lambda: (True, size, None))

    def _lg_ensure(self, comm: _HostComm, announce: bool = False) -> None:
        """Allocate this comm's receive arena once and queue its
        announce. Called from irecv (the natural rendezvous point), from
        a waiting _lg_isend for EVERY open comm (a rank blocked in a
        large send must still announce the arenas its peers' sends
        need, or two ranks in blocking symmetric sends over separate tx
        comms deadlock), and — with ``announce=True`` — from the REQ
        path in ``_pump`` (the peer explicitly asked: re-queue even if
        an earlier announce went out, e.g. one the epoch fence
        dropped).

        NEVER blocks: the announce (or the capacity-exhausted NACK —
        rkey 0, size 0, so the peer's large sends fail FAST with the
        real diagnosis) rides the same deferred control queue as the
        credit ACKs, flushed non-blockingly at every pump/probe of this
        comm. A blocking post here would hold the comm lock across a
        full-ring wait — exactly the cross-lane head-of-line blocking
        the lane subsystem promises cannot happen (the REQ path calls
        this from inside the locked pump)."""
        with comm._lock:
            if comm._lg_mr is None and not comm._lg_dead:
                try:
                    comm._lg_mr = self.alloc_mr(comm, self.LG_ARENA)
                except Exception:
                    comm._lg_dead = True
            if comm._lg_announced and not announce:
                return
            if comm._lg_dead:
                ann = (0).to_bytes(8, "little") + (0).to_bytes(8, "little")
            else:
                ann = (comm._lg_mr.rkey.to_bytes(8, "little")
                       + self.LG_ARENA.to_bytes(8, "little"))
            # LG protocol control rides channel 0 (comm-global state: the
            # arena serves every lane; any lane's drain sees the announce)
            comm._lg_ack_queue.append(comm._hdr(self._LG_RKEY_TAG) + ann)
            comm._lg_announced = True
            comm._flush_lg_acks()

    def _lg_descriptor(self, payload, lg: bool):
        """``(offset, length)`` when ``payload`` is a put descriptor for a
        >= LG_MIN expectation, else None — the ONE parser of the LG
        descriptor frame (``magic | offset | length``), shared by the
        legacy and zero-copy receive paths so the protocol can never
        desynchronize between them."""
        if not (lg and len(payload) == 32
                and payload[:16] == self._LG_MAGIC):
            return None
        return (int.from_bytes(payload[16:24], "little"),
                int.from_bytes(payload[24:32], "little"))

    def _lg_credit(self, comm: _HostComm, length: int) -> None:
        """Return ``length`` bytes of arena credit to the sender — queued,
        then flushed best-effort (NON-blocking: a nominally non-blocking
        Request.test() must not spin on a full send ring; a deferred ACK
        drains at the next probe/pump of this comm)."""
        _trace.record("lg-credit-acked", nbytes=length)
        comm._lg_ack_queue.append(comm._hdr(self._LG_ACK_TAG)
                                  + length.to_bytes(8, "little"))
        self._lg_flush_acks(comm)

    def _lg_flush_acks(self, comm: _HostComm) -> None:
        """Post queued credit ACKs until the send ring backpressures —
        never blocks (the irecv probe calls this from Request.test()).
        A deferred ACK also retries at EVERY ``_pump`` of this comm
        (``_HostComm._flush_lg_acks``), so any later verb on the comm —
        send or receive — returns the peer's credit; the sender's own
        credit wait keeps pumping (isend step 2), which is what empties
        the ring."""
        comm._flush_lg_acks()

    def _lg_drain_acks(self, comm: _HostComm) -> None:
        # credit ACKs are comm-global (the arena serves every lane), so
        # the drain scans EVERY lane's stash for the ACK tag — a credit
        # returned under one lane's context must unblock any lane's
        # sender, or an idle lane could strand another's credit forever
        with comm._lock:
            for key in [k for k in comm._unexpected
                        if k[1] == self._LG_ACK_TAG]:
                for payload in comm._unexpected.pop(key):
                    comm._lg_outstanding -= int.from_bytes(payload, "little")

    def _lg_take_announce(self, comm: _HostComm) -> bool:
        """Pop the peer's arena announce from any lane's stash into
        ``comm._lg_peer``; True when present (comm-global, like the
        ACKs — see ``_lg_drain_acks``)."""
        with comm._lock:
            for key in [k for k in comm._unexpected
                        if k[1] == self._LG_RKEY_TAG]:
                ann = comm._unexpected.pop(key)
                comm._lg_peer = (int.from_bytes(ann[0][:8], "little"),
                                 int.from_bytes(ann[0][8:16], "little"))
                return True
        return False

    def _lg_isend(self, comm: _HostComm, mr: memoryview, tag: int,
                  timeout_s: float, progress, chan: int = 0) -> Request:
        deadline = time.monotonic() + timeout_s
        back = _Backoff()
        # announce MY arena on this comm before waiting on the peer's: on
        # a bidirectional comm (one QP pair playing both _RingWire roles)
        # this alone breaks the symmetric-blocking-send deadlock — each
        # side's announce rides the same pair the other side waits on.
        # (Only THIS comm: comms belong to one rank-thread each; touching
        # the whole net's list here would race other threads' QPs.)
        # For peers that are merely PUMPING (no irecv posted yet), the
        # REQ frame below makes their next _pump ensure+announce; p2p
        # topologies additionally ensure rx comms in their progress engine.
        self._lg_ensure(comm)
        if comm._lg_peer is None:
            req = comm._hdr(self._LG_REQ_TAG)
            self._post_backpressured(comm, lambda: comm.qp.post_send(req),
                                     "send ring full", timeout_s, progress)
        # 1. the peer's arena announce (sent at its comm setup / irecv)
        while comm._lg_peer is None:
            if self._lg_take_announce(comm):
                break
            comm._pump()
            if progress is not None:
                progress()
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    "host net: large-message send waited for the peer's "
                    "arena announce (no matching >= LG_MIN irecv posted?)")
            back.pause()
        rkey, arena = comm._lg_peer
        if arena == 0:
            # the peer NACKed: its MR capacity could not fit an arena
            raise OSError(
                "host net: peer has no large-message arena (MR capacity "
                "exhausted on its side); chunk at the caller below "
                f"LG_MIN={self.LG_MIN} B or raise the peer's mr_capacity")
        need = len(mr)
        # 2. bump-allocate a window; reset to 0 when everything prior is
        # ACKed; block on credit otherwise. Allocation holds the comm
        # lock: concurrent lanes' large sends interleave their windows
        # safely (the single-writer-per-direction invariant becomes
        # single-ALLOCATOR-per-direction under the lock).
        stall_t0 = None  # one event per stall episode, not per poll
        offset = None
        while True:
            self._lg_drain_acks(comm)
            with comm._lock:
                if comm._lg_outstanding == 0:
                    comm._lg_head = 0
                if comm._lg_head + need <= arena:
                    offset = comm._lg_head
                    comm._lg_head += need
                    comm._lg_outstanding += need
                    break
            if stall_t0 is None:
                stall_t0 = time.perf_counter()
                _trace.record("credit-stalled", tag=tag, need=need,
                              outstanding=comm._lg_outstanding)
            comm._pump()
            if progress is not None:
                progress()
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    "host net: large-message arena credit starved "
                    "(peer not consuming?)")
            back.pause()
        if stall_t0 is not None:
            # the stall's resolution (with the wait as dur): what the
            # causal tracer attributes to the op's credit-stall bucket
            _trace.record("credit-resumed", tag=tag,
                          dur=time.perf_counter() - stall_t0)
        # 3. the put, completed BEFORE the descriptor leaves (the soft-NIC
        # applies posts in order, but completion is the portable guarantee)
        self.iwrite(comm, rkey, mr, offset, timeout_s=timeout_s,
                    progress=progress).wait(
                        timeout_s=max(0.1, deadline - time.monotonic()),
                        progress=progress)
        # 4. descriptor under the ORIGINAL tag AND the message's lane:
        # magic | offset | length
        desc = (self._LG_MAGIC + offset.to_bytes(8, "little")
                + need.to_bytes(8, "little"))
        data = comm._hdr(tag, chan) + desc
        self._post_backpressured(comm, lambda: comm.qp.post_send(data),
                                 "send ring full", timeout_s, progress)
        comm._pump()
        return Request(_test=lambda: (True, need, None))

    def irecv(self, comm: _HostComm, nbytes: int, tag: int = 0,
              channel: int | None = None) -> Request:
        chan = _lanes.current_channel() if channel is None else int(channel)
        key = (chan, tag)
        lg = nbytes >= self.LG_MIN
        if lg:
            self._lg_ensure(comm)  # the LG rendezvous step 1
        t0 = _verb_entry("irecv", tag=tag, nbytes=nbytes, chan=chan)

        def probe():
            with comm._lock:
                if comm._lg_ack_queue:  # credit deferred by an earlier probe
                    self._lg_flush_acks(comm)
                ready = comm._unexpected.get(key)
                if not ready:
                    comm._pump()
                    ready = comm._unexpected.get(key)
                if not ready:
                    return False, 0, None
                payload = ready.pop(0)
                if not ready:  # drop exhausted keys: callers use fresh
                    del comm._unexpected[key]  # tags per step
                desc = self._lg_descriptor(payload, lg)
                if desc is not None:
                    # a put descriptor: the bytes are already in my arena.
                    # Zero-copy view + one tobytes — the descriptor frame
                    # arrived through the fenced message ring AFTER the
                    # sender's put completed, which is the ordering
                    # read_mr_view's caveat requires (and faster than
                    # the fenced read_mr_local double copy)
                    offset, length = desc
                    out = self.read_mr_view(comm, comm._lg_mr, offset,
                                            length).tobytes()
                    _WIRE.copied(length)  # arena staged out (irecv_into
                    #                       lands it in place instead)
                    self._lg_credit(comm, length)
                    _verb_done("irecv", t0, tag=tag, nbytes=length)
                    return True, length, out
                _verb_done("irecv", t0, tag=tag, nbytes=len(payload))
                return True, len(payload), payload
        return Request(_test=probe)

    def irecv_into(self, comm: _HostComm, buf, tag: int = 0, *,
                   combine=None, dtype=None,
                   channel: int | None = None, codec=None) -> Request:
        """Post a receive landing DIRECTLY in ``buf`` — the zero-copy twin
        of :meth:`irecv` (the ``recv_into`` capability in
        :class:`NetProperties`). ``buf`` is a writable C-contiguous byte
        buffer, typically a slice of the destination ndarray; the completed
        Request's ``size`` is the byte count delivered and ``payload`` is
        None (the data is already in ``buf``).

        ``combine``: optional binary numpy ufunc (``np.add`` & friends) —
        instead of overwriting, the arrived bytes are interpreted as
        ``dtype`` and folded INTO ``buf`` in place the moment the frame
        completes. This is the streaming-reduce primitive of the pipelined
        ring collectives: the fold reads straight out of the wire buffer
        (frame path) or the large-message arena view (put path), so the
        steady state stages no intermediate payload copy at all. ``buf``'s
        length must then be a multiple of ``dtype``'s itemsize, and the
        sender must frame on element boundaries (``_RingWire`` aligns its
        frame size for exactly this reason).

        Frame-path buffers are recycled to the comm's receive pool after
        consumption, so a long-lived comm's steady state allocates nothing.

        ``codec``: optional :class:`transport.codec.WireCodec` — the
        arriving bytes are then an ENCODED frame (per-frame scale
        header + one byte per element, ``codec.encoded_nbytes`` of
        them for a ``buf``-sized decoded payload) and the consume step
        decodes-and-folds straight out of the wire buffer into ``buf``
        (land when ``combine`` is None): the quantized-collective
        twin of the streaming fold, still zero staging copies. Needs
        an explicit ``dtype`` like ``combine`` does; the LG-vs-frame
        routing is decided on the WIRE size, matching the sender's
        routing of the encoded post by construction.
        """
        mv = memoryview(buf)
        if mv.readonly:
            raise ValueError("irecv_into needs a writable destination buffer")
        dest = np.frombuffer(mv.cast("B"), np.uint8)
        nbytes = dest.nbytes
        if combine is not None or codec is not None:
            if dtype is None:
                raise ValueError("combine/codec needs an explicit dtype")
            dtype = np.dtype(dtype)
            if nbytes % dtype.itemsize:
                raise ValueError(
                    f"{nbytes} B destination is not a whole number of "
                    f"{dtype} elements")
        chan = _lanes.current_channel() if channel is None else int(channel)
        key = (chan, tag)
        # the wire expectation: encoded size under a codec (the sender
        # posts exactly this — one arithmetic, codec.encoded_nbytes),
        # the decoded size otherwise; LG routing follows the wire size
        wire_nbytes = (codec.encoded_nbytes(nbytes, dtype.itemsize)
                       if codec is not None else nbytes)
        lg = wire_nbytes >= self.LG_MIN
        if lg:
            self._lg_ensure(comm)  # the LG rendezvous step 1
        t0 = _verb_entry("irecv_into", tag=tag, nbytes=wire_nbytes,
                         chan=chan)
        frame_kind = "frame-landed" if combine is None else "frame-combined"
        label = None  # resolved lazily at first consume (registry lookup)

        def consume(src_u8, length: int) -> None:
            # land or fold `src_u8` (uint8 array view of the arrived bytes)
            # into the destination — the ONE write of the zero-copy path
            nonlocal label
            if codec is not None:
                # decode-and-fold straight out of the wire buffer (the
                # codec validates the frame against the expectation and
                # refuses named on mismatch); the decode+fold cost is
                # this frame's compute-fold share under a sampled span
                if _trace.tracing():
                    f0 = time.perf_counter()
                    codec.decode_fold(src_u8[:length], dest, dtype, combine)
                    fold = time.perf_counter() - f0
                else:
                    codec.decode_fold(src_u8[:length], dest, dtype, combine)
                    fold = 0.0
            elif combine is None:
                dest[:length] = src_u8
                fold = 0.0
            elif _trace.tracing():
                # sampled op: the fold's own cost feeds the causal
                # tracer's compute-fold bucket (two perf_counter reads
                # per frame, paid only under a sampled span)
                f0 = time.perf_counter()
                d = dest[:length].view(dtype)
                combine(d, src_u8.view(dtype), out=d)
                fold = time.perf_counter() - f0
            else:
                d = dest[:length].view(dtype)
                combine(d, src_u8.view(dtype), out=d)
                fold = 0.0
            if label is None:
                label = comm._label(chan)
            _WIRE.streamed(nbytes=length, channel=label)
            # one irecv_into request is one wire frame, so this event IS
            # the frame's landing slice (post->consume as dur): the trace
            # lane the acceptance check counts against frames_streamed;
            # under a sampled op span it is additionally stamped
            # (epoch, chan, op) — the causal tracer's hop landings
            _verb_done("irecv_into", t0, tag=tag, nbytes=length)
            if fold > 0.0:
                _trace.record(frame_kind, tag=tag, nbytes=length,
                              dur=time.perf_counter() - t0, fold=fold)
            else:
                _trace.record(frame_kind, tag=tag, nbytes=length,
                              dur=time.perf_counter() - t0)

        def probe():
            with comm._lock:
                if comm._lg_ack_queue:  # credit deferred by earlier probe
                    self._lg_flush_acks(comm)
                ready = comm._unexpected.get(key)
                if not ready:
                    comm._pump()
                    ready = comm._unexpected.get(key)
                if not ready:
                    return False, 0, None
                payload = ready.pop(0)
                if not ready:
                    del comm._unexpected[key]
                desc = self._lg_descriptor(payload, lg)
                if desc is not None:
                    # put descriptor: bytes already sit in my arena —
                    # consume them through the zero-copy view (ordering
                    # per read_mr_view's caveat: the descriptor frame
                    # arrived through the fenced ring AFTER the sender's
                    # put), then return the credit
                    offset, length = desc
                    consume(self.read_mr_view(comm, comm._lg_mr, offset,
                                              length), length)
                    self._lg_credit(comm, length)
                    return True, length, None
                n = len(payload)
                consume(np.frombuffer(payload, np.uint8), n)
                comm._recycle(payload)
                return True, n, None
        return Request(_test=probe)

    # -- one-sided verbs (optional capability; see NetProperties.one_sided) --

    def alloc_mr(self, comm: _HostComm, nbytes: int):
        """Allocate + register an ``nbytes`` one-sided-accessible region on
        this comm's QP (``ibv_reg_mr``). Ship ``.rkey`` to the peer out of
        band (e.g. over isend); the owner touches content via ``.read`` /
        ``.write``."""
        return comm.qp.reg_mr(nbytes)

    @staticmethod
    def _post_backpressured(comm: _HostComm, post, what: str,
                            timeout_s: float, progress) -> int:
        """Retry ``post()`` until it yields a wr_id, pumping this comm (and
        the caller's ``progress`` hook — other comms must keep draining or
        two mutually-sending ranks deadlock) while backpressured."""
        deadline = time.monotonic() + timeout_s
        back = _Backoff()
        while True:
            # the post attempt and its slot-freeing pump hold the comm
            # lock (concurrent lane threads post on one QP); the pause
            # and the caller's progress hook run UNLOCKED so other lanes
            # — and other comms' pumps — keep moving while we wait
            with comm._lock:
                wr = post()
                if wr >= 0:
                    return wr
                comm._pump()
            if progress is not None:
                progress()
            if time.monotonic() >= deadline:
                raise TimeoutError(f"host net: {what} backpressured, peer stalled")
            back.pause()

    def iwrite(self, comm: _HostComm, rkey: int, mr: memoryview,
               offset: int = 0, timeout_s: float = 10.0,
               progress=None) -> Request:
        """One-sided put of ``mr`` into the peer MR named by ``rkey``: no
        peer receive, no peer CQE — the soft-NIC applies it. Backpressure
        handling mirrors :meth:`isend` (``progress`` keeps other comms
        draining). ``mr`` passes to the native layer ZERO-COPY (writable
        buffers borrow via from_buffer; the native planes copy
        synchronously during the post call)."""
        size = memoryview(mr).nbytes
        t0 = _verb_entry("iwrite", nbytes=size, offset=offset)
        wr = self._post_backpressured(
            comm, lambda: comm.qp.post_rdma_write(rkey, mr, offset),
            "one-sided write", timeout_s, progress)
        return _traced_request(
            "iwrite", t0,
            Request(_test=lambda: self._onesided_probe(comm, wr, size, None)))

    def iread(self, comm: _HostComm, rkey: int, nbytes: int,
              offset: int = 0, timeout_s: float = 10.0,
              progress=None) -> Request:
        """One-sided get from the peer MR; the completed Request's payload
        carries the fetched bytes."""
        into = bytearray(nbytes)
        t0 = _verb_entry("iread", nbytes=nbytes, offset=offset)
        wr = self._post_backpressured(
            comm, lambda: comm.qp.post_rdma_read(rkey, into, offset),
            "one-sided read", timeout_s, progress)
        return _traced_request(
            "iread", t0,
            Request(_test=lambda: self._onesided_probe(comm, wr, nbytes, into)))

    def read_mr_local(self, comm: _HostComm, mr, offset: int,
                      nbytes: int) -> bytes:
        """Read the OWNER's view of its own MR with peer writes visible.
        shm plane: a local fenced copy through the QP (the arena is shared,
        so the acquire fence pairs with the writer's release)."""
        return comm.qp.rdma_read(mr.rkey, nbytes, offset)

    def read_mr_view(self, comm: _HostComm, mr, offset: int, nbytes: int):
        """ZERO-COPY owner read of an MR window (uint8 numpy view over the
        shared mapping). No fence of its own: callers must order it after
        a fenced doorbell read (see ``MemoryRegion.view``'s caveat) and
        consume before releasing the protocol window that guards the
        bytes. The bulk-data fast path of the put-based rings."""
        return mr.view(offset, nbytes)

    @staticmethod
    def _onesided_probe(comm: _HostComm, wr: int, size: int, into):
        with comm._lock:
            if wr not in comm._onesided_done:
                comm._pump()
            if wr not in comm._onesided_done:
                return False, 0, None
            status = comm._onesided_done[wr]
            if status is not None:
                # terminal: leave the record so a retried test()/wait()
                # re-raises the real error instead of spinning to a
                # misleading timeout
                raise OSError(
                    f"host net: one-sided op denied (status {status})")
            del comm._onesided_done[wr]
        return True, size, bytes(into) if into is not None else None

    def close_comm(self, comm: _HostComm) -> None:
        comm.close()
        # deregister: an elastic group closes comms mid-life (heal's ring
        # repair, p2p teardown) — left in the registry they would pile up
        # across heals and every later set_epoch would pump dead handles
        try:
            self._comms.remove(comm)
        except ValueError:
            pass  # already deregistered (double close is legal)

    def close(self) -> None:
        for c in self._comms:
            c.close()
        self._comms.clear()


class TCPNet(HostQPNet):
    """The host-plane vtable over TCP queue pairs (``native/rtcp.cpp``) —
    the cross-host wire. Handles are ``"host:port"`` strings, dialable from
    any machine that can route to the listener; everything above the QP
    (tag matching, ``_HostComm``, the gloo-analogue collectives) is shared
    with the shm plane verbatim, the way the reference's net plugin served
    both loopback and RDMA NICs through one vtable.
    """

    PLANE = "tcp"  # own wire-model key: tcp's alpha/beta are its own

    def __init__(self):
        super().__init__()
        self._listeners = []

    def get_properties(self, dev: int = 0) -> NetProperties:
        return NetProperties(name="tcp-qp", plane="host", max_comms=1 << 16,
                             max_inflight=1 << 10, byte_oriented=True,
                             one_sided=True, recv_into=True)

    def listen(self, dev: int = 0, capacity: int = 1 << 20,
               mr_capacity: int = 64 << 20):
        """-> (handle "host:port", listener). ``capacity`` and
        ``mr_capacity`` are accepted for vtable-signature parity with the
        shm plane and unused (TCP's tx bound is the fixed 64 MiB rtcp
        queue cap, not a ring size; TCP MRs are heap buffers sized at
        ``reg_mr`` time, not carved from a pre-sized arena)."""
        from rocnrdma_tpu_torch import native
        assert self._inited, "call init() first"
        listener = native.TcpListener()
        self._listeners.append(listener)
        return listener.handle, listener

    def connect(self, dev: int, handle: str, timeout_s: float = 10.0) -> _HostComm:
        from rocnrdma_tpu_torch import native
        assert self._inited, "call init() first"
        t0 = _verb_entry("connect", plane="tcp")
        comm = _HostComm(native.TcpQueuePair.connect(handle, timeout_s), net=self)
        self._comms.append(comm)
        _verb_done("connect", t0, plane="tcp")
        return comm

    def accept(self, listener, timeout_s: float = 10.0) -> _HostComm:
        t0 = _verb_entry("accept", plane="tcp")
        comm = _HostComm(listener.accept(timeout_s), net=self)
        self._comms.append(comm)
        _verb_done("accept", t0, plane="tcp")
        return comm

    def read_mr_local(self, comm: _HostComm, mr, offset: int,
                      nbytes: int) -> bytes:
        """TCP plane: MRs are conn-local heap buffers and peer writes apply
        inside OUR progress engine — pump, then read directly (a
        ``comm.qp.rdma_read`` here would go over the wire to the PEER's MR
        table, which is a different region)."""
        comm._pump()
        return mr.read(offset, nbytes)

    def read_mr_view(self, comm: _HostComm, mr, offset: int, nbytes: int):
        """TCP plane zero-copy owner read: pump (peer writes land in our
        progress engine), then view the conn-local MR storage directly."""
        comm._pump()
        return mr.view(offset, nbytes)

    def close(self) -> None:
        super().close()
        for l in self._listeners:
            l.close()
        self._listeners.clear()


# ---------------------------------------------------------------------------
# Device plane: the vtable over mesh point-to-point
# ---------------------------------------------------------------------------


class DeviceMeshNet:
    """The vtable shape over one rank-major tensor on the mesh's device.

    ``listen``/``connect``/``accept`` reduce to naming a (src, dst) rank
    pair — every rank is a row of one tensor, already "connected".
    ``reg_mr`` places an ``(n_ranks, ...)`` array or tensor on the mesh's
    device (rows = ranks). One isend/irecv pair is one row copy: the
    output is zeros, except that row ``dst`` holds row ``src`` — what the
    reference's single-pair ``ppermute`` gives. ``test`` is a CUDA event
    query (complete at once on the CPU).
    """

    def __init__(self, mesh=None):
        from rocnrdma_tpu_torch.runtime.mesh import (RANK_AXIS,
                                                     detect_topology,
                                                     rank_mesh)
        self.mesh = (mesh if mesh is not None
                     else rank_mesh(detect_topology().n_devices))
        if self.mesh.axis_names != (RANK_AXIS,):
            raise ValueError("DeviceMeshNet runs on a 1-D rank mesh")
        self.axis = self.mesh.axis_names[0]
        self.n_ranks = self.mesh.n_ranks
        self.device = self.mesh.device
        self._inited = False

    def init(self) -> None:
        self._inited = True

    def devices(self) -> int:
        return self.n_ranks

    def get_properties(self, dev: int = 0) -> NetProperties:
        return NetProperties(name=f"mesh-p2p[{dev}]", plane="device",
                             max_comms=self.n_ranks * (self.n_ranks - 1),
                             max_inflight=1, byte_oriented=False)

    def listen(self, dev: int):
        """-> (handle, listen_comm): the handle names the receiving rank."""
        assert self._inited, "call init() first"
        return f"rank:{dev}", dev

    def connect(self, dev: int, handle: str):
        """-> send_comm: the (src, dst) pair this comm will copy over."""
        assert self._inited, "call init() first"
        dst = int(handle.split(":", 1)[1])
        return (dev, dst)

    def accept(self, listen_comm: int):
        return listen_comm

    def reg_mr(self, comm, array):
        """Lay the buffer out on the mesh's device: (n_ranks, ...) one row
        per rank. A numpy array is copied in; a tensor on another device
        raises (no silent change of device)."""
        import torch
        if array.shape[0] != self.n_ranks:
            raise ValueError(
                f"leading dim must be n_ranks={self.n_ranks}, got "
                f"{tuple(array.shape)}")
        if isinstance(array, torch.Tensor):
            if array.device != self.device:
                raise ValueError(f"reg_mr: tensor on {array.device}, mesh "
                                 f"on {self.device}")
            return array
        return torch.from_numpy(np.ascontiguousarray(array)).to(self.device)

    def isend(self, send_comm, mr, tag: int = 0, timeout_s: float = 10.0,
              progress=None) -> Request:
        # timeout_s/progress accepted for signature parity with the host
        # plane; the copy is enqueued on the device's stream, so there is
        # no backpressure to pump
        import torch
        src, dst = send_comm
        if not (0 <= src < self.n_ranks and 0 <= dst < self.n_ranks):
            raise ValueError(f"pair ({src}, {dst}) outside {self.n_ranks} "
                             f"ranks")
        out = torch.zeros_like(mr)
        out[dst].copy_(mr[src])
        event = None
        if out.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        return self._request(out, event)

    def irecv(self, recv_comm, in_flight: Request, tag: int = 0) -> Request:
        # one copy serves both ends: the transfer was enqueued by isend;
        # recv observes it
        return in_flight

    def _request(self, out, event) -> Request:
        def probe():
            if event is not None and not event.query():
                return False, 0, None
            return True, out.numel() * out.element_size(), out
        return Request(_test=probe)

    def test(self, req: Request):
        return req.test()

    def close(self) -> None:
        pass


# ---------------------------------------------------------------------------
# Collectives riding the vtable (the way RCCL rides the net plugin)
# ---------------------------------------------------------------------------


class _RingWire:
    """One rank's view of the ring for a single collective call: byte-level
    ``exchange`` over the vtable verbs, with per-hop tag namespacing and
    frame chunking to the plugin's limit.

    ``send_comm`` reaches rank ``(rank+1) % n``; ``recv_comm`` hears rank
    ``(rank-1) % n``. Tags are ``(hop << 16) | frame_index`` — identical on
    both ends because every rank executes the same hop sequence.

    ``progress`` overrides the default extra progress hook (the recv comm's
    pump) used while sends backpressure/flush — p2p tx wires slot a
    plane-wide engine here. ``timeout_s`` bounds every blocking wait in an
    exchange (request waits, send backpressure, tx flush).
    """

    def __init__(self, net, send_comm, recv_comm, progress=None,
                 timeout_s: float = 30.0, peers: tuple | None = None,
                 world: int | None = None):
        self.net = net
        self.send_comm = send_comm
        self.recv_comm = recv_comm
        self.progress = progress
        self.timeout_s = timeout_s
        # (send_peer_rank, recv_peer_rank) when the caller knows them (the
        # ring collectives do; p2p wires name the one peer twice): what a
        # stalled hop's postmortem NAMES, turning "net request timed out"
        # into "recv hop 3 frame 2 peer rank 1"
        self.peers = peers
        # ring size when the caller knows it (the ring collectives pass
        # n_ranks; p2p wires leave it None): a wire-model pick input —
        # depth is bounded by the hops a ring of this size can pipeline
        self.world = world
        # the committed host wire model: per-call picks of
        # frame_bytes / pipeline_depth / LG-vs-frame cutover replace the
        # static negotiated constants below. None on planes without one
        # (the device mesh) — those keep the legacy static frame.
        self._model = getattr(net, "wire_model", None)
        # LG-capable planes (the host QP nets) take ring hops in LG_CHUNK
        # units — isend auto-routes those over the put path, one native
        # bulk copy per hop; everything else chunks at the frame
        self._base_frame = (getattr(net, "LG_CHUNK", None)
                            or getattr(net, "MAX_FRAME", (1 << 16) - 4))
        # the zero-copy receive verb, gated on the plane's ADVERTISED
        # recv_into capability (NetProperties) — not a bare getattr, which
        # a delegating wrapper like FaultNet would satisfy even over an
        # inner plane that lacks the verb (e.g. the device mesh)
        try:
            caps = net.get_properties(0)
        except Exception:
            caps = None
        self._recv_into = (getattr(net, "irecv_into", None)
                           if getattr(caps, "recv_into", False) else None)
        self._hops = itertools.count(1)

    @property
    def frame(self) -> int:
        """The wire chunk, resolved at USE time: the plane's base frame
        capped at the CURRENT lane context's ``credit_bytes`` — a paced
        lane's wire quantum is its credit, bounding how long any single
        post (and the comm lock / native copy under it) can hold the
        wire from a higher-priority lane. Resolved per call rather than
        frozen at construction because p2p wires are CACHED per (peer,
        direction) and may be created under one lane's context then
        carry another lane's stream (first-contact wiring, heal-time
        resume rebuilds): both ends of a stream run its posts under the
        stream's OWN lane context (the verbs and the resume paths
        guarantee it), so call-time resolution is what keeps the two
        ends' frame sizes — and hence frame indices and wire tags — in
        agreement. The default lane has no credit and keeps the full
        quantum."""
        f = self._base_frame
        credit = self._lane_credit()
        if credit:
            f = max(1, min(f, credit))
        return f

    def _lane_credit(self) -> int | None:
        """The CURRENT lane context's pacing credit (None unpaced) —
        the lane half of every pick's input (both ring ends run a
        stream's posts under the stream's own lane context, so the two
        ends resolve the same credit)."""
        reg = getattr(self.net, "lanes", None)
        lane = (reg.get(_lanes.current_channel())
                if reg is not None else None)
        return lane.credit_bytes if lane is not None else None

    def _resolve_codec(self, size_key, dtype):
        """The stream's wire codec, or None uncompressed — negotiated
        through the size_key like every other wire parameter: a PURE
        function of (the lane's ``codec=`` knob, the shared dtype, the
        cross-rank-identical size_key, world, committed model version),
        so both ends of every hop chunk AND decode identically with no
        wire negotiation. The lane knob "auto" resolves through the
        committed model's ``pick_codec`` (off on cheap-beta planes, on
        for the slow leg); non-floating dtypes pass through
        uncompressed on both ends (the shared-dtype rule); planes
        without the recv_into capability keep the uncompressed wire
        (capability is uniform across a ring, so the ends agree)."""
        reg = getattr(self.net, "lanes", None)
        lane = (reg.get(_lanes.current_channel())
                if reg is not None else None)
        name = lane.codec if lane is not None else None
        if name is None or self._recv_into is None:
            return None
        from rocnrdma_tpu_torch.transport import codec as _codec
        if not _codec.WireCodec.supports(dtype):
            return None
        if name == "auto":
            if self._model is None or size_key is None:
                return None
            name = self._model.pick_codec(
                int(size_key), np.dtype(dtype).itemsize,
                world=self.world or 2)
            # verdict-only conformance note: the codec pick's cost
            # rides the stream's priced note; here only the verdict
            # coverage is recorded
            _conformance.note_pick(
                self._model.plane, "codec", size_key=int(size_key),
                world=self.world or 2, version=self._model.version,
                sched=name or "off")
            if name is None:
                return None
        return _codec.get(name)

    def _pick(self, nbytes: int):
        """The wire model's per-call pick for a message/hop of
        ``nbytes`` on this plane — pure function of (nbytes, world,
        lane credit, committed model version), so both ends of an edge
        derive the same frame from the same message size and their
        frame tags agree. None on model-less planes (legacy static
        framing)."""
        if self._model is None:
            return None
        return self._model.pick(nbytes, world=self.world or 2,
                                credit_bytes=self._lane_credit())

    def _tag(self, hop: int, nbytes: int, frame: int | None = None):
        """The (hop, frame-index) tag packer — the ONE definition of the
        wire tag layout, shared by exchange, stream, and the non-blocking
        p2p. ``frame`` overrides the wire's default chunking (the
        streaming mode's dtype-aligned frame)."""
        frame = self.frame if frame is None else frame
        n_frames = -(-nbytes // frame)
        if n_frames >= (1 << 16):
            raise ValueError(
                f"{n_frames} frames in one message overflows the 16-bit "
                f"frame-index tag field (> ~4 GB); chunk at the caller")
        return lambda fi: (hop << 16) | fi

    def _stall(self, direction: str, hop: int, frame, exc) -> TimeoutError:
        """A wire wait timed out: record the stall, dump the flight
        postmortem, and return the enriched TimeoutError for the caller
        to raise — the hang-triage half of the observability story. The
        enriched message (and the postmortem header) name the hop, frame
        index, and peer rank the time went to; the last-N event dump
        shows what the wire was doing on the way in."""
        peer = None
        if self.peers is not None:
            peer = self.peers[0 if direction in ("send", "flush") else 1]
        peer_s = "?" if peer is None else peer
        _FLIGHT.record("stall", dir=direction, hop=hop,
                       frame="?" if frame is None else frame, peer=peer_s)
        reason = (f"ring wire stalled: {direction} hop {hop} "
                  f"frame {'?' if frame is None else frame} "
                  f"peer rank {peer_s}")
        _postmortem(reason)
        return TimeoutError(f"{reason} ({exc})")

    def _aligned_frame(self, itemsize: int) -> int:
        """The streaming frame size: the wire frame rounded DOWN to a whole
        number of ``itemsize``-byte elements, so every frame can be folded
        in the buffer's own dtype the moment it lands. Both ring ends
        compute it from the same (dtype, wire) pair, so tags agree."""
        it = max(1, int(itemsize))
        return max(it, self.frame - self.frame % it)

    def queue_send(self, out: np.ndarray, hop: int, progress=None,
                   frame: int | None = None, first_frame: int = 0,
                   codec=None, dtype=None,
                   commit_into: np.ndarray | None = None,
                   payload0: bytes | None = None) -> None:
        """Queue ``out`` (uint8) as chunked frames on the send comm (may
        pump under backpressure; does NOT flush — callers flush or drain).
        ``frame`` overrides the chunking (streaming mode). ``first_frame``
        is the stream-resume cursor: frames below it were already
        fence-acknowledged by the receiver in an earlier epoch, so a
        resumed p2p send re-queues only the tail — frame INDICES (and so
        wire tags) are preserved, which is what lets the receiver's
        re-posted tail receives match. ``codec`` (with its ``dtype``)
        quantizes each frame before the post (the streaming codec's
        send half): frame indices and tags still run over the DECODED
        layout — only the posted payload shrinks — so the receiver's
        codec-aware ``irecv_into`` expectations match by construction.
        ``commit_into``: optional uint8 buffer (same layout as ``out``)
        receiving each frame's DECODED quantized image — the
        exchange-and-fold schedule points it at the fold destination,
        so both ends start their fold from the SAME on-grid values
        (the §5k cross-rank-bitwise rule for the degenerate 2-rank
        hop)."""
        tag = self._tag(hop, len(out), frame)
        frame = self.frame if frame is None else frame
        if codec is not None and commit_into is not None:
            # two phases: EVERY frame's quantized image commits into
            # the fold destination BEFORE any post — a post may pump
            # the progress engine, and a peer frame folding into a
            # destination frame not yet committed would be overwritten
            # by the late commit (the encoded payloads are materialized
            # because the per-thread encode scratch only survives to
            # the next encode)
            payloads = []
            for fi, off in enumerate(range(0, len(out), frame)):
                if fi < first_frame:
                    payloads.append(None)
                    continue
                seg = np.ascontiguousarray(out[off:off + frame])
                payloads.append(bytes(codec.encode(
                    seg.view(dtype),
                    commit=commit_into[off:off + seg.nbytes].view(dtype))))
                _WIRE.encoded(saved=seg.nbytes - len(payloads[-1]))
            for fi, payload in enumerate(payloads):
                if payload is None:
                    continue
                self.net.isend(self.send_comm,
                               self.net.reg_mr(self.send_comm, payload),
                               tag=tag(fi), timeout_s=self.timeout_s,
                               progress=progress)
            return
        for fi, off in enumerate(range(0, len(out), frame)):
            if fi < first_frame:
                continue
            seg = np.ascontiguousarray(out[off:off + frame])
            if codec is not None:
                # frame 0 may ride the caller's pre-built payload (the
                # EF layer's stash, matched by the STREAM against this
                # exact burst — byte-identical to what encode would
                # produce, the §5k idempotency rule, so results cannot
                # depend on which path ran)
                payload = payload0 if fi == 0 and payload0 is not None                     else codec.encode(seg.view(dtype))
                _WIRE.encoded(saved=seg.nbytes - len(payload))
            else:
                payload = seg
            self.net.isend(self.send_comm,
                           self.net.reg_mr(self.send_comm, payload),
                           tag=tag(fi), timeout_s=self.timeout_s,
                           progress=progress)

    def post_recvs(self, nbytes: int, hop: int, into=None,
                   first_frame: int = 0, frame: int | None = None) -> list:
        """Post the chunked frame receives for an ``nbytes`` inbound
        message; returns ``[(offset, nbytes, Request), ...]`` to drain.
        ``into``: optional uint8 destination ndarray — on nets with the
        ``recv_into`` capability every frame lands there directly and the
        drained Request carries payload None (zero staging copies).
        ``first_frame``: the stream-resume cursor — frames below it
        already landed in ``into`` before the stream's epoch was fenced,
        so a resumed receive posts only the missing tail (same frame
        indices, hence same wire tags as the sender's resumed
        ``queue_send``). ``frame`` overrides the chunking (the tuner's
        per-message pick; the sender derives the same value from the
        same message size, so tags agree)."""
        tag = self._tag(hop, nbytes, frame)
        frame = self.frame if frame is None else frame
        recv_into = self._recv_into if into is not None else None
        reqs = []
        for fi, off in enumerate(range(0, nbytes, frame)):
            if fi < first_frame:
                continue
            nb = min(frame, nbytes - off)
            if recv_into is not None:
                req = recv_into(self.recv_comm, into[off:off + nb],
                                tag=tag(fi))
            else:
                req = self.net.irecv(self.recv_comm, nb, tag=tag(fi))
            reqs.append((off, nb, req))
        return reqs

    def exchange(self, out: np.ndarray, in_nbytes: int,
                 hop: int | None = None) -> np.ndarray:
        """One ring hop: send ``out`` (uint8) right, receive ``in_nbytes``
        from the left. Directions are framed independently (they may differ
        in length with uneven chunking).

        ``hop`` defaults to this wire's call counter — correct whenever every
        rank makes the same sequence of exchange calls (allreduce, allgather,
        alltoall). Schedules where ranks make DIFFERENT call sequences (the
        pipelined broadcast: root only sends, relays recv+forward) must pass
        an explicit hop so tags agree per ring edge."""
        if hop is None:
            hop = next(self._hops)
        # the non-streaming path frames PER MESSAGE from the wire model
        # (depth 1 — no cross-hop pipeline): each direction's frame is a
        # pure function of that message's byte count, which both ends
        # know exactly (sender: len(out); receiver: in_nbytes), so the
        # two ends' chunking — and hence frame tags — agree with no
        # negotiation. One constraint the stream path does not have:
        # exchange carries the ROOTED verbs' one-directional sends, and
        # a >= LG_MIN message's put-path rendezvous (arena announce +
        # credit) is what couples the sender's completion to the
        # receiver's liveness — the uniform-abort property the rooted
        # self-heal retry depends on (a frame-path send would queue and
        # commit against a dead peer). So the pick tunes the frame size
        # WITHIN the message's path and never moves a >= LG_MIN message
        # off the put path; the path rule is message-size-intrinsic, so
        # both ends still agree. Recorded so wire_stats()/bench records
        # name the pick on this path too (gauge: last exchange wins).
        out_pick = self._pick(len(out)) if len(out) else None
        in_pick = self._pick(in_nbytes) if in_nbytes else None
        credit = self._lane_credit()

        def keep_path(pick, nbytes):
            if pick is None:
                return None
            f = pick.frame_bytes
            if self._model is not None and nbytes >= self._model.lg_min \
                    and (not credit or credit >= self._model.lg_min):
                # the lane's pacing credit outranks path preservation:
                # a paced lane's wire quantum is its credit (the QoS
                # bound), and a credit below LG_MIN already rode the
                # frame path pre-tuner — same cap, same semantics
                f = max(f, self._model.lg_min)
            return f
        out_frame = keep_path(out_pick, len(out))
        in_frame = keep_path(in_pick, in_nbytes)
        # the gauge records the frame the wire ACTUALLY posts (the
        # keep_path-adjusted value — the fit corpus and the picks
        # column read this, so a pick that was path-bumped must not
        # masquerade as the raw model output)
        shown_frame = in_frame if in_frame is not None else out_frame
        shown = in_pick or out_pick
        _WIRE.negotiated(
            shown_frame if shown_frame is not None else self.frame, 1,
            shown.version if shown is not None else None)
        if shown is not None:
            # the conformance note for the non-streaming hop: one hop
            # of the larger direction at the (path-preserved) frame,
            # depth 1 — the schedule this path actually runs
            nb = max(in_nbytes, len(out))
            _conformance.note_pick(
                self._model.plane, "exchange", size_key=nb,
                world=self.world or 2, version=shown.version,
                sched=f"{(shown_frame or self.frame) // 1024}K/d1",
                predicted_s=self._model.hop_time(
                    nb, shown_frame or self.frame, 1))
        got = np.empty(in_nbytes, np.uint8)
        # queue all chunked irecvs — landing straight in ``got`` on
        # recv_into-capable nets — then the isends, then drain; the plugin
        # pumps receives while a send backpressures, so no deadlock
        reqs = self.post_recvs(in_nbytes, hop, into=got, frame=in_frame)
        # progress engine: while our send ring is full, keep draining the
        # comm our inbound data arrives on, or two mutually-sending ranks
        # stall each other. The net's group-level hook (the p2p resume
        # service — ProcessGroup sets net._progress_hook) rides every
        # blocking loop too: a rank blocked in a collective must still
        # answer its interrupted p2p streams' resume protocol.
        hook = getattr(self.net, "_progress_hook", None)
        pump = _with_hook(self.progress if self.progress is not None
                          else getattr(self.recv_comm, "_pump", None),
                          hook)

        def send_progress():
            # also CONSUME the inbound frames that have landed: a pump only
            # stashes a put-path descriptor, and the arena credit it holds
            # returns to our left neighbour when the receive is tested. A
            # hop whose second put waits for credit, on every rank of the
            # ring at once, waits on a neighbour that is itself in this
            # loop: without the tests nobody's credit comes back (a
            # 4-rank 16 MiB alltoall could stall so; ROADMAP Queue 3)
            if pump is not None:
                pump()
            for _, _, r in reqs:
                r.test()

        try:
            self.queue_send(out, hop, send_progress, frame=out_frame)
        except TimeoutError as e:
            raise self._stall("send", hop, 0, e) from e
        # Wait for the inbound frames WHILE keeping our own outbound
        # flowing. A hop larger than the kernel socket buffers leaves the
        # tail of our frames in the user-space tx queue; the peer cannot
        # feed us until it drains us and vice versa, so a wait that only
        # pumps the recv comm deadlocks symmetrically (observed at 16 MB
        # hops: both ranks time out with MBs stuck in their send queues).
        send_pump = _with_hook(getattr(self.send_comm, "_pump", None), hook)
        for fi, (off, nb, r) in enumerate(reqs):
            try:
                payload = r.wait(timeout_s=self.timeout_s,
                                 progress=send_pump)
            except TimeoutError as e:
                raise self._stall("recv", hop, fi, e) from e
            if payload is not None:  # legacy plane: stage the copy out
                got[off:off + nb] = np.frombuffer(payload, np.uint8)
                _WIRE.copied(nb)
        # Symmetric tail: a rank whose receives all completed early may
        # still hold queued tx that nothing would otherwise flush — the
        # peer would time out on frames we believe are sent. Flushing
        # cannot deadlock: the peer always drains its inbound socket.
        try:
            _flush_tx(self.send_comm, self.timeout_s, extra_pump=pump,
                      what="ring hop: peer stopped draining")
        except TimeoutError as e:
            raise self._stall("flush", hop, None, e) from e
        return got

    def stream(self, first_send: np.ndarray, hops: list, dtype,
               timeout_s: float | None = None,
               size_key: int | None = None,
               commit_first_into: np.ndarray | None = None) -> None:
        """Pipelined multi-hop engine — the zero-copy streaming mode of the
        ring collectives. ``hops`` is one ``(dest, combine)`` pair per ring
        hop: ``dest`` is that hop's inbound destination as a uint8 view of
        the caller's buffer; ``combine`` is None (land the bytes — the
        allgather-style hops) or a reduce ufunc (fold them into ``dest``
        in ``dtype`` — the reduce-scatter-style hops). The engine relies on
        the chain property every ring schedule here satisfies: hop k+1
        SENDS hop k's completed ``dest`` (hop 0 sends ``first_send``), so

        - hop k+1's receives are posted while hop k's tail frames drain
          (double buffering across hops),
        - frame f of hop k+1's send is queued the moment frame f of hop k
          is consumed (frame-granular pipelining), and
        - each frame is reduced the instant its transfer completes, via
          ``irecv_into``'s in-place fold — combine compute overlaps wire
          transfer, and the steady state stages zero payload copies and
          allocates nothing (comm receive pool).

        Every blocking point uses ``consume_progress``, which besides
        pumping CONSUMES ready inbound frames in post order (their probes
        fold in place and return large-message credit) — a rank blocked
        queueing its next hop keeps acking its predecessor, so symmetric
        rings whose hop size approaches the LG arena cannot mutually
        starve. Nets without the ``recv_into`` capability fall back to
        sequential per-hop :meth:`exchange` calls (the capability is
        uniform across a ring, so both ends take the same path and tags
        agree).

        ``size_key``: the tuner's pick key — the stream's LARGEST hop
        payload, as a value every rank of the ring derives identically
        (max chunk size from (buffer bytes, n) for the balanced verbs,
        max(counts) for the ragged ones — the collectives own the
        arithmetic). The committed wire model resolves frame_bytes and
        the posting-window depth from it per call; None (p2p wires,
        model-less planes) keeps the legacy static frame. Cross-rank
        frame agreement is the load-bearing property: ONE frame serves
        the whole stream, every rank derives it from the same
        (size_key, lane, model version), so every edge's tags match."""
        t = self.timeout_s if timeout_s is None else timeout_s
        H = len(hops)
        # consume the EF layer's hints FIRST, unconditionally — on
        # every exit path of this stream, including the fallback and
        # the no-op, a stale mark or payload stash must be dead (a
        # stash surviving into a later send would ship a previous
        # collective's bytes)
        input_committed = _wire_codec.take_input_committed()
        stash = _wire_codec.take_stash()
        if H == 0:
            return
        if self._recv_into is None:
            send = first_send
            for dest, combine in hops:
                got = self.exchange(send, dest.nbytes)
                if combine is None:
                    dest[:] = got
                else:
                    d = dest.view(dtype)
                    combine(d, got.view(dtype), out=d)
                send = dest
            return
        # ONE frame for the whole stream (a comm is one FIFO — per-hop
        # re-framing buys no parallelism, only tag disagreement), sized
        # by the committed wire model when the caller gave a pick key,
        # else the legacy plane default; always rounded DOWN to a whole
        # number of dtype elements so every frame folds in place
        it = np.dtype(dtype).itemsize
        pick = self._pick(size_key) if size_key is not None else None
        if pick is not None:
            frame = max(it, pick.frame_bytes - pick.frame_bytes % it)
            # the posting window: how many hops ahead receives are
            # posted. 2 is the engine's structural double buffer (the
            # legacy depth); the model only ever deepens it, and a ring
            # of H hops cannot pipeline deeper than H.
            depth = max(1, min(pick.pipeline_depth, H))
        else:
            frame = self._aligned_frame(it)
            depth = 2 if H > 1 else 1
        # the stream's wire codec , negotiated through the
        # same size_key as the frame: every rank derives the same
        # (codec, frame, depth) triple from the same pure inputs, so
        # the sender's encoded posts and the receiver's codec-aware
        # expectations agree on every edge with no handshake
        codec = self._resolve_codec(size_key, dtype)
        if codec is not None:
            # the picked frame is a WIRE quantum (the model prices
            # per-post alpha and posted bytes); under a codec each
            # post carries ``itemsize`` decoded bytes per wire byte,
            # so the DECODED window scales by the ratio — same wire
            # bytes per post as the pick intended, 1/ratio as many
            # posts per hop. Both ends derive the same scaled frame
            # from the same (pick, dtype), so tags still agree.
            frame *= it
        # the negotiated wire parameters, recorded where they are chosen
        # (gauges on WIRE -> wire_stats()/bench records) so a throughput
        # regression is attributable to the frame choice — and to the
        # model version that chose it
        _WIRE.negotiated(frame, depth,
                         pick.version if pick is not None else None,
                         codec=codec.name if codec is not None else None)
        # the ring neighbours ride the event (up = who our inbound
        # frames come from, down = who we forward to): the cross-rank
        # edges of the causal trace need no wire-format change — frames
        # already name their peer here
        up = self.peers[1] if self.peers is not None else None
        down = self.peers[0] if self.peers is not None else None
        _trace.record("stream-start", hops=H, frame=frame, depth=depth,
                      up=up, down=down,
                      codec=codec.name if codec is not None else None)
        if pick is not None:
            # the conformance note: what the committed model
            # PREDICTED this stream would cost — H hops at the picked
            # (frame, depth), priced by the same hop formula the pick
            # minimized — recorded against the op span so the measured
            # wall can judge the model at commit. One thread-local
            # read on unsampled ops; never a copy, never store traffic.
            _conformance.note_pick(
                self._model.plane, "stream", size_key=size_key,
                world=self.world or 2, version=pick.version,
                sched=f"{frame // 1024}K/d{depth}",
                predicted_s=H * self._model.hop_time(size_key, frame,
                                                     depth))
        hop_nos = [next(self._hops) for _ in range(H)]
        pending = collections.deque()  # posted recv Requests, arrival order
        send_pump = getattr(self.send_comm, "_pump", None)
        recv_pump = (self.progress if self.progress is not None
                     else getattr(self.recv_comm, "_pump", None))
        hook = getattr(self.net, "_progress_hook", None)

        def consume_progress():
            # keep our outbound flowing AND consume ready inbound frames
            # in order (an empty-handed head probe pumps the recv comm
            # itself, so inbound keeps landing either way); the net's
            # group-level hook (p2p resume service) gets its turn too —
            # a rank blocked streaming a collective must still answer
            # its interrupted p2p streams
            if send_pump is not None:
                send_pump()
            while pending and pending[0].test()[0]:
                pending.popleft()
            if not pending and recv_pump is not None:
                recv_pump()
            if hook is not None:
                hook()

        def post_hop(k):
            dest, combine = hops[k]
            tagf = self._tag(hop_nos[k], dest.nbytes, frame)
            reqs = []
            for fi, off in enumerate(range(0, dest.nbytes, frame)):
                nb = min(frame, dest.nbytes - off)
                r = self._recv_into(self.recv_comm, dest[off:off + nb],
                                    tag=tagf(fi), combine=combine,
                                    dtype=dtype, codec=codec)
                _trace.record("frame-posted", hop=hop_nos[k], frame=fi,
                              nbytes=nb)
                reqs.append((off, nb, r))
                pending.append(r)
            return reqs

        posted = [None] * H
        for j in range(min(depth, H)):
            posted[j] = post_hop(j)  # the posting window: hops 1..depth-1's
            #                          receives are live before hop 0
            #                          starts draining (depth 2 = the
            #                          classic cross-hop double buffer)
        # hop 0's outbound is known up front: queue the whole burst
        # (``commit_first_into``: the exchange-and-fold schedule's
        # write-back of the quantized image into its fold destination —
        # meaningful only under a codec, and SKIPPED when the EF layer
        # already quantization-committed the input: the write-back
        # would reproduce the destination byte-for-byte at the cost of
        # a full pass and the two-phase post ordering)
        commit0 = (commit_first_into
                   if codec is not None and not input_committed else None)
        # the EF layer's pre-built hop-0 payload applies only when it
        # describes EXACTLY this burst: same decoded bytes, same dtype,
        # single frame (a multi-frame burst re-encodes per frame; the
        # popped stash then simply dies with this stream)
        payload0 = None
        if codec is not None and stash is not None \
                and stash[0] == len(first_send) \
                and stash[1] == np.dtype(dtype).str \
                and len(first_send) <= frame:
            payload0 = stash[2]
        try:
            self.queue_send(first_send, hop_nos[0], consume_progress,
                            frame=frame, codec=codec, dtype=dtype,
                            commit_into=commit0, payload0=payload0)
        except TimeoutError as e:
            raise self._stall("send", hop_nos[0], 0, e) from e
        if _trace.tracing():
            # sampled op: when each hop's frames were handed to the
            # wire (the causal tracer splits a critical-path segment
            # at this point — sender-side hold vs wire+receiver)
            _trace.record("frame-sent", hop=hop_nos[0], frame=0)
        blocked = True  # nothing precedes frame 0: its arrival is not overlap
        for k in range(H):
            # keep the posting window full: hops k..k+depth-1 posted
            # before hop k drains (depth 1 degenerates to post-on-entry)
            for j in range(k, min(k + depth, H)):
                if posted[j] is None:
                    posted[j] = post_hop(j)
            dest = hops[k][0]
            nxt_tag = (self._tag(hop_nos[k + 1], dest.nbytes, frame)
                       if k + 1 < H else None)
            for fi, (off, nb, r) in enumerate(posted[k]):
                if r.test()[0]:
                    # complete before we first looked — genuine overlap
                    # only if we did real work (consume + send queueing)
                    # since the last blocking wait; frames that merely
                    # piled up while we were blocked on a predecessor
                    # would overstate the pipeline
                    if not blocked:
                        _WIRE.overlapped()
                    blocked = False
                else:
                    # sampled op: the BLOCKED portion of this wait is
                    # the recv-wait bucket of the causal attribution
                    # (the frame's own dur spans post->consume, which
                    # includes time we spent productively elsewhere)
                    t_w = (time.perf_counter() if _trace.tracing()
                           else None)
                    try:
                        r.wait(timeout_s=t, progress=consume_progress)
                    except TimeoutError as e:
                        raise self._stall("recv", hop_nos[k], fi, e) from e
                    if t_w is not None:
                        _trace.record("recv-wait", hop=hop_nos[k],
                                      frame=fi,
                                      dur=time.perf_counter() - t_w)
                    blocked = True
                if nxt_tag is not None:
                    # this frame of dest is final: it IS frame f of the
                    # next hop's outbound — queue it while our later
                    # frames are still in flight (re-encoded under the
                    # stream's codec: the frame was decoded into dest,
                    # so the forward re-quantizes the folded values —
                    # deterministic, and lossless for already-quantized
                    # allgather-phase chunks per the codec's idempotent
                    # power-of-two scale rule)
                    seg = dest[off:off + nb]
                    if codec is not None:
                        # a FOLD hop's forward is where fresh values
                        # first meet the codec: commit the quantized
                        # image locally too (encode's one-pass commit
                        # write-back), so this rank's copy of the
                        # reduced chunk is byte-identical to what every
                        # downstream rank decodes (the cross-rank-
                        # bitwise rule of §5k; land hops already hold
                        # the decoded image, and the idempotent pow2
                        # scale makes their re-encode lossless)
                        v = seg.view(dtype)
                        payload = codec.encode(
                            v, commit=v if hops[k][1] is not None
                            else None)
                        _WIRE.encoded(saved=seg.nbytes - len(payload))
                    else:
                        payload = seg
                    try:
                        self.net.isend(self.send_comm,
                                       self.net.reg_mr(self.send_comm,
                                                       payload),
                                       tag=nxt_tag(fi), timeout_s=t,
                                       progress=consume_progress)
                    except TimeoutError as e:
                        raise self._stall("send", hop_nos[k + 1], fi,
                                          e) from e
                    if _trace.tracing():
                        _trace.record("frame-sent", hop=hop_nos[k + 1],
                                      frame=fi)
            posted[k] = None
        try:
            _flush_tx(self.send_comm, t, extra_pump=consume_progress,
                      what="ring stream: peer stopped draining")
        except TimeoutError as e:
            raise self._stall("flush", hop_nos[-1], None, e) from e


def _with_hook(base, hook):
    """Compose a comm pump with the net's group-level progress hook
    (either may be None) into one progress callable — the ONE
    definition of the composition the ring wire's blocking loops use
    (the hook is how a rank blocked in a collective keeps serving its
    interrupted p2p streams' resume protocol)."""
    if hook is None:
        return base
    if base is None:
        return hook

    def pump():
        base()
        hook()
    return pump


def _as_bytes(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a).view(np.uint8).ravel()


def exchange_fold_preferred(model, nbytes: int,
                            credit_bytes: int | None = None) -> bool:
    """Whether a 2-rank allreduce of ``nbytes`` should run as ONE
    whole-buffer exchange-and-fold instead of the generic two
    half-buffer hops: the committed wire model prices both schedules
    and the cheaper one wins (ties keep the generic ring). High-alpha
    planes (tcp: the per-hop floor dominates) take the single hop;
    cheap-alpha planes (shm) keep the pipelined halves. PURE function
    of (nbytes, lane credit, committed model version) — both ends
    derive the same schedule, so their hop tags agree; model-less
    planes (and the sweep's ``ROCNRDMA_WIRE_XFOLD=0`` pin) keep the
    generic ring."""
    if model is None or not getattr(model, "exchange_fold", True):
        return False
    half = -(-nbytes // 2)
    p1 = model.pick(nbytes, world=2, credit_bytes=credit_bytes)
    p2 = model.pick(half, world=2, credit_bytes=credit_bytes)
    t1 = model.hop_time(nbytes, p1.frame_bytes, p1.pipeline_depth)
    t2 = 2.0 * model.hop_time(half, p2.frame_bytes, p2.pipeline_depth)
    # a modeled >= 10% win, not a bare tie: the generic ring keeps the
    # frame-granular cross-hop pipeline the single hop gives up, which
    # the hop model does not price — near-tie verdicts go to the
    # schedule whose behavior the committed tables were measured on
    return t1 < 0.9 * t2


def _prefer_exchange_fold(wire: "_RingWire", nbytes: int) -> bool:
    verdict = exchange_fold_preferred(wire._model, nbytes,
                                      wire._lane_credit())
    if wire._model is not None:
        # verdict-only conformance note (no priced cost — the chosen
        # schedule's stream prices itself at its own pick site)
        _conformance.note_pick(
            wire._model.plane, "xfold", size_key=nbytes,
            world=2, version=wire._model.version,
            sched="fold" if verdict else "ring")
    return verdict


def allreduce_size_key(model, elems: int, itemsize: int, n: int,
                       credit_bytes: int | None = None) -> int:
    """THE size_key a ring allreduce's stream will negotiate under —
    one definition shared with the error-feedback layer, so a lane's
    ``codec="auto"`` resolves to the SAME verdict at the collective
    boundary (where EF decides whether to run) and inside the wire
    (where frames decide whether to encode). Pure function of its
    inputs and the committed model version, like the picks it feeds."""
    nbytes = elems * itemsize
    if n == 2 and exchange_fold_preferred(model, nbytes, credit_bytes):
        return nbytes
    return max(elems * (i + 1) // n - elems * i // n
               for i in range(max(2, n))) * itemsize


def _pipeline_chunks(nbytes: int, frame: int, n: int) -> int:
    """Chunk count for the pipelined rooted schedules (broadcast, chain
    reduce): enough chunks that relaying overlaps with the next chunk's
    arrival, capped at the rank count. Every rank on an edge MUST compute
    the same value — hop tags are per chunk — so both schedules share this
    one formula."""
    return max(1, min(n, nbytes // max(1, frame) + 1))


def ring_allreduce_over_net(net, send_comm, recv_comm, local: np.ndarray,
                            rank: int, n_ranks: int,
                            op: str = "sum",
                            timeout_s: float = 30.0) -> np.ndarray:
    """Host-plane ring allreduce built ONLY from the vtable verbs.

    Classic two-phase schedule — (n-1) reduce-scatter steps then (n-1)
    allgather steps over the ring, reducing (``op``: sum/prod/max/min) in
    the input's own dtype (like every sibling here — pre-cast yourself if
    you want fp32 accumulation). This is the proof the vtable carries
    collectives, and doubles as the cross-process gloo-analogue oracle path.
    """
    x = np.array(local, copy=True).ravel()
    n = n_ranks
    if n == 1:
        return x.reshape(np.shape(local))
    combine = _NET_REDUCE_OPS[op]  # KeyError = unknown op, caller's bug
    wire = _RingWire(net, send_comm, recv_comm, timeout_s=timeout_s,
                     peers=((rank + 1) % n, (rank - 1) % n), world=n)
    flat = _as_bytes(x)
    if n == 2 and _prefer_exchange_fold(wire, x.nbytes):
        # the 2-rank degenerate ring: the generic schedule's two
        # SEQUENTIAL half-buffer hops (reduce-scatter + allgather)
        # move the same total bytes as ONE full-duplex whole-buffer
        # exchange-and-fold — but pay the per-hop latency floor twice.
        # Whether one big hop or two pipelined half-hops wins is a
        # plane property (tcp's per-hop cost dwarfs shm's), so the
        # committed wire model arbitrates (_prefer_exchange_fold — a
        # pure function of (bytes, committed version), so both ends
        # run the same schedule). One hop: both ends queue their
        # whole buffer, then fold the peer's frames into it on
        # arrival. Bitwise-identical to the generic schedule: every
        # element is mine ⊕ peer's, and IEEE folds are commutative,
        # so the operand order difference cannot change a single bit.
        # The outbound is the CALLER's buffer (read-only — the fold
        # lands in the private working copy ``x``): send source and
        # fold destination must not alias, because a backpressured
        # send's progress hook consumes ready inbound frames, and a
        # fold landing ahead of the send cursor would corrupt frames
        # not yet copied out. Reading ``local`` directly (instead of
        # a second private copy) is retry-safe for the same reason
        # the entry copy exists: nothing here writes it. Under a
        # codec, ``commit_first_into`` writes the outbound's quantized
        # image into the fold destination first, so both ends fold
        # Q(mine) + Q(peer's) — bitwise-identical results even for
        # inputs not already on the quantization grid.
        wire.stream(_as_bytes(np.asarray(local)).ravel(),
                    [(flat, combine)], x.dtype, size_key=x.nbytes,
                    commit_first_into=flat)
        return x.reshape(np.shape(local))
    bounds = [len(x) * i // n for i in range(n + 1)]
    chunk = lambda i: x[bounds[i % n]:bounds[i % n + 1]]
    # ONE pipelined 2(n-1)-hop stream: the n-1 reduce-scatter hops (fold
    # each frame on arrival) chained straight into the n-1 allgather hops
    # (land each frame on arrival). Hop k+1 always sends hop k's completed
    # chunk — including across the phase boundary (the last reduce hop
    # lands chunk rank+1 fully reduced, which IS the first allgather
    # send) — so frames flow continuously from first send to last landing.
    hops = [(_as_bytes(chunk(rank - k - 1)), combine) for k in range(n - 1)]
    hops += [(_as_bytes(chunk(rank - k)), None) for k in range(n - 1)]
    # tuner pick key: the largest chunk — a pure function of (len(x), n),
    # so every rank derives the same frame and the ring's tags agree
    wire.stream(_as_bytes(chunk(rank)), hops, x.dtype,
                size_key=max(chunk(i).nbytes for i in range(n)))
    return x.reshape(np.shape(local))


_NET_REDUCE_OPS = {"sum": np.add, "prod": np.multiply,
                   "max": np.maximum, "min": np.minimum}


def _stream_reduce_scatter(wire: "_RingWire", chunk, rank: int, n: int,
                           dtype, combine) -> None:
    """The -1-shifted streaming reduce chain — the ONE definition of its
    offset arithmetic, shared by the dense and ragged reduce-scatter verbs
    (chunk bounds differ, the schedule does not): hop k sends
    chunk(rank-k-1) and folds the arrival into chunk(rank-k-2); after n-1
    hops chunk(rank) is fully reduced on this rank."""
    hops = [(_as_bytes(chunk(rank - k - 2)), combine) for k in range(n - 1)]
    # pick key: the largest chunk — identical on every rank (the chunk
    # layout is shared, floor-balanced or counts-derived alike)
    wire.stream(_as_bytes(chunk(rank - 1)), hops, dtype,
                size_key=max(chunk(i).nbytes for i in range(n)))


def ring_reduce_scatter_over_net(net, send_comm, recv_comm,
                                 local: np.ndarray, rank: int,
                                 n_ranks: int, op: str = "sum",
                                 timeout_s: float = 30.0) -> np.ndarray:
    """Ring reduce-scatter over the verbs: every rank contributes ``local``
    (all ranks the same shape/dtype; flattened and split into n
    floor-balanced element ranges) and gets back the fully-reduced range
    ``r`` as a flat array — standard reduce-scatter semantics, composable
    with ``ring_allgather_over_net``. The first phase of the allreduce,
    exposed standalone for sharded-optimizer (ZeRO/FSDP-style) host paths.
    """
    x = np.array(local, copy=True).ravel()
    n = n_ranks
    if n == 1:
        return x
    combine = _NET_REDUCE_OPS[op]  # KeyError = unknown op, caller's bug
    wire = _RingWire(net, send_comm, recv_comm, timeout_s=timeout_s,
                     peers=((rank + 1) % n, (rank - 1) % n), world=n)
    bounds = [len(x) * i // n for i in range(n + 1)]
    chunk = lambda i: x[bounds[i % n]:bounds[i % n + 1]]
    _stream_reduce_scatter(wire, chunk, rank, n, x.dtype, combine)
    return np.array(chunk(rank), copy=True)


def _flush_tx(comm, timeout_s: float, extra_pump=None,
              what: str = "peer stopped draining") -> None:
    """Pump until ``comm``'s user-space tx queue is empty. A send CQE means
    "handed to the kernel", but with the kernel buffer full the tail stays
    in user space — and a caller that stops touching the comm after its own
    receives complete would strand it, starving the peer. No-op on comms
    without a tx queue (shm plane, device plane)."""
    tx_pending = (getattr(comm.qp, "tx_pending", None)
                  if hasattr(comm, "qp") else None)
    if tx_pending is None:
        return
    deadline = time.monotonic() + timeout_s
    back = _Backoff()
    while tx_pending() > 0:
        comm._pump()
        if extra_pump is not None:
            extra_pump()
        if time.monotonic() >= deadline:
            raise TimeoutError(f"tx flush: {what}; bytes still queued "
                               f"after {timeout_s}s")
        back.pause()


_RDMA_SETUP_TAG = 0x52444D41  # "RDMA": rkey-exchange tag namespace


def _rdma_ring_state(net, send_comm, recv_comm, cap: int):
    """Per-connection one-sided ring state, cached on the recv comm.

    Layout of MY inbound data MR (registered on recv_comm, written by the
    predecessor): ``[slot0: cap][slot1: cap][flag0: 8][flag1: 8]`` — the
    writer puts a chunk into slot h%2 then puts the hop number h into
    flag h%2 (same connection, so the data write is visible before the
    doorbell). MY credit MR (on send_comm, written by the successor) holds
    the last hop number the successor consumed; with 2 slots the writer
    stalls until ``consumed >= h - 2`` before reusing a slot.

    MR registration is bump-allocated for the connection's life, so the
    state is cached per (comm pair, capacity) and capacities round up to a
    power of two — re-registration happens only on growth.
    """
    cap = 1 << max(6, (cap - 1).bit_length())  # pow2, >= 64 B
    state = getattr(recv_comm, "_rdma_ring", None)
    if state is not None and state["cap"] >= cap:
        return state
    data_mr = net.alloc_mr(recv_comm, 2 * cap + 16)
    credit_mr = net.alloc_mr(send_comm, 8)
    req = net.irecv(send_comm, 8, tag=_RDMA_SETUP_TAG)
    net.isend(recv_comm,
              net.reg_mr(recv_comm, data_mr.rkey.to_bytes(8, "little")),
              tag=_RDMA_SETUP_TAG)
    peer_data_rkey = int.from_bytes(req.wait(), "little")
    req = net.irecv(recv_comm, 8, tag=_RDMA_SETUP_TAG)
    net.isend(send_comm,
              net.reg_mr(send_comm, credit_mr.rkey.to_bytes(8, "little")),
              tag=_RDMA_SETUP_TAG)
    peer_credit_rkey = int.from_bytes(req.wait(), "little")
    state = {"cap": cap, "data_mr": data_mr, "credit_mr": credit_mr,
             "peer_data_rkey": peer_data_rkey,
             "peer_credit_rkey": peer_credit_rkey, "hop": 0}
    recv_comm._rdma_ring = state
    return state


def _rdma_ring_io(net, send_comm, recv_comm, cap: int, timeout_s: float):
    """The put/take engine shared by every put-based ring collective:
    returns ``(st, put, take, ack, finish)``. ``put(hop, buf)`` writes a
    chunk (zero-copy: numpy slices pass straight to the native post) into
    the successor's slot ``hop % 2`` and rings the doorbell;
    ``take(hop, nbytes)`` polls the predecessor's doorbell and returns a
    ZERO-COPY view of the slot — the caller consumes it (in-place
    combine / copy-out) and only then calls ``ack(hop)``, which releases
    the credit letting the predecessor overwrite the slot (acking before
    consuming would race the view against the next write, which is why
    the ack is no longer inside take). ``finish(hop)`` persists the hop
    counter and flushes both comms' queued tx (a fast rank must not exit
    holding a slow rank's last hop in its user-space queue — observed at
    16 MB: rank 0 finishes correct in 0.13 s, rank 1 times out on the
    doorbell with 3.2 MB stranded in rank 0's send queue). The caller
    runs the phase loops."""

    from rocnrdma_tpu_torch.native import fence_acquire as _fence_acquire

    st = _rdma_ring_state(net, send_comm, recv_comm, cap)
    cap = st["cap"]
    data_mr, credit_mr = st["data_mr"], st["credit_mr"]
    send_pump = getattr(send_comm, "_pump", None)
    recv_pump = getattr(recv_comm, "_pump", None)
    pending: list = []  # outstanding one-sided Requests, probed in waits

    def probe_pending() -> None:
        # surfaces a remote ERR_REMOTE denial (raised by test()) instead of
        # letting it rot in the CQE cache until a misleading timeout
        pending[:] = [r for r in pending if not r.test()[0]]

    def put(hop: int, out) -> None:
        # wait for slot credit, then data -> slot, doorbell -> flag.
        # BOTH comms must pump while waiting: our own ACK to the
        # predecessor may still sit in the recv comm's tx queue, and if
        # every rank waits for credit while pumping only its send comm,
        # no ACK ever flushes and the ring deadlocks globally.
        deadline = time.monotonic() + timeout_s
        back = _Backoff()
        while hop > 2:
            consumed = int.from_bytes(
                net.read_mr_local(send_comm, credit_mr, 0, 8), "little")
            if consumed >= hop - 2:
                break
            if recv_pump is not None:
                recv_pump()
            probe_pending()
            if time.monotonic() >= deadline:
                raise TimeoutError("rdma ring: successor stopped consuming")
            back.pause()
        slot = hop % 2
        pending.append(net.iwrite(send_comm, st["peer_data_rkey"],
                                  memoryview(out), offset=slot * cap))
        pending.append(net.iwrite(send_comm, st["peer_data_rkey"],
                                  hop.to_bytes(8, "little"),
                                  offset=2 * cap + 8 * slot))
        if _trace.tracing():
            # sampled op: when this hop's chunk was handed to the wire
            # (the causal tracer's hold/xfer split point, the put-ring
            # twin of the streaming engine's frame-sent)
            _trace.record("frame-sent", hop=hop, frame=0)

    def take(hop: int, nbytes: int) -> np.ndarray:
        slot = hop % 2
        t0 = time.perf_counter()
        deadline = time.monotonic() + timeout_s
        back = _Backoff()
        while True:
            flag = int.from_bytes(
                net.read_mr_local(recv_comm, data_mr, 2 * cap + 8 * slot, 8),
                "little")
            if flag == hop:
                break
            if send_pump is not None:  # keep our own outbound flowing
                send_pump()
            probe_pending()
            if time.monotonic() >= deadline:
                raise TimeoutError("rdma ring: predecessor's doorbell never rang")
            back.pause()
        # acquire AFTER the matching flag load, BEFORE the raw view loads:
        # the fenced read above orders the flag load itself, not the view
        # reads that follow it — without this fence a weakly-ordered CPU
        # could pair flag==hop with pre-doorbell slot bytes (pairs with
        # the writer's release fence in rqp_rdma_write)
        _fence_acquire()
        # the put-ring's landing event (ROADMAP: critical paths
        # skipped the put rings because they record no irecv_into frame
        # events): one doorbell hop is one frame, and under a sampled op
        # span this is the hop landing the cross-rank assembler chains
        _trace.record("frame-landed", hop=hop, nbytes=nbytes,
                      dur=time.perf_counter() - t0)
        return net.read_mr_view(recv_comm, data_mr, slot * cap, nbytes)

    def ack(hop: int) -> None:
        # credit: predecessor may now reuse (overwrite) the slot — callers
        # must have fully consumed take()'s view first
        pending.append(net.iwrite(recv_comm, st["peer_credit_rkey"],
                                  hop.to_bytes(8, "little"), offset=0))
        # the consume side of the landing above: the slot's view has
        # been folded/copied out and the credit released — the flight
        # timeline's proof of WHEN the predecessor was unblocked
        _trace.record("frame-consumed", hop=hop)

    def finish(hop: int) -> None:
        st["hop"] = hop
        for comm in (send_comm, recv_comm):
            _flush_tx(comm, timeout_s,
                      what="rdma ring: peer stopped draining at exit")

    return st, put, take, ack, finish


def _rdma_stream_start(rank: int, n: int, hops: int, cap: int) -> None:
    """The put-ring's stream-start span site: one record per rdma
    collective naming the ring neighbours (up = the predecessor whose
    doorbell we poll, down = the successor whose MR we put into) — the
    cross-rank edges the causal tracer chains put-ring hop landings
    along, exactly like the streaming engine's stream-start."""
    _trace.record("stream-start", hops=hops, frame=cap, depth=2,
                  up=(rank - 1) % n, down=(rank + 1) % n)


def _chunk_layout(x: np.ndarray, n: int):
    """Floor-balanced n-way element ranges of a flat buffer: the chunk
    accessor (index mod n) and the largest chunk's byte size (the slot
    capacity). One definition for the whole rdma family — the layout must
    agree across collectives sharing a connection's MR state."""
    bounds = [len(x) * i // n for i in range(n + 1)]
    chunk = lambda i: x[bounds[i % n]:bounds[i % n + 1]]
    cap = max(chunk(i).nbytes for i in range(n))
    return chunk, cap


def _rdma_reduce_phase(put, take, ack, chunk, x, rank: int, n: int, hop: int,
                       shift: int = 0, op: str = "sum") -> int:
    """The n-1 doorbell reduce hops in place (the put/take twin of the msg
    plane's streaming reduce chain): at step k, put chunk ``rank - k +
    shift``, combine the taken chunk into ``rank - k - 1 + shift``. Returns
    the advanced hop counter. shift=0 is the allreduce layout; shift=-1
    lands chunk r fully reduced on rank r. The combine reads take()'s
    zero-copy slot view in place; the credit ack only goes out after."""
    combine = _NET_REDUCE_OPS[op]
    for k in range(n - 1):
        hop += 1
        send_i, recv_i = rank - k + shift, rank - k - 1 + shift
        put(hop, chunk(send_i))
        incoming = take(hop, chunk(recv_i).nbytes)
        combine(chunk(recv_i), incoming.view(x.dtype), out=chunk(recv_i))
        ack(hop)
    return hop


def ring_allreduce_rdma(net, send_comm, recv_comm, local: np.ndarray,
                        rank: int, n_ranks: int, op: str = "sum",
                        timeout_s: float = 30.0) -> np.ndarray:
    """Ring allreduce whose DATA PATH is one-sided RDMA writes.

    The put-based ring of real RDMA transports: each hop writes its chunk
    straight into the successor's registered MR, then writes the hop number
    as a doorbell flag; the receiver polls the flag, consumes, and writes a
    credit back into the predecessor's MR so slots recycle safely (2-slot
    double buffering). No posted receives and no recv CQEs on the data
    path — only the one-time rkey exchange uses send/recv. Works on both
    host planes: shm (direct memcpy through the shared arena, fenced) and
    TCP (soft-NIC frames applied by the target's progress engine).
    """
    x = np.array(local, copy=True).ravel()
    n = n_ranks
    if n == 1:
        return x.reshape(np.shape(local))
    chunk, cap = _chunk_layout(x, n)
    st, put, take, ack, finish = _rdma_ring_io(net, send_comm, recv_comm,
                                               cap, timeout_s)
    _rdma_stream_start(rank, n, 2 * (n - 1), cap)
    hop = _rdma_reduce_phase(put, take, ack, chunk, x, rank, n, st["hop"],
                             op=op)
    for k in range(n - 1):  # allgather phase
        hop += 1
        send_i, recv_i = rank + 1 - k, rank - k
        put(hop, chunk(send_i))
        incoming = take(hop, chunk(recv_i).nbytes)
        chunk(recv_i)[:] = incoming.view(x.dtype)
        ack(hop)
    finish(hop)
    return x.reshape(np.shape(local))


def ring_reduce_scatter_rdma(net, send_comm, recv_comm, local: np.ndarray,
                             rank: int, n_ranks: int, op: str = "sum",
                             timeout_s: float = 30.0) -> np.ndarray:
    """Reduce-scatter on the put-based one-sided data path: the -1-shifted
    reduce phase of :func:`ring_allreduce_rdma` alone (rank r ends with the
    fully-reduced range r), same doorbell/credit wire protocol."""
    x = np.array(local, copy=True).ravel()
    n = n_ranks
    if n == 1:
        return x
    chunk, cap = _chunk_layout(x, n)
    st, put, take, ack, finish = _rdma_ring_io(net, send_comm, recv_comm,
                                               cap, timeout_s)
    _rdma_stream_start(rank, n, n - 1, cap)
    # shift=-1: chunk r lands fully reduced on rank r
    hop = _rdma_reduce_phase(put, take, ack, chunk, x, rank, n, st["hop"],
                             shift=-1, op=op)
    finish(hop)
    return np.array(chunk(rank), copy=True)


def ring_allgather_rdma(net, send_comm, recv_comm, local: np.ndarray,
                        rank: int, n_ranks: int,
                        timeout_s: float = 30.0) -> np.ndarray:
    """Allgather on the put-based one-sided data path: n-1 hops circulating
    whole blocks through the successor's MR slots (doorbell + credit, no
    posted receives). Returns ``(n, *local.shape)`` in rank order."""
    block = np.ascontiguousarray(local)
    n = n_ranks
    out = np.empty((n,) + block.shape, block.dtype)
    out[rank] = block
    if n == 1:
        return out
    st, put, take, ack, finish = _rdma_ring_io(net, send_comm, recv_comm,
                                               block.nbytes, timeout_s)
    _rdma_stream_start(rank, n, n - 1, block.nbytes)
    hop = st["hop"]
    for k in range(n - 1):
        hop += 1
        send_i = (rank - k) % n
        recv_i = (rank - k - 1) % n
        put(hop, out[send_i])
        incoming = take(hop, block.nbytes)
        out[recv_i] = incoming.view(block.dtype).reshape(block.shape)
        ack(hop)
    finish(hop)
    return out


def ring_allgather_over_net(net, send_comm, recv_comm, local: np.ndarray,
                            rank: int, n_ranks: int,
                            timeout_s: float = 30.0) -> np.ndarray:
    """Ring allgather over the verbs: every rank contributes ``local`` (all
    ranks the same shape/dtype) and receives ``(n, *local.shape)`` in rank
    order. n-1 hops, each circulating one rank's block."""
    block = np.ascontiguousarray(local)
    n = n_ranks
    out = np.empty((n,) + block.shape, block.dtype)
    out[rank] = block
    if n == 1:
        return out
    wire = _RingWire(net, send_comm, recv_comm, timeout_s=timeout_s,
                     peers=((rank + 1) % n, (rank - 1) % n), world=n)
    # pipelined: hop k lands origin (rank-k-1)'s block STRAIGHT into its
    # output row, and that row is hop k+1's outbound — frame f forwards
    # the moment it arrives, no per-hop staging buffer
    hops = [(_as_bytes(out[(rank - k - 1) % n]), None) for k in range(n - 1)]
    # pick key: one block — every hop moves exactly one (same-shape) block
    wire.stream(_as_bytes(out[rank]), hops, block.dtype,
                size_key=block.nbytes)
    return out


def ring_broadcast_over_net(net, send_comm, recv_comm, local: np.ndarray,
                            rank: int, n_ranks: int, root: int = 0,
                            timeout_s: float = 30.0) -> np.ndarray:
    """Chunked pipelined ring broadcast: the root pushes chunks rightward;
    every rank forwards as it receives (the bandwidth-optimal non-tree
    broadcast for a ring wire). Non-root ``local`` supplies shape/dtype."""
    n = n_ranks
    _check_root(root, n)
    if n == 1:
        return np.array(local, copy=True)
    wire = _RingWire(net, send_comm, recv_comm, timeout_s=timeout_s,
                     peers=((rank + 1) % n, (rank - 1) % n), world=n)
    # non-root contents are irrelevant: only shape/dtype matter, so skip the
    # payload-sized copy and zero-fill there; root sends from a byte view
    flat = (_as_bytes(local) if rank == root
            else np.empty(local.nbytes, np.uint8))
    # chunk the payload so forwarding pipelines: rank r starts relaying chunk
    # c while chunk c+1 is still inbound upstream
    n_chunks = _pipeline_chunks(local.nbytes, wire.frame, n)
    bounds = [local.nbytes * i // n_chunks for i in range(n_chunks + 1)]
    last = (rank - root) % n == n - 1  # ring tail: do not forward
    for c in range(n_chunks):
        lo, hi = bounds[c], bounds[c + 1]
        # every edge carries chunk c exactly once -> hop c+1 is unique per
        # edge even though ranks make different call sequences
        if rank == root:
            wire.exchange(flat[lo:hi], 0, hop=c + 1)
        else:
            incoming = wire.exchange(np.empty(0, np.uint8), hi - lo, hop=c + 1)
            flat[lo:hi] = incoming
            if not last:
                wire.exchange(flat[lo:hi], 0, hop=c + 1)
    if rank != root:
        return flat.view(local.dtype).reshape(local.shape)
    return np.array(local, copy=True)


def _check_root(root: int, n: int) -> None:
    # modular index arithmetic below would otherwise WRAP an out-of-range
    # root and silently deliver the result to the wrong rank
    if not 0 <= root < n:
        raise ValueError(f"root {root} out of range for {n} ranks")


def ring_reduce_over_net(net, send_comm, recv_comm, local: np.ndarray,
                         rank: int, n_ranks: int, root: int = 0,
                         op: str = "sum",
                         timeout_s: float = 30.0) -> np.ndarray | None:
    """Rooted reduce over the verbs: every rank contributes ``local`` (same
    shape/dtype everywhere); only ``root`` gets the reduced result (others
    return None — non-root outputs are undefined in the reference API too).

    Chunked pipelined CHAIN reduce — the time-reversal of the pipelined ring
    broadcast: partials flow ringward toward the root, each rank combining
    its own contribution before forwarding, chunked so rank r relays chunk c
    while chunk c+1 is still inbound upstream. Each non-root ring edge
    carries every chunk exactly once, so per-chunk hop tags agree per edge
    even though ranks make different call sequences.
    """
    n = n_ranks
    _check_root(root, n)
    if n == 1:
        return np.array(local, copy=True)
    combine = _NET_REDUCE_OPS[op]  # KeyError = unknown op, caller's bug
    acc = np.array(local, copy=True).ravel()
    wire = _RingWire(net, send_comm, recv_comm, timeout_s=timeout_s,
                     peers=((rank + 1) % n, (rank - 1) % n), world=n)
    d = (root - rank) % n  # my hop distance to the root (0 = root)
    n_chunks = _pipeline_chunks(acc.nbytes, wire.frame, n)
    bounds = [acc.size * i // n_chunks for i in range(n_chunks + 1)]
    for c in range(n_chunks):
        lo, hi = bounds[c], bounds[c + 1]
        seg = acc[lo:hi]
        if d < n - 1:  # everyone but the chain head hears upstream first
            incoming = wire.exchange(np.empty(0, np.uint8), seg.nbytes,
                                     hop=c + 1)
            combine(seg, incoming.view(acc.dtype), out=seg)
        if d > 0:  # everyone but the root forwards its partial
            wire.exchange(_as_bytes(seg), 0, hop=c + 1)
    if rank != root:
        return None
    return acc.reshape(np.shape(local))


def ring_gather_over_net(net, send_comm, recv_comm, local: np.ndarray,
                         rank: int, n_ranks: int,
                         root: int = 0,
                         timeout_s: float = 30.0) -> np.ndarray | None:
    """Rooted gather over the verbs: every rank contributes ``local`` (same
    shape/dtype everywhere); ``root`` returns ``(n, *local.shape)`` in rank
    order, others return None.

    A gather IS a ragged alltoall where only the root's column is non-empty,
    so this rides :func:`ring_alltoallv_over_net`'s train schedule: each
    block travels its ring distance to the root and is relayed by the ranks
    between — no global-max padding, no extra machinery."""
    block = np.ascontiguousarray(local)
    n = n_ranks
    _check_root(root, n)
    counts = np.zeros((n, n), np.int64)
    counts[:, root] = block.size
    segs = [block.ravel() if j == root else np.empty(0, block.dtype)
            for j in range(n)]
    out = ring_alltoallv_over_net(net, send_comm, recv_comm, segs, counts,
                                  rank, n, dtype=block.dtype,
                                  timeout_s=timeout_s)
    if rank != root:
        return None
    return np.stack([o.reshape(block.shape) for o in out])


def ring_scatter_over_net(net, send_comm, recv_comm, local: np.ndarray,
                          rank: int, n_ranks: int,
                          root: int = 0,
                          timeout_s: float = 30.0) -> np.ndarray:
    """Rooted scatter over the verbs: ``root`` passes ``(n, ...)`` — row j
    goes to rank j; every other rank passes a TEMPLATE of one row's
    shape/dtype (contents ignored — it sizes the receive, the reference
    API's recvbuff role). Every rank returns its row.

    The ragged-alltoall dual of :func:`ring_gather_over_net`: only the
    root's ROW of the count matrix is non-empty."""
    n = n_ranks
    _check_root(root, n)
    buf = np.ascontiguousarray(local)
    if rank == root:
        if buf.shape[0] != n:
            raise ValueError(f"scatter root wants (n, ...), got {buf.shape}")
        row_shape, dtype, row_size = buf.shape[1:], buf.dtype, buf[0].size
        segs = [np.ascontiguousarray(buf[j]).ravel() for j in range(n)]
    else:
        row_shape, dtype, row_size = buf.shape, buf.dtype, buf.size
        segs = [np.empty(0, dtype) for _ in range(n)]
    counts = np.zeros((n, n), np.int64)
    counts[root, :] = row_size
    out = ring_alltoallv_over_net(net, send_comm, recv_comm, segs, counts,
                                  rank, n, dtype=dtype,
                                  timeout_s=timeout_s)
    return out[root].reshape(row_shape)


def ring_alltoallv_over_net(net, send_comm, recv_comm, segments: list,
                            counts: np.ndarray, rank: int, n_ranks: int,
                            dtype=np.float32,
                            timeout_s: float = 30.0) -> list:
    """Variable-count alltoall (the RCCL ``ncclAllToAllv`` extension beyond
    stock NCCL): rank r sends ``segments[j]`` — ``counts[r, j]`` elements —
    to rank j and receives ``counts[src, rank]`` elements from every src.
    ``counts`` is the full (n, n) element-count matrix, known on every rank
    (the MPI alltoallv contract), so only actual bytes travel — no padding
    to a global max. Returns the n received segments in source order
    (``out[rank]`` is the local segment).

    Same train schedule as :func:`ring_alltoall_over_net`, with ragged
    cars: every rank launches its n-1 outbound segments in travel order;
    at hop s the arriving train originated at rank-s, its head car is
    addressed to us (``counts[rank-s, rank]`` elements), and the rest is
    forwarded. Each hop's train length is computable from ``counts`` alone.
    """
    n = n_ranks
    dtype = np.dtype(dtype)
    counts = np.asarray(counts, dtype=np.int64)
    if counts.shape != (n, n):
        raise ValueError(f"counts must be ({n}, {n}), got {counts.shape}")
    if len(segments) != n:
        raise ValueError(f"need {n} segments, got {len(segments)}")
    segs = [np.ascontiguousarray(s, dtype=dtype).ravel() for s in segments]
    for j, seg in enumerate(segs):
        if seg.size != counts[rank, j]:
            raise ValueError(
                f"segment {j} has {seg.size} elements, "
                f"counts[{rank}, {j}] says {counts[rank, j]}")
    out: list = [None] * n
    out[rank] = segs[rank].copy()
    if n == 1:
        return out
    wire = _RingWire(net, send_comm, recv_comm, timeout_s=timeout_s,
                     peers=((rank + 1) % n, (rank - 1) % n), world=n)
    isz = dtype.itemsize
    train = np.concatenate(
        [_as_bytes(segs[(rank + off) % n]) for off in range(1, n)])
    for s in range(1, n):
        o = (rank - s) % n  # the arriving train's origin
        in_bytes = int(sum(counts[o, (o + off) % n]
                           for off in range(s, n))) * isz
        incoming = wire.exchange(train, in_bytes)
        head = int(counts[o, rank]) * isz
        out[o] = incoming[:head].view(dtype).copy()
        train = incoming[head:]  # forward the rest at the next hop
    return out


def ring_allgatherv_over_net(net, send_comm, recv_comm, local: np.ndarray,
                             counts, rank: int, n_ranks: int,
                             timeout_s: float = 30.0) -> list:
    """Ragged allgather: rank r contributes ``counts[r]`` elements; every rank returns
    the n segments in rank order. ``counts`` is the length-n per-rank
    element-count vector, identical everywhere (the MPI contract — so only
    actual bytes travel, no global-max padding).

    Ring schedule, n-1 hops: at hop s each rank forwards the segment that
    originated at ``rank - s + 1`` and receives origin ``rank - s`` (the
    segment just received IS the next hop's send, so each segment travels
    the ring once). Per-rank wire = sum(counts) - counts[rank] — the
    allgather optimum, ragged or not."""
    n = n_ranks
    counts = np.asarray(counts, np.int64).ravel()
    if counts.shape != (n,):
        raise ValueError(f"counts must be length {n}, got {counts.shape}")
    seg = np.ascontiguousarray(local).ravel()
    if seg.size != counts[rank]:
        raise ValueError(f"local has {seg.size} elements, "
                         f"counts[{rank}] says {counts[rank]}")
    out: list = [None] * n
    out[rank] = seg.copy()
    if n == 1:
        return out
    wire = _RingWire(net, send_comm, recv_comm, timeout_s=timeout_s,
                     peers=((rank + 1) % n, (rank - 1) % n), world=n)
    # pipelined ragged train: each hop lands origin (rank-s)'s segment
    # straight into its (pre-allocated, exactly-sized) output slot, and
    # that slot is the next hop's outbound — no staging, no .copy()
    for s in range(1, n):
        origin = (rank - s) % n
        out[origin] = np.empty(int(counts[origin]), seg.dtype)
    hops = [(_as_bytes(out[(rank - s) % n]), None) for s in range(1, n)]
    # pick key: the largest contribution — counts is the shared MPI
    # vector, so every rank derives the same frame
    wire.stream(_as_bytes(seg), hops, seg.dtype,
                size_key=int(counts.max()) * seg.dtype.itemsize)
    return out


def ring_reduce_scatter_v_over_net(net, send_comm, recv_comm,
                                   local: np.ndarray, counts, rank: int,
                                   n_ranks: int, op: str = "sum",
                                   timeout_s: float = 30.0) -> np.ndarray:
    """Ragged reduce-scatter: ``local`` is the concatenation of n ragged chunks
    (chunk j holds ``counts[j]`` elements; same layout on every rank); rank
    r returns the elementwise reduction of every rank's chunk r.

    The ragged generalization of :func:`ring_reduce_scatter_over_net`:
    identical n-1 pipelined ring steps (the -1-shifted stream, so
    chunk r lands on rank r), with chunk bounds taken from ``counts``
    instead of floor-balanced — wire bytes are exactly the non-own chunks,
    as in the dense case."""
    n = n_ranks
    counts = np.asarray(counts, np.int64).ravel()
    if counts.shape != (n,):
        raise ValueError(f"counts must be length {n}, got {counts.shape}")
    x = np.array(local, copy=True).ravel()
    if x.size != int(counts.sum()):
        raise ValueError(f"local has {x.size} elements, counts sum to "
                         f"{int(counts.sum())}")
    if n == 1:
        return x
    bounds = np.concatenate([[0], np.cumsum(counts)])
    chunk = lambda i: x[bounds[i % n]:bounds[i % n + 1]]
    combine = _NET_REDUCE_OPS[op]  # KeyError = unknown op, caller's bug
    wire = _RingWire(net, send_comm, recv_comm, timeout_s=timeout_s,
                     peers=((rank + 1) % n, (rank - 1) % n), world=n)
    # same -1-shifted streaming reduce chain as the dense verb, with the
    # chunk bounds taken from ``counts`` instead of floor-balanced
    _stream_reduce_scatter(wire, chunk, rank, n, x.dtype, combine)
    return np.array(chunk(rank), copy=True)


def ring_chain_reduce_over_net(net, send_comm, recv_comm,
                               local: np.ndarray, rank: int,
                               n_ranks: int, op: str = "sum",
                               timeout_s: float = 30.0) -> np.ndarray:
    """Frame-pipelined chain reduce onto RING RANK 0 — the node-local
    "reduce-scatter-shaped" leg of the hierarchical schedule (
    DESIGN.md §5l) for nodes whose sizes differ (the uniform fast path
    rides the plain reduce-scatter instead). Implemented as the ragged
    reduce-scatter with ROOT-CONCENTRATED counts ``[N, 0, ..., 0]``:
    the -1-shifted stream degenerates to a relay chain that folds the
    whole buffer toward rank 0, frame-granularly pipelined through
    ``_RingWire.stream`` like every other leg — so lanes, QoS credits,
    codecs, tracing spans, and the epoch fence apply unchanged. Returns
    the full reduction on rank 0, an empty array elsewhere."""
    x = np.asarray(local).ravel()
    counts = np.zeros(max(1, n_ranks), np.int64)
    counts[0] = x.size
    return ring_reduce_scatter_v_over_net(net, send_comm, recv_comm, x,
                                          counts, rank, n_ranks, op=op,
                                          timeout_s=timeout_s)


def ring_chain_bcast_over_net(net, send_comm, recv_comm,
                              local: np.ndarray, rank: int,
                              n_ranks: int,
                              timeout_s: float = 30.0) -> np.ndarray:
    """Frame-pipelined relay broadcast FROM RING RANK 0 — the
    node-local "allgather-shaped" leg of the hierarchical schedule for
    unequal nodes (the dual of :func:`ring_chain_reduce_over_net`).
    The ragged allgather with root-concentrated counts relays rank 0's
    buffer around the ring, each hop's landed frames forwarded while
    later frames are still in flight. ``local`` on every rank supplies
    the size/dtype (the broadcast recv-buffer contract); only rank 0's
    contents travel. Returns the broadcast buffer on every rank."""
    x = np.asarray(local).ravel()
    counts = np.zeros(max(1, n_ranks), np.int64)
    counts[0] = x.size
    segs = ring_allgatherv_over_net(net, send_comm, recv_comm,
                                    x if rank == 0 else x[:0], counts,
                                    rank, n_ranks, timeout_s=timeout_s)
    return segs[0]


def ring_alltoall_over_net(net, send_comm, recv_comm, local: np.ndarray,
                           rank: int, n_ranks: int,
                           timeout_s: float = 30.0) -> np.ndarray:
    """Shift alltoall over the verbs: ``local`` is ``(n, ...)`` — block d is
    this rank's payload for rank d. Each rank launches a "train" of its
    n-1 outbound blocks; at hop s every rank pulls off the block addressed
    to it and forwards the rest (train shrinks by one block per hop)."""
    blocks = np.ascontiguousarray(local)
    n = n_ranks
    assert blocks.shape[0] == n, f"alltoall wants (n, ...), got {blocks.shape}"
    out = np.empty_like(blocks)
    out[rank] = blocks[rank]
    if n == 1:
        return out
    wire = _RingWire(net, send_comm, recv_comm, timeout_s=timeout_s,
                     peers=((rank + 1) % n, (rank - 1) % n), world=n)
    bnb = blocks[0].nbytes
    # my outbound train: blocks for rank+1, rank+2, ... rank+n-1 (travel order)
    train = np.concatenate(
        [_as_bytes(blocks[(rank + off) % n]) for off in range(1, n)])
    for s in range(1, n):
        # incoming train originated at rank-s; its head block is mine
        in_blocks = n - s
        incoming = wire.exchange(train, in_blocks * bnb)
        src = (rank - s) % n
        out[src] = incoming[:bnb].view(blocks.dtype).reshape(blocks.shape[1:])
        train = incoming[bnb:]  # forward the rest at the next hop
    return out
