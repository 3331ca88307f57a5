"""Multi-tenant collective lanes — per-channel identity, priority, credit.

A serving fleet multiplexes latency-critical inference allreduces over
the same wires as bulk training/checkpoint transfers. The vtable was
always async-request-shaped (PAPER.md's rccl-net ABI: ``isend/irecv/
test`` returning handles) — the one-collective-at-a-time serialization
lived purely in the group layer. This module is the lane subsystem that
removes it:

- **Identity.** Every framed message carries a 4-byte channel id next to
  the ``tag|epoch`` identity (the wire header is ``tag(4) | epoch(4) |
  chan(4)``), and the comm's receive stash is keyed ``(chan, tag)`` — so
  two collectives in flight on ONE comm can never tag-collide as long as
  they ride different lanes. Channel ids are a stable hash of the lane
  NAME (:func:`lane_id`), so every rank derives the same id for "bulk"
  with no cross-rank rendezvous; id 0 is the default lane, which is what
  every un-laned verb stamps — today's single-lane semantics preserved.

- **Priority + credit** (:class:`LaneGate`). The shared resources on a
  comm are the send ring / tcp tx FIFO, the comm lock, and (CPython)
  the interpreter. The gate is an admission controller at the ``isend``
  boundary with three mechanisms, each precise about what it bounds:
  (1) *contending admits defer by priority* — a waiting admit declares
  an intent first, and any lower-priority admit on the comm defers
  until every higher intent clears (so when both tenants are blocked
  at the gate, the latency lane's post always goes first); (2) *credit
  pacing* — a lane with ``credit_bytes`` may post at most that many
  bytes between yields, its wire quantum (``_RingWire`` frame) is
  capped at the credit (bounding any single post's ring/lock/GIL
  hold), and on the tcp plane its posts defer while the shared
  user-space tx queue holds more than its credit (FIFO-depth bound: a
  latency frame behind the bulk backlog waits at most
  ``credit/bandwidth``); (3) *busy-aware throttling* — ``ChannelHandle``
  verbs bracket themselves busy, and while a HIGHER-priority lane is
  mid-collective a paced lane's pacing yield becomes a genuine
  GIL-releasing sleep. Deliberately a throttle, not a hard block: a
  continuously-busy latency lane must slow the bulk tenant, never
  starve it (the bench floors the bulk lane's throughput for exactly
  this). An UNPACED lane gets only mechanism (1) — priority without a
  credit is a tie-breaker at the gate, not a wire-clearing preemption.
  Deferrals pump the comm (inbound keeps flowing) and are bounded by
  ``timeout_s`` — a starved lane raises a NAMED TimeoutError, never
  hangs.

- **Context** (:func:`lane_context`). The channel a verb stamps is
  thread-local: a :class:`~rocnrdma_tpu_torch.distributed.ChannelHandle` verb
  enters its lane's context and every framed message issued under the
  call — ring frames, LG descriptors, p2p frames — lands in that lane.
  LG *protocol control* (arena announce, credit ACK, REQ) stays on
  channel 0 by design: the arena and its credit are comm-global state
  shared by every lane, and any lane's drain returns any lane's credit.

Epoch interaction: the fence is lane-agnostic by construction — a stale
frame is dropped whatever lane it rides (``_HostComm._pump`` checks the
epoch before the stash), counted per lane in
``metrics.WIRE.channel_frames_fenced`` so a heal's postmortem can say
WHICH tenant's frames died with the old generation.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
import zlib

from rocnrdma_tpu_torch import lockwitness as _lockwitness
from rocnrdma_tpu_torch.metrics import VERBS as _VERB_LAT, WIRE as _WIRE
from rocnrdma_tpu_torch.obs import FLIGHT as _FLIGHT
from rocnrdma_tpu_torch.obs import trace as _trace
from rocnrdma_tpu_torch.transport.backoff import Backoff

DEFAULT_LANE = "default"


def fallback_label(channel: int) -> str:
    """The label of a wire channel id no registry can name — frames can
    arrive on a lane the local process never opened. ONE definition: the
    per-lane counters, fence events, and fault-injection knobs all key
    by this string, and two spellings would silently split a tenant's
    telemetry."""
    return DEFAULT_LANE if channel == 0 else f"c{channel:08x}"


def lane_id(name: str) -> int:
    """The stable 32-bit channel id of lane ``name`` — a pure function
    of the name (crc32), so every rank of a job derives the same id
    with no rendezvous. Id 0 is reserved for the default lane; the
    astronomically unlucky name whose crc32 IS 0 maps to 1 (a same-name
    pair still agrees cross-rank, which is the property that matters)."""
    if name == DEFAULT_LANE:
        return 0
    return zlib.crc32(name.encode()) or 1


@dataclasses.dataclass(frozen=True)
class Lane:
    """One registered lane: the wire channel id, the human name, the
    scheduling priority (higher = more urgent; the default lane is 0),
    the pacing credit (bytes this lane may post between yields;
    None = unpaced — the default lane's setting, so single-lane
    workloads pay nothing), and the wire codec this lane's streaming
    collectives compress under (``transport.codec``: "int8" / "fp8",
    "auto" = the tuner's per-(plane, size) pick, None = uncompressed
    — the default). Every rank opens the same lane name with the same
    knobs, so both ends of every hop derive the same codec with no
    rendezvous — the same no-negotiation contract as the channel id."""

    id: int
    name: str
    priority: int = 0
    credit_bytes: int | None = None
    codec: str | None = None


class LaneRegistry:
    """Per-net lane table: name -> :class:`Lane`, id -> :class:`Lane`.

    ``open`` is idempotent for identical parameters and REFUSES a
    conflicting re-open (two tenants silently disagreeing on a lane's
    priority is a scheduling bug, not a merge). The default lane exists
    from construction. All state is behind one lock — lanes are opened
    from whatever thread first touches them."""

    def __init__(self):
        self._lock = _lockwitness.make_lock("lanes.py::LaneRegistry._lock")
        d = Lane(0, DEFAULT_LANE, 0, None)
        self._by_name: dict[str, Lane] = {DEFAULT_LANE: d}
        self._by_id: dict[int, Lane] = {0: d}
        # True once any non-default lane opens — monotonic, read WITHOUT
        # the lock by the gate's per-send fast path (a single-tenant
        # process must pay one attribute read per post, not three lock
        # acquisitions)
        self.multi = False

    def open(self, name: str, priority: int = 0,
             credit_bytes: int | None = None,
             codec: str | None = None) -> Lane:
        with self._lock:
            cur = self._by_name.get(name)
            if cur is not None:
                if (cur.priority, cur.credit_bytes, cur.codec) != \
                        (int(priority), credit_bytes, codec):
                    raise ValueError(
                        f"lane {name!r} already open with priority="
                        f"{cur.priority} credit_bytes={cur.credit_bytes} "
                        f"codec={cur.codec}; conflicting re-open refused")
                return cur
            lid = lane_id(name)
            clash = self._by_id.get(lid)
            if clash is not None:
                raise ValueError(
                    f"lane id collision: {name!r} hashes to the id of "
                    f"{clash.name!r} — pick a different lane name")
            lane = Lane(lid, name, int(priority), credit_bytes, codec)
            self._by_name[name] = lane
            self._by_id[lid] = lane
            self.multi = True
            return lane

    def set_credit(self, name: str, credit_bytes: int | None) -> Lane:
        """Swap lane ``name``'s pacing credit in place (the evasion
        engine's shrink hook: a reshape caps the straggler's
        credits so its frames stop monopolising the gate). The gate
        re-reads the registry per admit, so the new credit takes effect
        on the next post with no re-open; ``multi`` flips on when a
        credit lands on the default lane, else the fast path would
        bypass the gate the cap is meant to engage. A later identical
        ``open`` still compares against the CURRENT knobs — a capped
        lane's original opener re-opening is a conflict, named."""
        with self._lock:
            cur = self._by_name.get(name)
            if cur is None:
                raise KeyError(f"lane {name!r} not open")
            lane = dataclasses.replace(cur, credit_bytes=credit_bytes)
            self._by_name[name] = lane
            self._by_id[lane.id] = lane
            if credit_bytes is not None:
                self.multi = True
            return lane

    def cap_credits(self, credit_bytes: int) -> list[str]:
        """Cap EVERY open lane's credit to at most ``credit_bytes``
        (unpaced lanes get the cap outright); returns the names whose
        credit changed, name-sorted — the deterministic record the
        evasion log carries."""
        changed = []
        for lane in self.snapshot():
            if lane.credit_bytes is None or lane.credit_bytes > credit_bytes:
                self.set_credit(lane.name, int(credit_bytes))
                changed.append(lane.name)
        return changed

    def get(self, channel: int) -> Lane | None:
        with self._lock:
            return self._by_id.get(channel)

    def by_name(self, name: str) -> Lane | None:
        with self._lock:
            return self._by_name.get(name)

    def snapshot(self) -> list:
        """Every registered lane, name-sorted (immutable Lane values).
        The hierarchical host plane MIRRORS a group's open
        lanes onto its per-leg sub-nets through this — a lane's QoS
        credit and wire codec must mean the same thing on every leg a
        laned collective rides, and each net resolves lanes from its
        own registry."""
        with self._lock:
            return [self._by_name[k] for k in sorted(self._by_name)]

    def label(self, channel: int) -> str:
        """The lane NAME behind a wire channel id (per-channel counters
        and flight events key by this, so telemetry reads "bulk", not a
        hash); an unregistered id falls back to :func:`fallback_label`."""
        lane = self.get(channel)
        return lane.name if lane is not None else fallback_label(channel)

    def __len__(self) -> int:
        with self._lock:
            return len(self._by_name)


# ---------------------------------------------------------------------------
# The thread-local lane context: which channel un-annotated verbs stamp.
# ---------------------------------------------------------------------------

_TLS = threading.local()


def current_channel() -> int:
    """The channel id the calling thread's verbs stamp (0 = default)."""
    return getattr(_TLS, "channel", 0)


@contextlib.contextmanager
def lane_context(channel: int):
    """Run a block with every framed message stamped ``channel`` — the
    mechanism :class:`~rocnrdma_tpu_torch.distributed.ChannelHandle` wraps its
    verbs in. Nests and restores; thread-local, so concurrent lane
    threads never see each other's channel."""
    prev = getattr(_TLS, "channel", 0)
    _TLS.channel = int(channel)
    try:
        yield
    finally:
        _TLS.channel = prev


# ---------------------------------------------------------------------------
# Lane scheduling-point observability (the analyzer's lane rule pins
# that every blocking lane point records entry + completion, like the
# net verbs' _verb_entry/_verb_done — redefined here rather than
# imported to keep lanes.py importable from plugin.py without a cycle).
# ---------------------------------------------------------------------------


def _lane_entry(point: str, **ctx) -> float:
    """Record a lane scheduling point's entry (``<point>-wait``);
    returns the timestamp the completion side measures from. Recorded
    through the causal tracer's stamper so a wait inside a sampled op
    span lands in that op's lane-admit attribution bucket."""
    _trace.record(point + "-wait", **ctx)
    return time.perf_counter()


def _lane_done(point: str, t0: float, **ctx) -> None:
    """Record a lane scheduling point's completion (``<point>-done``
    with the wait as ``dur``) and feed the latency histogram — a lane
    starving shows up as this point's tail, next to the verb it held."""
    dt = time.perf_counter() - t0
    _VERB_LAT.observe(point, dt)
    _trace.record(point + "-done", dur=dt, **ctx)


class LaneGate:
    """Per-net admission controller at the send boundary (see the
    module docstring's priority/credit model). One gate per net; the
    per-comm scheduling state (pacing windows, waiting intents) lives
    on the comm object itself so it dies with the wiring.

    The uncontended fast path — a process that never opened a second
    lane — is ONE attribute read (``registry.multi``, a monotonic flag):
    the default lane's semantics (and the smoke gates' zero-copy/
    throughput floors) are preserved bit-for-bit at zero per-frame
    cost."""

    def __init__(self, registry: LaneRegistry):
        self.registry = registry
        self._lock = _lockwitness.make_lock("lanes.py::LaneGate._lock")
        # priority -> count of lanes currently INSIDE a collective
        # (ChannelHandle._run brackets every verb with busy_enter/exit):
        # a paced lane's yields become genuine GIL-releasing sleeps
        # while any higher-priority lane is mid-collective, so the
        # latency lane's frames, folds, and pumps get the interpreter —
        # the CPython-threads half of the QoS story, next to the
        # wire-side credit/priority admission
        self._busy: dict[int, int] = {}

    def busy_enter(self, channel: int) -> None:
        """Mark lane ``channel`` as inside a collective (bracketed by
        :meth:`busy_exit`); lower-priority paced lanes throttle while
        any higher-priority lane is busy."""
        lane = self.registry.get(channel)
        prio = lane.priority if lane is not None else 0
        with self._lock:
            self._busy[prio] = self._busy.get(prio, 0) + 1

    def busy_exit(self, channel: int) -> None:
        lane = self.registry.get(channel)
        prio = lane.priority if lane is not None else 0
        with self._lock:
            n = self._busy.get(prio, 0) - 1
            if n > 0:
                self._busy[prio] = n
            else:
                self._busy.pop(prio, None)

    @staticmethod
    def _state(comm) -> dict:
        st = getattr(comm, "_lane_state", None)
        if st is None:
            st = comm._lane_state = {"window": {}, "intents": {}}
        return st

    @staticmethod
    def _tx_backlog(comm) -> int:
        tx = getattr(getattr(comm, "qp", None), "tx_pending", None)
        if tx is None:
            return 0
        try:
            return tx()
        except OSError:
            return 0  # a dying comm's backlog is the peer's problem now

    def admit(self, comm, channel: int, nbytes: int,
              timeout_s: float = 10.0, progress=None) -> None:
        """Block until lane ``channel`` may post ``nbytes`` on ``comm``:

        - immediately when this process runs a single lane (fast path);
        - defers while any HIGHER-priority admit is itself WAITING at
          this gate on this comm (declared intents: when both tenants
          contend for admission, the latency lane's post goes first);
        - a lane with ``credit_bytes`` yields once per credit of posted
          bytes (pacing) and, on planes with a user-space tx queue,
          defers while the shared backlog exceeds its credit; while a
          higher-priority lane is mid-collective (the busy bracket),
          those yields become genuine GIL-releasing sleeps — a
          throttle, deliberately not a hard block (a continuously-busy
          latency lane must slow the bulk tenant, never starve it).

        Deferrals pump ``comm`` (and the caller's ``progress`` hook) so
        inbound — including the very traffic that drains the backlog —
        keeps flowing; ``timeout_s`` bounds the whole wait with a NAMED
        TimeoutError."""
        if not self.registry.multi:
            return  # single-lane process: today's wire, untouched
        lane = self.registry.get(channel)
        prio = lane.priority if lane is not None else 0
        credit = lane.credit_bytes if lane is not None else None
        with self._lock:
            st = self._state(comm)
            intents, window = st["intents"], st["window"]
            if not any(n for p, n in intents.items() if p > prio) \
                    and (credit is None
                         or (window.get(channel, 0) + nbytes <= credit
                             and self._tx_backlog(comm) <= credit)):
                window[channel] = window.get(channel, 0) + nbytes
                return
            # going to wait: declare intent FIRST, so lower-priority
            # lanes checking after us already defer
            intents[prio] = intents.get(prio, 0) + 1
        label = self.registry.label(channel)
        t0 = _lane_entry("lane-admit", lane=label, prio=prio, nbytes=nbytes)
        deadline = time.monotonic() + timeout_s
        back = Backoff()
        yielded = waited = False
        try:
            while True:
                with self._lock:
                    higher = any(n for p, n in intents.items() if p > prio)
                    over = (credit is not None
                            and window.get(channel, 0) + nbytes > credit)
                    if over and yielded:
                        window[channel] = 0  # paid the yield: fresh window
                        over = False
                    backlog = (credit is not None
                               and self._tx_backlog(comm) > credit)
                    higher_busy = any(n for p, n in self._busy.items()
                                      if p > prio)
                    if not higher and not over and not backlog:
                        window[channel] = window.get(channel, 0) + nbytes
                        _lane_done("lane-admit", t0, lane=label)
                        return
                if over and not yielded:
                    yielded = True
                    _WIRE.lane_yield()
                elif not waited:
                    waited = True
                    _WIRE.lane_wait()
                pump = getattr(comm, "_pump", None)
                if pump is not None:
                    pump()
                if progress is not None:
                    progress()
                if time.monotonic() >= deadline:
                    # the wait's resolution belongs on the timeline even
                    # (especially) when it is a failure: an unmatched
                    # lane-admit-wait is exactly the blind spot a "why
                    # did the lane starve?" postmortem cannot afford
                    _FLIGHT.record("lane-admit-abort", lane=label,
                                   prio=prio, error="TimeoutError",
                                   dur=time.perf_counter() - t0)
                    raise TimeoutError(
                        f"lane {label!r} (priority {prio}) starved: "
                        f"higher-priority traffic or backlog held the "
                        f"wire past {timeout_s}s")
                if higher_busy:
                    # a higher-priority lane is MID-COLLECTIVE: the
                    # pacing yield becomes a genuine sleep — the GIL
                    # (and the comm lock) go to the latency lane's
                    # frames instead of a spin re-check. This is the
                    # bound on the bulk tenant's interference: one
                    # credit window of posts, then a real yield, while
                    # latency traffic is in flight.
                    time.sleep(0.0005)
                else:
                    back.pause()
        finally:
            with self._lock:
                n = intents.get(prio, 0) - 1
                if n > 0:
                    intents[prio] = n
                else:
                    intents.pop(prio, None)
