"""FaultNet — a deterministic fault-injecting net plane.

The reference's whole reason to exist is a transport that keeps
collectives correct over an unreliable wire; the production half of that
claim is proving the stack DEGRADES CLEANLY — named errors, never hangs —
when connects flake, completions stall, and peers die mid-collective.
This module is the wire that misbehaves on demand: :class:`FaultNet`
wraps ANY vtable net (``HostQPNet``, ``TCPNet``, ``DeviceMeshNet``) with
the same verbs (``listen / connect / accept / reg_mr / isend / irecv /
irecv_into / test / close``) and injects faults from a **seeded,
replayable schedule** — the zero-copy receive path included, so the
pipelined ring collectives see every fault class the legacy path did.

Fault classes (all off by default; see :class:`FaultSchedule`):

- **connect/accept refusals** — the first ``k`` attempts raise
  ``ConnectionRefusedError`` (a peer whose listener isn't up yet, a
  flaky SYN); later attempts may flake with probability ``p``. The
  refusal happens BEFORE the inner verb runs, so a retry can succeed.
- **delayed test completions** — with probability ``p`` an ``irecv``'s
  completion is held for a drawn number of extra ``test()`` polls after
  the wire actually delivered it (a slow CQ, an interrupt coalesce).
  Progress underneath keeps flowing — only the *report* is late.
- **comm death after the Nth op** — every data verb past the threshold
  raises ``OSError`` (the NIC fell off the bus). Poisoning, not
  retryable, exactly like a real half-written QP.
- **rank partition** — after ``partition_after_ops`` data ops this
  net drops traffic silently: sends complete locally but never arrive,
  receives never complete. The layers above MUST turn that into a named
  ``TimeoutError``; a hang is a failed test.
- **close drops** — with probability ``p`` a ``close_comm`` skips the
  graceful teardown (a peer that died without FIN); the wrapped net's
  final ``close()`` still reclaims everything.

Determinism: every decision is drawn from per-fault-class
``random.Random`` streams seeded by ``(seed, rank, class)`` string keys
(process-stable hashing) and advanced only by this rank's own op
sequence — never by wall-clock time or cross-rank interleaving. Two runs
of the same seed against the same local call sequence inject byte-for-
byte the same faults; ``FaultSchedule.log`` records them and
``fingerprint()`` hashes the log for cheap replay assertions.

Counters ride :class:`rocnrdma_tpu_torch.metrics.FaultCounters` so the chaos
harness can sum injected faults across ranks from each worker's one-line
JSON.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import random

from rocnrdma_tpu_torch import lockwitness as _lockwitness
from rocnrdma_tpu_torch.metrics import FaultCounters
from rocnrdma_tpu_torch.obs import FLIGHT as _FLIGHT
from rocnrdma_tpu_torch.transport import lanes as _lanes
from rocnrdma_tpu_torch.transport.plugin import Request


@dataclasses.dataclass
class FaultSchedule:
    """The seeded, replayable fault plan for ONE rank's net.

    ``seed``/``rank`` key the random streams; every knob defaults to "no
    faults", so an empty schedule makes :class:`FaultNet` a transparent
    wrapper. Construct one per rank (``FaultSchedule(seed, rank)``) —
    per-rank streams keep determinism independent of thread/process
    interleaving.
    """

    seed: int = 0
    rank: int = 0
    # connection-plane faults
    connect_refusals: int = 0       # first k connect() attempts refused
    accept_refusals: int = 0        # first k accept() attempts refused
    connect_flake_p: float = 0.0    # later connects refused with prob p
    # admission-plane faults (the elastic-grow surface): the store-side
    # join/spare registration, not a vtable verb — consulted directly by
    # ProcessGroup's join/spare entry points, which retry refusals under
    # the same shared backoff as refused connects
    join_refusals: int = 0          # first k admission attempts refused
    die_at_promotion: bool = False  # spare os._exit(7)s the moment its
    #   admit record lands — the spare-death-mid-promotion chaos case:
    #   survivors' first heal times out at the wired barrier and the
    #   retried heal must burn the spare and shrink instead
    # completion-plane faults
    test_delay_p: float = 0.0       # prob an irecv completion is held
    test_delay_polls: tuple = (1, 8)  # held for uniform[a, b] extra polls
    # death-plane faults
    die_after_ops: int | None = None        # OSError on every op past N
    partition_after_ops: int | None = None  # silent blackhole past N
    kill_after_ops: int | None = None       # os._exit(7) AT op N: the
    #   SIGKILLed-host analogue (no FIN, no teardown, no destructors),
    #   keyed on the rank's own op sequence instead of wall clock so a
    #   kill-and-heal chaos run replays deterministically — every peer
    #   sees byte-for-byte the same pre-death traffic on every run
    close_drop_p: float = 0.0       # prob a close_comm skips teardown
    # per-CHANNEL faults (the multi-tenant lane surface): knobs keyed by
    # lane NAME so one tenant's wire can misbehave while its neighbours'
    # stays clean. Each lane's decisions advance that lane's OWN op/draw
    # streams (seeded ``(seed, rank, "chan:<lane>:<class>")``), so the
    # injection log stays replay-equal per seed however the lanes'
    # verbs interleave — the same stream-local-coordinate discipline as
    # :meth:`record` documents for the resume service.
    chan_partition_after_ops: dict | None = None  # lane -> blackhole past N
    #   of THAT LANE's data ops (the global partition knob's per-tenant
    #   twin: sends complete locally, never arrive; recvs never complete)
    chan_test_delay_p: dict | None = None   # lane -> completion-delay prob
    #   (overrides the global test_delay_p for that lane's receives;
    #   draws come from the lane's own rng stream)
    # store-plane faults (the survivable control plane's
    # surface). None of these are vtable verbs — like join_fault they
    # are consulted directly by the store layer: store_conn_drop_ops by
    # ``BootstrapClient._rpc`` (drop the live connection BEFORE the Nth
    # store round-trip of THIS rank — the reconnect-replay/failover
    # path runs at a deterministic coordinate of the rank's own
    # store-op stream), and the two close knobs by the DATA-op stream
    # (``op_fault``): at op N the armed server (the primary a
    # store-hosting rank runs, or a node's proxy) is closed abruptly —
    # keyed on the host rank's own op sequence, never wall clock, so a
    # store-death chaos run replays byte-for-byte.
    store_conn_drop_ops: tuple = ()        # drop conn before store op N
    store_close_after_ops: int | None = None  # close armed store AT op N
    proxy_close_after_ops: int | None = None  # close armed proxy AT op N
    # chronic degradation (armed via :meth:`degrade_rank`):
    # EVERY irecv completion past ``after_ops`` data ops is held for a
    # FIXED ``factor`` extra polls — slow-but-alive, the straggler the
    # evasion engine exists for. Distinct from the one-shot probabilistic
    # ``test_delay``: no rng draw (the hold count is a constant), so the
    # injection log is a pure function of this rank's own recv sequence.
    degrade_factor: int = 0         # extra polls per held completion
    degrade_after_ops: int = 0      # data ops before degradation starts

    def __post_init__(self):
        self.counters = FaultCounters()
        self.log: list = []   # (op_no, kind, detail) in injection order
        self.ops = 0          # data ops (isend/irecv) seen so far
        self._connect_attempts = 0
        self._accept_attempts = 0
        self._join_attempts = 0
        self._test_draws = 0
        self._close_draws = 0
        self._degrade_draws = 0
        self._store_ops = 0
        self.store_conn_drop_ops = tuple(
            int(n) for n in (self.store_conn_drop_ops or ()))
        self._store_close_fn = None
        self._proxy_close_fn = None
        self._rngs: dict[str, random.Random] = {}
        # per-lane streams (see the chan_* knobs): each lane's own data-op
        # and completion-draw counters — the coordinates its injections
        # are logged at, replay-stable under any cross-lane interleaving
        self.chan_partition_after_ops = dict(self.chan_partition_after_ops
                                             or {})
        self.chan_test_delay_p = dict(self.chan_test_delay_p or {})
        self._chan_ops: dict[str, int] = {}
        self._chan_test_draws: dict[str, int] = {}
        # multi-tenant lanes run data verbs from CONCURRENT threads over
        # one FaultNet: the decision state (op counters, draw counters,
        # rng streams, the log) mutates under this lock, or a lost
        # `ops += 1` silently shifts every op-keyed kill/partition and
        # corrupts the replay contract. (The lock makes the decisions
        # race-free; op-keyed determinism across THREADS additionally
        # needs each thread's traffic on its own lane — the per-lane
        # streams — which is the documented chaos discipline.)
        import threading
        self._lock = _lockwitness.make_rlock("faults.py::FaultSchedule._lock")

    def _rng(self, stream: str) -> random.Random:
        # string seeding is sha512-based (process-stable), unlike hash()
        if stream not in self._rngs:
            self._rngs[stream] = random.Random(
                f"{self.seed}:{self.rank}:{stream}")
        return self._rngs[stream]

    def record(self, kind: str, detail=None, coord=None) -> None:
        """Append an injection to the log at ``coord`` — the deciding
        stream's OWN coordinate (attempt/draw counter; defaults to the
        global data-op index, right for op-placed faults like the
        kills). Coordinates are stream-local by design: once an
        opportunistic engine runs verbs at wall-clock-determined points
        (the p2p resume service fires tail sends whenever the
        peer's cursor lands), the global op index of an independent
        stream's injection is no longer replay-stable — each stream's
        own sequence still is."""
        coord = self.ops if coord is None else coord
        self.counters.count(kind)
        self.log.append((coord, kind, detail))
        # every injection also lands on the flight-recorder timeline, so
        # a chaos trace shows the fault NEXT TO its absorption (the retry/
        # stall events the layers above record). The event args come from
        # the schedule's own deterministic state (stream coordinate +
        # detail), never from timing — two replays of one seed record the
        # same fault event sequence (what the replay-equality test
        # asserts).
        _FLIGHT.record("fault-" + kind, op=coord, rank=self.rank,
                       detail=detail)

    def fingerprint(self) -> str:
        """Stable digest of the injection log — two runs of one seed over
        one call sequence must produce equal fingerprints (the replay
        assertion the soak test makes). Digested in CANONICAL order: the
        multiset of (coord, kind, detail) entries is a pure function of
        the seed, but the list's interleaving across independent streams
        is not (see :meth:`record` on the resume service), so the log is
        sorted before hashing."""
        return hashlib.sha256(
            json.dumps(sorted(self.log, key=repr),
                       default=str).encode()).hexdigest()

    # -- per-verb decisions (each advances only its own stream) ------------

    def connect_fault(self) -> str | None:
        self._connect_attempts += 1
        if self._connect_attempts <= self.connect_refusals:
            self.record("connect-refused", self._connect_attempts,
                        coord=self._connect_attempts)
            return f"injected refusal {self._connect_attempts}/" \
                   f"{self.connect_refusals}"
        if (self.connect_flake_p
                and self._rng("connect").random() < self.connect_flake_p):
            self.record("connect-flaked", self._connect_attempts,
                        coord=self._connect_attempts)
            return "injected transient connect flake"
        return None

    def join_fault(self) -> str | None:
        """One admission attempt (a joiner's/spare's store registration):
        the first ``join_refusals`` attempts are refused — the caller
        retries under the shared backoff, like refused connects.
        Deterministic: keyed on this rank's own attempt counter."""
        self._join_attempts += 1
        if self._join_attempts <= self.join_refusals:
            self.record("join-refused", self._join_attempts,
                        coord=self._join_attempts)
            return f"injected admission refusal {self._join_attempts}/" \
                   f"{self.join_refusals}"
        return None

    def promotion_fault(self) -> None:
        """Called by a spare the moment it reads its admit record: with
        ``die_at_promotion`` the spare hard-dies HERE — after the heal
        leader assigned it a slot, before it wires — the worst-placed
        spare death (survivors are already waiting at the wired
        barrier)."""
        if self.die_at_promotion:
            import os
            self.record("killed-at-promotion")
            print("FAULT: spare killed at promotion", flush=True)
            os._exit(7)

    def accept_fault(self) -> str | None:
        self._accept_attempts += 1
        if self._accept_attempts <= self.accept_refusals:
            self.record("accept-refused", self._accept_attempts,
                        coord=self._accept_attempts)
            return f"injected refusal {self._accept_attempts}/" \
                   f"{self.accept_refusals}"
        return None

    def op_fault(self, verb: str, lane: str | None = None) -> str | None:
        """Called once per data op (isend/irecv); returns the death mode
        in force, if any. ``lane`` (a lane NAME) additionally consults
        the per-channel knobs — a lane's partition is decided on that
        lane's OWN op counter, so the decision is independent of how
        other lanes' traffic interleaves (replay-equal per seed)."""
        with self._lock:
            mode = self._op_fault_locked(verb, lane)
            fire = self._store_deaths_due_locked(verb)
        # the armed closes run OUTSIDE the schedule lock: close() joins
        # server threads, and a join under the decision lock would hold
        # every other lane's fault decisions hostage to the teardown
        for fn in fire:
            fn()
        return mode

    def arm_store_death(self, close_fn) -> None:
        """Arm ``store_close_after_ops``: at data op N of THIS rank,
        ``close_fn`` (the primary store's close) runs — the
        store-hosting rank's store dies at a deterministic point of its
        own op sequence while the rank itself lives. The hard-death
        variant (host rank AND store die together) is the existing
        ``kill_after_ops`` on the hosting rank."""
        with self._lock:
            self._store_close_fn = close_fn

    def arm_proxy_death(self, close_fn) -> None:
        """Arm ``proxy_close_after_ops``: same discipline for a node's
        proxy store — only that node's ranks lose their shard and must
        re-point through their armed failover lists."""
        with self._lock:
            self._proxy_close_fn = close_fn

    def _store_deaths_due_locked(self, verb: str) -> list:
        fire = []
        if (self._store_close_fn is not None
                and self.store_close_after_ops is not None
                and self.ops >= self.store_close_after_ops):
            fire.append(self._store_close_fn)
            self._store_close_fn = None
            self.record("store-closed", verb)
        if (self._proxy_close_fn is not None
                and self.proxy_close_after_ops is not None
                and self.ops >= self.proxy_close_after_ops):
            fire.append(self._proxy_close_fn)
            self._proxy_close_fn = None
            self.record("proxy-closed", verb)
        return fire

    def store_fault(self) -> bool:
        """One store round-trip of this rank's client
        (``BootstrapClient._rpc``): True when the live connection must
        be dropped FIRST — the reconnect-replay (and, with failover
        armed, re-point) path runs at this coordinate of the rank's own
        store-op stream. Deterministic like every other decision here:
        the counter advances once per call, never by wall clock."""
        with self._lock:
            self._store_ops += 1
            if self._store_ops in self.store_conn_drop_ops:
                self.record("store-conn-dropped", self._store_ops,
                            coord=self._store_ops)
                return True
            return False

    def _op_fault_locked(self, verb: str, lane: str | None) -> str | None:
        self.ops += 1
        if self.kill_after_ops is not None and self.ops >= self.kill_after_ops:
            # the hard kill: mid-collective, mid-frame-stream, skipping
            # every destructor — exactly a SIGKILLed host, but landed at
            # a deterministic point of this rank's own op sequence
            import os
            self.record("killed", verb)
            print(f"FAULT: killed at op {self.ops} ({verb})", flush=True)
            os._exit(7)
        if self.die_after_ops is not None and self.ops > self.die_after_ops:
            self.record("comm-dead", verb)
            return "dead"
        if (self.partition_after_ops is not None
                and self.ops > self.partition_after_ops):
            self.record("partitioned", verb)
            return "partitioned"
        if lane is not None and self.chan_partition_after_ops:
            lim = self.chan_partition_after_ops.get(lane)
            if lim is not None:
                n = self._chan_ops.get(lane, 0) + 1
                self._chan_ops[lane] = n
                if n > lim:
                    self.record("chan-partitioned", (lane, verb), coord=n)
                    return "partitioned"
        return None

    def test_delay(self, lane: str | None = None) -> int:
        """Extra not-done ``test()`` polls to inject on this irecv
        (0 = report truthfully). A lane named in ``chan_test_delay_p``
        draws from its OWN rng stream and draw counter — the global
        stream never advances for it, so default-lane replay logs are
        byte-identical with and without laned traffic alongside."""
        with self._lock:
            return self._test_delay_locked(lane)

    def _test_delay_locked(self, lane: str | None) -> int:
        # the chronic hold stacks ON TOP of any one-shot delay draw: a
        # degraded rank's flaky CQ is still flaky — and the one-shot
        # streams advance exactly as they would undegraded, so arming
        # degrade_rank never shifts the test_delay replay log
        chronic = self._degrade_hold_locked()
        if lane is not None and lane in self.chan_test_delay_p:
            p = self.chan_test_delay_p[lane]
            rng = self._rng(f"chan:{lane}:test")
            n = self._chan_test_draws.get(lane, 0) + 1
            self._chan_test_draws[lane] = n
            if p and rng.random() < p:
                lo, hi = self.test_delay_polls
                d = rng.randint(lo, hi)
                self.record("chan-test-delayed", (lane, d), coord=n)
                return chronic + d
            return chronic
        rng = self._rng("test")
        self._test_draws += 1
        if self.test_delay_p and rng.random() < self.test_delay_p:
            lo, hi = self.test_delay_polls
            d = rng.randint(lo, hi)
            self.record("test-delayed", d, coord=self._test_draws)
            return chronic + d
        return chronic

    def degrade_rank(self, rank: int, factor: int,
                     after_ops: int = 0) -> bool:
        """Arm chronic slowness on ``rank``: every irecv completion past
        ``after_ops`` data ops is held ``factor`` extra polls (the slow
        CQ that never recovers — a degrading host, not a dead one). The
        chaos harness calls this on EVERY rank's schedule with the same
        arguments; only the named rank's arms (returns True). Holds are
        logged per completion at the degrade stream's own draw counter,
        so ``fingerprint()`` stays replay-equal per seed."""
        with self._lock:
            if rank != self.rank:
                return False
            self.degrade_factor = int(factor)
            self.degrade_after_ops = int(after_ops)
            return True

    def _degrade_hold_locked(self) -> int:
        """The chronic hold in force for one irecv completion (0 when
        disarmed) — deterministic, no rng: the fixed factor, logged at
        this stream's own coordinate."""
        if not self.degrade_factor or self.ops <= self.degrade_after_ops:
            return 0
        self._degrade_draws += 1
        self.record("degraded", self.degrade_factor,
                    coord=self._degrade_draws)
        return self.degrade_factor

    def close_drop(self) -> bool:
        self._close_draws += 1
        if (self.close_drop_p
                and self._rng("close").random() < self.close_drop_p):
            self.record("close-dropped", coord=self._close_draws)
            return True
        return False


class FaultNet:
    """The vtable wrapper that misbehaves on ``schedule``'s command.

    EVERY canonical net verb is defined here explicitly — data verbs
    (two-sided ``isend``/``irecv``/``irecv_into`` and one-sided
    ``iwrite``/``iread``) under the fault model, the rest as documented
    passthroughs — and the vtable-conformance pass
    (``tools/analyze/vtable.py``) pins it that way: a verb that fell
    through ``__getattr__`` would run with zero fault coverage. The
    delegation stays for NON-verb attributes only (``LG_CHUNK``,
    ``MAX_FRAME``, plane-specific helpers), so ``_RingWire`` chunking
    and frame constants ride through unchanged. Comms are the inner
    net's own objects — progress pumps and per-comm state need no
    adaptation.
    """

    def __init__(self, inner, schedule: FaultSchedule | None = None):
        self.inner = inner
        self.schedule = schedule if schedule is not None else FaultSchedule()
        self.counters = self.schedule.counters

    def __getattr__(self, name):
        return getattr(self.inner, name)

    # -- vtable ------------------------------------------------------------

    def init(self) -> None:
        self.inner.init()

    def devices(self) -> int:
        return self.inner.devices()

    def get_properties(self, dev: int = 0):
        return self.inner.get_properties(dev)

    def listen(self, *args, **kw):
        return self.inner.listen(*args, **kw)

    def connect(self, *args, **kw):
        why = self.schedule.connect_fault()
        if why is not None:
            raise ConnectionRefusedError(f"faultnet: {why}")
        return self.inner.connect(*args, **kw)

    def accept(self, *args, **kw):
        # refusal precedes the inner verb: the peer's dial stays pending
        # in the listener backlog, so a retried accept can succeed
        why = self.schedule.accept_fault()
        if why is not None:
            raise ConnectionRefusedError(f"faultnet: {why}")
        return self.inner.accept(*args, **kw)

    def reg_mr(self, comm, buffer):
        return self.inner.reg_mr(comm, buffer)

    def open_lane(self, name: str, priority: int = 0,
                  credit_bytes: int | None = None,
                  codec: str | None = None):
        """Passthrough: lane registration is local configuration (the
        per-channel fault knobs key by lane NAME and are consulted by
        the data verbs below — registering a lane injects nothing; the
        lane's wire ``codec`` knob rides through so a quantized lane's
        faults land on genuinely encoded frames)."""
        return self.inner.open_lane(name, priority=priority,
                                    credit_bytes=credit_bytes, codec=codec)

    def _lane(self, kw: dict) -> str:
        """The lane NAME of a data verb call: the explicit ``channel``
        kwarg if the caller passed one, else the calling thread's lane
        context — resolved to a name through the inner net's registry
        (the per-channel knobs key by name so chaos configs read
        "bulk", not a hash)."""
        chan = kw.get("channel")
        if chan is None:
            chan = _lanes.current_channel()
        reg = getattr(self.inner, "lanes", None)
        if reg is not None:
            return reg.label(chan)
        return _lanes.fallback_label(chan)

    def set_epoch(self, epoch: int) -> None:
        """Passthrough: the epoch fence lives at the inner plane's comm
        boundary (``_HostComm._pump``), BELOW fault injection — injected
        faults and the generation fence compose (a delayed completion
        whose frame went stale is fenced at true delivery, deterministic
        under replay because the fence keys off frame contents, not
        timing)."""
        self.inner.set_epoch(epoch)

    def _dead_mode(self, verb: str, lane: str | None = None) -> str | None:
        mode = self.schedule.op_fault(verb, lane=lane)
        if mode == "dead":
            raise OSError(
                f"faultnet: comm dead (injected death after "
                f"{self.schedule.die_after_ops} ops; {verb} refused)")
        return mode

    def isend(self, comm, mr, tag: int = 0, **kw) -> Request:
        if self._dead_mode("isend", self._lane(kw)) == "partitioned":
            # blackhole: complete locally, deliver nowhere — the PEER's
            # recv (or this rank's next recv) must time out, named
            size = len(mr)
            return Request(_test=lambda: (True, size, None))
        return self.inner.isend(comm, mr, tag=tag, **kw)

    def irecv(self, comm, *args, **kw) -> Request:
        lane = self._lane(kw)
        if self._dead_mode("irecv", lane) == "partitioned":
            return Request(_test=lambda: (False, 0, None))  # never completes
        req = self.inner.irecv(comm, *args, **kw)
        hold = self.schedule.test_delay(lane=lane)
        if hold == 0:
            return req

        state = {"left": hold}

        def probe():
            done, size = req.test()   # progress underneath keeps flowing
            if not done:
                return False, 0, None
            if state["left"] > 0:     # hold the completion REPORT only
                state["left"] -= 1
                return False, 0, None
            return True, size, req.payload

        return Request(_test=probe)

    def irecv_into(self, comm, buf, tag: int = 0, codec=None,
                   **kw) -> Request:
        """The zero-copy receive, under the SAME fault model as irecv: a
        partitioned net never completes it, a dead comm refuses it, and a
        delayed completion holds only the REPORT — the inner probe still
        lands/folds the bytes at true delivery time, so the data path the
        streaming collectives reduce over is byte-identical with and
        without the delay (what keeps chaos runs bitwise-correct AND
        replay-equal: every decision below draws from the schedule's own
        op-sequence streams, never from arrival timing). Per-channel
        knobs see the message's lane (explicit ``channel`` kwarg or the
        thread's lane context), so one tenant's receives can stall or
        blackhole while its neighbours' flow clean.

        ``codec`` is wrapped EXPLICITLY (not a ``__getattr__``
        fall-through — the vtable pass pins that no data-verb surface
        can bypass fault injection): a quantized lane's decode-and-fold
        path sees every fault class the plain path does, and a delayed
        encoded frame still decodes at true delivery time, so quantized
        chaos runs stay bitwise replay-equal per seed."""
        lane = self._lane(kw)
        if self._dead_mode("irecv_into", lane) == "partitioned":
            return Request(_test=lambda: (False, 0, None))  # never completes
        req = self.inner.irecv_into(comm, buf, tag=tag, codec=codec, **kw)
        hold = self.schedule.test_delay(lane=lane)
        if hold == 0:
            return req

        state = {"left": hold}

        def probe():
            done, size = req.test()   # progress underneath keeps flowing
            if not done:
                return False, 0, None
            if state["left"] > 0:     # hold the completion REPORT only
                state["left"] -= 1
                return False, 0, None
            return True, size, req.payload

        return Request(_test=probe)

    # -- one-sided verbs (the put-based data path) -------------------------
    #
    # Once these fell through __getattr__ — the put-based ring
    # collectives ran with ZERO fault coverage, the exact bug class the
    # vtable-conformance pass (tools/analyze/vtable.py) now makes
    # structurally impossible. Same model as the two-sided verbs: iwrite
    # and iread are data ops (they advance the schedule's op stream and
    # honor die/partition); alloc_mr is connection-plane setup and
    # read_mr_local/read_mr_view are reads of this rank's OWN memory —
    # explicit passthroughs, so the wrap is a documented decision instead
    # of a silent delegation.

    def alloc_mr(self, comm, nbytes: int):
        """Passthrough: MR registration is local setup (the connection
        faults already cover the rendezvous it rides on)."""
        return self.inner.alloc_mr(comm, nbytes)

    def iwrite(self, comm, rkey, mr, **kw) -> Request:
        if self._dead_mode("iwrite", self._lane(kw)) == "partitioned":
            # blackhole: the put "completes" locally but never lands — the
            # peer's doorbell poll (or credit wait) must time out, named
            size = memoryview(mr).nbytes
            return Request(_test=lambda: (True, size, None))
        return self.inner.iwrite(comm, rkey, mr, **kw)

    def iread(self, comm, rkey, nbytes: int, **kw) -> Request:
        if self._dead_mode("iread", self._lane(kw)) == "partitioned":
            return Request(_test=lambda: (False, 0, None))  # never completes
        return self.inner.iread(comm, rkey, nbytes, **kw)

    def read_mr_local(self, comm, mr, offset: int, nbytes: int):
        """Passthrough: the owner reading its own MR cannot flake — under
        a partition the peer's writes simply never arrive, which is the
        fault (the doorbell value stays stale and the caller times out)."""
        return self.inner.read_mr_local(comm, mr, offset, nbytes)

    def read_mr_view(self, comm, mr, offset: int, nbytes: int):
        """Passthrough, as :meth:`read_mr_local`."""
        return self.inner.read_mr_view(comm, mr, offset, nbytes)

    def test(self, req: Request):
        return req.test()

    def close_comm(self, comm) -> None:
        if self.schedule.close_drop():
            return  # died without FIN; inner.close() still reclaims it
        if hasattr(self.inner, "close_comm"):
            self.inner.close_comm(comm)
        elif hasattr(comm, "close"):
            comm.close()  # device-plane comms are bare rank pairs: no-op

    def close(self) -> None:
        self.inner.close()
