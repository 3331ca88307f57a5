"""Causal collective tracing — cross-rank op spans, critical-path
attribution, and the straggler scoreboard (DESIGN.md §6d).

the fleet histograms say *that* a collective was slow; this module
says *why* and *where*. Every collective already has a stable identity —
the committed-op counter under ``ProcessGroup._op_lock``, the group
epoch, and the lane channel — so ``_ring`` opens a per-op **span
context** (:func:`op_span`) and the wire's existing flight events
(``frame-posted``, ``frame-landed``/``frame-combined``,
``credit-stalled``, ``lane-admit-*``) recorded through :func:`record`
are stamped ``(epoch, chan, op)`` and collected into one **per-rank op
record**: the op's wall span, per-hop frame landing times (relative to
the rank's clock-sync mark, the same alignment contract the Perfetto
merger rides), the ring neighbours (frames already name their peer, so
cross-rank causality needs no wire-format change), and the measured
waits.

A leader-side assembler (:func:`assemble` — records travel inside the
fleet snapshots, same bounded best-effort publish rules) merges
the per-rank records of one ``(epoch, chan, op)`` into a cross-rank
span tree and extracts the **critical path**: the streaming engine only
forwards hop ``k+1``'s frame after hop ``k``'s landing *report*, so the
landing of hop ``k`` on rank ``r`` is causally gated by the landing of
hop ``k-1`` on ``r``'s upstream neighbour — the path is the unique
upstream chain walked back from the op's last landing, and each
segment's time belongs to the UPSTREAM rank that held the frame
(its recv-wait, its credit stall, its lane admission, its folds).
Per-rank wall time is attributed to five buckets
(:func:`attribution`): ``lane-admit``, ``credit-stall``, ``recv-wait``,
``compute-fold`` (all measured), and ``wire`` (the residual — so the
buckets sum to the op's wall span by construction). A windowed
:func:`scoreboard` turns assembled ops into the per-rank share of
critical-path time and a worst-hop histogram — the feed
``transport/tuner.py``'s stall breakdown wants.

Overhead model: the sampling knob ``ROCNRDMA_TRACE_SAMPLE`` (default
every 8th op per lane; ``0`` disables tracing) bounds
the hot path — an unsampled op pays one thread-local read per span
site, a sampled op additionally appends its events to a per-op list
(no formatting, no I/O) and builds one small record at commit. The
``bench_host --smoke`` zero-copy/floor gates run with tracing ON at
the default sampling.

Replay equality: :func:`digest` hashes only the STRUCTURAL half of the
records (identity, verbs, neighbours, per-hop frame counts — all pure
functions of the seed's event order); every wall-clock field is
excluded, so two same-seed chaos runs digest identically.

CLI::

    python -m rocnrdma_tpu_torch.obs.trace --store host:port [--watch SECS]
                                     [--json]
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import sys
import threading
import time

from rocnrdma_tpu_torch import lockwitness as _lockwitness
from rocnrdma_tpu_torch.obs.recorder import FLIGHT

DEFAULT_SAMPLE = 8

# the attribution buckets (seconds, per rank, summing to the op's wall
# span): the five MEASURED waits + the wire residual. ``encode`` is the
# streaming codec's quantize cost — pure calling-thread
# compute outside every recorded wait, so it counts in full like the
# scheduling waits; the DECODE half runs inside the consume callbacks
# and is measured as that frame's fold, landing in compute-fold.
WAIT_BUCKETS = ("lane-admit", "credit-stall", "recv-wait", "encode",
                "compute-fold")
BUCKETS = WAIT_BUCKETS + ("wire",)

# event kinds the op collector folds into the record (everything else
# recorded under a span rides the flight ring only)
_WAIT_EVENTS = {"lane-admit-done": "lane-admit",
                "credit-resumed": "credit-stall",
                "recv-wait": "recv-wait",
                "frame-encode-done": "encode"}
_LAND_KINDS = ("frame-landed", "frame-combined")


def sample_every() -> int:
    """The sampling stride: every Nth op per lane is fully traced
    (``ROCNRDMA_TRACE_SAMPLE``; 0 disables tracing, a malformed value
    degrades to the default — this is read on the collective hot path's
    slow half, never per frame)."""
    raw = os.environ.get("ROCNRDMA_TRACE_SAMPLE")
    if raw is None:
        return DEFAULT_SAMPLE
    try:
        return max(0, int(raw))
    except ValueError:
        return DEFAULT_SAMPLE


# ---------------------------------------------------------------------------
# The per-op span context (thread-local, like the lane context): which
# (epoch, chan, op) the wire's span sites stamp, and — when the op is
# sampled — the event list the op record is built from at commit.
# ---------------------------------------------------------------------------

_TLS = threading.local()


class _OpCtx:
    __slots__ = ("epoch", "chan", "op", "verb", "rank", "members", "t0",
                 "events", "conf")

    def __init__(self, epoch, chan, op, verb, rank, members=1):
        self.epoch = epoch
        self.chan = chan
        self.op = op
        self.verb = verb
        self.rank = rank
        self.members = members
        self.t0 = 0.0
        self.events: list = []
        # the pure picks' conformance notes (obs.conformance): appended
        # by note_pick under this span, joined against the measured
        # wall at COMMIT only — an aborted attempt's notes die with
        # the context, which is what keeps the conformance stream
        # replay-pure on its structural half
        self.conf: list | None = None


@contextlib.contextmanager
def bucket_members(n: int):
    """Mark the next op span opened on this thread as a COALESCED
    bucket of ``n`` member ops (the async verb surface's fused
    streams, DESIGN.md §5i): the span — and the op record the
    assembler and the replay digest consume — carries the member
    count, so a trace reader sees "one op, 64 collectives inside"
    instead of a mysteriously large small-op. Thread-local, nests and
    restores like the lane context."""
    prev = getattr(_TLS, "members", 1)
    _TLS.members = max(1, int(n))
    try:
        yield
    finally:
        _TLS.members = prev


def tracing() -> bool:
    """True while the calling thread is inside a SAMPLED op span (only
    sampled ops carry a context at all — this is the one check the
    per-frame span sites pay on unsampled ops)."""
    return getattr(_TLS, "op", None) is not None


@contextlib.contextmanager
def suspended():
    """Run a block OUTSIDE the calling thread's op span. The p2p
    stream-resume service runs from the net progress hook INSIDE a
    traced collective's blocking waits; its lane admits and credit
    stalls belong to the resumed stream, not to the op that happened
    to pump it — stamping them would double-bill the op (the enclosing
    recv-wait already covers that wall time) and drive the wire
    residual negative."""
    prev = getattr(_TLS, "op", None)
    if prev is None:
        yield
        return
    _TLS.op = None
    try:
        yield
    finally:
        _TLS.op = prev


def record(kind: str, **args) -> None:
    """Record one span-site flight event: stamped with the active op's
    identity and collected into the op's event list when a sampled span
    is open, a plain ``FLIGHT.record`` otherwise. The wire's span sites
    (frame lifecycle, credit stalls, lane admission) call THIS instead
    of ``FLIGHT.record`` — one extra thread-local read per event is the
    whole unsampled-path cost.

    Inside a hierarchical LEG context (:func:`leg`) every frame
    event's hop id is lifted into that leg's hop namespace
    (``hop + leg << 16``): one hierarchical collective streams several
    ``_RingWire``s under ONE op span, and each wire's hop counter
    starts at 1 — without the offset the legs' per-hop entries would
    collide in the op record (frame counts merged across legs, landing
    times maxed across sub-rings)."""
    ctx = getattr(_TLS, "op", None)
    leg_no = getattr(_TLS, "leg", 0)
    if leg_no:
        h = _hop_of(args)
        if h is not None:
            args = dict(args, hop=h + (leg_no << 16))
    if ctx is not None:
        args = dict(args, op=ctx.op, chan=ctx.chan, epoch=ctx.epoch)
        ctx.events.append((time.perf_counter(), kind, args))
    FLIGHT.record(kind, **args)


@contextlib.contextmanager
def leg(leg_no: int):
    """Run one LEG of a hierarchical collective (the local
    reduce-scatter, the cross-node ring, the local allgather) under a
    distinct hop namespace, with a structural ``hier-leg`` marker on
    the op's event list (the record assembler counts the legs; the
    replay digest covers the count). Thread-local, nests and restores
    like the lane context."""
    prev = getattr(_TLS, "leg", 0)
    _TLS.leg = int(leg_no)
    record("hier-leg", leg=int(leg_no))
    try:
        yield
    finally:
        _TLS.leg = prev


# -- the span markers (the analyzer's span-pairing rule, pass #4f, pins
# that every _span_open in this module has a guaranteed close) ----------


def _span_open(kind: str, **args) -> float:
    """Open a trace span (``<kind>-start`` on the flight timeline);
    returns the timestamp the close side measures the wall span from."""
    FLIGHT.record(kind + "-start", **args)
    return time.perf_counter()


def _span_close(kind: str, t0: float, **args) -> float:
    """Close a trace span (``<kind>-end`` with the wall span as
    ``dur``); returns the wall seconds."""
    dt = time.perf_counter() - t0
    FLIGHT.record(kind + "-end", dur=dt, **args)
    return dt


def _span_abort(kind: str, t0: float, **args) -> None:
    """Close a trace span on an abort path (``<kind>-abort`` with the
    partial wall as ``dur``) — the record-and-reraise half of the
    span-pairing invariant."""
    FLIGHT.record(kind + "-abort", dur=time.perf_counter() - t0, **args)


@contextlib.contextmanager
def op_span(epoch: int, chan: int, op: int, verb: str, rank: int):
    """Run one collective attempt under its op span. Sampling decides
    here: an unsampled op (or a nested span — p2p issued from inside a
    traced collective stays with the outer op) yields None and records
    nothing. A sampled op opens a ``trace-op`` span, collects the span
    sites' events, and on COMMIT pushes the finished op record to
    :data:`TRACE`; on an abort the span closes with ``trace-op-abort``
    and re-raises (aborted attempts never reach the buffer — their
    partial frame counts are timing-shaped and would poison the replay
    digest)."""
    n = sample_every()
    if n <= 0 or op % n or getattr(_TLS, "op", None) is not None:
        yield None
        return
    members = getattr(_TLS, "members", 1)
    ctx = _OpCtx(epoch, chan, op, verb, rank, members=members)
    ctx.t0 = _span_open("trace-op", epoch=epoch, chan=chan, op=op,
                        verb=verb, rank=rank, members=members)
    _TLS.op = ctx
    try:
        yield ctx
    except BaseException as e:
        _span_abort("trace-op", ctx.t0, epoch=epoch, chan=chan, op=op,
                    error=type(e).__name__)
        raise
    else:
        wall = _span_close("trace-op", ctx.t0, epoch=epoch, chan=chan,
                           op=op)
        TRACE.push(_op_record(ctx, wall))
        if ctx.conf:
            # the conformance join: the op's pick notes meet
            # the measured wall under the same stable identity, on the
            # COMMIT path only — the abort path above re-raises past
            # this, so aborted attempts never join. Lazy import: trace
            # must stay importable without the conformance layer.
            from rocnrdma_tpu_torch.obs import conformance as _conf
            _conf.join_commit(ctx, wall)
    finally:
        _TLS.op = None


# ---------------------------------------------------------------------------
# Op records: one small JSON-able dict per sampled, COMMITTED op.
# ---------------------------------------------------------------------------


def _hop_of(args: dict):
    """The wire hop an op-stamped frame event belongs to: explicit
    ``hop`` (posted events) or decoded from the frame ``tag``
    (``hop << 16 | frame`` — the ONE tag layout, ``_RingWire._tag``)."""
    if "hop" in args:
        return args["hop"]
    tag = args.get("tag")
    return tag >> 16 if isinstance(tag, int) else None


def _events_to_record(events, *, epoch, chan, op, verb, rank,
                      t_start, wall_s, sync, members=1) -> dict:
    """The ONE op-record assembler: fold a sampled op's span-site events
    into the condensed per-rank record. ``sync`` is the rank's
    clock-sync mark — every stored time is relative to it, which is
    what lets the assembler align ranks (and the Perfetto merger reuse
    the records against its frame slices)."""
    # hop -> [frames, t_post0, t_land_last, t_sent0]: the hop number is
    # the GLOBAL ring step — a rank RECEIVES hop k's frames from its
    # upstream and SENDS hop k's frames to its downstream (its hop k-1
    # dest forwarded), so one hop entry carries both edges' times
    hops: dict[int, list] = {}
    waits = {b: 0.0 for b in WAIT_BUCKETS}
    up = down = None
    n_frames = 0
    hier_legs = 0
    for t, kind, args in events:
        if kind == "hier-leg":
            # a hierarchical collective's leg marker:
            # structural — the digest covers the leg count, and the
            # assembler knows this op's hop entries span several
            # sub-rings (no single-ring critical path exists)
            hier_legs = max(hier_legs, int(args.get("leg", 0)))
        elif kind == "stream-start":
            up = args.get("up", up)
            down = args.get("down", down)
        elif kind == "frame-posted":
            h = _hop_of(args)
            cur = hops.setdefault(h, [0, None, None, None])
            if cur[1] is None or t < cur[1]:
                cur[1] = t
        elif kind == "frame-sent":
            h = _hop_of(args)
            cur = hops.setdefault(h, [0, None, None, None])
            if cur[3] is None or t < cur[3]:
                cur[3] = t
        elif kind in _LAND_KINDS:
            h = _hop_of(args)
            cur = hops.setdefault(h, [0, None, None, None])
            cur[0] += 1
            n_frames += 1
            if cur[2] is None or t > cur[2]:
                cur[2] = t
            waits["compute-fold"] += args.get("fold", 0.0)
        else:
            bucket = _WAIT_EVENTS.get(kind)
            if bucket is not None:
                waits[bucket] += args.get("dur", 0.0)
    base = min(hops) if hops else 0
    if base >= (1 << 16):
        # leg-namespaced (hierarchical) hops keep their ABSOLUTE leg
        # ids: normalizing against this rank's own first leg would make
        # leg decoding depend on which legs the rank happened to run —
        # a singleton node skips the local legs, and its cross-ring
        # hops must still read as leg 2 at the assembler
        base = 0

    def rel(t):
        return None if t is None else round(t - sync, 9)

    return {
        "v": 1,
        "epoch": epoch, "chan": chan, "op": op, "verb": verb,
        "rank": rank, "up": up, "down": down,
        # coalesced-bucket spans: how many member collectives the one
        # op carries (1 for ordinary collectives) — structural, so the
        # replay digest covers it
        "members": members,
        # hierarchical spans: the highest leg index this
        # op's streams ran under (0 for flat collectives) — structural,
        # and the assembler's signal that the hop entries span several
        # sub-rings (so no single-ring critical path is extracted)
        "hier_legs": hier_legs,
        "t_start": rel(t_start),
        "wall_s": round(wall_s, 9),
        "n_frames": n_frames,
        # hop indices normalized 0-based within the op (the wire's hop
        # counter is per-_RingWire and already starts at 0 for the ring
        # collectives; p2p/long-lived wires are not op-traced)
        "hops": [[h - base, c[0], rel(c[1]), rel(c[2]), rel(c[3])]
                 for h, c in sorted(hops.items())],
        "waits": {b: round(s, 9) for b, s in waits.items()},
    }


def _op_record(ctx: _OpCtx, wall_s: float) -> dict:
    sync = FLIGHT.sync_ts or 0.0
    return _events_to_record(
        ctx.events, epoch=ctx.epoch, chan=ctx.chan, op=ctx.op,
        verb=ctx.verb, rank=ctx.rank, t_start=ctx.t0, wall_s=wall_s,
        sync=sync, members=ctx.members)


def records_from_events(events, rank: int, sync_ts) -> list:
    """Rebuild op records from a raw flight-event dump (the Perfetto
    merger's path: dumps carry the op-stamped events, and building the
    critical-path lane from the SAME events that render the frame
    slices keeps the two lanes aligned exactly). Only COMPLETE spans
    (a ``trace-op-start`` with its matching ``trace-op-end``) yield a
    record — a span open at dump time (or closed by an abort) has
    timing-shaped partial contents."""
    sync = sync_ts or 0.0
    spans: dict[tuple, dict] = {}
    for t, kind, args in events:
        key = (args.get("epoch"), args.get("chan"), args.get("op"))
        if None in key:
            continue
        if kind == "trace-op-start":
            spans[key] = {"t0": t, "verb": args.get("verb", "?"),
                          "members": args.get("members", 1),
                          "events": [], "wall": None}
        elif kind == "trace-op-end" and key in spans:
            spans[key]["wall"] = args.get("dur", 0.0)
        elif kind == "trace-op-abort":
            spans.pop(key, None)
        elif key in spans and spans[key]["wall"] is None:
            spans[key]["events"].append((t, kind, args))
    out = []
    for (epoch, chan, op), s in sorted(spans.items()):
        if s["wall"] is None:
            continue
        out.append(_events_to_record(
            s["events"], epoch=epoch, chan=chan, op=op, verb=s["verb"],
            rank=rank, t_start=s["t0"], wall_s=s["wall"], sync=sync,
            members=s.get("members", 1)))
    return out


class TraceBuffer:
    """Bounded ring of this rank's recent op records (the fleet
    snapshot publishes its contents; ``trace_stats`` reads it). Same
    lock discipline as the flight recorder — producers are whatever
    thread committed the collective."""

    def __init__(self, capacity: int = 16):
        self.capacity = max(1, capacity)
        self._lock = _lockwitness.make_lock(
            "obs/trace.py::TraceBuffer._lock")
        self._recs: list = []

    def push(self, rec: dict) -> None:
        with self._lock:
            self._recs.append(rec)
            if len(self._recs) > self.capacity:
                del self._recs[0]

    def snapshot(self) -> list:
        """The buffered records, oldest first (plain JSON-able data)."""
        with self._lock:
            return [dict(r) for r in self._recs]

    def reset(self) -> None:
        with self._lock:
            self._recs = []


def _from_env() -> TraceBuffer:
    try:
        cap = int(os.environ.get("ROCNRDMA_TRACE_OPS", "16"))
    except ValueError:
        cap = 16
    return TraceBuffer(capacity=max(1, cap))


# THE per-rank trace buffer (one per rank process, like FLIGHT/WIRE).
TRACE = _from_env()


# ---------------------------------------------------------------------------
# Attribution + cross-rank assembly (pure functions over records).
# ---------------------------------------------------------------------------


def attribution(rec: dict) -> dict:
    """One rank's op wall span split across the five buckets, summing
    to ``wall_s`` EXACTLY by construction. The three scheduling waits
    (lane-admit, credit-stall, recv-wait) are disjoint on the calling
    thread and count in full; folds OVERLAP those waits (the consume
    callbacks run from the very progress loops the waits pump), so
    ``compute-fold`` is credited only up to the wall time NOT already
    billed to a wait — never double-billed, and ``wire`` (the residual)
    can never go negative from fold overlap."""
    waits = rec.get("waits", {})
    b = {k: waits.get(k, 0.0) for k in WAIT_BUCKETS if k != "compute-fold"}
    residual = rec.get("wall_s", 0.0) - sum(b.values())
    b["compute-fold"] = min(waits.get("compute-fold", 0.0),
                            max(0.0, residual))
    b["wire"] = residual - b["compute-fold"]
    return b


def _land(rec: dict, hop: int):
    for entry in rec.get("hops", []):
        if entry[0] == hop:
            return entry[3]
    return None


def _sent(rec: dict, hop: int):
    for entry in rec.get("hops", []):
        if entry[0] == hop and len(entry) > 4:
            return entry[4]
    return None


def assemble(records, world: int | None = None) -> list:
    """Merge per-rank op records into per-op cross-rank span trees with
    their critical paths. ``records``: a flat iterable of op records
    from any number of ranks (each names its own rank). ``world``: when
    given, ops missing a rank's record are SKIPPED (a partial tree's
    critical path would silently blame whoever happened to publish).
    Independently, a critical path is only extracted when the op's
    streamed records form a CLOSED ring — every participant's ``up``
    neighbour present — a structural guard the world count alone
    cannot give: a dead rank's unwritten dump leaves exactly as many
    records as a smaller world would, but breaks ring closure.

    The critical path is the unique upstream landing chain (module
    docstring); each segment's time is attributed to its SOURCE rank —
    the upstream neighbour whose report-wait/credit/admission held the
    frame — and the head segment (hop 0) to the rank that queued the
    op's first send burst."""
    ops: dict[tuple, dict[int, dict]] = {}
    for r in records:
        ops.setdefault((r["epoch"], r["chan"], r["op"]),
                       {})[r["rank"]] = r
    out = []
    for (epoch, chan, op), per_rank in sorted(ops.items()):
        if world is not None and len(per_rank) < world:
            continue
        with_hops = {r: rec for r, rec in per_rank.items()
                     if rec.get("hops")}
        hier_legs = max((rec.get("hier_legs", 0)
                         for rec in per_rank.values()), default=0)
        if hier_legs:
            # hierarchical op: the hop entries span several
            # sub-rings whose `up` neighbours are SUB-ring indices —
            # the single-ring upstream chain does not exist, and a
            # cross-leg walk would blame whoever's local index
            # collided. Walls and the five-bucket attribution stay
            # exact; the critical path is deliberately not extracted.
            with_hops = {}
        elif not all(rec.get("up") in with_hops
                     for rec in with_hops.values()):
            with_hops = {}  # open ring: no trustworthy causal chain
        tree = {
            "epoch": epoch, "chan": chan, "op": op,
            "verb": next(iter(per_rank.values()))["verb"],
            # a coalesced bucket's member-op count (1 otherwise):
            # every rank committed the same bucket, so any record's
            # count is the op's
            "members": max(rec.get("members", 1)
                           for rec in per_rank.values()),
            "ranks": {str(r): {
                "wall_s": rec["wall_s"],
                "t_start": rec["t_start"],
                "up": rec.get("up"),
                "attribution": {k: round(v, 9) for k, v in
                                attribution(rec).items()},
            } for r, rec in sorted(per_rank.items())},
            "wall_s": round(
                max((rec["t_start"] or 0.0) + rec["wall_s"]
                    for rec in per_rank.values())
                - min(rec["t_start"] or 0.0
                      for rec in per_rank.values()), 9),
            "critical_path": [],
            "cp_total_s": 0.0,
            "cp_share": {},
            "cp_rank": None,
            "worst_hop": None,
        }
        if hier_legs:
            # the hierarchical op's structural story: no
            # single-ring critical path exists, but the
            # per-LEG walls do — the leg-namespaced hop entries carry
            # each sub-ring's posting/landing times, so the table can
            # say WHICH leg (local RS, cross ring, local AG) the wall
            # went to instead of dropping the op entirely
            tree["hier_legs"] = hier_legs
            tree["legs"] = _leg_walls(per_rank)
        if with_hops:
            path = _critical_path(with_hops)
            share: dict[int, float] = {}
            worst = None
            for node in path:
                # sender-side hold belongs to the upstream rank that
                # sat on the frame; the transfer+consume part to the
                # receiving rank (whose held completions / slow folds
                # it contains) — the split that lets one slow rank's
                # injected delay read as THAT rank on the path
                share[node["src"]] = share.get(node["src"], 0.0) \
                    + node["hold"]
                share[node["rank"]] = share.get(node["rank"], 0.0) \
                    + node["xfer"]
                if worst is None or node["dur"] > worst["dur"]:
                    worst = node
            total = sum(share.values())
            tree["critical_path"] = path
            tree["cp_total_s"] = round(total, 9)
            tree["cp_share"] = {str(r): round(s, 9)
                                for r, s in sorted(share.items())}
            if share:
                # sorted() pins the tie-break: equal shares blame the
                # LOWEST rank, so the evasion engine's decisions stay a
                # pure function of the trace stream 
                tree["cp_rank"] = max(sorted(share), key=share.get)
            if worst is not None:
                blame = (worst["src"] if worst["hold"] >= worst["xfer"]
                         else worst["rank"])
                tree["worst_hop"] = {"rank": worst["rank"],
                                     "hop": worst["hop"],
                                     "src": worst["src"],
                                     "blame": blame,
                                     "dur": worst["dur"]}
        out.append(tree)
    return out


def _leg_walls(per_rank: dict[int, dict]) -> list:
    """Cross-rank per-leg walls of one hierarchical op, from the
    leg-namespaced hop entries (``trace.leg`` lifts each sub-ring's
    hops into ``hop + leg << 16``, and the record assembler keeps
    hierarchical hops ABSOLUTE — normalizing per rank would misread a
    rank that skipped the local legs, e.g. a singleton node whose only
    hops are the cross ring's — so the leg index is ``hop >> 16``). A
    leg's wall runs from the earliest post/send any rank recorded in
    it to the latest landing — the whole-fleet span of that schedule
    stage. Legs whose records carry no usable times report ``wall_s``
    None (frames still counted): best-effort, never invented."""
    legs: dict[int, dict] = {}
    for rec in per_rank.values():
        for entry in rec.get("hops", []):
            h, frames, t_post, t_land = entry[0], entry[1], entry[2], \
                entry[3]
            t_sent = entry[4] if len(entry) > 4 else None
            leg = h >> 16
            cur = legs.setdefault(leg, {"frames": 0, "t0": None,
                                        "t1": None})
            cur["frames"] += frames
            for t in (t_post, t_sent):
                if t is not None and (cur["t0"] is None
                                      or t < cur["t0"]):
                    cur["t0"] = t
            if t_land is not None and (cur["t1"] is None
                                       or t_land > cur["t1"]):
                cur["t1"] = t_land
    return [{"leg": leg,
             "frames": v["frames"],
             "wall_s": (round(max(0.0, v["t1"] - v["t0"]), 9)
                        if v["t0"] is not None and v["t1"] is not None
                        else None)}
            for leg, v in sorted(legs.items())]


def _critical_path(per_rank: dict[int, dict]) -> list:
    """The unique upstream landing chain, oldest-first. Node ``(r, k)``
    is hop ``k``'s last-frame landing on rank ``r``; its predecessor is
    ``(up(r), k-1)`` — the engine forwards hop ``k``'s frames only
    after the upstream consumed its hop ``k-1``, so that edge IS the
    causality (no greedy choice to make). Each segment splits at the
    upstream's SEND time: ``hold = sent(up, k) - land(up, k-1)`` (the
    upstream sat on the frame — its credit stall, its lane admission)
    and ``xfer = land(r, k) - sent(up, k)`` (wire plus the receiver's
    consume — where a held completion report or a slow fold lives);
    records without send times fold the whole segment into ``hold``.
    The head segment runs from the op's earliest start."""
    # start: the globally last landing
    r, k, t_end = None, None, None
    for rank, rec in per_rank.items():
        for entry in rec["hops"]:
            land = entry[3]
            if land is not None and (t_end is None or land > t_end):
                r, k, t_end = rank, entry[0], land
    if r is None:
        return []
    t0 = min(rec["t_start"] or 0.0 for rec in per_rank.values())
    path = []
    while k is not None and k >= 0:
        land = _land(per_rank[r], k)
        if land is None:
            break
        up = per_rank[r].get("up")
        prev = (_land(per_rank[up], k - 1)
                if k > 0 and up in per_rank else None)
        if k > 0 and prev is not None:
            sent = _sent(per_rank[up], k)
            dur = max(0.0, land - prev)
            if sent is not None:
                hold = min(dur, max(0.0, sent - prev))
                xfer = max(0.0, dur - hold)
            else:
                hold, xfer = dur, 0.0
            path.append({"rank": r, "hop": k, "t_end": round(land, 9),
                         "dur": round(dur, 9),
                         "hold": round(hold, 9),
                         "xfer": round(xfer, 9),
                         "src": up})
            r, k = up, k - 1
        else:
            # the head: hop 0's landing, fed by the upstream's opening
            # send burst (attributed to the sender when known)
            src = up if up is not None else r
            sent = _sent(per_rank[up], k) if up in per_rank else None
            dur = max(0.0, land - t0)
            if sent is not None:
                hold = min(dur, max(0.0, sent - t0))
                xfer = max(0.0, dur - hold)
            else:
                hold, xfer = dur, 0.0
            path.append({"rank": r, "hop": k, "t_end": round(land, 9),
                         "dur": round(dur, 9),
                         "hold": round(hold, 9),
                         "xfer": round(xfer, 9),
                         "src": src})
            break
    path.reverse()
    return path


def scoreboard(assembled, window: int | None = None) -> dict:
    """The windowed straggler scoreboard over assembled ops: each
    rank's share of total critical-path time, a worst-hop histogram
    (how often each (rank, hop) was an op's single worst segment), and
    the straggler — the rank holding the largest share (ties broken to
    the LOWEST rank, so consumers stay replay-pure). ``window`` keeps
    only the most recent N assembled ops (``assemble`` sorts by
    (epoch, chan, op), so the tail IS the newest work) — the sliding
    view the evasion engine scores each tick."""
    if window is not None and window > 0:
        assembled = assembled[-window:]
    share: dict[int, float] = {}
    worst: dict[str, dict] = {}
    n = 0
    for tree in assembled:
        if not tree["critical_path"]:
            continue
        n += 1
        for rank_s, sec in tree["cp_share"].items():
            share[int(rank_s)] = share.get(int(rank_s), 0.0) + sec
        w = tree.get("worst_hop")
        if w is not None:
            hist = worst.setdefault(str(w.get("blame", w["src"])), {})
            hop = str(w["hop"])
            hist[hop] = hist.get(hop, 0) + 1
    total = sum(share.values())
    return {
        "ops": n,
        "cp_time_s": round(total, 9),
        "share": {str(r): round(s / total, 6) if total > 0 else 0.0
                  for r, s in sorted(share.items())},
        "worst_hop": worst,
        "straggler": (max(sorted(share), key=share.get)
                      if share else None),
    }


def digest(records) -> str:
    """Replay digest over op records: the STRUCTURAL fields only —
    identity, verb, rank, neighbours, per-hop frame counts. Every
    wall-clock-shaped field (spans, landing times, waits) is excluded,
    so the digest is a pure function of the seed's event order and two
    same-seed chaos runs hash identically."""
    structural = sorted(
        [r["epoch"], r["chan"], r["op"], r["verb"], r["rank"],
         r.get("up"), r.get("down"), r.get("n_frames", 0),
         r.get("members", 1), r.get("hier_legs", 0),
         [[entry[0], entry[1]] for entry in r.get("hops", [])]]
        for r in records)
    return hashlib.sha256(
        json.dumps(structural, sort_keys=True).encode()).hexdigest()


# ---------------------------------------------------------------------------
# Rendering + CLI (a pure store observer, like the fleet CLI).
# ---------------------------------------------------------------------------


def _us(s: float) -> str:
    return f"{s * 1e6:,.0f}us"


def format_trace(stats: dict) -> str:
    """Human-readable trace report: one block per assembled op (wall,
    critical path total, the straggler's share, the worst hop, per-rank
    attribution), then the windowed scoreboard."""
    sample = stats.get("sample")
    lines = [f"trace: epoch {stats.get('epoch', '?')}  "
             f"sample every {'?' if sample is None else sample}  "
             f"ops assembled {len(stats['ops'])}"]
    for tree in stats["ops"]:
        lines.append(
            f"  op e{tree['epoch']} c{tree['chan']} #{tree['op']} "
            f"{tree['verb']}"
            + (f" [hier x{tree['hier_legs']} legs]"
               if tree.get("hier_legs") else "")
            + f": wall {_us(tree['wall_s'])}  "
            f"cp {_us(tree['cp_total_s'])}  "
            + (f"cp-rank {tree['cp_rank']}" if tree["cp_rank"] is not None
               else "cp-rank -"))
        if tree.get("legs"):
            # hierarchical ops carry no single-ring critical path; the
            # per-leg walls are the structural attribution instead —
            # which schedule stage (local RS / cross ring / local AG)
            # the op's wall actually went to
            lines.append("    legs: " + "  ".join(
                f"L{lg['leg']}={_us(lg['wall_s']) if lg['wall_s'] is not None else '?'}"
                f" ({lg['frames']}f)" for lg in tree["legs"]))
        w = tree.get("worst_hop")
        if w is not None:
            lines.append(f"    worst hop: rank {w['src']} -> "
                         f"rank {w['rank']} hop {w['hop']} "
                         f"({_us(w['dur'])}, "
                         f"blame rank {w.get('blame', w['src'])})")
        for rank_s, info in tree["ranks"].items():
            a = info["attribution"]
            lines.append(
                f"    rank {rank_s}: wall {_us(info['wall_s'])}  "
                + "  ".join(f"{b}={_us(a[b])}" for b in BUCKETS))
    sb = stats.get("scoreboard") or {}
    if sb.get("ops"):
        shares = "  ".join(f"r{r}={frac:.0%}"
                           for r, frac in sb["share"].items())
        lines.append(f"  scoreboard ({sb['ops']} ops): {shares}  "
                     f"straggler rank {sb['straggler']}")
    return "\n".join(lines)


def read_trace(store_handle: str, group: str = "default",
               timeout_s: float = 5.0, flat: bool = False) -> dict:
    """One observer read of a group's published trace records: the
    fleet meta pointer names the generation, the records ride the
    fleet snapshots AND the telemetry tree's digests (concatenated
    unchanged up the agent tree — ``obs.fleet.read_records``, the same
    O(log n) root read with per-rank fallback as the fleet CLI;
    ``flat=True`` forces one read per member), and the assembler
    merges them. Records are fenced per record (a survivor's buffer
    still carries pre-heal ops whose trees would pair ranks that no
    longer neighbour each other). Raises ``LookupError`` when the
    group has published nothing."""
    from rocnrdma_tpu_torch.obs import fleet as _fleet
    epoch, members, records = _fleet.read_records(store_handle, group,
                                                  timeout_s, flat=flat)
    assembled = assemble(records, world=len(members))
    # the sampling stride is the PUBLISHING ranks' knob — a rank-less
    # observer cannot know it, only infer the spacing of what arrived
    # (the MINIMUM consecutive gap: one op dropped by a best-effort
    # publish must not read as double the stride)
    ops = sorted({t["op"] for t in assembled})
    inferred = min((b - a for a, b in zip(ops, ops[1:])), default=None)
    return {"epoch": epoch, "members": members,
            "sample": inferred, "ops": assembled,
            "scoreboard": scoreboard(assembled)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m rocnrdma_tpu_torch.obs.trace",
        description="Read a running group's causal collective traces "
                    "from its bootstrap store (one-shot, or --watch "
                    "for a live refresh)")
    p.add_argument("--store", required=True,
                   help="the group's bootstrap store handle (host:port)")
    p.add_argument("--group", default="default")
    p.add_argument("--timeout", type=float, default=5.0)
    p.add_argument("--watch", type=float, default=None, metavar="SECS",
                   help="refresh every SECS seconds until interrupted")
    p.add_argument("--iterations", type=int, default=0,
                   help=argparse.SUPPRESS)  # test hook: bound --watch
    p.add_argument("--json", action="store_true",
                   help="print the assembled trace snapshot as JSON")
    p.add_argument("--flat", action="store_true",
                   help="read one fleet snapshot per rank (O(n)) "
                        "instead of the telemetry tree's root digest "
                        "(O(log n)) — the escape hatch when agents "
                        "are suspect")
    args = p.parse_args(argv)
    shown = 0
    while True:
        try:
            stats = read_trace(args.store, args.group, args.timeout,
                               flat=args.flat)
        except (LookupError, OSError, TimeoutError) as e:
            print(f"trace: {type(e).__name__}: {e}", file=sys.stderr)
            return 1
        print(json.dumps(stats) if args.json else format_trace(stats),
              flush=True)
        shown += 1
        if args.watch is None or (args.iterations
                                  and shown >= args.iterations):
            return 0
        try:
            time.sleep(args.watch)
        except KeyboardInterrupt:
            return 0


if __name__ == "__main__":
    sys.exit(main())
