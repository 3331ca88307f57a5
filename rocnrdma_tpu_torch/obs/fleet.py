"""Fleet telemetry plane — live cross-rank aggregation over the store.

The flight recorder and the heal/grow machinery left rich PER-RANK
observability (``metrics.WIRE``/``VERBS``, the event ring, the liveness
table) with no fleet-level view: the self-tuning wire needs a live
measure feed from EVERY rank, multi-tenant lanes need per-channel fleet
metrics, and an operator watching a healing job needs one screen, not N
stderr streams. This module is that layer:

- :class:`FleetAgent` — the per-rank publisher. It piggybacks a windowed
  telemetry snapshot (wire counters + delta, verb-latency histograms,
  flight-ring high-water mark, coarse health state, recent health
  transitions) onto the existing liveness heartbeat: the watchdog thread
  calls :meth:`FleetAgent.publish` each tick, writing ONE epoch-qualified
  store key (``pg/<group>/fleet/e<epoch>/<orig>``) plus a tiny ``meta``
  pointer. Publishes are strictly best-effort and bounded — an explicit
  ``timeout_s`` on every store write, NO retry loop, failures recorded
  as ``telemetry-abort`` flight events and absorbed (a telemetry stall
  must never stall a heartbeat, let alone a collective; the analyzer's
  telemetry rule in ``tools/analyze/obs.py`` pins exactly this shape).

- :func:`aggregate` — the leader-side merger. Snapshots are epoch-tagged
  and FENCED like wire frames: a payload stamped with another generation
  is dropped and counted (``stale_dropped``, plus a ``telemetry-fenced``
  flight event), never merged into a post-heal view. Live snapshots
  merge exactly: wire counters by field-wise addition
  (``WireCounters.merge``), verb latencies by bucket-wise histogram
  addition (``VerbLatencies.merge`` — log2 buckets share one exponent
  grid, so the merged P50/P99 read off ``bucket_percentile_us`` equal
  what one recorder observing every rank would report), throughput by
  summing each rank's own windowed streamed-bytes rate.

- the CLI — ``python -m rocnrdma_tpu_torch.obs.fleet --store host:port`` reads
  the group's telemetry namespace once and prints the fleet table;
  ``--watch SECS`` refreshes it live. The CLI is a pure observer: a
  rank-less store client, reads only.

Staleness/overhead model (DESIGN.md §6c): one publish is one bounded
store ``set`` of a few KB from the watchdog thread; the freshest view
lags by at most one watchdog interval per rank; a heal's leader prune
sweeps dead generations' ``fleet/e<k>/`` keys so long-lived stores never
accrete snapshot keys (``transport.bootstrap``'s generic prefixed kv
sweep).

Fleet-scale tree aggregation (DESIGN.md §6e): the flat read
above is one key per rank per refresh — fine at 4 ranks, a wall at 256.
The hierarchical plane splits the work: a per-node :class:`NodeAgent`
(elected exactly like the hier-ring leader — the node's lowest
SURVIVING original rank, re-elected by the confirmed-dead set and by
every heal/grow) reads its local ranks' snapshot keys, condenses them
into ONE node digest (wire counters merged field-wise, verb histograms
bucket-wise, per-rank health/transitions/rates preserved as small
rows, trace records concatenated for cp assembly), merges its tree
children's subtree digests, and publishes one epoch-qualified subtree
key per window (``fleet/e<N>/tree/<node>`` — swept by the same heal
prune). The tree is heap-shaped over the ordered node list with a
fanout knob (``ROCNRDMA_FLEET_FANOUT``), so digests reach the root in
⌈log_f(nodes)⌉ windows and an observer reads O(log n) keys (meta +
root + per-rank fallbacks for uncovered members) instead of O(n); the
``--flat`` escape hatch keeps the per-rank read. Exactness is by
construction: the merge operators are associative and the final
assembly (:func:`_assemble`) runs once over identical per-rank rows,
so tree-merged equals flat-merged bit-for-bit on every counter and
histogram bucket (the property ``tests/test_fleettree.py`` pins at
depth). A dead agent degrades its node to direct per-rank reads (the
observer's fallback) until re-election — telemetry stays strictly
best-effort and bounded on every agent path, same as the per-rank
publishes.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import threading
import time

from rocnrdma_tpu_torch import lockwitness as _lockwitness
from rocnrdma_tpu_torch.metrics import (
    CONF as _CONF,
    STORE as _STORE,
    VERBS as _VERBS,
    WIRE as _WIRE,
    ConformanceCounters,
    StoreCounters,
    VerbLatencies,
    WireCounters,
    bucket_percentile_us,
)
from rocnrdma_tpu_torch.obs.recorder import FLIGHT as _FLIGHT
from rocnrdma_tpu_torch.obs import conformance as _conformance
from rocnrdma_tpu_torch.obs import trace as _trace

# the coarse per-rank health states the fleet plane reports. Transitions
# are recorded by ProcessGroup._set_health at protocol points (confirmed
# death -> degraded, heal/grow entry -> healing, standby admission wait
# -> resuming, committed membership -> ok), never sampled from timers —
# so the transition SEQUENCE is a pure function of the failure story and
# replays equal from a chaos seed (the FLEET digest contract).
HEALTH_STATES = ("ok", "degraded", "healing", "resuming")

# counters whose fleet totals are deterministic per chaos seed (what the
# FLEET digest may hash): fence/resume counts are data-flow-determined,
# grows/promotions are membership events, and the per-LANE fence split
# (channel_frames_fenced, a lane-name -> count dict) is the same
# data-flow fact attributed per tenant. Stream/copy/overlap counts are
# wall-clock-shaped (how many frames landed before an abort's timeout
# fired) and stay OUT of any replay-equality contract.
DETERMINISTIC_COUNTERS = ("frames_fenced", "frames_resumed", "grows",
                          "promotions", "evasion_reshapes",
                          "evasion_promotions", "channel_frames_fenced")


def _ns(group: str) -> str:
    return f"pg/{group}/fleet"


def snapshot_key(group: str, epoch: int, orig: int) -> str:
    """The one store key rank ``orig`` publishes under in ``epoch`` —
    epoch-qualified exactly like the heartbeat/heal namespaces, so a
    healed-away generation's telemetry is unreachable by construction
    (and sweepable by prefix: ``pg/<group>/fleet/e<k>/``)."""
    return f"{_ns(group)}/e{epoch}/{orig}"


def meta_key(group: str) -> str:
    """The discovery pointer the CLI reads first: current epoch +
    member list, re-written by every publish (last writer wins; every
    member of one generation writes the same value)."""
    return f"{_ns(group)}/meta"


# ---------------------------------------------------------------------------
# The telemetry tree: node split, agent election, tree shape.
# ---------------------------------------------------------------------------

DEFAULT_FANOUT = 4

# origs past the node map's reach (grow joiners) run as singleton nodes
# — the same convention as the hierarchical collectives' node split
_JOINER_NODE_BASE = 1 << 20


def tree_fanout() -> int:
    """The agent tree's fanout knob (``ROCNRDMA_FLEET_FANOUT``, floor 2
    — fanout 1 would be a depth-n chain, the very shape this tree
    exists to avoid; malformed values degrade to the default)."""
    raw = os.environ.get("ROCNRDMA_FLEET_FANOUT")
    if raw is None:
        return DEFAULT_FANOUT
    try:
        return max(2, int(raw))
    except ValueError:
        return DEFAULT_FANOUT


def tree_key(group: str, epoch: int, node_idx: int) -> str:
    """The ONE subtree-digest key node ``node_idx``'s agent publishes —
    under the epoch-qualified fleet namespace, so the heal leader's
    existing ``fleet/e<k>/`` prune sweeps dead generations' digests
    with the per-rank snapshots, no new hygiene path needed."""
    return f"{_ns(group)}/e{epoch}/tree/{node_idx}"


def split_nodes(members, node_of) -> list:
    """The membership split into nodes: ``[(node_id, [origs
    ascending]), ...]`` ordered by each node's lowest original rank — a
    pure function of (members, map), the same convention as the
    hierarchical collectives' split, so the telemetry tree and the
    hier rings agree on who a node's leader is. ``node_of`` None (a
    flat group running the tree anyway, e.g. simfleet) makes every
    member a singleton node."""
    by_node: dict = {}
    for g in members:
        if node_of is None:
            nid = g
        elif g < len(node_of):
            nid = node_of[g]
        else:
            nid = _JOINER_NODE_BASE + g
        by_node.setdefault(nid, []).append(g)
    nodes = [(nid, sorted(mem)) for nid, mem in by_node.items()]
    nodes.sort(key=lambda kv: kv[1][0])
    return nodes


def node_agents(nodes, dead=()) -> dict:
    """The elected agent per node index: the node's lowest original
    rank NOT in the confirmed-dead set (``None`` when the whole node
    is dead). Election is a pure function of (nodes, dead) — every
    rank derives the same verdict from the shared death flags, and a
    heal/grow that rewrites the membership re-elects for free, exactly
    like the hier-ring leader."""
    dead = set(dead)
    return {idx: next((g for g in mem if g not in dead), None)
            for idx, (_nid, mem) in enumerate(nodes)}


def tree_children(idx: int, n_nodes: int, fanout: int) -> list:
    """Node ``idx``'s children in the heap-shaped agent tree (node
    indices are positions in the ordered :func:`split_nodes` list, so
    the shape is a pure function of (membership, fanout))."""
    lo = fanout * idx + 1
    return [c for c in range(lo, min(lo + fanout, n_nodes))]


def tree_depth(n_nodes: int, fanout: int) -> int:
    """Propagation depth of the agent tree: how many publish windows a
    leaf's digest needs to reach the root — ⌈log_f(nodes)⌉-shaped (0
    for a single node)."""
    if n_nodes <= 1:
        return 0
    return max(1, math.ceil(math.log(n_nodes * (fanout - 1) + 1, fanout))
               - 1)


def _bootstrap():
    """Lazy transport.bootstrap import (module-level would be a cycle:
    bootstrap counts its RPCs into metrics and flight-records through
    the obs package this module lives in)."""
    from rocnrdma_tpu_torch.transport import bootstrap
    return bootstrap


class FleetAgent:
    """Per-rank telemetry publisher riding the liveness heartbeat.

    Owns the window state (last-published counter snapshots + stamp) so
    each publish carries both CUMULATIVE counters (exact cross-rank
    merging) and the DELTA over its own window (live rates). All state
    is behind one lock: the watchdog thread publishes on its tick while
    the main thread may publish explicitly (``publish_telemetry``) or
    read a fresh local snapshot for ``fleet_stats``.
    """

    def __init__(self, pg):
        self._pg = pg
        self._lock = _lockwitness.make_lock("fleet.py::FleetAgent._lock")
        self._last_wire: dict | None = None
        self._last_t: float | None = None
        self._seq = 0

    def local_snapshot(self) -> dict:
        """This rank's telemetry payload, as the aggregator consumes it
        (plain JSON-serializable data). Cheap: two counter snapshots and
        a ring high-water read — no store traffic, no event scan."""
        pg = self._pg
        now = time.monotonic()
        wire = _WIRE.snapshot()
        with self._lock:
            seq = self._seq
            window_s = (now - self._last_t
                        if self._last_t is not None else 0.0)
            # the one windowing definition (scalars field-wise, per-lane
            # dicts key-wise), applied to the snapshot already in hand
            delta = WireCounters.delta_of(wire, self._last_wire)
        orig = pg.global_ranks[pg.rank] if pg.global_ranks else -1
        return {
            "v": 1,
            "rank": pg.rank,
            "orig": orig,
            "epoch": pg.epoch,
            "seq": seq,
            "plane": pg.plane,
            "health": pg.health(),
            "transitions": pg.health_transitions(),
            "heals": pg.heals,
            "window_s": round(window_s, 6),
            "wire": wire,
            "wire_delta": delta,
            # the negotiation GAUGES next to the counters: the
            # algorithm verdict / codec / frame picks
            # the wire last resolved — a silently-flat fleet is visible
            # from the observer CLI only if the gauge travels
            "negotiation": _WIRE.negotiation(),
            # the store-ops ledger: per-traffic-class store
            # round-trips, so the fleet view carries its own control-
            # plane cost as a counted fact
            "store": _STORE.snapshot(),
            "verb_latency": _VERBS.snapshot(),
            "flight": {"recorded": _FLIGHT.recorded(),
                       "capacity": _FLIGHT.capacity,
                       "saturated": _FLIGHT.saturated},
            # this rank's recent sampled op records (obs.trace): the
            # causal tracer's cross-rank assembly rides THIS channel —
            # no extra store writes, same bounded best-effort publish
            "trace": _trace.TRACE.snapshot(),
            # predictive straggler evasion: the armed
            # engine's tick/flagged-ranks/actions summary plus the
            # structural decision-log digest — how the fleet CLI shows
            # WHO was reshaped/promoted-around before any death.
            # getattr: test fakes predate the verb
            "evasion": (pg.evasion_state()
                        if hasattr(pg, "evasion_state")
                        else {"armed": False}),
            # model-conformance cells: predicted-vs-measured
            # cost per (plane, verb, size bucket) — cumulative, so the
            # tree's exact merge (ConformanceCounters.merge) holds the
            # same cross-rank totals the flat read would
            "conf": _CONF.snapshot(),
        }

    def publish(self, client, timeout_s: float = 1.0) -> bool:
        """ONE bounded, best-effort publish of this rank's snapshot.

        The contract the analyzer's telemetry rule enforces on this
        file: every store write carries an explicit ``timeout_s`` (the
        retry budget — one healthy round-trip, no reconnect loop past
        the bound) and a failure leaves a ``telemetry-abort`` flight
        event and returns False. Callers (the watchdog tick, the
        explicit ``publish_telemetry``) absorb that False: telemetry is
        an observer, never a participant."""
        snap = self.local_snapshot()
        pg = self._pg
        meta = json.dumps({"epoch": pg.epoch, "members": pg.global_ranks,
                           "world": pg.world_size, "group": pg.group_name})
        try:
            with _bootstrap().store_traffic("telemetry-publish"):
                client.set(snapshot_key(pg.group_name, snap["epoch"],
                                        snap["orig"]),
                           json.dumps(snap), timeout_s=timeout_s)
                client.set(meta_key(pg.group_name), meta,
                           timeout_s=timeout_s)
        except (OSError, TimeoutError) as e:
            _FLIGHT.record("telemetry-abort", epoch=snap["epoch"],
                           error=type(e).__name__)
            return False
        now = time.monotonic()
        with self._lock:
            self._seq += 1
            self._last_wire = snap["wire"]
            self._last_t = now
        return True


class NodeAgent:
    """Per-node telemetry aggregator — the telemetry tree's worker
    role.

    NOT a thread and NOT always an aggregator: every rank holds one,
    and :meth:`tick` (called from the owning rank's watchdog tick right
    after the per-rank publish, or from ``publish_telemetry``) first
    derives the election verdict — the node's lowest original rank not
    in the confirmed-dead set — and returns immediately on every rank
    that is not its node's agent. The elected rank reads its LOCAL
    ranks' per-rank snapshot keys plus its tree children's subtree
    digests, merges them (:func:`digest_of_snapshots` /
    :func:`merge_digests` — the same associative operators the flat
    path runs), and publishes ONE subtree digest key. Everything is
    strictly best-effort and bounded under the publish rules the
    analyzer's telemetry pass pins: explicit ``timeout_s`` on every
    store op, one attempt per tick, failures flight-evented
    (``telemetry-abort``) and absorbed. A dead agent simply stops
    publishing its subtree key; observers fall back to direct per-rank
    reads for the uncovered ranks (the degraded mode), and the next
    death-flag scan or heal re-elects."""

    def __init__(self, pg, fanout: int | None = None):
        self._pg = pg
        self._fanout = fanout

    def enabled(self) -> bool:
        """Tree publishing runs when the group carries a node map (the
        fleets where O(n) reads bite) or when ``ROCNRDMA_FLEET_TREE=1``
        forces singleton-node trees (simfleet, flat groups at scale);
        ``ROCNRDMA_FLEET_TREE=0`` kills it outright."""
        env = os.environ.get("ROCNRDMA_FLEET_TREE")
        if env == "0":
            return False
        return (env == "1"
                or getattr(self._pg, "_node_of", None) is not None)

    def _dead_origs(self):
        fn = getattr(self._pg, "confirmed_dead", None)
        return fn() if callable(fn) else ()

    def role(self) -> tuple:
        """``(my_node_idx, am_agent, nodes)`` — the election verdict, a
        pure function of (members, node map, confirmed dead)."""
        pg = self._pg
        members = list(pg.global_ranks or [])
        nodes = split_nodes(members, getattr(pg, "_node_of", None))
        agents = node_agents(nodes, self._dead_origs())
        me = members[pg.rank] if members else -1
        my_idx = next((i for i, (_nid, mem) in enumerate(nodes)
                       if me in mem), None)
        return my_idx, (my_idx is not None
                        and agents.get(my_idx) == me), nodes

    def tick(self, client, timeout_s: float = 1.0) -> bool:
        """One bounded, best-effort aggregation pass: local snapshot
        keys + child subtree digests in, one subtree digest key out.
        Returns False (never raises) when this rank is not an agent,
        the tree is disabled, or any store op failed — the failure is
        a ``telemetry-abort`` flight event, and the node degrades to
        direct per-rank reads at the observer until the next tick or
        re-election."""
        pg = self._pg
        if not self.enabled():
            return False
        my_idx, am_agent, nodes = self.role()
        if not am_agent:
            return False
        epoch = pg.epoch
        group = pg.group_name
        fanout = self._fanout or tree_fanout()
        local = nodes[my_idx][1]
        deadline = time.monotonic() + timeout_s
        remaining = lambda: max(0.05, deadline - time.monotonic())
        snaps: list = []
        child_digests: list = []
        try:
            with _bootstrap().store_traffic("telemetry-read"):
                for orig in local:
                    raw = client.try_get(
                        snapshot_key(group, epoch, orig),
                        timeout_s=remaining())
                    snaps.append(_parse(raw))
                for c in tree_children(my_idx, len(nodes), fanout):
                    raw = client.try_get(tree_key(group, epoch, c),
                                         timeout_s=remaining())
                    child_digests.append(_parse(raw))
        except (OSError, TimeoutError) as e:
            _FLIGHT.record("telemetry-abort", epoch=epoch, agent=my_idx,
                           error=type(e).__name__)
            return False
        subtree = merge_digests(
            [digest_of_snapshots(snaps, epoch, local)] + child_digests,
            epoch)
        try:
            with _bootstrap().store_traffic("telemetry-publish"):
                client.set(tree_key(group, epoch, my_idx),
                           json.dumps(subtree), timeout_s=remaining())
        except (OSError, TimeoutError) as e:
            _FLIGHT.record("telemetry-abort", epoch=epoch, agent=my_idx,
                           error=type(e).__name__)
            return False
        return True


def _parse(raw):
    """A torn/garbage store payload reads as missing, never a crash in
    the observability plane itself."""
    if raw is None:
        return None
    try:
        out = json.loads(raw)
    except ValueError:
        return None
    return out if isinstance(out, dict) else None


def condense_rank(s: dict) -> dict:
    """One rank's snapshot condensed to the small row a node digest
    carries: the per-rank facts the final fleet view preserves verbatim
    (health, transitions, windowed rate inputs, the rank's OWN P99, the
    negotiation gauges), WITHOUT the bulky per-rank histograms — those
    merge into the digest's fleet-level totals instead. A pure function
    of the snapshot, so every aggregation path (flat, any tree shape)
    derives identical rows and the final assembly is exact."""
    win = s.get("window_s") or 0.0
    delta = s.get("wire_delta", {})
    per_chan = delta.get("channel_bytes_streamed", {})
    neg = s.get("negotiation") or {}
    return {
        "rank": s.get("rank"),
        "orig": s.get("orig"),
        "health": s.get("health"),
        "seq": s.get("seq"),
        "heals": s.get("heals", 0),
        "window_s": win,
        "plane": s.get("plane", "?"),
        "bytes_w": delta.get("payload_bytes_streamed", 0),
        "chan_bytes_w": dict(per_chan) if isinstance(per_chan, dict)
                        else {},
        "p99_us": max((bucket_percentile_us(m["buckets"], 0.99)
                       for m in s.get("verb_latency", {}).values()),
                      default=0),
        "flight_recorded": s.get("flight", {}).get("recorded", 0),
        "flight_capacity": s.get("flight", {}).get("capacity", 0),
        "transitions": s.get("transitions", []),
        "algo": neg.get("algorithm"),
        "codec": neg.get("codec"),
        # the evasion engine's lockstep-adopted summary:
        # every rank of a generation carries the same flagged sets,
        # so any one row can label the whole membership
        "evasion": s.get("evasion", {"armed": False}),
        # this rank's worst out-of-band conformance ratio
        # (None = conformant) — a pure function of the snapshot, so
        # every aggregation path derives the identical row value
        "drift": _conformance.rank_drift(s.get("conf")),
    }


def digest_of_snapshots(snapshots, epoch: int, members) -> dict:
    """Condense parsed per-rank payloads into one DIGEST — the node
    agent's unit of aggregation, and (over the whole membership) the
    flat path's too: :func:`aggregate` is literally a one-digest tree,
    which is what makes tree-merged == flat-merged true by
    construction rather than by test luck.

    Fencing is the frame fence's contract applied to telemetry: a
    payload stamped with another generation — or an orig outside
    ``members`` — is dropped, counted in ``stale_dropped``, and left
    on the flight timeline as ``telemetry-fenced``; duplicates keep
    the highest ``seq``. The digest carries: merged wire counters
    (field-wise exact), merged verb histograms (bucket-wise exact),
    merged store-ops ledgers, condensed per-rank rows, and the ranks'
    trace records concatenated (the causal tracer's cp assembly rides
    the tree unchanged)."""
    members = set(members)
    live: dict[int, dict] = {}
    stale = 0
    for s in snapshots:
        if s is None:
            continue
        if s.get("epoch") != epoch or s.get("orig") not in members:
            stale += 1
            _FLIGHT.record("telemetry-fenced", epoch=epoch,
                           got=s.get("epoch"), orig=s.get("orig"))
            continue
        cur = live.get(s["orig"])
        if cur is None or s.get("seq", 0) >= cur.get("seq", 0):
            live[s["orig"]] = s
    ordered = [live[orig] for orig in sorted(live)]
    traces: list = []
    for s in ordered:
        traces.extend(s.get("trace", []))
    return {
        "v": 1,
        "epoch": epoch,
        "covers": sorted(live),
        "stale_dropped": stale,
        "wire_totals": WireCounters.merge([s["wire"] for s in ordered]),
        "verb_latency": VerbLatencies.merge(
            [s["verb_latency"] for s in ordered]),
        "store_totals": StoreCounters.merge(
            [s["store"] for s in ordered if isinstance(s.get("store"),
                                                       dict)]),
        # the conformance cells' exact cross-rank merge:
        # integer sums / bucket-wise histograms / min-max extremes —
        # associative, so tree-merged == flat-merged on every cell
        "conf_totals": ConformanceCounters.merge(
            [s["conf"] for s in ordered if isinstance(s.get("conf"),
                                                      dict)]),
        "rows": {str(s["orig"]): condense_rank(s) for s in ordered},
        "trace": traces,
    }


def merge_digests(digests, epoch: int) -> dict:
    """Associative merge of subtree digests (the agent tree's upward
    step). Digests stamped with another epoch are fenced like
    snapshots; a digest whose ``covers`` overlaps ranks already merged
    is dropped whole and counted stale (subtrees are disjoint by
    construction — an overlap means a torn tree, and double-counting
    a rank's counters would corrupt the exact totals the fence
    exists to protect)."""
    rows: dict[str, dict] = {}
    wire, verbs, store, confs, traces = [], [], [], [], []
    covers: set = set()
    stale = 0
    for d in digests:
        if d is None:
            continue
        if d.get("epoch") != epoch:
            stale += 1
            _FLIGHT.record("telemetry-fenced", epoch=epoch,
                           got=d.get("epoch"), orig="digest")
            continue
        dc = set(d.get("covers", ()))
        if dc & covers:
            stale += 1
            _FLIGHT.record("telemetry-fenced", epoch=epoch,
                           got=epoch, orig="digest-overlap")
            continue
        covers |= dc
        stale += d.get("stale_dropped", 0)
        rows.update(d.get("rows", {}))
        wire.append(d.get("wire_totals", {}))
        verbs.append(d.get("verb_latency", {}))
        store.append(d.get("store_totals", {}))
        confs.append(d.get("conf_totals", {}))
        traces.extend(d.get("trace", []))
    return {
        "v": 1,
        "epoch": epoch,
        "covers": sorted(covers),
        "stale_dropped": stale,
        "wire_totals": WireCounters.merge(wire),
        "verb_latency": VerbLatencies.merge(verbs),
        "store_totals": StoreCounters.merge(store),
        "conf_totals": ConformanceCounters.merge(confs),
        "rows": rows,
        "trace": traces,
    }


def _assemble(digest: dict, epoch: int, members: list) -> dict:
    """The final fleet view from one (fully merged) digest. Runs ONCE,
    at the observer, iterating the per-rank rows in sorted orig order —
    so even the float accumulations (rounded GB/s sums) are identical
    whichever tree shape delivered the rows."""
    rows = {int(o): r for o, r in digest.get("rows", {}).items()}
    verb_merged = digest.get("verb_latency", {})
    p50 = {v: bucket_percentile_us(m["buckets"], 0.50)
           for v, m in verb_merged.items()}
    p99 = {v: bucket_percentile_us(m["buckets"], 0.99)
           for v, m in verb_merged.items()}
    plane_GBps: dict[str, float] = {}
    channel_GBps: dict[str, float] = {}
    ranks: dict[str, dict] = {}
    worst_p99 = 0
    for orig in sorted(rows):
        r = rows[orig]
        win = r.get("window_s") or 0.0
        rate = (r.get("bytes_w", 0) / win / 1e9 if win > 0 else 0.0)
        if win > 0:
            plane_GBps[r.get("plane", "?")] = round(
                plane_GBps.get(r.get("plane", "?"), 0.0) + rate, 6)
            # the multi-tenant split of the same gauge: each rank's
            # windowed per-LANE streamed bytes (keyed by lane name),
            # summed across ranks — the per-channel fleet throughput
            # the QoS scheduler is judged by
            for lane, nb in r.get("chan_bytes_w", {}).items():
                channel_GBps[lane] = round(
                    channel_GBps.get(lane, 0.0) + nb / win / 1e9, 6)
        worst_p99 = max(worst_p99, r.get("p99_us", 0))
        ev = r.get("evasion") or {}
        evade = (None if not ev.get("armed")
                 else "P" if orig in ev.get("promoted", ())
                 else "R" if orig in ev.get("reshaped", ())
                 else "-")
        ranks[str(orig)] = {
            "rank": r.get("rank"),
            "health": r.get("health"),
            "seq": r.get("seq"),
            "window_s": win,
            "GBps": round(rate, 6),
            "p99_us": r.get("p99_us", 0),
            "flight_recorded": r.get("flight_recorded", 0),
            "flight_capacity": r.get("flight_capacity", 0),
            "transitions": r.get("transitions", []),
            "algo": r.get("algo"),
            "codec": r.get("codec"),
            # per-rank evasion flag: R = reshaped off the
            # critical chain, P = slot proactively re-crewed by a
            # promoted spare, '-' = armed and clean, None = not armed
            "evade": evade,
            # per-rank model drift: the rank's worst
            # out-of-band P50 predicted/measured ratio, None conformant
            "drift": r.get("drift"),
        }
    return {
        "epoch": epoch,
        "world_size": len(members),
        "members": list(members),
        "missing": [m for m in members if m not in rows],
        "stale_dropped": digest.get("stale_dropped", 0),
        "health": {str(orig): rows[orig].get("health")
                   for orig in sorted(rows)},
        "heals": max((r.get("heals", 0) for r in rows.values()),
                     default=0),
        "wire_totals": digest.get("wire_totals", {}),
        "store_totals": digest.get("store_totals", {}),
        "plane_GBps": plane_GBps,
        "channel_GBps": channel_GBps,
        "verb_latency": verb_merged,
        "verb_p50_us": p50,
        "verb_p99_us": p99,
        "worst_p99_us": worst_p99,
        # the fleet-level conformance table: the exactly-
        # merged cells plus the drifting cell keys — what the
        # conformance CLI and ProcessGroup.conformance_stats() read
        "conf_totals": digest.get("conf_totals", {}),
        "conf_drift": [k for k, v in _conformance.summarize(
            digest.get("conf_totals", {})).items() if v["drift"]],
        "ranks": ranks,
    }


def aggregate(snapshots, epoch: int, members: list) -> dict:
    """Merge per-rank telemetry payloads into ONE fleet snapshot.

    ``snapshots``: parsed payload dicts (``None`` entries skipped —
    missing ranks are reported, not invented). ``epoch``/``members``:
    the generation the caller believes current; any payload stamped
    with a DIFFERENT epoch is fenced — dropped, counted in
    ``stale_dropped``, and left on the flight timeline as a
    ``telemetry-fenced`` event — exactly the frame fence's contract
    applied to telemetry (a pre-heal rank's counters must never blend
    into a post-heal fleet view).

    The merged verb P50/P99 are bucket-exact: log2 histograms add
    bucket-wise (`VerbLatencies.merge`), and the percentile is read off
    the merged buckets, so it equals the percentile a single observer
    of all ranks' verbs would report (at bucket resolution).

    Internally this is the degenerate one-node case of the telemetry
    tree: condense → digest → assemble, shared verbatim with the
    hierarchical path  — which is WHY tree-merged equals
    flat-merged: there is one assembly, fed associatively-merged
    identical parts."""
    return _assemble(digest_of_snapshots(snapshots, epoch, members),
                     epoch, members)


def format_fleet(snap: dict) -> str:
    """Human-readable fleet table (the CLI's output; also handy in test
    failure messages). One header block (epoch, membership, health
    rollup, fleet counters), one row per live rank, one line per merged
    verb histogram."""
    w = snap["wire_totals"]
    lines = [
        f"fleet: epoch {snap['epoch']}  world {snap['world_size']}  "
        f"members {snap['members']}  heals {snap['heals']}",
        "  health: " + (" ".join(
            f"{o}={h}" for o, h in sorted(snap["health"].items(),
                                          key=lambda kv: int(kv[0])))
            or "(no live telemetry)"),
        f"  missing: {snap['missing']}  stale_dropped: "
        f"{snap['stale_dropped']}",
        f"  fenced {w.get('frames_fenced', 0)}  "
        f"resumed {w.get('frames_resumed', 0)}  "
        f"grows {w.get('grows', 0)}  promotions {w.get('promotions', 0)}  "
        # the predictive-evasion action counts  next to the
        # reactive membership events they pre-empt
        f"evade-R {w.get('evasion_reshapes', 0)}  "
        f"evade-P {w.get('evasion_promotions', 0)}  "
        # the hier counter next to the per-rank algo/codec columns
        # below: hier_ops counts schedules that actually RAN — a fleet
        # whose every rank gauges algorithm=hier but whose hier_ops
        # stays 0 is picking and silently falling back
        f"hier {w.get('hier_ops', 0)}  "
        f"streamed {w.get('frames_streamed', 0)} frames / "
        f"{w.get('payload_bytes_streamed', 0)} B",
        # the control plane's own cost, as counted by the store-ops
        # ledger: per-traffic-class store round-trips
        "  store-ops: " + (
            f"{snap['store_totals'].get('ops', 0)} total  " + " ".join(
                f"{c}={n}" for c, n in sorted(
                    snap["store_totals"].get("classes", {}).items()))
            if snap.get("store_totals", {}).get("ops") else "(no ledger)"),
        "  throughput: " + (" ".join(
            f"{p}={gb:.3f} GB/s" for p, gb in sorted(
                snap["plane_GBps"].items())) or "(no window yet)"),
        "  lanes: " + (" ".join(
            f"{lane}={gb:.3f} GB/s" for lane, gb in sorted(
                snap.get("channel_GBps", {}).items()))
            or "(no laned traffic in window)"),
        # the per-tenant fence split next to the per-tenant throughput:
        # which lane's frames died with a fenced generation (published
        # since the lanes PR; rendered here so the --watch view carries
        # the whole per-lane story on one screen)
        "  lane-fenced: " + (" ".join(
            f"{lane}={n}" for lane, n in sorted(
                snap["wire_totals"].get("channel_frames_fenced",
                                        {}).items()))
            or "(none)"),
    ]
    if snap.get("conf_drift"):
        lines.append("  conf-drift: " + " ".join(snap["conf_drift"]))
    hdr = (f"  {'orig':>5} {'rank':>5} {'health':>9} {'GB/s':>8} "
           f"{'p99(us)':>8} {'algo':>6} {'codec':>6} {'evade':>6} "
           f"{'drift':>7} {'flight':>12}")
    lines += [hdr, "  " + "-" * (len(hdr) - 2)]
    for o in sorted(snap["ranks"], key=int):
        r = snap["ranks"][o]
        drift = r.get("drift")
        lines.append(
            f"  {o:>5} {r['rank']:>5} {r['health']:>9} {r['GBps']:>8.3f} "
            f"{r['p99_us']:>8} "
            # the negotiation gauges: the
            # flat-vs-hier verdict and wire codec each rank last
            # resolved — a silently-flat fleet shows a column of
            # 'ring' here while the counters line's hier stays 0
            f"{r.get('algo') or '-':>6} {r.get('codec') or '-':>6} "
            # the per-rank evasion flag: R reshaped,
            # P proactively re-crewed, '-' armed+clean, 'off' unarmed
            f"{r.get('evade') or 'off':>6} "
            # the per-rank model drift: the worst
            # out-of-band P50 predicted/measured ratio, '-' conformant
            f"{f'{drift:.2f}x' if drift is not None else '-':>7} "
            f"{r['flight_recorded']}/{r['flight_capacity']}")
    for verb in sorted(snap["verb_latency"]):
        m = snap["verb_latency"][verb]
        lines.append(
            f"  verb {verb:>12}: n={m['count']} "
            f"mean={m['mean_us']:.1f}us "
            f"p50<={snap['verb_p50_us'][verb]}us "
            f"p99<={snap['verb_p99_us'][verb]}us")
    return "\n".join(lines)


def _observer_client(store_handle: str, group: str, timeout_s: float):
    """The rank-less, read-classed store client every observer read
    here rides (reads only; its round-trips land in the ledger's
    ``telemetry-read`` class)."""
    return _bootstrap().BootstrapClient(store_handle, None, timeout_s,
                                        scope=f"pg/{group}/ring",
                                        traffic_class="telemetry-read")


def _read_meta(client, group: str, timeout_s: float) -> tuple:
    """``(epoch, members)`` from the meta pointer; ``LookupError`` when
    nothing is published (distinct from an empty fleet) or the meta is
    torn — named so the observer CLI survives the degraded fleet it
    exists to observe."""
    meta_raw = client.try_get(meta_key(group), timeout_s=timeout_s)
    if meta_raw is None:
        raise LookupError(
            f"no fleet telemetry published for group {group!r} "
            f"(is a member's watchdog running?)")
    try:
        meta = json.loads(meta_raw)
        return int(meta["epoch"]), list(meta["members"])
    except (ValueError, KeyError, TypeError) as e:
        # a torn/garbage meta write: the observer names it instead
        # of dying with a decode traceback mid --watch
        raise LookupError(
            f"fleet meta for group {group!r} is unreadable "
            f"({type(e).__name__}) — a publish may be in flight; "
            f"retry") from e


def _fetch_snaps(client, group: str, epoch: int, origs, remaining) -> list:
    """Per-rank snapshot fallback reads under a shared remaining-budget
    deadline (a rank whose key cannot be read in budget is missing,
    never waited for; once the budget hits zero the remaining keys are
    not even asked for — n zero-budget round-trips against a dead
    store would stack n bounded reply waits). The ONE per-rank fetch:
    the observer paths here and ``ProcessGroup._fetch_member_snapshots``
    both ride it."""
    snaps = []
    for orig in origs:
        budget = remaining()
        if budget <= 0:
            snaps.append(None)  # out of budget: missing, not waited
            continue
        try:
            raw = client.try_get(snapshot_key(group, epoch, orig),
                                 timeout_s=budget)
        except (OSError, TimeoutError):
            raw = None  # reported missing, never waited for
        snaps.append(_parse(raw))
    return snaps


def fetch_root_digest(client, group: str, epoch: int, timeout_s: float):
    """One bounded read of the telemetry tree's root subtree digest
    for ``epoch`` — None on missing, torn, out-of-budget, or stamped
    with another generation (fenced + flight-evented like every fleet
    read). The ONE root fetch: ``read_tree`` and
    ``ProcessGroup._tree_root_digest`` both ride it, so the member and
    observer paths cannot drift on what counts as a valid digest."""
    try:
        raw = client.try_get(tree_key(group, epoch, 0),
                             timeout_s=timeout_s)
    except (OSError, TimeoutError):
        return None
    root = _parse(raw)
    if root is not None and root.get("epoch") != epoch:
        _FLIGHT.record("telemetry-fenced", epoch=epoch,
                       got=root.get("epoch"), orig="digest")
        return None
    return root


def read_snapshots(store_handle: str, group: str = "default",
                   timeout_s: float = 5.0) -> tuple:
    """One FLAT observer read of a group's published telemetry
    payloads: ``(epoch, members, snapshots)`` — the meta pointer names
    the generation, then every member's snapshot key is fetched under
    ONE remaining-budget deadline (an unreadable/torn payload reads as
    None, never waited for). O(n) store reads — the ``--flat`` escape
    hatch and the fallback path; :func:`read_tree` is the O(log n)
    default. Raises ``LookupError`` when the group has published
    nothing (no meta key) — distinct from an empty fleet."""
    client = _observer_client(store_handle, group, timeout_s)
    # ONE deadline for the whole refresh (meta + every member key): each
    # read gets the remaining budget, so an overloaded store costs one
    # bounded refresh, not (members + 1) stacked timeouts — the same
    # remaining-budget shape as ProcessGroup.fleet_stats
    deadline = time.monotonic() + timeout_s
    remaining = lambda: max(0.1, deadline - time.monotonic())
    try:
        epoch, members = _read_meta(client, group, remaining())
        return epoch, members, _fetch_snaps(client, group, epoch,
                                            members, remaining)
    finally:
        client.close()


def read_tree(store_handle: str, group: str = "default",
              timeout_s: float = 5.0) -> tuple:
    """One TREE observer read: ``(epoch, members, merged_digest)``.
    The meta pointer names the generation, the root subtree digest
    (``tree/0``) carries every rank an agent covered, and only the
    UNCOVERED members (dead agents' nodes, a tree still propagating,
    or a fleet with no agents at all) fall back to direct per-rank
    snapshot reads — so a healthy tree costs the observer 2 store
    round-trips where the flat read costs n+1, and a degraded one
    costs 2 + the degraded node's size, never silently less truth.
    Raises ``LookupError`` exactly like :func:`read_snapshots`."""
    client = _observer_client(store_handle, group, timeout_s)
    deadline = time.monotonic() + timeout_s
    remaining = lambda: max(0.1, deadline - time.monotonic())
    try:
        epoch, members = _read_meta(client, group, remaining())
        root = fetch_root_digest(client, group, epoch, remaining())
        covers = set(root.get("covers", ())) if root is not None else set()
        uncovered = [m for m in members if m not in covers]
        fallback = (_fetch_snaps(client, group, epoch, uncovered,
                                 remaining) if uncovered else [])
        merged = merge_digests(
            [root, digest_of_snapshots(fallback, epoch, uncovered)],
            epoch)
        return epoch, members, merged
    finally:
        client.close()


def read_fleet(store_handle: str, group: str = "default",
               timeout_s: float = 5.0, flat: bool = False) -> dict:
    """One observer read of a group's published telemetry, assembled
    into the fleet view. Default is the TREE path (O(log n) reads,
    per-rank fallback for uncovered members — a fleet publishing no
    digests degrades to exactly the flat read); ``flat=True`` is the
    escape hatch forcing one read per member. Raises ``LookupError``
    when the group has published nothing (no meta key) — distinct
    from an empty fleet."""
    if flat:
        epoch, members, snaps = read_snapshots(store_handle, group,
                                               timeout_s)
        return aggregate(snaps, epoch=epoch, members=members)
    epoch, members, digest = read_tree(store_handle, group, timeout_s)
    return _assemble(digest, epoch, members)


def read_records(store_handle: str, group: str = "default",
                 timeout_s: float = 5.0, flat: bool = False) -> tuple:
    """``(epoch, members, trace_records)`` — the causal tracer's
    observer fetch (``obs.trace.read_trace``). Trace records ride the
    fleet snapshots AND the tree digests (concatenated unchanged), so
    the trace CLI reads O(log n) keys too; records are fenced per
    record like ``trace_stats`` (a survivor's buffer still carries
    pre-heal ops whose trees would pair ranks that no longer
    neighbour each other)."""
    if flat:
        epoch, members, snaps = read_snapshots(store_handle, group,
                                               timeout_s)
        records = []
        for s in snaps:
            if s is None or s.get("epoch") != epoch:
                continue
            records.extend(r for r in s.get("trace", [])
                           if r.get("epoch") == epoch)
        return epoch, members, records
    epoch, members, digest = read_tree(store_handle, group, timeout_s)
    return epoch, members, [r for r in digest.get("trace", [])
                            if r.get("epoch") == epoch]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m rocnrdma_tpu_torch.obs.fleet",
        description="Read a running group's fleet telemetry from its "
                    "bootstrap store (one-shot, or --watch for a live "
                    "refresh)")
    p.add_argument("--store", required=True,
                   help="the group's bootstrap store handle (host:port)")
    p.add_argument("--group", default="default")
    p.add_argument("--timeout", type=float, default=5.0,
                   help="store read deadline per refresh (seconds)")
    p.add_argument("--watch", type=float, default=None, metavar="SECS",
                   help="refresh every SECS seconds until interrupted")
    p.add_argument("--iterations", type=int, default=0,
                   help=argparse.SUPPRESS)  # test hook: bound --watch
    p.add_argument("--json", action="store_true",
                   help="print the raw fleet snapshot as JSON")
    p.add_argument("--flat", action="store_true",
                   help="read one snapshot key per rank (O(n)) instead "
                        "of the agent tree's root digest (O(log n)) — "
                        "the escape hatch when agents are suspect")
    args = p.parse_args(argv)
    shown = 0
    while True:
        try:
            snap = read_fleet(args.store, args.group, args.timeout,
                              flat=args.flat)
        except (LookupError, OSError, TimeoutError) as e:
            print(f"fleet: {type(e).__name__}: {e}", file=sys.stderr)
            return 1
        print(json.dumps(snap) if args.json else format_fleet(snap),
              flush=True)
        shown += 1
        if args.watch is None or (args.iterations and
                                  shown >= args.iterations):
            return 0
        try:
            time.sleep(args.watch)
        except KeyboardInterrupt:
            return 0


if __name__ == "__main__":
    sys.exit(main())
