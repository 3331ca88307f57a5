"""Bandwidth metric definitions: the bench half of ``rocnrdma_tpu/metrics.py``.

Conventions (nccl-tests accounting, as in the reference):

- ``size_bytes`` is the per-rank buffer size S.
- **algbw** = S / t, what the caller observes.
- **busbw** = algbw x a per-collective factor that normalises for the
  traffic the algorithm must move per link (allreduce: 2(n-1)/n).

When n ranks share one GPU (``--fake-devices N``), every "link" is the
card's own HBM: a busbw measured that way is an HBM number, not an NVLink
number.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import math
import threading
import time
from typing import IO

from rocnrdma_tpu_torch import lockwitness as _lockwitness

GiB = 1024**3
MiB = 1024**2
KiB = 1024

_BUSBW_FACTOR = {
    "allreduce": lambda n: 2.0 * (n - 1) / n,
    "allgather": lambda n: (n - 1) / n,
    "reducescatter": lambda n: (n - 1) / n,
    "alltoall": lambda n: (n - 1) / n,
    "alltoallv": lambda n: (n - 1) / n,
    "allgatherv": lambda n: (n - 1) / n,
    "reducescatterv": lambda n: (n - 1) / n,
    "broadcast": lambda n: 1.0,
    "reduce": lambda n: 1.0,
    "gather": lambda n: (n - 1) / n,
    "scatter": lambda n: (n - 1) / n,
    "sendrecv": lambda n: 1.0,
    "fsdp": lambda n: (n - 1) / n,
    "moe_layer": lambda n: 2 * (n - 1) / n,
}


def algbw_GBps(size_bytes: int, seconds: float) -> float:
    """Algorithmic bandwidth in GB/s (decimal GB, as bandwidths are quoted)."""
    return size_bytes / seconds / 1e9


def busbw_GBps(collective: str, n_ranks: int, size_bytes: int,
               seconds: float, counts=None) -> float:
    """Bus bandwidth in GB/s per rank for ``collective`` over ``n_ranks``.

    ``counts``: per-rank element counts of the ragged verbs
    (allgatherv/reducescatterv); the factor is then the busiest rank's
    ``(sum - min(counts)) / sum``. A single rank moves nothing: 0.0."""
    if collective not in _BUSBW_FACTOR:
        raise ValueError(f"unknown collective {collective!r}; know {sorted(_BUSBW_FACTOR)}")
    if n_ranks < 1:
        raise ValueError(f"n_ranks must be >= 1, got {n_ranks}")
    if n_ranks == 1:
        return 0.0
    if counts is not None and collective in ("allgatherv", "reducescatterv"):
        total = float(sum(counts))
        if total <= 0:
            return 0.0
        factor = (total - float(min(counts))) / total
        return algbw_GBps(size_bytes, seconds) * factor
    return algbw_GBps(size_bytes, seconds) * _BUSBW_FACTOR[collective](n_ranks)


@dataclasses.dataclass
class BenchRecord:
    """One benchmark measurement row, serialisable to JSONL (one object per
    line, so an interrupted sweep resumes by reading back completed rows)."""

    bench: str
    collective: str
    algo: str
    n_ranks: int
    size_bytes: int
    dtype: str
    mean_s: float
    algbw_GBps: float
    busbw_GBps: float
    platform: str = ""
    # "performance" on the GPU; "correctness-oracle" on the CPU, whose
    # bandwidth columns are computed for format parity only
    tier: str = "performance"
    extra: dict = dataclasses.field(default_factory=dict)
    ts: float = dataclasses.field(default_factory=time.time)

    @classmethod
    def measure(cls, bench, collective, algo, n_ranks, size_bytes, dtype,
                mean_s, platform="", counts=None, **extra):
        return cls(
            bench=bench, collective=collective, algo=algo, n_ranks=n_ranks,
            size_bytes=size_bytes, dtype=dtype, mean_s=mean_s,
            algbw_GBps=algbw_GBps(size_bytes, mean_s),
            busbw_GBps=busbw_GBps(collective, n_ranks, size_bytes, mean_s,
                                  counts=counts),
            platform=platform,
            tier=("correctness-oracle" if platform == "cpu"
                  else "performance"),
            extra=extra,
        )

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @classmethod
    def from_json(cls, line: str) -> "BenchRecord":
        return cls(**json.loads(line))

    def write(self, fp: IO[str]) -> None:
        fp.write(self.to_json() + "\n")
        fp.flush()

    def key(self) -> tuple:
        """Identity of a sweep point, for resume-time dedup."""
        return record_key(self.bench, self.collective, self.algo, self.n_ranks,
                          self.size_bytes, self.dtype, knob_key(self.extra))


# Collective knobs that change the program (and so the sweep-point identity).
_KNOB_KEYS = ("op", "root", "shift", "cross_dtype", "intra_algo")


def knob_key(extra: dict) -> tuple:
    """Canonical (knob, value) tuple from a record's extra/knob dict."""
    return tuple((k, extra[k]) for k in _KNOB_KEYS
                 if extra.get(k) is not None)


def record_key(bench: str, collective: str, algo: str, n_ranks: int,
               size_bytes: int, dtype: str, knobs: tuple = ()) -> tuple:
    """THE sweep-point identity; every resume-key producer builds it here."""
    return (bench, collective, algo, n_ranks, size_bytes, dtype) + tuple(knobs)


def load_completed(path) -> set:
    """Read back a (possibly partial) JSONL sweep; return the set of done keys."""
    done = set()
    try:
        with open(path) as fp:
            for line in fp:
                line = line.strip()
                if not line:
                    continue
                try:
                    d = json.loads(line)
                except json.JSONDecodeError:
                    continue  # torn tail line from an interrupted run
                done.add(record_key(d["bench"], d["collective"], d["algo"],
                                    d["n_ranks"], d["size_bytes"], d["dtype"],
                                    knob_key(d.get("extra", {}))))
    except FileNotFoundError:
        pass
    return done


def format_table(records: list) -> str:
    """Human-readable stdout table for a list of BenchRecords. The ``tier``
    column keeps a CPU correctness-oracle row from reading as a
    measurement."""
    hdr = (f"{'collective':>13} {'algo':>12} {'ranks':>5} {'bytes':>14} "
           f"{'dtype':>9} {'tier':>18} {'time(us)':>12} "
           f"{'algbw GB/s':>11} {'busbw GB/s':>11}")
    lines = [hdr, "-" * len(hdr)]
    for r in records:
        lines.append(
            f"{r.collective:>13} {r.algo:>12} {r.n_ranks:>5} {r.size_bytes:>14} "
            f"{r.dtype:>9} {r.tier:>18} {r.mean_s * 1e6:>12.1f} "
            f"{r.algbw_GBps:>11.2f} {r.busbw_GBps:>11.2f}")
    return "\n".join(lines)


def scored_algbw_row(trials_s, per_rank_bytes: int, n_ranks: int,
                     algo: str, on_cpu: bool) -> dict:
    """The contract's second metric (alltoall algbw, ``BASELINE.json:2``) as
    a scored artifact row: the median of the trials' algbw and their
    spread. The headline's multi-rank branch writes it."""
    from statistics import median
    gb = sorted(algbw_GBps(per_rank_bytes, s) for s in trials_s)
    return {"metric": "alltoall_algbw_GBps_per_chip",
            "value": round(median(gb), 3), "unit": "GB/s", "algo": algo,
            "n_ranks": n_ranks, "size_bytes": per_rank_bytes,
            "stat": "median-of-trials",
            "spread": [round(gb[0], 3), round(gb[-1], 3)],
            "on_cpu": on_cpu}


# ---------------------------------------------------------------------------
# The host plane's counters: a copy of rocnrdma_tpu/metrics.py's (the wire,
# the store, per-verb latencies, conformance, faults). Process-wide
# singletons of THIS package: the reference's are separate objects.
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class WireCounters:
    """Zero-copy telemetry for the pipelined host-plane ring wire.

    Producers are the net-plugin's receive paths (``transport.plugin``):
    ``irecv_into`` counts every frame it lands or combines in place
    (``frames_streamed``); the legacy copy paths — staging a payload
    through an intermediate ``bytes``/``frombuffer`` materialization —
    count ``frames_copied`` and the bytes so staged
    (``payload_bytes_copied``). ``frames_overlapped`` counts streamed
    frames whose wire transfer had ALREADY completed when the consume
    loop first looked — i.e. the transfer fully overlapped the combine
    of earlier frames, which is the pipelining win made observable.

    The steady-state contract of the zero-copy ring collectives is
    ``payload_bytes_copied == 0`` across a timed window (the
    ``bench_host --smoke`` gate asserts exactly that on a delta of
    :data:`WIRE`, the process-wide instance every producer increments).

    Mutation goes through the ``copied``/``streamed``/``overlapped``
    methods, which hold the instance's own lock: producers include
    progress hooks that p2p verbs may drive from a watchdog-adjacent
    context, and "bumped under the GIL" is an implementation accident,
    not a contract — the lock makes the increments (and the
    snapshot/delta windows the smoke gate asserts on) sound wherever
    they run (the static race pass, ``tools/analyze/races.py``, enforces
    the same discipline for thread-shared attributes).
    """

    payload_bytes_copied: int = 0   # bytes staged through an extra copy
    payload_bytes_streamed: int = 0 # bytes landed/combined with NO staging
    #                                 copy (the numerator of the fleet
    #                                 plane's aggregate-throughput gauge)
    frames_streamed: int = 0        # frames landed/combined in place
    frames_copied: int = 0          # frames that took a staging copy
    frames_overlapped: int = 0      # streamed frames that beat the consumer
    frames_fenced: int = 0          # stale-epoch frames dropped at the vtable
    frames_resumed: int = 0         # p2p frames re-delivered on a resumed
    #                                 stream continuation across a heal/grow
    grows: int = 0                  # grow() admissions this rank completed
    promotions: int = 0             # spare promotions this rank took part in
    # predictive straggler evasion: policy actions taken
    # BEFORE any death confirmation — tier-1 ring reshapes around a
    # chronically cp-dominant rank, and tier-2 proactive drains/spare
    # promotions it escalated to. Counted on every member at the
    # action's lockstep commit, so same-seed chaos runs agree.
    evasion_reshapes: int = 0       # tier-1 ring rotations committed
    evasion_promotions: int = 0     # tier-2 proactive promotions committed
    # multi-tenant lane telemetry . The scalar pair counts the
    # LaneGate's scheduling decisions (a pacing yield a credit lane
    # paid; an admit deferred behind higher-priority intent/backlog);
    # the dicts are PER-LANE counters keyed by lane NAME ("default",
    # "bulk", ...; unregistered wire channels print as hex) so the
    # fleet plane can attribute throughput and epoch fencing to a
    # tenant, not just to the wire. Dict counters merge/window exactly
    # like the scalars (nested key-wise in merge()/delta()).
    lane_yields: int = 0            # credit-pacing yields paid by laned sends
    lane_waits: int = 0             # admits deferred (priority or backlog)
    channel_frames_streamed: dict = dataclasses.field(default_factory=dict)
    channel_bytes_streamed: dict = dataclasses.field(default_factory=dict)
    channel_frames_fenced: dict = dataclasses.field(default_factory=dict)
    # collective-coalescing telemetry (the async verb surface,
    # transport/coalesce.py): member ops absorbed into fused buckets,
    # buckets committed, a decile histogram of bucket fill at flush
    # (how full buckets run — the tuner's bucket_bytes feedback), and
    # the per-trigger split (size/time/barrier — a workload flushing
    # mostly by barrier is under-filling its buckets). Counted at
    # bucket COMMIT only, so retried buckets count once and the totals
    # are deterministic per seed.
    ops_coalesced: int = 0          # member ops that rode a fused bucket
    buckets_flushed: int = 0        # fused buckets committed
    bucket_fill: dict = dataclasses.field(default_factory=dict)
    bucket_triggers: dict = dataclasses.field(default_factory=dict)
    # quantized-wire telemetry (transport/codec.py): frames the sender
    # encoded to fp8/int8 and the payload bytes the compression kept
    # off the wire (decoded minus encoded size, headers included) —
    # deterministic counts of the op sequence, so the chaos FLEET
    # digest can cover codec activity
    frames_encoded: int = 0         # outgoing frames quantized at the wire
    payload_bytes_saved: int = 0    # decoded-minus-wire bytes the codec cut
    # node-aware hierarchical collectives: collectives that
    # ran the two-level schedule (local reduce-scatter -> cross-node
    # allreduce -> local allgather) instead of the flat ring — counted
    # per completed schedule, so the bench can prove the hier path was
    # genuinely exercised, not just picked
    hier_ops: int = 0

    def __post_init__(self):
        # not a dataclass field: asdict()/snapshot() must stay pure counters
        self._lock = _lockwitness.make_lock("metrics.py::WireCounters._lock")
        # negotiation GAUGES (not counters — windowing them with delta()
        # would be nonsense): the frame size, pipeline depth, and wire-
        # model version the ring wire last picked, so a perf regression
        # is attributable to the frame choice — and to the committed
        # tuner version that chose it (picks vary per call)
        self._frame_bytes = 0
        self._pipeline_depth = 0
        self._tuner_version = None
        self._codec = None
        # the node-aware ALGORITHM gauge: the flat-vs-
        # hierarchical verdict the last node-mapped collective resolved
        # ("ring"/"hier" — tuner.pick_algorithm, or the caller's
        # explicit override), so a record can PIN which schedule its
        # floor was measured on
        self._algorithm = None

    def copied(self, nbytes: int, frames: int = 1) -> None:
        """Record ``nbytes`` staged through an extra payload copy (the
        legacy path's one frame at a time)."""
        with self._lock:
            self.payload_bytes_copied += nbytes
            self.frames_copied += frames

    def streamed(self, frames: int = 1, nbytes: int = 0,
                 channel: str | None = None) -> None:
        """Record frames landed/combined in place (the zero-copy path);
        ``nbytes`` is the payload so delivered — the fleet telemetry
        plane's throughput gauge divides its window delta by the window
        seconds to estimate live per-rank wire bandwidth. ``channel``
        (a lane NAME) additionally attributes the delivery to its lane
        in the per-channel counters."""
        with self._lock:
            self.frames_streamed += frames
            self.payload_bytes_streamed += nbytes
            if channel is not None:
                self.channel_frames_streamed[channel] = \
                    self.channel_frames_streamed.get(channel, 0) + frames
                self.channel_bytes_streamed[channel] = \
                    self.channel_bytes_streamed.get(channel, 0) + nbytes

    def overlapped(self, frames: int = 1) -> None:
        """Record streamed frames whose transfer beat the consume loop."""
        with self._lock:
            self.frames_overlapped += frames

    def fenced(self, frames: int = 1, channel: str | None = None) -> None:
        """Record stale-epoch frames dropped at the vtable boundary (the
        epoch fence of the self-healing process group: a frame stamped
        with a pre-heal group generation can never reach a post-heal
        reduction — it is counted here and on the flight timeline as an
        ``epoch-fenced`` event instead of being delivered). ``channel``
        (a lane NAME) attributes the drop to its lane — a heal fences
        every lane's stale frames, and the per-lane count is what lets
        a postmortem say WHICH tenant's stream died with the epoch."""
        with self._lock:
            self.frames_fenced += frames
            if channel is not None:
                self.channel_frames_fenced[channel] = \
                    self.channel_frames_fenced.get(channel, 0) + frames

    def lane_yield(self, n: int = 1) -> None:
        """Record credit-pacing yields a laned send paid (the bulk lane
        giving the wire back every ``credit_bytes`` — see
        ``transport.lanes.LaneGate``)."""
        with self._lock:
            self.lane_yields += n

    def lane_wait(self, n: int = 1) -> None:
        """Record lane admits deferred behind higher-priority intent or
        tx backlog (the QoS scheduler actually scheduling)."""
        with self._lock:
            self.lane_waits += n

    def coalesced(self, members: int, fill: float, trigger: str) -> None:
        """Record one fused bucket COMMIT: ``members`` member ops rode
        the bucket, ``fill`` is its payload over the lane's
        ``bucket_bytes`` (clamped into the decile histogram — a
        size-triggered bucket may slightly overshoot 100%), ``trigger``
        names what flushed it (``size``/``time``/``barrier``)."""
        decile = min(10, max(1, math.ceil(min(1.0, fill) * 10)))
        label = f"<={decile * 10}%"
        with self._lock:
            self.ops_coalesced += members
            self.buckets_flushed += 1
            self.bucket_fill[label] = self.bucket_fill.get(label, 0) + 1
            self.bucket_triggers[trigger] = \
                self.bucket_triggers.get(trigger, 0) + 1

    def encoded(self, saved: int, frames: int = 1) -> None:
        """Record ``frames`` outgoing wire frames quantized by the
        streaming codec and the ``saved`` payload bytes (decoded size
        minus wire size) the compression kept off the wire."""
        with self._lock:
            self.frames_encoded += frames
            self.payload_bytes_saved += saved

    def resumed(self, frames: int = 1) -> None:
        """Record p2p frames re-delivered by the stream-resume protocol
        (the retry-widening half of the elastic group: an interrupted
        send/recv stream continues from its last fence-acknowledged
        frame across a heal/grow instead of tearing down)."""
        with self._lock:
            self.frames_resumed += frames

    def grew(self, n: int = 1) -> None:
        """Record completed ``grow()`` admissions (counted on every
        member of the widened group, joiners included)."""
        with self._lock:
            self.grows += n

    def promoted(self, n: int = 1) -> None:
        """Record spare promotions (counted on every member of the healed
        group: survivors when their heal admits a spare, the spare when
        its ``wait_promotion`` completes)."""
        with self._lock:
            self.promotions += n

    def evaded_reshape(self, n: int = 1) -> None:
        """Record tier-1 evasion reshapes (every member of the rotated
        ring counts its own lockstep commit)."""
        with self._lock:
            self.evasion_reshapes += n

    def evaded_promotion(self, n: int = 1) -> None:
        """Record tier-2 proactive promotions (counted on the members
        that drove the drain+promote, next to the ``promotions`` the
        underlying heal path counts)."""
        with self._lock:
            self.evasion_promotions += n

    def hier(self, n: int = 1) -> None:
        """Record completed hierarchical (node-aware two-level)
        collectives — the schedule actually running, not
        merely picked."""
        with self._lock:
            self.hier_ops += n

    def algorithm_picked(self, algo: str) -> None:
        """Record the node-aware flat-vs-hierarchical verdict the last
        node-mapped collective resolved (gauge semantics: last pick
        wins; see ``tuner.pick_algorithm``)."""
        with self._lock:
            self._algorithm = algo

    def negotiated(self, frame_bytes: int, pipeline_depth: int,
                   tuner_version: int | None = None,
                   codec: str | None = None) -> None:
        """Record the frame size / pipeline depth the ring wire chose
        for a stream, plus the wire-model version that chose them (None
        = a legacy static pick) and the wire codec in force (None =
        uncompressed; gauge semantics: last negotiation wins)."""
        with self._lock:
            self._frame_bytes = int(frame_bytes)
            self._pipeline_depth = int(pipeline_depth)
            self._tuner_version = (int(tuner_version)
                                   if tuner_version is not None else None)
            self._codec = codec

    def negotiation(self) -> dict:
        """The last-negotiated wire parameters (``frame_bytes`` /
        ``pipeline_depth`` / ``tuner_version`` / ``codec``), for
        wire_stats() and bench records."""
        with self._lock:
            return {"frame_bytes": self._frame_bytes,
                    "pipeline_depth": self._pipeline_depth,
                    "tuner_version": self._tuner_version,
                    "codec": self._codec,
                    "algorithm": self._algorithm}

    def snapshot(self) -> dict:
        with self._lock:
            return dataclasses.asdict(self)

    def delta(self, since: dict) -> dict:
        """Counter movement since a ``snapshot()`` (the per-measurement
        window the bench attaches to its records). Per-channel dict
        counters window key-wise — a lane absent from the base snapshot
        deltas from zero."""
        return self.delta_of(self.snapshot(), since)

    @staticmethod
    def delta_of(cur: dict, since: dict | None) -> dict:
        """Window one plain snapshot dict against an earlier one —
        scalars field-wise, per-channel dict counters key-wise. The ONE
        definition of the windowing; :meth:`delta` and the fleet
        publisher (which already holds a snapshot and must not re-read
        the live counters) both ride it."""
        if since is None:
            return {k: (dict(v) if isinstance(v, dict) else v)
                    for k, v in cur.items()}
        out: dict = {}
        for k, v in cur.items():
            base = since.get(k)
            if isinstance(v, dict):
                base = base if isinstance(base, dict) else {}
                out[k] = {lane: n - base.get(lane, 0)
                          for lane, n in v.items()}
            else:
                out[k] = v - (base if isinstance(base, (int, float)) else 0)
        return out

    @staticmethod
    def merge(snapshots) -> dict:
        """Cross-rank merge of ``snapshot()``/``delta()`` dicts: exact
        field-wise integer addition (every field is a count of disjoint
        per-rank events, so the fleet total IS the sum — no averaging,
        no loss); per-channel dict counters add key-wise, equally exact.
        The fleet aggregator (``obs.fleet``) merges the live ranks'
        published snapshots through this; it is equally usable
        standalone on bench-record ``wire`` dicts in post-processing.
        Unknown keys are summed too, so a snapshot from a newer rank
        with an extra counter merges rather than raises."""
        out: dict = {}
        for s in snapshots:
            for k, v in s.items():
                if isinstance(v, dict):
                    m = out.setdefault(k, {})
                    for lane, n in v.items():
                        if isinstance(n, (int, float)) \
                                and not isinstance(n, bool):
                            m[lane] = m.get(lane, 0) + n
                elif isinstance(v, (int, float)) and not isinstance(v, bool):
                    out[k] = out.get(k, 0) + v
        return out

    def overlap_ratio(self, since: dict | None = None) -> float:
        """Fraction of streamed frames whose transfer fully overlapped the
        consumption of earlier frames (0.0 with nothing streamed).

        ``since``: an earlier ``snapshot()`` — the ratio is then computed
        over the WINDOW since that snapshot, which is what any gated
        measurement must use: the lifetime ratio dilutes a regressing
        steady loop with whatever the warmup did (the smoke gate windows
        every other counter with ``delta()`` for the same reason)."""
        with self._lock:
            streamed = self.frames_streamed
            overlapped = self.frames_overlapped
        if since is not None:
            streamed -= since.get("frames_streamed", 0)
            overlapped -= since.get("frames_overlapped", 0)
        if streamed <= 0:
            return 0.0
        return overlapped / streamed

    def reset(self) -> None:
        with self._lock:
            self.payload_bytes_copied = 0
            self.payload_bytes_streamed = 0
            self.frames_streamed = 0
            self.frames_copied = 0
            self.frames_overlapped = 0
            self.frames_fenced = 0
            self.frames_resumed = 0
            self.grows = 0
            self.promotions = 0
            self.evasion_reshapes = 0
            self.evasion_promotions = 0
            self.lane_yields = 0
            self.lane_waits = 0
            self.channel_frames_streamed = {}
            self.channel_bytes_streamed = {}
            self.channel_frames_fenced = {}
            self.ops_coalesced = 0
            self.buckets_flushed = 0
            self.bucket_fill = {}
            self.bucket_triggers = {}
            self.frames_encoded = 0
            self.payload_bytes_saved = 0
            self.hier_ops = 0
            self._frame_bytes = 0
            self._pipeline_depth = 0
            self._tuner_version = None
            self._codec = None
            self._algorithm = None


# THE process-wide wire-counter instance (one per rank process — host-plane
# ranks are OS processes, so summing across ranks happens at the harness,
# like FaultCounters). transport.plugin increments it; benches/tests window
# it with snapshot()/delta().
WIRE = WireCounters()


# the traffic classes the store-ops ledger attributes round-trips to
# : everything the control plane asks of the bootstrap store
# falls into one of these, so "per-rank control traffic is O(1) per
# window and observer traffic O(log n)" is a COUNTED invariant the
# simfleet harness and the sentinel ratchet can hold, not a vibe.
STORE_CLASSES = (
    "heartbeat",          # watchdog beats, death keys, liveness probes
    "telemetry-publish",  # fleet snapshot/meta/node-digest writes
    "telemetry-read",     # fleet/trace observer + node-agent reads
    "rendezvous",         # bootstrap/hier ring wiring, heal/grow protocol
    "election",           # first-writer-wins proposals (agree/setnx)
    "prune",              # epoch-bump store hygiene sweeps
    "replication",        # primary -> replica critical-state forwards
    "proxy-upstream",     # node proxy -> primary condensed/forwarded ops
)


class StoreCounters:
    """Per-traffic-class ledger of bootstrap-store round-trips.

    Counted at :meth:`transport.bootstrap.BootstrapClient._rpc` — the
    ONE choke point every store conversation flows through — so every
    request→reply (polls included: a blocking ``get`` that polls ten
    times is ten round-trips of load on the store) lands in exactly one
    class of :data:`STORE_CLASSES`. Per-op counts ride alongside under
    ``class:op`` keys for postmortems; the class totals are the
    contract surface (``wire_stats()``, fleet snapshots, the simfleet
    harness, sentinel's ``check_store_traffic``).

    Same lock/window/merge discipline as :class:`WireCounters`:
    producers may run from the watchdog thread, consumers window with
    ``snapshot()``/``delta()``, and cross-rank totals add key-wise
    exactly (disjoint per-rank events)."""

    def __init__(self):
        self._lock = _lockwitness.make_lock("metrics.py::StoreCounters._lock")
        self._by_class: dict[str, int] = {}
        self._by_op: dict[str, int] = {}

    def count(self, traffic_class: str, op: str | None = None,
              n: int = 1) -> None:
        """Record ``n`` store round-trips of ``traffic_class`` (an
        unknown class counts under itself — the ledger never drops
        traffic it cannot name — and ``op`` attributes the RPC op for
        the per-op split)."""
        with self._lock:
            self._by_class[traffic_class] = \
                self._by_class.get(traffic_class, 0) + n
            if op is not None:
                key = f"{traffic_class}:{op}"
                self._by_op[key] = self._by_op.get(key, 0) + n

    def snapshot(self) -> dict:
        """``{"ops": total, "classes": {...}, "by_op": {...}}`` — plain
        JSON-able data, the wire_stats()/fleet-snapshot format."""
        with self._lock:
            return {"ops": sum(self._by_class.values()),
                    "classes": dict(self._by_class),
                    "by_op": dict(self._by_op)}

    def delta(self, since: dict | None) -> dict:
        """Ledger movement since a ``snapshot()`` — the measurement
        window simfleet and the bench attach (key-wise, like the wire
        counters' per-lane dicts)."""
        return self.delta_of(self.snapshot(), since)

    @staticmethod
    def delta_of(cur: dict, since: dict | None) -> dict:
        if since is None:
            return {"ops": cur.get("ops", 0),
                    "classes": dict(cur.get("classes", {})),
                    "by_op": dict(cur.get("by_op", {}))}
        out = {"ops": cur.get("ops", 0) - since.get("ops", 0)}
        for field in ("classes", "by_op"):
            base = since.get(field, {})
            out[field] = {k: v - base.get(k, 0)
                          for k, v in cur.get(field, {}).items()
                          if v - base.get(k, 0)}
        return out

    @staticmethod
    def merge(snapshots) -> dict:
        """Cross-rank merge of ledger snapshots/deltas: exact key-wise
        integer addition, like every counter merge here."""
        out = {"ops": 0, "classes": {}, "by_op": {}}
        for s in snapshots:
            out["ops"] += s.get("ops", 0)
            for field in ("classes", "by_op"):
                m = out[field]
                for k, v in s.get(field, {}).items():
                    m[k] = m.get(k, 0) + v
        return out

    def reset(self) -> None:
        with self._lock:
            self._by_class = {}
            self._by_op = {}


# THE process-wide store-ops ledger (one per rank process, like WIRE):
# transport.bootstrap counts into it at the RPC choke point.
STORE = StoreCounters()


class VerbLatencies:
    """Per-verb latency histograms for the net-vtable blocking verbs.

    Log2-bucketed on microseconds: an observation of ``s`` seconds lands
    in the bucket labelled ``"<=Nus"`` where N is the smallest power of
    two >= the latency (floor 1 us, everything past ~67 s collapses into
    the top bucket — a verb that slow is a hang, and hangs are the
    postmortem's job, not the histogram's). Log buckets because verb
    latencies span ~5 decades (a sub-10 us shm frame probe to a
    multi-second cross-host LG credit wait) and the interesting signal is
    the SHAPE — a second mode appearing two buckets right is a retry path
    engaging — not microsecond precision.

    Producers are ``transport.plugin``'s verb instrumentation (entry/
    completion around every blocking verb); consumers window with
    ``snapshot()``/``delta()`` exactly like :class:`WireCounters` (the
    bench attaches the windowed histograms to its records, and
    ``ProcessGroup.wire_stats()`` exports the running ones). Same lock
    discipline as every shared counter here: producers may run from
    watchdog-adjacent progress hooks, so mutation holds the instance
    lock.
    """

    _TOP = 26  # 2**26 us ~ 67 s: ceiling bucket

    def __init__(self):
        self._lock = _lockwitness.make_lock("metrics.py::VerbLatencies._lock")
        # verb -> {"count": int, "total_s": float,
        #          "buckets": Counter{exponent: n}}
        self._verbs: dict[str, dict] = {}

    def observe(self, verb: str, seconds: float) -> None:
        """Record one completed verb invocation of ``seconds`` latency."""
        us = seconds * 1e6
        # smallest e with 2**e >= us (floor 1 us, cap at the top bucket)
        e = (min(self._TOP, max(0, math.ceil(math.log2(us))))
             if us > 1.0 else 0)
        with self._lock:
            v = self._verbs.get(verb)
            if v is None:
                v = self._verbs[verb] = {"count": 0, "total_s": 0.0,
                                         "buckets": collections.Counter()}
            v["count"] += 1
            v["total_s"] += seconds
            v["buckets"][e] += 1

    def snapshot(self) -> dict:
        """verb -> {count, total_s, mean_us, buckets{"<=Nus": n}} — plain
        JSON-serializable data (the wire_stats()/bench-record format)."""
        with self._lock:
            out = {}
            for verb, v in self._verbs.items():
                out[verb] = {
                    "count": v["count"],
                    "total_s": v["total_s"],
                    "mean_us": (v["total_s"] / v["count"] * 1e6
                                if v["count"] else 0.0),
                    "buckets": {f"<={1 << e}us": n
                                for e, n in sorted(v["buckets"].items())},
                }
            return out

    def delta(self, since: dict) -> dict:
        """Histogram movement since a ``snapshot()`` — per-verb count/
        total/bucket differences, dropping verbs that did not move (the
        per-measurement window the bench attaches)."""
        out = {}
        for verb, v in self.snapshot().items():
            base = since.get(verb, {})
            count = v["count"] - base.get("count", 0)
            if count <= 0:
                continue
            total_s = v["total_s"] - base.get("total_s", 0.0)
            base_b = base.get("buckets", {})
            buckets = {lbl: n - base_b.get(lbl, 0)
                       for lbl, n in v["buckets"].items()
                       if n - base_b.get(lbl, 0)}
            out[verb] = {"count": count, "total_s": total_s,
                         "mean_us": total_s / count * 1e6,
                         "buckets": buckets}
        return out

    @staticmethod
    def merge(snapshots) -> dict:
        """Cross-rank merge of ``snapshot()``/``delta()`` dicts:
        bucket-wise histogram ADDITION, which is exact — log2 buckets
        are identical on every rank (same exponent grid, same labels),
        so summing the per-rank counts of a bucket yields precisely the
        histogram a single recorder observing all ranks' verbs would
        hold. Counts and total_s sum; mean_us is recomputed from the
        merged totals. This is what makes fleet-level P50/P99 honest:
        percentiles are read off the MERGED buckets
        (:func:`bucket_percentile_us`), never averaged across ranks."""
        out: dict = {}
        for s in snapshots:
            for verb, v in s.items():
                m = out.setdefault(verb, {"count": 0, "total_s": 0.0,
                                          "buckets": {}})
                m["count"] += v.get("count", 0)
                m["total_s"] += v.get("total_s", 0.0)
                for lbl, n in v.get("buckets", {}).items():
                    m["buckets"][lbl] = m["buckets"].get(lbl, 0) + n
        for m in out.values():
            m["mean_us"] = (m["total_s"] / m["count"] * 1e6
                            if m["count"] else 0.0)
            m["buckets"] = dict(sorted(
                m["buckets"].items(), key=lambda kv: _bucket_us(kv[0])))
        return out

    def reset(self) -> None:
        with self._lock:
            self._verbs = {}


def _bucket_us(label: str) -> int:
    """The microsecond upper bound a ``"<=Nus"`` histogram label names."""
    return int(label[2:-2])


def bucket_percentile_us(buckets: dict, q: float) -> int:
    """The ``q``-quantile (0 < q <= 1) of a log2 latency histogram, as
    the microsecond UPPER BOUND of the bucket the quantile falls in —
    the resolution the histogram actually has (claiming finer would be
    invented precision). Works on per-rank and merged buckets alike;
    0 for an empty histogram."""
    if not 0.0 < q <= 1.0:
        raise ValueError(f"quantile must be in (0, 1], got {q}")
    total = sum(buckets.values())
    if total <= 0:
        return 0
    want = q * total
    seen = 0
    for lbl, n in sorted(buckets.items(), key=lambda kv: _bucket_us(kv[0])):
        seen += n
        if seen >= want:
            return _bucket_us(lbl)
    raise AssertionError("unreachable: seen reaches total >= q*total")


# THE process-wide per-verb latency histograms (same one-per-rank-process
# scoping as WIRE above); transport.plugin's verb instrumentation
# observes into it.
VERBS = VerbLatencies()


class ConformanceCounters:
    """Model-conformance cells: predicted-vs-measured cost for the pure
    pick surface .

    Every committed-model pick (tuner frame/depth, codec, algorithm,
    bucket size, exchange-fold) predicts a cost; the trace op span
    measures a wall. ``obs.conformance`` joins the two at collective
    COMMIT (aborted attempts never join) and calls :meth:`joined` —
    one observation per (plane, op). Cells are keyed
    ``"{plane}|{verb}|lg{k}"`` with ``k`` the floor-log2 of the pick's
    size_key, so a drifting model names its plane AND size regime.

    Exact-merge discipline (the WIRE/VERBS contract): every merged
    field is an integer count, an integer sum, an integer-keyed
    histogram, or a min/max extreme — all associative — so
    tree-merged equals flat-merged bit-for-bit on every cell
    (``tests/test_fleettree.py`` pins it). The predicted/measured
    RATIO is never stored as a float: each join lands one tick in the
    quarter-octave log2 histogram ``q_hist`` (``q = round(4 *
    log2(pred/meas))``), and P50/worst ratios are READ OFF the merged
    histogram (:meth:`p50_ratio`/:meth:`worst_ratio`) — the same
    read-off-the-merged-buckets honesty as the fleet verb P99s.

    Digest hygiene (the chaos replay contract): ``n``/``picks``/
    ``pred_us``/``vers``/``sched`` are STRUCTURAL — pure functions of
    the seed's committed-op sequence and the committed model version —
    and :meth:`structural` projects exactly them for the replay
    digests. ``meas_us``/``q_hist``/``q_min``/``q_max`` carry wall
    clock and stay timing-shaped (digest-excluded, like every wall
    field in ``obs.trace``). ``aux`` counts pick events with no
    joinable cost (bucket-size picks outside any op span, unsampled
    ops' picks) — kept next to the cells but outside every digest.

    Same lock discipline as every shared counter here; producers are
    the op-span commit hook, consumers window with snapshot()/delta()
    and merge cross-rank with :meth:`merge`.
    """

    Q_SCALE = 4    # quarter-octave log2 ratio resolution
    Q_CLAMP = 64   # |q| cap: ratios beyond 2**16 collapse to the rim

    def __init__(self):
        self._lock = _lockwitness.make_lock(
            "metrics.py::ConformanceCounters._lock")
        self._cells: dict[str, dict] = {}
        self._aux: dict[str, int] = {}

    @staticmethod
    def cell_key(plane, verb, size_key: int) -> str:
        """THE cell identity: plane, verb, floor-log2 size bucket."""
        n = max(1, int(size_key))
        return f"{plane}|{verb}|lg{n.bit_length() - 1}"

    @classmethod
    def quantize(cls, pred_us: int, meas_us: int) -> int:
        """The ratio tick one join lands: ``round(4 * log2(p/m))``,
        clamped — 0 is perfect conformance, +4 is the model predicting
        2x the measured cost, -4 half of it."""
        q = round(cls.Q_SCALE * math.log2(max(1, pred_us)
                                          / max(1, meas_us)))
        return max(-cls.Q_CLAMP, min(cls.Q_CLAMP, q))

    def joined(self, plane, verb, size_key: int, predicted_s: float,
               measured_s: float, version, picks: int = 1,
               sched: str | None = None) -> None:
        """Record one committed join: a plane's summed predicted cost
        for an op against the op span's measured wall. ``picks`` is
        how many pick notes the join folded (structural); ``sched``
        labels the picked schedule (e.g. ``"256K/d3"``)."""
        key = self.cell_key(plane, verb, size_key)
        pred_us = max(1, round(predicted_s * 1e6))
        meas_us = max(1, round(measured_s * 1e6))
        q = self.quantize(pred_us, meas_us)
        with self._lock:
            c = self._cells.get(key)
            if c is None:
                c = self._cells[key] = {
                    "n": 0, "picks": 0, "pred_us": 0, "meas_us": 0,
                    "q_min": q, "q_max": q, "q_hist": {}, "vers": {},
                    "sched": {}}
            c["n"] += 1
            c["picks"] += picks
            c["pred_us"] += pred_us
            c["meas_us"] += meas_us
            c["q_min"] = min(c["q_min"], q)
            c["q_max"] = max(c["q_max"], q)
            qk = str(q)
            c["q_hist"][qk] = c["q_hist"].get(qk, 0) + 1
            vk = str(version)
            c["vers"][vk] = c["vers"].get(vk, 0) + 1
            if sched is not None:
                c["sched"][sched] = c["sched"].get(sched, 0) + 1

    def noted(self, plane, kind: str, n: int = 1) -> None:
        """Record a pick event with no joinable cost (an auxiliary
        pick — bucket sizing, a codec/algorithm verdict outside any
        sampled span). Kept for coverage accounting, outside every
        digest."""
        key = f"{plane}|{kind}"
        with self._lock:
            self._aux[key] = self._aux.get(key, 0) + n

    def snapshot(self) -> dict:
        """``{"cells": {key: cell}, "aux": {key: n}}`` — plain
        JSON-able data (the fleet-snapshot / wire_stats format)."""
        with self._lock:
            return {"cells": {k: {f: (dict(v) if isinstance(v, dict)
                                      else v) for f, v in c.items()}
                              for k, c in self._cells.items()},
                    "aux": dict(self._aux)}

    def delta(self, since: dict | None) -> dict:
        """Cell movement since a ``snapshot()`` (the bench window):
        counts/sums/histograms subtract key-wise, unmoved cells drop;
        the ``q_min``/``q_max`` extremes are cumulative (a window's
        own extremes are not recoverable from two snapshots) and keep
        their current values."""
        return self.delta_of(self.snapshot(), since)

    @staticmethod
    def delta_of(cur: dict, since: dict | None) -> dict:
        if since is None:
            return cur
        out_cells: dict = {}
        base_cells = since.get("cells", {})
        for k, c in cur.get("cells", {}).items():
            b = base_cells.get(k, {})
            n = c.get("n", 0) - b.get("n", 0)
            if n <= 0 and c.get("picks", 0) <= b.get("picks", 0):
                continue
            cell = {"n": n,
                    "picks": c.get("picks", 0) - b.get("picks", 0),
                    "pred_us": c.get("pred_us", 0) - b.get("pred_us", 0),
                    "meas_us": c.get("meas_us", 0) - b.get("meas_us", 0),
                    "q_min": c.get("q_min", 0), "q_max": c.get("q_max", 0)}
            for f in ("q_hist", "vers", "sched"):
                bd = b.get(f, {})
                cell[f] = {lbl: nn - bd.get(lbl, 0)
                           for lbl, nn in c.get(f, {}).items()
                           if nn - bd.get(lbl, 0)}
            out_cells[k] = cell
        base_aux = since.get("aux", {})
        aux = {k: n - base_aux.get(k, 0)
               for k, n in cur.get("aux", {}).items()
               if n - base_aux.get(k, 0)}
        return {"cells": out_cells, "aux": aux}

    @staticmethod
    def merge(snapshots) -> dict:
        """Cross-rank merge of ``snapshot()``/``delta()`` dicts: cells
        key-wise, counts and integer-µs sums by exact addition, ratio
        histograms bucket-wise, extremes by min/max — every operator
        associative, so any tree of merges equals the flat merge
        bit-for-bit (the output's key order is sorted at every level
        for the same reason)."""
        cells: dict = {}
        aux: dict = {}
        for s in snapshots:
            if not isinstance(s, dict):
                continue
            for k, c in s.get("cells", {}).items():
                m = cells.get(k)
                if m is None:
                    m = cells[k] = {"n": 0, "picks": 0, "pred_us": 0,
                                    "meas_us": 0, "q_min": None,
                                    "q_max": None, "q_hist": {},
                                    "vers": {}, "sched": {}}
                for f in ("n", "picks", "pred_us", "meas_us"):
                    m[f] += c.get(f, 0)
                qn, qx = c.get("q_min", 0), c.get("q_max", 0)
                m["q_min"] = qn if m["q_min"] is None \
                    else min(m["q_min"], qn)
                m["q_max"] = qx if m["q_max"] is None \
                    else max(m["q_max"], qx)
                for f in ("q_hist", "vers", "sched"):
                    d = m[f]
                    for lbl, nn in c.get(f, {}).items():
                        d[lbl] = d.get(lbl, 0) + nn
            for k, nn in s.get("aux", {}).items():
                aux[k] = aux.get(k, 0) + nn
        for m in cells.values():
            m["q_hist"] = dict(sorted(m["q_hist"].items(),
                                      key=lambda kv: int(kv[0])))
            m["vers"] = dict(sorted(m["vers"].items()))
            m["sched"] = dict(sorted(m["sched"].items()))
        return {"cells": dict(sorted(cells.items())),
                "aux": dict(sorted(aux.items()))}

    @classmethod
    def p50_ratio(cls, cell: dict) -> float:
        """The cell's median predicted/measured ratio, read off the
        merged quarter-octave histogram (1.0 = the model was right;
        0.5 = the wire took twice the predicted time)."""
        hist = cell.get("q_hist", {})
        total = sum(hist.values())
        if total <= 0:
            return 1.0
        want = 0.5 * total
        seen = 0
        for qk, n in sorted(hist.items(), key=lambda kv: int(kv[0])):
            seen += n
            if seen >= want:
                return round(2.0 ** (int(qk) / cls.Q_SCALE), 4)
        raise AssertionError("unreachable: seen reaches total")

    @classmethod
    def worst_ratio(cls, cell: dict) -> float:
        """The cell's worst-conformance ratio: the merged extreme
        (q_min or q_max) furthest from perfect."""
        qn, qx = cell.get("q_min"), cell.get("q_max")
        if qn is None or qx is None:
            return 1.0
        q = qn if abs(qn) >= abs(qx) else qx
        return round(2.0 ** (q / cls.Q_SCALE), 4)

    @staticmethod
    def structural(snap: dict) -> dict:
        """The digest-covered projection: per-cell sample counts at
        commit, pick counts, the integer predicted-µs sum, the model-
        version split, and the picked-schedule split — every field a
        pure function of the seed's committed-op sequence. Walls,
        ratio histograms, and the aux table are timing-shaped and
        excluded (the FLEET/TRACELOG hygiene the chaos suite pins)."""
        cells = snap.get("cells", {}) if isinstance(snap, dict) else {}
        return {k: {"n": c.get("n", 0), "picks": c.get("picks", 0),
                    "pred_us": c.get("pred_us", 0),
                    "vers": dict(sorted(c.get("vers", {}).items())),
                    "sched": dict(sorted(c.get("sched", {}).items()))}
                for k, c in sorted(cells.items())}

    def reset(self) -> None:
        with self._lock:
            self._cells = {}
            self._aux = {}


# THE process-wide conformance table (same one-per-rank-process scoping
# as WIRE/VERBS above); obs.conformance's commit-side join observes
# into it.
CONF = ConformanceCounters()


@dataclasses.dataclass
class FaultCounters:
    """Named fault-event counters — the chaos-plane telemetry row.

    Producers are the fault-injection layer (``transport.faults.FaultNet``
    counts every fault it injects) and the survival machinery (retry
    loops count what they absorbed); consumers are the chaos harness and
    soak tests, which sum counters across ranks from the one-line JSON
    each worker prints. Keys are free-form kind strings
    (``connect-refused``, ``test-delayed``, ``comm-dead``, ...); the
    class owns only the wire format (counting itself rides
    ``collections.Counter``) so every producer serialises identically
    (the same single-owner discipline as the busbw table above)."""

    counts: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)

    def __post_init__(self):
        if not isinstance(self.counts, collections.Counter):
            self.counts = collections.Counter(self.counts)

    def count(self, kind: str, n: int = 1) -> None:
        self.counts[kind] += n

    def total(self) -> int:
        return sum(self.counts.values())

    def merge(self, other: "FaultCounters") -> "FaultCounters":
        self.counts.update(other.counts)
        return self

    def to_json(self) -> str:
        return json.dumps(dict(sorted(self.counts.items())))

    @classmethod
    def from_json(cls, line: str) -> "FaultCounters":
        return cls(counts=json.loads(line))


def format_host_table(records: list) -> str:
    """The reference's ``format_table``, kept for ``bench_host``'s records
    (the device benches print :func:`format_table`). The
    ``tier`` column is load-bearing, not decoration: without it a
    correctness-oracle row (CPU fake devices timesharing one core) prints
    indistinguishable from a performance row, and a reader quotes an
    oracle's "bandwidth" as a measurement. ``wp99(us)`` is the
    WORST-RANK verb-latency P99 from the record's attached fleet
    snapshot (``extra["fleet"]["worst_p99_us"]``): a mean-looking row
    can hide one rank's tail, and the slowest rank is what a collective
    actually waits on; ``-`` for records with no fleet telemetry.
    ``lane`` names the QoS channel a multi-tenant measurement ran on
    (the bench_host lanes scenario tags its latency-lane rows); ``-``
    for ordinary single-tenant rows. ``cp-rank`` is the rank holding
    the largest share of the SLOWEST sampled op's critical path (the
    causal tracer's attribution, ``extra["trace"]["cp_rank"]``) — the
    straggler a mean-looking row is actually waiting on; ``-`` for
    records with no assembled trace.
    ``bfill%`` is the mean coalescer bucket fill of a fused-stream
    measurement (``extra["coalesce"]["fill_pct"]``): a coalesced row
    running near-empty buckets pays the fused header for none of the
    amortization; ``-`` for rows that coalesced nothing.
    ``picks`` is the wire tuner's per-row choice — the frame size and
    pipeline depth the streaming engine last negotiated for the
    measurement (``extra["wire"]["frame_bytes"]/["pipeline_depth"]``,
    printed ``<frame KiB>K/d<depth>``): a GB/s movement between two
    rows of the same sweep point is attributable to the pick that
    changed, not just observable; ``-`` for rows with no wire gauge.
    ``codec`` names the wire compression the row's streams ran under
    (``extra["wire"]["codec"]`` — the negotiated gauge, so it reports
    what the wire ACTUALLY did, including an ``auto`` knob the tuner
    resolved to off); ``-`` for uncompressed rows.
    ``sops`` is the store-ops ledger's window total for the
    measurement (``extra["store"]["ops"]`` — how many bootstrap-store
    round-trips the row's control plane cost): a collective
    whose measurement grew store chatter is a control-plane regression
    even when the GB/s holds; ``-`` for rows with no ledger window."""
    hdr = (f"{'collective':>13} {'algo':>12} {'ranks':>5} {'bytes':>14} "
           f"{'dtype':>9} {'tier':>18} {'lane':>9} {'time(us)':>12} "
           f"{'algbw GB/s':>11} {'busbw GB/s':>11} {'wp99(us)':>9} "
           f"{'cp-rank':>8} {'bfill%':>7} {'picks':>10} {'codec':>6} "
           f"{'sops':>6}")
    lines = [hdr, "-" * len(hdr)]
    for r in records:
        wp99 = r.extra.get("fleet", {}).get("worst_p99_us")
        cp = r.extra.get("trace", {}).get("cp_rank")
        fill = r.extra.get("coalesce", {}).get("fill_pct")
        wire = r.extra.get("wire", {})
        sops = r.extra.get("store", {}).get("ops")
        picks = "-"
        if wire.get("frame_bytes"):
            picks = (f"{wire['frame_bytes'] // 1024}K"
                     f"/d{wire.get('pipeline_depth', 0)}")
        lines.append(
            f"{r.collective:>13} {r.algo:>12} {r.n_ranks:>5} {r.size_bytes:>14} "
            f"{r.dtype:>9} {r.tier:>18} {r.extra.get('lane', '-'):>9} "
            f"{r.mean_s * 1e6:>12.1f} "
            f"{r.algbw_GBps:>11.2f} {r.busbw_GBps:>11.2f} "
            f"{wp99 if wp99 is not None else '-':>9} "
            f"{cp if cp is not None else '-':>8} "
            f"{fill if fill is not None else '-':>7} "
            f"{picks:>10} "
            f"{wire.get('codec') or '-':>6} "
            f"{sops if sops is not None else '-':>6}"
        )
    return "\n".join(lines)
