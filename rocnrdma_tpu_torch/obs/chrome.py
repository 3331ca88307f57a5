"""Per-rank flight dumps and the multi-rank Chrome-trace merger.

Each rank serializes its recorder to one small JSON (``dump_rank`` —
wired into ``ProcessGroup.destroy`` and the chaos worker via the
``ROCNRDMA_FLIGHT_DUMP`` env dir, or callable on demand); ``merge``
reads N of them and emits ONE Chrome-trace JSON loadable in Perfetto /
``chrome://tracing``, the host-plane twin of ``trace.py``'s device
lanes.

Clock alignment: ranks are OS processes whose ``perf_counter`` origins
are unrelated, but every rank records a ``clock-sync`` mark right after
the bootstrap ring's ``wired`` store barrier (the existing handshake
exchange — all ranks exit it within one store poll interval, so the
residual skew is bounded by that poll period, ~1-20 ms, documented in
DESIGN.md's observability section). The merger shifts each rank's
timeline so its sync mark sits at a common origin.

Lane layout: one Perfetto *process* per rank (``pid = rank``), five
threads inside it — ``verbs`` (net-vtable entry/completion spans),
``frames`` (ring-wire frame lifecycle slices, one per streamed frame),
``control`` (bootstrap retries, faults, stalls, sync marks),
``membership`` (the unified host+device recovery timeline: epoch bumps
and heal/grow/promotion protocol events, ``member-*`` spans for the
heal/grow/promotion wall time and the device-plane ``reinit_runtime``
phases, ``fleet-health`` transitions), and ``critical-path`` (the
causal tracer's per-op spans plus the synthesized ``cp-hop`` slices —
each sampled op's critical path, segment by segment, on the rank that
held it, aligned 1:1 against the frame slices it is derived from).
Events whose args carry ``dur`` (seconds) render as complete slices
(``ph:X``) spanning post→completion; everything else is an instant.

CLI::

    python -m rocnrdma_tpu_torch.obs.chrome --out merged.json \
        flight_rank0.json flight_rank1.json
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from rocnrdma_tpu_torch.obs.recorder import FLIGHT, FlightRecorder

# kind prefixes -> lane (tid). Unlisted kinds land in "control".
_FRAME_KINDS = ("frame-", "stream-", "credit-", "lg-credit")
_VERB_PREFIXES = ("isend", "irecv", "iwrite", "iread", "connect", "accept")
# the membership track: epoch bumps and group-shape changes — heal/grow
# protocol events, spare/joiner admission, device-plane restarts, and
# the fleet plane's health transitions. The member-* kinds carry ``dur``
# (heal/grow/promotion wall spans, reinit_runtime's shutdown → election
# → reinit → reprobe phases) and render as slices ALIGNED against the
# frame lane — the one unified host+device timeline.
_MEMBER_PREFIXES = ("member-", "heal-", "grow-", "promote-", "standby-",
                    "deviceheal-", "fleet-health")
# the causal-trace track: per-op span markers (``trace-op-*``) plus the
# SYNTHESIZED ``cp-hop`` slices — the merger re-runs the obs.trace
# assembler over the dumps' op-stamped frame events and renders each
# critical-path segment on the rank it belongs to, aligned 1:1 against
# that rank's frame slices (both lanes are built from the same events)
_TRACE_PREFIXES = ("trace-", "cp-")

_LANES = {"verbs": 0, "frames": 1, "control": 2, "membership": 3,
          "critical-path": 4}


def _lane(kind: str) -> int:
    if kind.startswith(_TRACE_PREFIXES):
        return _LANES["critical-path"]
    if kind.startswith(_FRAME_KINDS):
        return _LANES["frames"]
    if kind.startswith(_VERB_PREFIXES):
        return _LANES["verbs"]
    if kind.startswith(_MEMBER_PREFIXES):
        return _LANES["membership"]
    return _LANES["control"]


def dump_rank(path: str, rank: int,
              recorder: FlightRecorder | None = None) -> dict:
    """Serialize ``recorder`` (default the process-wide ``FLIGHT``) to
    ``path`` as one rank's flight dump: the buffered events, the sync
    mark, and the rank's wire counters (so a merger — or a test — can
    check frame-slice counts against ``frames_streamed`` without
    re-deriving them). Returns the dict it wrote."""
    from rocnrdma_tpu_torch.metrics import VERBS, WIRE
    rec = FLIGHT if recorder is None else recorder
    d = {
        "rank": rank,
        "sync_ts": rec.sync_ts,
        "recorded": rec.recorded(),
        "capacity": rec.capacity,
        "wire": WIRE.snapshot(),
        "verb_latency": VERBS.snapshot(),
        "events": [[t, kind, args] for t, kind, args in rec.events()],
    }
    with open(path, "w") as fp:
        json.dump(d, fp, default=str)
        fp.write("\n")
    return d


def dump_if_env(rank: int, group: str = "default") -> str | None:
    """The ONE exit-time dump hook (``ProcessGroup.destroy``, the chaos
    worker): when ``ROCNRDMA_FLIGHT_DUMP`` names a directory, write this
    rank's flight dump there and return the path; else (or on any I/O
    failure — teardown must not die for a dump) return None. Non-default
    groups key the filename by group too: ``split()``/``shrink()``
    subgroups RE-RANK, so two processes can both be rank 0 of sibling
    subgroups and must not clobber one ``flight_rank0.json``."""
    dump_dir = os.environ.get("ROCNRDMA_FLIGHT_DUMP")
    if not dump_dir:
        return None
    name = (f"flight_rank{rank}.json" if group == "default" else
            f"flight_rank{rank}_" +
            "".join(c if c.isalnum() else "-" for c in group) + ".json")
    path = os.path.join(dump_dir, name)
    try:
        dump_rank(path, rank)
    except OSError:
        return None
    return path


def merge(dump_paths: list, out_path: str | None = None) -> dict:
    """Merge per-rank flight dumps into one Chrome trace. Each rank's
    timeline is shifted so its ``clock-sync`` mark (fallback: its first
    event) lands at a common origin; a global offset keeps every
    timestamp positive (Perfetto dislikes negative ts)."""
    dumps = []
    for p in dump_paths:
        with open(p) as fp:
            dumps.append(json.load(fp))

    def origin(d):
        if d.get("sync_ts") is not None:
            return d["sync_ts"]
        return d["events"][0][0] if d["events"] else 0.0

    def start(ev):
        # a dur-carrying completion event renders as a slice STARTING at
        # t - dur; after a ring wrap the matching -post event may be
        # evicted, so the bias must come from slice starts, not instants,
        # or the oldest retained slice lands at negative ts
        t, _, args = ev
        dur = args.get("dur")
        return t - dur if isinstance(dur, (int, float)) and dur >= 0 else t

    # aligned time of the earliest slice start across ranks: biases every
    # emitted ts >= 0 (Perfetto dislikes negative timestamps)
    earliest = min((start(ev) - origin(d) for d in dumps
                    for ev in d["events"]), default=0.0)
    trace: list = []
    for d in dumps:
        rank, off = d["rank"], origin(d)
        trace.append({"ph": "M", "pid": rank, "name": "process_name",
                      "args": {"name": f"rank {rank} (host plane)"}})
        for lane, tid in sorted(_LANES.items(), key=lambda kv: kv[1]):
            trace.append({"ph": "M", "pid": rank, "tid": tid,
                          "name": "thread_name", "args": {"name": lane}})
        for t, kind, args in d["events"]:
            ts_us = (t - off - earliest) * 1e6
            ev = {"pid": rank, "tid": _lane(kind), "name": kind,
                  "cat": "host", "args": args}
            dur = args.get("dur")
            if isinstance(dur, (int, float)) and dur >= 0:
                # a completion event spanning post -> done
                ev.update(ph="X", ts=round(ts_us - dur * 1e6, 3),
                          dur=round(dur * 1e6, 3))
            else:
                ev.update(ph="i", ts=round(ts_us, 3), s="t")
            trace.append(ev)
    trace += _critical_path_events(dumps, origin, earliest)
    merged = {"traceEvents": trace, "displayTimeUnit": "ms",
              "otherData": {"ranks": sorted(d["rank"] for d in dumps),
                            "source": "rocnrdma_tpu_torch.obs flight recorder"}}
    if out_path is not None:
        with open(out_path, "w") as fp:
            json.dump(merged, fp)
            fp.write("\n")
    return merged


def _critical_path_events(dumps: list, origin, earliest: float) -> list:
    """The synthesized critical-path slices: rebuild each rank's op
    records from its dump's op-stamped events (``obs.trace
    .records_from_events`` — the SAME events the frame lane renders,
    so the two lanes align exactly), assemble the cross-rank trees,
    and emit one ``cp-hop`` slice per critical-path segment on the
    rank whose landing ends it. Ops missing any rank's record are
    skipped (a partial path would blame whoever happened to dump)."""
    from rocnrdma_tpu_torch.obs import trace as trace_mod
    records = []
    for d in dumps:
        records += trace_mod.records_from_events(
            [(e[0], e[1], e[2]) for e in d["events"]],
            rank=d["rank"], sync_ts=origin(d))
    out = []
    for tree in trace_mod.assemble(records, world=len(dumps)):
        for node in tree["critical_path"]:
            out.append({
                "pid": node["rank"], "tid": _LANES["critical-path"],
                "name": "cp-hop", "cat": "host", "ph": "X",
                "ts": round((node["t_end"] - node["dur"] - earliest)
                            * 1e6, 3),
                "dur": round(node["dur"] * 1e6, 3),
                "args": {"epoch": tree["epoch"], "chan": tree["chan"],
                         "op": tree["op"], "hop": node["hop"],
                         "src": node["src"]}})
    return out


def critical_path_slices(merged: dict, rank: int) -> list:
    """One rank's synthesized ``cp-hop`` slices (its segments of the
    sampled ops' critical paths) — what the acceptance check aligns
    against the same rank's frame slices."""
    return [e for e in merged["traceEvents"]
            if e.get("pid") == rank and e.get("ph") == "X"
            and e.get("name") == "cp-hop"]


def frame_slices(merged: dict, rank: int) -> list:
    """The frame-level slices of one rank's lane (the ``frame-landed`` /
    ``frame-combined`` completion events) — what the acceptance check
    compares against ``frames_streamed``."""
    return [e for e in merged["traceEvents"]
            if e.get("pid") == rank and e.get("ph") == "X"
            and e.get("name") in ("frame-landed", "frame-combined")]


def membership_events(merged: dict, rank: int) -> list:
    """One rank's membership-track events (heal/grow/promotion protocol
    instants, ``member-*`` spans, ``fleet-health`` transitions) — the
    lane the kill-and-heal acceptance reads the recovery story from,
    aligned against the same rank's frame slices."""
    tid = _LANES["membership"]
    return [e for e in merged["traceEvents"]
            if e.get("pid") == rank and e.get("tid") == tid
            and e.get("ph") in ("X", "i")]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m rocnrdma_tpu_torch.obs.chrome",
        description="Merge per-rank flight dumps into one Chrome trace")
    p.add_argument("dumps", nargs="+", help="per-rank flight JSON files")
    p.add_argument("--out", required=True, help="merged trace output path")
    args = p.parse_args(argv)
    try:
        merged = merge(args.dumps, args.out)
    except (OSError, json.JSONDecodeError, KeyError) as e:
        print(f"chrome merge failed: {type(e).__name__}: {e}",
              file=sys.stderr)
        return 1
    ranks = merged["otherData"]["ranks"]
    print(f"merged {len(args.dumps)} rank dump(s) (ranks {ranks}, "
          f"{len(merged['traceEvents'])} trace events) -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
