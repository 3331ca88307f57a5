"""Model-conformance telemetry — predicted vs measured cost for every
pure pick (DESIGN.md §6g).

Every schedule decision in this repo is a PURE pick against a committed
model (tuner frame/depth, ``pick_codec``, ``pick_algorithm``,
``pick_bucket_bytes``, ``exchange_fold_preferred``) — and until now
nothing recorded what the model PREDICTED next to what the wire
MEASURED. A stale or mis-fit model silently prices the slower path
forever. This module is the honesty layer:

- **Pick side** (:func:`note_pick`): every pick site calls it with the
  pick's (plane, size_key, world, committed model version, picked
  schedule, predicted seconds). Inside a SAMPLED op span the note is
  appended to the span context (one thread-local read + one list append
  — no lock, no store traffic); outside any span (unsampled ops,
  bucket-size picks at coalescer construction) it degrades to one
  auxiliary counter bump, so coverage is still counted but nothing
  un-joinable is invented.

- **Join side** (:func:`join_commit`, called by ``obs.trace.op_span``
  at COMMIT only): the op's notes are folded per plane — predicted
  seconds sum, pick count, max size_key — and joined against the op
  span's measured wall under the op's stable identity (epoch, chan,
  per-lane op counter). Aborted attempts never reach this hook (the
  span's abort path re-raises past it), so the structural half of the
  stream is replay-pure while walls stay timing-shaped — exactly the
  trace-record contract (DESIGN.md §6d) extended to conformance.

- **Estimator** (:data:`metrics.CONF`): per-(plane, verb, log2-size-
  bucket) cells with the WIRE/VERBS snapshot/delta/merge-exact
  discipline — integer sums, quarter-octave ratio histograms, min/max
  extremes — so the table rides the per-rank fleet snapshot and the
  tree digests bucket-wise-exactly (tree-merged == flat-merged
  by construction; observer reads stay O(log n)).

- **Drift** (:func:`summarize`/:func:`drift_report`): a cell whose
  median predicted/measured ratio leaves :data:`DRIFT_BAND` with at
  least :data:`MIN_SAMPLES` joins is DRIFTING, named as
  ``plane|verb|lgK``. ``ProcessGroup.tune_wire`` consumes this as its
  refit trigger signal (a ``tuner-drift`` flight event per drifted
  cell, visible in TUNERLOG); the sentinel's ``check_model_drift``
  ratchets the committed bands (``results/conformance_r01.json``).

CLI::

    python -m rocnrdma_tpu_torch.obs.conformance --store host:port
                                           [--watch SECS] [--json]
                                           [--flat]

The CLI is a rank-less pure observer riding the fleet tree's root
digest (2 store round-trips on a healthy tree), falling back to
per-rank snapshot reads only for uncovered members — the same
degraded-mode contract as ``obs.fleet``.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

from rocnrdma_tpu_torch.metrics import CONF as _CONF, ConformanceCounters
from rocnrdma_tpu_torch.obs.recorder import FLIGHT as _FLIGHT
from rocnrdma_tpu_torch.obs import trace as _trace

# the committed drift band on a cell's MEDIAN predicted/measured ratio:
# within [0.25, 4.0] (two octaves either side) the model is considered
# conformant — host-plane hop models are fitted on quiet machines and
# run on loaded ones, so a generous band keeps the trigger for genuine
# regime departures (a degraded rank, a stale fit), not scheduler
# noise. The sentinel's per-bucket ratchet (results/conformance_r01.json)
# is the tight, measured complement to this coarse structural band.
DRIFT_BAND = (0.25, 4.0)

# joins a cell needs before its ratio is trusted to name a drift — a
# single outlier wall (one preempted sample) must not fire the refit
# trigger or fail a tier-1 ratchet
MIN_SAMPLES = 3


# ---------------------------------------------------------------------------
# Pick side: note at the pick site, join at the op span's commit.
# ---------------------------------------------------------------------------


def note_pick(plane, kind: str, size_key: int = 0, world: int = 0,
              version=None, sched: str | None = None,
              predicted_s: float | None = None) -> None:
    """Record one pure-pick conformance event. Inside a sampled op
    span: appended to the span context, joined against the measured
    wall at commit (and dying with the context on abort — aborted
    attempts never join). Outside any span: one auxiliary counter
    bump (coverage without invented walls). ``predicted_s`` None
    marks a pick with no priced cost; ``kind`` names the pick
    site (``stream``/``exchange``/``codec``/``algorithm``/``bucket``/
    ``xfold``)."""
    ctx = getattr(_trace._TLS, "op", None)
    p = plane if plane is not None else "?"
    if ctx is None:
        _CONF.noted(p, kind)
        return
    notes = ctx.conf
    if notes is None:
        notes = ctx.conf = []
    notes.append((p, kind, int(size_key), int(world), version, sched,
                  predicted_s))


def join_commit(ctx, wall_s: float) -> None:
    """The commit-side join (called by ``obs.trace.op_span`` after the
    op record is pushed — same stable op identity, same
    committed-attempts-only stream). Notes fold PER PLANE: predicted
    seconds sum (a hier op streams several legs; each plane's summed
    prediction joins once), pick count, max size_key as the cell's
    bucket key, the last priced pick's model version and schedule.
    Un-priced notes (verdict-only picks) count as auxiliary coverage
    on their plane instead of polluting the ratio cells."""
    notes = getattr(ctx, "conf", None)
    if not notes:
        return
    priced: dict = {}
    for p, kind, size_key, _world, version, sched, pred_s in notes:
        if pred_s is None:
            _CONF.noted(p, kind)
            continue
        cur = priced.get(p)
        if cur is None:
            cur = priced[p] = [0.0, 0, 1, version, sched]
        cur[0] += pred_s
        cur[1] += 1
        cur[2] = max(cur[2], size_key)
        cur[3] = version
        cur[4] = sched if sched is not None else cur[4]
    for p, (pred_s, picks, size, version, sched) in priced.items():
        _CONF.joined(p, ctx.verb, size, pred_s, wall_s, version,
                     picks=picks, sched=sched)


# ---------------------------------------------------------------------------
# Drift: summarize merged cells, name what left the band.
# ---------------------------------------------------------------------------


def summarize(conf: dict, band=None, min_n: int | None = None) -> dict:
    """Per-cell drift summary from a merged (or single-rank) conf
    table: sample/pick counts, integer predicted/measured µs sums,
    P50 and worst predicted/measured ratios read off the merged
    histogram, the model-version split, and the band verdict."""
    cells = conf.get("cells", {}) if isinstance(conf, dict) else {}
    lo, hi = band if band is not None else DRIFT_BAND
    mn = MIN_SAMPLES if min_n is None else min_n
    out = {}
    for key, cell in sorted(cells.items()):
        p50 = ConformanceCounters.p50_ratio(cell)
        n = cell.get("n", 0)
        out[key] = {
            "n": n,
            "picks": cell.get("picks", 0),
            "pred_us": cell.get("pred_us", 0),
            "meas_us": cell.get("meas_us", 0),
            "p50_ratio": p50,
            "worst_ratio": ConformanceCounters.worst_ratio(cell),
            "vers": dict(sorted(cell.get("vers", {}).items())),
            "sched": dict(sorted(cell.get("sched", {}).items())),
            "drift": bool(n >= mn and not lo <= p50 <= hi),
        }
    return out


def drift_report(conf: dict | None = None, band=None,
                 min_n: int | None = None) -> list:
    """The refit trigger's feed: ``[(cell_key, p50_ratio), ...]`` for
    every cell outside the band (worst departure first). ``conf``
    defaults to THIS rank's live table — what ``tune_wire``'s rank-0
    trigger reads before broadcasting its verdict."""
    if conf is None:
        conf = ConformanceCounters.merge([_CONF.snapshot()])
    s = summarize(conf, band=band, min_n=min_n)
    out = [(k, v["p50_ratio"]) for k, v in s.items() if v["drift"]]
    out.sort(key=lambda kv: (-abs(math.log2(max(kv[1], 1e-9))), kv[0]))
    return out


def top_drift(summary: dict):
    """The worst drifting cell's ``(key, info)`` — what
    ``conformance_stats()`` names — or None when everything
    conforms."""
    drifting = [(k, v) for k, v in summary.items() if v["drift"]]
    if not drifting:
        return None
    drifting.sort(key=lambda kv: (-abs(math.log2(
        max(kv[1]["p50_ratio"], 1e-9))), kv[0]))
    return drifting[0]


def rank_drift(conf_snap) -> float | None:
    """One rank's worst out-of-band P50 ratio (None when every cell
    conforms or too few samples) — the fleet table's per-rank drift
    column. Pure function of the snapshot, so every aggregation path
    derives the same value (the condense-row exactness contract)."""
    if not isinstance(conf_snap, dict):
        return None
    worst = None
    for key, v in summarize(conf_snap).items():
        if not v["drift"]:
            continue
        if worst is None or (abs(math.log2(max(v["p50_ratio"], 1e-9)))
                             > abs(math.log2(max(worst, 1e-9)))):
            worst = v["p50_ratio"]
    return worst


# ---------------------------------------------------------------------------
# Observer side: the rank-less read + CLI (rides the fleet tree).
# ---------------------------------------------------------------------------


def read_conformance(store_handle: str, group: str = "default",
                     timeout_s: float = 5.0, flat: bool = False) -> dict:
    """One observer read of a group's conformance table, assembled
    from the fleet tree's root digest (O(log n) store reads; uncovered
    members fall back to per-rank snapshot reads — ``obs.fleet``'s
    degraded-mode contract) or, with ``flat``, one read per member.
    Returns ``{"epoch", "members", "cells", "summary", "drift",
    "top"}``. Raises ``LookupError`` like ``fleet.read_fleet`` when
    nothing is published; every abort leaves a ``conf-abort`` flight
    event and re-raises (the conf-* surface contract the analyzer's
    conformance rule pins)."""
    _FLIGHT.record("conf-read", group=group, flat=bool(flat))
    try:
        from rocnrdma_tpu_torch.obs import fleet as _fleet
        if flat:
            epoch, members, snaps = _fleet.read_snapshots(
                store_handle, group, timeout_s)
            conf = ConformanceCounters.merge(
                [s.get("conf") for s in snaps
                 if s is not None and s.get("epoch") == epoch])
        else:
            epoch, members, digest = _fleet.read_tree(
                store_handle, group, timeout_s)
            conf = digest.get("conf_totals") or {"cells": {}, "aux": {}}
        summary = summarize(conf)
        top = top_drift(summary)
        return {"epoch": epoch, "members": members,
                "cells": conf.get("cells", {}),
                "aux": conf.get("aux", {}),
                "summary": summary,
                "drift": [k for k, v in summary.items() if v["drift"]],
                "top": ({"cell": top[0],
                         "p50_ratio": top[1]["p50_ratio"],
                         "n": top[1]["n"]} if top else None)}
    except BaseException as e:
        _FLIGHT.record("conf-abort", op="read", error=type(e).__name__)
        raise


def format_conformance(view: dict) -> str:
    """Human-readable conformance table (the CLI's output): one row
    per (plane, verb, size-bucket) cell — joins, picks, predicted vs
    measured totals, P50/worst ratios, model versions — and a drift
    verdict line naming the worst offender."""
    lines = [f"conformance: epoch {view['epoch']}  "
             f"members {view['members']}  "
             f"band [{DRIFT_BAND[0]}, {DRIFT_BAND[1]}] on p50 "
             f"(min {MIN_SAMPLES} samples)"]
    hdr = (f"  {'cell':>28} {'n':>5} {'picks':>6} {'pred(us)':>10} "
           f"{'meas(us)':>10} {'p50':>7} {'worst':>7} {'vers':>8} "
           f"{'drift':>6}")
    lines += [hdr, "  " + "-" * (len(hdr) - 2)]
    for key, v in view.get("summary", {}).items():
        vers = ",".join(sorted(v.get("vers", {})))
        lines.append(
            f"  {key:>28} {v['n']:>5} {v['picks']:>6} "
            f"{v['pred_us']:>10} {v['meas_us']:>10} "
            f"{v['p50_ratio']:>7.3f} {v['worst_ratio']:>7.3f} "
            f"{vers or '-':>8} {'DRIFT' if v['drift'] else 'ok':>6}")
    if not view.get("summary"):
        lines.append("  (no joined picks published yet — is tracing "
                     "sampling? ROCNRDMA_TRACE_SAMPLE)")
    aux = view.get("aux", {})
    if aux:
        lines.append("  aux picks: " + " ".join(
            f"{k}={n}" for k, n in sorted(aux.items())))
    top = view.get("top")
    lines.append(f"  drift: {top['cell']} p50={top['p50_ratio']:.3f} "
                 f"n={top['n']}" if top else "  drift: none")
    return "\n".join(lines)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m rocnrdma_tpu_torch.obs.conformance",
        description="Read a running group's model-conformance table "
                    "(predicted vs measured cost per pure pick) from "
                    "its bootstrap store (one-shot, or --watch for a "
                    "live refresh)")
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
                   help="print the raw conformance view as JSON")
    p.add_argument("--flat", action="store_true",
                   help="read one snapshot key per rank (O(n)) instead "
                        "of the fleet tree's root digest (O(log n))")
    args = p.parse_args(argv)
    shown = 0
    while True:
        try:
            view = read_conformance(args.store, args.group, args.timeout,
                                    flat=args.flat)
        except (LookupError, OSError, TimeoutError) as e:
            print(f"conformance: {type(e).__name__}: {e}",
                  file=sys.stderr)
            return 1
        print(json.dumps(view) if args.json
              else format_conformance(view), flush=True)
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
