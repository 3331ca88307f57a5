"""Host-plane transport benchmark: the native QP ring under real load.

The device-plane benches (`bench_allreduce` et al.) measure the collectives
on the card; this one measures the plane this framework built itself — the
C++ queue pairs (`native/rtcp.cpp`) carrying the ring collectives of
`transport/plugin.py` through the process-group front door
(`distributed.py`). It is the closest analogue of what the reference's
`bench_allreduce` measured on ITS transport (verbs + NIC), and doubles as
a soak test of the whole host stack: rendezvous store, ring wiring, tag
framing, backpressure.

Ranks are REAL OS processes (rank 0 of the bench re-executes this module
as workers), because the host plane's progress engines spin in Python —
threads would serialize on the GIL and understate the plane.

Timing: per (collective, size): warmup, store barrier, ``iters`` back-to-
back calls, stop; the recorded time is the MAX across ranks (a collective
is as slow as its slowest rank) of the per-rank trimmed mean.

Usage::

    python -m rocnrdma_tpu_torch.bench.bench_host --ranks 4 --sizes 64K,1M
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

from rocnrdma_tpu_torch import metrics as M

# the device benches' runner and timing modules import torch, which the
# workers (one process per rank, re-executed per fleet) must not pay for
_UNITS = {"K": 1024, "M": 1024**2, "G": 1024**3}


def parse_size(s: str) -> int:
    """``64K`` / ``1M`` / ``1G`` / plain bytes -> bytes (the runner's)."""
    s = s.strip().upper().rstrip("IB")
    if s and s[-1] in _UNITS:
        return int(float(s[:-1]) * _UNITS[s[-1]])
    return int(s)


def trimmed_mean(xs: list[float]) -> float:
    """Mean without the fastest and slowest sample (3 or more)."""
    if len(xs) > 2:
        xs = sorted(xs)[1:-1]
    return sum(xs) / len(xs)

COLLECTIVES = ("allreduce", "reducescatter", "allgather", "broadcast",
               "alltoall", "alltoallv", "allgatherv", "reducescatterv",
               "sendrecv")

# --smoke floors, the card machine's host's own: three clean runs of
# `bench_host --smoke` under the committed wire model on the host of an
# "NVIDIA H100 80GB HBM3, 700.00 W", written by
# `python -m rocnrdma_tpu_torch.bench.host_tune --planes ""` into
# rocnrdma_tpu_torch/results/host_smoke_h100.json ("smoke": per-run
# values, worst run, derived floors). That machine comes with two hosts
# (8 Intel cores each, family 6 model 207 or 143); the floors are the
# slower one's (model 143), which the faster clears with room. The rule: each GB/s floor is 0.625x the
# worst run, so the gate's standard 0.8x allowance lands at HALF the worst
# clean measurement; each ratio bar (coalesce, codec) is half the worst
# run and the lanes P99 ceiling twice it. Scheduler noise cannot trip a
# gate, a structural regression (pipelining lost, a per-frame copy
# creeping back, doorbell/credit serialization) halves throughput and
# does. The copy-count half of every gate is not a floor: zero steady-
# path payload copies on every rank, exactly, no allowance.
#
# per path, 2-rank 1 MiB allreduce (GB/s, algbw); worst runs shm 0.490,
# tcp 0.217, rdma 0.528
SMOKE_FLOORS = {"shm": 0.306, "tcp": 0.136, "rdma": 0.33}

# smoke fleet configurations: gate key -> (plane, transport)
SMOKE_PATHS = {"shm": ("shm", "msg"), "tcp": ("tcp", "msg"),
               "rdma": ("shm", "rdma"), "lanes": ("shm", "msg")}

# coalesce scenario smoke gate: the many-small-ops win the
# async coalescer must deliver — 2-rank shm, 64 KiB allreduces fused
# into bucketed streams must move >= this multiple of the unbatched
# algbw (one stream header + one credit negotiation per bucket instead
# of per op). Worst run 4.13x; a genuine coalescing regression (buckets
# degenerating to one-op flushes) falls below half of it.
SMOKE_COALESCE_SPEEDUP = 2.06

# codec scenario smoke gate: the quantized-wire arm — a
# 2-rank tcp 1 MiB allreduce with the int8 wire codec ON (error
# feedback active) — as a multiple of the fp32 tcp floor above. The
# worst run's best trial was 0.193 GB/s, 1.42x that floor (on this host
# the int8 arm does not beat the fp32 wire); the gate holds best >=
# 0.71x (mean >= 0.8x of that): an int8 arm far under the fp32 floor
# means the codec path itself collapsed (encode serialized, or the lane
# knob silently not engaging).
SMOKE_CODEC_X = 0.71

# hier scenario smoke gates: the node-aware two-level
# schedule on the simulated 2-node x 2-rank mixed topology (4 ranks,
# group plane tcp as the slow inter-node fabric, shm sub-rings as the
# intra-node one). SMOKE_HIER_X is the reference's capability bar over
# the flat tcp ring at 1 MiB (the hierarchy crosses the slow fabric once
# per shard in parallel instead of 2(n-1) sequential hops), printed
# beside the gate. The per-run --smoke gate holds the ABSOLUTE hier
# floor (SMOKE_FLOORS_HIER, standard 0.8x allowance; worst run 0.128
# GB/s) plus the reference's schedule-collapse guard at SMOKE_HIER_MIN_X:
# a hier arm measurably SLOWER than the same-run flat ring means the legs
# serialized or degraded to the flat path, which no load noise produces
# (the three runs' best-trial speedups: 1.41-1.60x).
SMOKE_HIER_X = 1.3
SMOKE_HIER_MIN_X = 0.9
SMOKE_FLOORS_HIER = 0.08

# lanes scenario smoke gate: the P99 ceiling (microseconds)
# for a 64 KiB allreduce on the HIGH-PRIORITY latency lane while a
# paced bulk allgather saturates the same 2-rank shm ring; the worst of
# the three runs was 5270.8 us. A starvation-class regression (a
# latency frame queued behind the bulk backlog FIFO: a full bulk drain)
# trips twice that.
SMOKE_LANES_P99_US = 10500.0
# ...and the other direction: the bulk lane must still make progress
# under the latency lane's priority (starvation is not allowed either
# way) — windowed bulk-lane throughput floor during the latency loop
# (worst run 0.202 GB/s)
SMOKE_LANES_BULK_GBPS = 0.101


def _smoke_args(path: str) -> list:
    if path == "hier":
        # the simulated 2-node x 2-rank mixed topology: 4 ranks whose
        # group plane is tcp (the slow inter-node leg) with shm
        # sub-rings inside each "node" — flat tcp ring vs the
        # hierarchical schedule vs hierarchical + per-leg codec, 1 MiB
        # allreduces, arms seconds apart on one fleet
        return ["--ranks", "4", "--plane", "tcp", "--transport", "msg",
                "--sizes", "1M", "--collectives", "hier",
                "--node-map", "0,0,1,1", "--repeats", "3", "--iters", "4"]
    if path == "codec":
        # 2-rank tcp ring, 1 MiB allreduces: the fp32 wire vs the int8
        # and fp8 codec lanes (error feedback ON) — the gate is the
        # int8 arm's algbw against the committed fp32 tcp floor, so
        # the quantized wire is held to an absolute bar, not merely a
        # same-run ratio
        return ["--ranks", "2", "--plane", "tcp", "--transport", "msg",
                "--sizes", "1M", "--collectives", "codec",
                "--repeats", "5", "--iters", "8"]
    if path == "coalesce":
        # 2-rank shm ring, 128 x 64 KiB allreduces: unbatched loop vs
        # the async coalescer's bucketed fused streams (4 MiB buckets
        # -> 64 member ops per fused collective); the gate is the
        # speedup ratio, so scheduler noise hits both arms alike
        return ["--ranks", "2", "--plane", "shm", "--transport", "msg",
                "--sizes", "64K", "--collectives", "coalesce",
                "--repeats", "3", "--iters", "1",
                "--small-ops", "128", "--bucket-size", "4M"]
    if path == "lanes":
        # 2-rank shm ring, 64 KiB latency-lane allreduces timed while a
        # bulk lane loops 8 MiB-block allgathers (16 MiB wire traffic
        # per op) — the bulk round count outlasts the latency loop so
        # every sample is measured UNDER load (overlap_ok pins it)
        return ["--ranks", "2", "--plane", "shm", "--transport", "msg",
                "--sizes", "64K", "--collectives", "lanes",
                "--repeats", "1", "--iters", "1", "--lat-iters", "200",
                "--bulk-size", "8M", "--bulk-rounds", "120"]
    plane, transport = SMOKE_PATHS[path]
    return ["--ranks", "2", "--plane", plane, "--transport", transport,
            "--sizes", "1M", "--collectives", "allreduce",
            "--repeats", "3", "--iters", "5"]


SMOKE_ARGS = _smoke_args("shm")


def _build_input(collective: str, n: int, elems: int, rng,
                 rank: int = 0, counts=None):
    if collective == "allgather":
        return rng.standard_normal(max(1, elems // n)).astype(np.float32)
    if collective == "alltoall":
        per = max(1, elems // n)
        return rng.standard_normal((n, per)).astype(np.float32)
    if collective == "alltoallv":
        # ragged: segment j from rank r carries counts[r, j] elements
        # (callers pass the deterministic matrix every rank derives
        # identically — the MPI contract)
        return [rng.standard_normal(c).astype(np.float32)
                for c in counts[rank]]
    if collective == "allgatherv":
        return rng.standard_normal(int(counts[rank])).astype(np.float32)
    if collective == "reducescatterv":
        return rng.standard_normal(int(counts.sum())).astype(np.float32)
    return rng.standard_normal(elems).astype(np.float32)


def _alltoallv_counts(n: int, per: int) -> np.ndarray:
    """Deterministic skewed (n, n) counts: rank r sends rank j between
    25% and 175% of the balanced chunk. (i + j) % n makes the fractions a
    LATIN SQUARE — every row and column is a permutation of the full
    range — so the train is genuinely ragged per segment while every
    rank's TOTAL sent bytes stays equal (the recorded size_bytes and the
    (n-1)/n busbw factor then mean the same thing on every rank; an
    earlier (i + 2j) % n variant degenerated to two sizes and bimodal
    row totals at even n)."""
    i, j = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    frac = 0.25 + 1.5 * ((i + j) % n) / max(1, n - 1)
    return np.maximum(1, (frac * per).astype(np.int64))


def _ragged_counts(n: int, per: int) -> np.ndarray:
    """Deterministic length-n per-rank element counts for the ragged
    allgatherv/reduce-scatter-v legs: rank r contributes/keeps between 25%
    and 175% of the balanced chunk, every rank deriving the same vector
    (the MPI recvcounts contract). Literally row 0 of the alltoallv
    matrix — ONE skew formula to maintain."""
    return _alltoallv_counts(n, per)[0]


def _issue(pg, collective: str, x, transport: str = "msg", counts=None):
    if collective == "allreduce":
        return pg.all_reduce(x, transport=transport)
    if collective == "reducescatter":
        return pg.reduce_scatter(x, transport=transport)
    if collective == "allgather":
        return pg.all_gather(x, transport=transport)
    if collective == "allgatherv":
        return pg.all_gather_v(x, counts)
    if collective == "reducescatterv":
        return pg.reduce_scatter_v(x, counts)
    if collective == "broadcast":
        return pg.broadcast(x, src=0)
    if collective == "alltoall":
        return pg.all_to_all(x)
    if collective == "alltoallv":
        return pg.all_to_all_v(x, counts)
    if collective == "sendrecv":
        # the neighbour shift exchange over the p2p verbs: send right,
        # receive left, both in flight (the ncclSend/ncclRecv pattern)
        handles = pg.batch_isend_irecv([
            ("recv", x, (pg.rank - 1) % pg.world_size),
            ("send", x, (pg.rank + 1) % pg.world_size),
        ])
        out = handles[0].wait()
        handles[1].wait()
        return out
    raise ValueError(f"unknown collective {collective!r}")


def _lanes_worker(pg, args) -> list:
    """The multi-tenant lanes scenario: P99 latency of a small
    HIGH-PRIORITY allreduce while a paced bulk allgather saturates the
    same ring — both lanes' collectives concurrently in flight over ONE
    comm pair (the bulk stream runs on its own thread; frames interleave
    at the lane scheduler). The record's headline is the latency lane's
    P99 (worst rank), next to the bulk lane's windowed throughput — the
    two numbers QoS is judged by: neither tenant may starve the other.

    Inputs are deterministic per (rank, lane), so both lanes' results
    are verified against their oracles (``lanes_ok``) — concurrency
    that corrupts either stream fails the bench, not just slows it."""
    import threading

    from rocnrdma_tpu_torch.metrics import VERBS, WIRE

    n = pg.world_size
    latency = pg.channel("latency", priority=8)
    bulk = pg.channel("bulk", priority=0, credit_bytes=1 << 20)
    small_elems = max(1, parse_size(args.sizes.split(",")[0]) // 4)
    bulk_elems = max(1, parse_size(args.bulk_size) // 4)

    def contrib(rank: int, lane: int, elems: int):
        return (np.random.default_rng((rank, lane))
                .standard_normal(elems).astype(np.float32))

    small = contrib(pg.rank, 0, small_elems)
    want_small = contrib(0, 0, small_elems)
    for r in range(1, n):
        want_small = want_small + contrib(r, 0, small_elems)
    big = contrib(pg.rank, 1, bulk_elems)
    # warmup both lanes; prove the bulk lane bitwise-correct once (the
    # timed loop re-checks the latency lane's last result)
    rows = bulk.all_gather(big, timeout_s=120.0)
    ok = all(np.array_equal(rows[r], contrib(r, 1, bulk_elems))
             for r in range(n))
    got = None
    for _ in range(3):
        got = latency.all_reduce(small, timeout_s=30.0)
    ok = ok and np.allclose(got, want_small, rtol=1e-4, atol=1e-4)
    pg.barrier()
    wire_base = WIRE.snapshot()
    verb_base = VERBS.snapshot()
    bulk_done = [None]
    bulk_err = [None]

    def bulk_run():
        # a bulk-lane failure must surface as ITSELF, not masquerade as
        # "bulk finished early" in the overlap gate: capture and re-raise
        # after the join
        try:
            for _ in range(args.bulk_rounds):
                bulk.all_gather(big, timeout_s=120.0)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            bulk_err[0] = e
            return
        bulk_done[0] = time.perf_counter()

    t = threading.Thread(target=bulk_run, daemon=True)
    t.start()
    samples = []
    t0_win = time.perf_counter()
    for _ in range(args.lat_iters):
        t0 = time.perf_counter()
        got = latency.all_reduce(small, timeout_s=30.0)
        samples.append(time.perf_counter() - t0)
    lat_end = time.perf_counter()
    window_s = lat_end - t0_win
    # the bulk lane's bytes streamed DURING the latency window (the
    # windowed per-lane counter — measured, not inferred from rounds)
    mid = WIRE.delta(wire_base)
    ok = ok and np.allclose(got, want_small, rtol=1e-4, atol=1e-4)
    # a valid sample set is measured UNDER load: the bulk thread must
    # still be running when the last latency sample lands
    overlap_ok = t.is_alive() or (bulk_done[0] is not None
                                  and bulk_done[0] >= lat_end)
    t.join(timeout=600.0)
    if bulk_err[0] is not None:
        raise SystemExit(
            f"lanes scenario: the bulk lane FAILED on rank {pg.rank} "
            f"({type(bulk_err[0]).__name__}: {bulk_err[0]})")
    wire = WIRE.delta(wire_base)
    wire["overlap_ratio"] = round(WIRE.overlap_ratio(since=wire_base), 4)
    wire.update(WIRE.negotiation())
    if args.smoke and wire["payload_bytes_copied"]:
        raise SystemExit(
            f"smoke gate: rank {pg.rank} staged "
            f"{wire['payload_bytes_copied']} payload bytes through copies "
            f"during the lanes scenario (want 0): {wire}")
    bulk_bytes = mid.get("channel_bytes_streamed", {}).get("bulk", 0)
    bulk_GBps = bulk_bytes / window_s / 1e9 if window_s > 0 else 0.0
    arr = np.sort(np.array(samples))
    p50 = float(arr[int(0.50 * (len(arr) - 1))]) * 1e6
    p99 = float(arr[int(0.99 * (len(arr) - 1))]) * 1e6
    # fleet reductions: the collective is as slow as its slowest rank,
    # QoS is as good as its worst rank, validity needs every rank
    stats = pg.all_reduce(np.array([p50, p99, float(np.mean(arr)) * 1e6,
                                    bulk_GBps]), op="max")
    valid = pg.all_reduce(np.array([1.0 if ok else 0.0,
                                    1.0 if overlap_ok else 0.0]), op="min")
    pg.publish_telemetry()
    pg.barrier()
    if pg.rank != 0:
        return []
    fl = pg.fleet_stats()
    fleet = {k: fl[k] for k in
             ("epoch", "health", "missing", "stale_dropped",
              "worst_p99_us", "verb_p50_us", "verb_p99_us",
              "verb_latency", "wire_totals", "channel_GBps")}
    return [M.BenchRecord.measure(
        "bench_host", "allreduce", "lanes", n, small.nbytes, "float32",
        float(stats[2]) / 1e6, platform=f"host-{args.plane}",
        iters=args.lat_iters, repeats=1, lane="latency",
        p50_us=round(float(stats[0]), 1), p99_us=round(float(stats[1]), 1),
        bulk_GBps=round(float(stats[3]), 4),
        bulk_lane_bytes=int(bulk_bytes), bulk_size=int(big.nbytes),
        bulk_rounds=args.bulk_rounds, window_s=round(window_s, 4),
        lanes_ok=bool(valid[0] > 0), overlap_ok=bool(valid[1] > 0),
        wire=wire, verb_lat=VERBS.delta(verb_base), fleet=fleet)]


def _coalesce_worker(pg, args) -> list:
    """The many-small-ops scenario: ``--small-ops`` allreduces
    of the first ``--sizes`` entry each, timed back to back UNBATCHED
    (one collective per op — the latency-floor regime the record
    pins) and then COALESCED (the async verb surface packs them into
    ``--bucket-size`` fused frame streams; one header, one fold pass,
    one credit negotiation per bucket). The headline is the speedup —
    the ratio is the bucketing win, and both arms run on the same fleet
    seconds apart so scheduler noise largely cancels. The coalesced
    results are checked BITWISE against the unbatched ones (same ring,
    same fold order — fused must be a pure repacking), and the smoke
    gate additionally pins zero steady-path copies on every rank."""
    from rocnrdma_tpu_torch.metrics import VERBS, WIRE

    n = pg.world_size
    small_bytes = parse_size(args.sizes.split(",")[0])
    elems = max(1, small_bytes // 4)
    ops = args.small_ops
    bucket_bytes = parse_size(args.bucket_size)
    ch = pg.channel("grads", bucket_bytes=bucket_bytes)

    def contrib(rank: int, j: int):
        return (np.random.default_rng((rank, j))
                .standard_normal(elems).astype(np.float32))

    xs = [contrib(pg.rank, j) for j in range(ops)]
    # warmup both arms (arena announces, pool priming, lane open)
    pg.all_reduce(xs[0])
    ch.allreduce_async(xs[0], timeout_s=60.0)
    ch.flush(timeout_s=60.0)

    def run_unbatched():
        return [pg.all_reduce(x, timeout_s=60.0) for x in xs]

    def run_coalesced():
        futs = [ch.allreduce_async(x, timeout_s=60.0) for x in xs]
        ch.flush(timeout_s=120.0)
        return [f.wait(timeout_s=60.0) for f in futs]

    spans = {"unbatched": [], "coalesced": []}
    outs = {}
    wire_base = WIRE.snapshot()
    verb_base = VERBS.snapshot()
    for _ in range(args.repeats):
        for mode, run in (("unbatched", run_unbatched),
                          ("coalesced", run_coalesced)):
            pg.barrier()
            t0 = time.perf_counter()
            outs[mode] = run()
            spans[mode].append((time.perf_counter() - t0) / ops)
    wire = WIRE.delta(wire_base)
    wire["overlap_ratio"] = round(WIRE.overlap_ratio(since=wire_base), 4)
    wire.update(WIRE.negotiation())
    if args.smoke and wire["payload_bytes_copied"]:
        raise SystemExit(
            f"smoke gate: rank {pg.rank} staged "
            f"{wire['payload_bytes_copied']} payload bytes through copies "
            f"during the coalesce scenario (want 0): {wire}")
    # the bitwise oracle: the fused repacking must reproduce the
    # unbatched ring results exactly (same schedule, same fold order)
    ok = all(np.array_equal(a, b)
             for a, b in zip(outs["unbatched"], outs["coalesced"]))
    per_op = {m: trimmed_mean(s) for m, s in spans.items()}
    # a collective is as slow as its slowest rank; validity needs all
    stats = pg.all_reduce(np.array([per_op["unbatched"],
                                    per_op["coalesced"]]), op="max")
    valid = pg.all_reduce(np.array([1.0 if ok else 0.0]), op="min")
    # mean bucket fill over the window (the format_table bfill column),
    # estimated from the decile histogram's UPPER edges — a deliberate
    # over-read bounded by one decile (the histogram's resolution;
    # claiming finer would be invented precision)
    fills = wire.get("bucket_fill", {})
    flushed = sum(fills.values())
    fill_pct = (round(sum(int(lbl[2:-1]) * k for lbl, k in fills.items())
                      / flushed) if flushed else 0)
    pg.publish_telemetry()
    pg.barrier()
    if pg.rank != 0:
        return []
    fl = pg.fleet_stats()
    fleet = {k: fl[k] for k in
             ("epoch", "health", "missing", "stale_dropped",
              "worst_p99_us", "verb_p50_us", "verb_p99_us",
              "verb_latency", "wire_totals")}
    t_unb, t_co = float(stats[0]), float(stats[1])
    speedup = t_unb / t_co if t_co > 0 else 0.0
    common = dict(iters=ops, repeats=args.repeats,
                  small_bytes=small_bytes, verb_lat=VERBS.delta(verb_base),
                  fleet=fleet, trace=_trace_summary(pg, "allreduce"))
    return [
        M.BenchRecord.measure(
            "bench_host", "allreduce", "unbatched", n, small_bytes,
            "float32", t_unb, platform=f"host-{args.plane}", **common),
        M.BenchRecord.measure(
            "bench_host", "allreduce", "coalesced", n, small_bytes,
            "float32", t_co, platform=f"host-{args.plane}", wire=wire,
            coalesce={"members_per_bucket": bucket_bytes // small_bytes,
                      "bucket_bytes": bucket_bytes, "ops": ops,
                      "fill_pct": fill_pct,
                      "speedup": round(speedup, 2),
                      "bitwise_ok": bool(valid[0] > 0),
                      "unbatched_algbw_GBps": round(
                          M.algbw_GBps(small_bytes, t_unb), 4)},
            **common),
    ]


def _codec_worker(pg, args) -> list:
    """The quantized-wire scenario: the first ``--sizes``
    entry allreduced over the fp32 wire, then over int8 and fp8 codec
    lanes (per-frame-scale quantization on every streaming frame,
    error feedback ON for the sum) — same fleet, arms seconds apart so
    scheduler noise largely cancels. Each codec row records its
    speedup over the fp32 arm, the max-abs error of the quantized
    result against the fp32 result (what the compression actually
    costs in value space), the payload bytes the codec kept off the
    wire, and ``floor_x`` — the arm's algbw as a multiple of the
    committed fp32 floor for this plane (the smoke gate's bar: the
    quantized wire must BEAT the fp32 floor, not merely its own run).
    """
    from rocnrdma_tpu_torch.metrics import VERBS, WIRE

    n = pg.world_size
    size = parse_size(args.sizes.split(",")[0])
    elems = max(1, size // 4)

    def contrib(rank: int):
        return (np.random.default_rng((rank, 77))
                .standard_normal(elems).astype(np.float32))

    x = contrib(pg.rank)
    want = contrib(0)
    for r in range(1, n):
        want = want + contrib(r)
    arms = [("fp32", pg),
            ("int8", pg.channel("q-int8", codec="int8")),
            ("fp8", pg.channel("q-fp8", codec="fp8"))]
    floor = SMOKE_FLOORS.get(args.plane, SMOKE_FLOORS["tcp"])
    rows = []
    fp32_t = None
    for name, surf in arms:
        surf.all_reduce(x, timeout_s=60.0)  # warmup: arenas, lane open
        wire_base = WIRE.snapshot()
        verb_base = VERBS.snapshot()
        spans = []
        out = None
        for _ in range(args.repeats):
            pg.barrier()
            t0 = time.perf_counter()
            for _ in range(args.iters):
                out = surf.all_reduce(x, timeout_s=60.0)
            spans.append((time.perf_counter() - t0) / args.iters)
        wire = WIRE.delta(wire_base)
        wire["overlap_ratio"] = round(WIRE.overlap_ratio(since=wire_base), 4)
        wire.update(WIRE.negotiation())
        if args.smoke and wire["payload_bytes_copied"]:
            raise SystemExit(
                f"smoke gate: rank {pg.rank} staged "
                f"{wire['payload_bytes_copied']} payload bytes through "
                f"copies during the codec scenario's {name} arm "
                f"(want 0): {wire}")
        mine = trimmed_mean(spans)
        sec = float(pg.all_reduce(np.array([mine]), op="max")[0])
        fleet_spans = pg.all_reduce(np.asarray(spans), op="max")
        spread_gb = sorted(M.algbw_GBps(size, float(s))
                           for s in fleet_spans)
        # value-space cost of the compression, fleet-wide worst rank
        err = float(np.abs(out - want).max())
        err = float(pg.all_reduce(np.array([err]), op="max")[0])
        pg.publish_telemetry()
        pg.barrier()
        if pg.rank != 0:
            continue
        fl = pg.fleet_stats()
        fleet = {k: fl[k] for k in
                 ("epoch", "health", "missing", "stale_dropped",
                  "worst_p99_us", "verb_p50_us", "verb_p99_us",
                  "verb_latency", "wire_totals")}
        algbw = M.algbw_GBps(size, sec)
        extra = dict(iters=args.iters, repeats=args.repeats,
                     spread=[round(spread_gb[0], 4),
                             round(spread_gb[-1], 4)],
                     wire=wire, verb_lat=VERBS.delta(verb_base),
                     fleet=fleet, trace=_trace_summary(pg, "allreduce"))
        if name == "fp32":
            fp32_t = sec
            algo = "ring"
        else:
            algo = f"codec-{name}"
            extra["codec"] = {
                "name": name,
                "speedup": round(fp32_t / sec, 3) if fp32_t else None,
                "max_abs_err": round(err, 6),
                "bytes_saved": int(wire.get("payload_bytes_saved", 0)),
                "frames_encoded": int(wire.get("frames_encoded", 0)),
                "floor_x": round(algbw / floor, 3),
                # the spread-BEST trial's multiple: the capability bar
                # the smoke gate holds to 1.5x (trial noise eats means;
                # the repo's sentinel resolves regressions by spread
                # intervals for the same reason), with the mean held
                # to the standard 0.8x allowance of the same bar
                "floor_x_best": round(spread_gb[-1] / floor, 3),
                "floor_GBps": floor,
            }
        rows.append(M.BenchRecord.measure(
            "bench_host", "allreduce", algo, n, size, "float32", sec,
            platform=f"host-{args.plane}", **extra))
    return rows


def _hier_worker(pg, args) -> list:
    """The node-aware hierarchical scenario: the first
    ``--sizes`` entry allreduced over the flat ring of the group's
    plane, then over the hierarchical schedule (node map from
    ``--node-map``), then hierarchical with a ``codec="auto"`` lane —
    per-leg arbitration: the committed models compress ONLY the slow
    cross-node leg. Same fleet, arms seconds apart so scheduler noise
    largely cancels. Each hier row records its speedup over the flat
    arm (mean and best-trial), the bitwise/value-space check against
    the flat result (inputs are integer-valued floats, so fp32 sums
    are exact and fold order cannot matter), the auto
    ``pick_algorithm`` verdict + the model's flat-vs-hier crossover
    size, and ``floor_x`` against the recorded hier floor."""
    from rocnrdma_tpu_torch.metrics import VERBS, WIRE
    from rocnrdma_tpu_torch.transport import tuner as _tuner

    n = pg.world_size
    size = parse_size(args.sizes.split(",")[0])
    elems = max(1, size // 4)

    def contrib(rank: int):
        # integer-valued: the fp32 sum of 4 such arrays is exact, so
        # the flat and hierarchical results must be BITWISE equal
        return (np.random.default_rng((rank, 14))
                .integers(-4096, 4096, elems).astype(np.float32))

    x = contrib(pg.rank)
    want = contrib(0)
    for r in range(1, n):
        want = want + contrib(r)
    hinfo = pg.hierarchy(timeout_s=60.0)  # build off the timed window
    intra = _tuner.host_wire_model(pg._intra_plane)
    inter = getattr(pg._net, "wire_model", None)
    sizes_scan = [1 << p for p in range(12, 25)]
    verdicts = {s: _tuner.pick_algorithm(s, pg._hier_node_sizes(),
                                         flat=inter, intra=intra)
                for s in sizes_scan}
    hier_sizes = [s for s, v in verdicts.items() if v == "hier"]
    crossover = min(hier_sizes) if hier_sizes else None
    arms = [("ring", pg, "ring"),
            ("hier", pg, "hier"),
            ("hier-codec", pg.channel("q-hier", codec="auto"), "hier")]
    rows = []
    flat_t = None
    flat_spread = None
    for name, surf, algo in arms:
        surf.all_reduce(x, timeout_s=60.0, algorithm=algo)  # warmup
        wire_base = WIRE.snapshot()
        verb_base = VERBS.snapshot()
        spans = []
        out = None
        for _ in range(args.repeats):
            pg.barrier()
            t0 = time.perf_counter()
            for _ in range(args.iters):
                out = surf.all_reduce(x, timeout_s=60.0, algorithm=algo)
            spans.append((time.perf_counter() - t0) / args.iters)
        wire = WIRE.delta(wire_base)
        wire["overlap_ratio"] = round(WIRE.overlap_ratio(since=wire_base), 4)
        wire.update(WIRE.negotiation())
        if args.smoke and wire["payload_bytes_copied"]:
            raise SystemExit(
                f"smoke gate: rank {pg.rank} staged "
                f"{wire['payload_bytes_copied']} payload bytes through "
                f"copies during the hier scenario's {name} arm "
                f"(want 0): {wire}")
        mine = trimmed_mean(spans)
        sec = float(pg.all_reduce(np.array([mine]), op="max")[0])
        fleet_spans = pg.all_reduce(np.asarray(spans), op="max")
        spread_gb = sorted(M.algbw_GBps(size, float(s))
                           for s in fleet_spans)
        err = float(np.abs(out - want).max())
        err = float(pg.all_reduce(np.array([err]), op="max")[0])
        bitwise = bool(np.array_equal(out, want))
        bitwise = bool(pg.all_reduce(
            np.array([int(bitwise)]), op="min")[0])
        pg.publish_telemetry()
        pg.barrier()
        if pg.rank != 0:
            continue
        fl = pg.fleet_stats()
        fleet = {k: fl[k] for k in
                 ("epoch", "health", "missing", "stale_dropped",
                  "worst_p99_us", "verb_p50_us", "verb_p99_us",
                  "verb_latency", "wire_totals")}
        algbw = M.algbw_GBps(size, sec)
        extra = dict(iters=args.iters, repeats=args.repeats,
                     spread=[round(spread_gb[0], 4),
                             round(spread_gb[-1], 4)],
                     wire=wire, verb_lat=VERBS.delta(verb_base),
                     fleet=fleet,
                     trace=_trace_summary(pg, "allreduce"
                                          if name == "ring"
                                          else "hierallreduce"))
        if name == "ring":
            flat_t = sec
            flat_spread = spread_gb
        else:
            extra["hier"] = {
                "speedup": round(flat_t / sec, 3) if flat_t else None,
                # best-trial speedup: the hier arm's best trial over
                # the flat arm's best (same-percentile comparison —
                # the smoke bar, so one noisy flat trial cannot gift
                # the gate a pass)
                "speedup_best": round(spread_gb[-1] / flat_spread[-1], 3)
                if flat_spread and flat_spread[-1] else None,
                "bitwise_ok": bitwise if name == "hier" else None,
                "max_abs_err": round(err, 6),
                "hier_ops": int(wire.get("hier_ops", 0)),
                "verdict": verdicts.get(size,
                                        _tuner.pick_algorithm(
                                            size, pg._hier_node_sizes(),
                                            flat=inter, intra=intra)),
                "crossover_bytes": crossover,
                "floor_GBps": SMOKE_FLOORS_HIER,
                "floor_x": round(algbw / SMOKE_FLOORS_HIER, 3),
                "floor_x_best": round(spread_gb[-1] / SMOKE_FLOORS_HIER,
                                      3),
                "topology": {"nodes": hinfo["nodes"],
                             "leaders": hinfo["leaders"],
                             "uniform": hinfo["uniform"],
                             "intra_plane": hinfo["intra_plane"],
                             "inter_plane": hinfo["inter_plane"]},
            }
            if name == "hier-codec":
                extra["hier"]["frames_encoded"] = \
                    int(wire.get("frames_encoded", 0))
                extra["hier"]["bytes_saved"] = \
                    int(wire.get("payload_bytes_saved", 0))
        rows.append(M.BenchRecord.measure(
            "bench_host", "allreduce", name, n, size, "float32", sec,
            platform=f"host-{args.plane}", **extra))
    return rows


def _trace_summary(pg, collective: str) -> dict:
    """The causal tracer's condensed verdict for one bench row: the
    SLOWEST assembled sampled op matching this collective — its wall
    span, critical-path total, the straggler rank (``cp_rank``, the
    ``format_table`` column), the worst hop, and that rank's
    five-bucket attribution. Sampling is the tracer's default
    (``ROCNRDMA_TRACE_SAMPLE``) — the bench proves the smoke floors
    hold with tracing ON, and the attached attribution is why a slow
    row was slow, not just that it was."""
    tr = pg.trace_stats()

    def norm(verb: str) -> str:
        # fn __name__ -> bench collective name: "ring_reduce_scatter_v
        # _over_net" -> "reducescatterv". EXACT equality after the
        # strip — a substring match would cross-credit the v-variants
        # ("alltoall" inside "alltoallv"), and the buffer retains
        # earlier collectives' ops across a multi-collective sweep
        for affix in ("ring_", "_over_net", "_rdma"):
            verb = verb.replace(affix, "")
        return verb.replace("_", "")

    # NEVER fall back to other collectives' ops: a mismatched verdict
    # on the row is worse than none
    ops = [t for t in tr["ops"] if norm(t["verb"]) == collective]
    out = {"sample": tr["sample"], "ops_assembled": len(tr["ops"]),
           "cp_rank": None}
    if not ops:
        return out
    slow = max(ops, key=lambda t: t["wall_s"])
    out.update(
        op=slow["op"], verb=slow["verb"], epoch=slow["epoch"],
        wall_us=round(slow["wall_s"] * 1e6, 1),
        cp_us=round(slow["cp_total_s"] * 1e6, 1),
        cp_rank=slow["cp_rank"],
        cp_share={r: round(s * 1e6, 1)
                  for r, s in slow["cp_share"].items()},
        worst_hop=slow["worst_hop"])
    if slow["cp_rank"] is not None:
        info = slow["ranks"].get(str(slow["cp_rank"]))
        if info is not None:
            out["attribution_us"] = {
                b: round(s * 1e6, 1)
                for b, s in info["attribution"].items()}
    return out


def worker(args) -> int:
    from rocnrdma_tpu_torch import distributed as dist
    from rocnrdma_tpu_torch.metrics import CONF, STORE, VERBS, WIRE
    from rocnrdma_tpu_torch.obs import conformance as _conformance

    node_of = ([int(v) for v in args.node_map.split(",")]
               if args.node_map else None)
    pg = dist.init_process_group(plane=args.plane, node_of=node_of)
    # the fleet telemetry agent rides the watchdog heartbeat — ON for
    # every bench fleet, the smoke runs included: the per-rank zero-copy
    # gate below then doubles as proof that the agent adds nothing to
    # the collective hot path (publishes are bounded store writes from
    # the watchdog thread)
    pg.start_watchdog()
    rng = np.random.default_rng(pg.rank)
    if args.collectives in ("lanes", "coalesce", "codec", "hier"):
        # the multi-tenant, many-small-ops, quantized-wire, and
        # hierarchical scenarios have their own loop shapes
        records = (_lanes_worker(pg, args) if args.collectives == "lanes"
                   else _coalesce_worker(pg, args)
                   if args.collectives == "coalesce"
                   else _codec_worker(pg, args)
                   if args.collectives == "codec"
                   else _hier_worker(pg, args))
        pg.barrier()
        pg.destroy()
        for rec in records:  # only rank 0 holds any
            print(rec.to_json())
        return 0
    records = []
    for collective in args.collectives.split(","):
        for size in (parse_size(s) for s in args.sizes.split(",")):
            elems = max(1, size // 4)
            per = max(1, elems // pg.world_size)
            counts = (_alltoallv_counts(pg.world_size, per)
                      if collective == "alltoallv"
                      else _ragged_counts(pg.world_size, per)
                      if collective in ("allgatherv", "reducescatterv")
                      else None)
            x = _build_input(collective, pg.world_size, elems, rng,
                             rank=pg.rank, counts=counts)
            # record the bytes actually moved (per-rank chunks round down),
            # matching the device benches' actual-bytes convention; the
            # gathered verbs record the gathered TOTAL (the sweep size-key
            # convention)
            actual = (x.nbytes * pg.world_size
                      if collective == "allgather"
                      else int(counts.sum()) * 4
                      if collective == "allgatherv"
                      else sum(seg.nbytes for seg in x)
                      if collective == "alltoallv" else x.nbytes)
            _issue(pg, collective, x, args.transport, counts)  # warmup
            # wire-counter window: warmup absorbs the one-time setup
            # (arena announces, pool priming), so the delta below is the
            # STEADY-state copy/stream/overlap telemetry of the timed loop
            wire_base = WIRE.snapshot()
            verb_base = VERBS.snapshot()
            store_base = STORE.snapshot()
            conf_base = CONF.snapshot()
            spans = []
            for _ in range(args.repeats):
                pg.barrier()
                t0 = time.perf_counter()
                for _ in range(args.iters):
                    _issue(pg, collective, x, args.transport, counts)
                spans.append((time.perf_counter() - t0) / args.iters)
            # the store-ops ledger window: how many bootstrap
            # round-trips the timed loop's control plane cost, by class
            # — the format_table sops column; a collective that grew
            # store chatter is a regression even when the GB/s holds
            store = STORE.delta(store_base)
            wire = WIRE.delta(wire_base)
            # windowed, same as every other gated counter: the lifetime
            # ratio would dilute the steady loop with the warmup's frames
            wire["overlap_ratio"] = round(WIRE.overlap_ratio(since=wire_base),
                                          4)
            # the wire parameters the streaming engine negotiated for this
            # collective (frame_bytes / pipeline_depth gauges): on the
            # record so a GB/s regression is attributable to a frame-
            # choice change, not just observable as a slowdown
            wire.update(WIRE.negotiation())
            if args.smoke and wire["payload_bytes_copied"]:
                # the zero-copy steady-path contract, enforced on EVERY
                # rank (each process checks its own counters)
                raise SystemExit(
                    f"smoke gate: rank {pg.rank} staged "
                    f"{wire['payload_bytes_copied']} payload bytes through "
                    f"copies during the steady {collective} loop "
                    f"(want 0): {wire}")
            mine = trimmed_mean(spans)
            # a collective is as slow as its slowest rank
            sec = float(pg.all_reduce(np.array([mine]), op="max")[0])
            # per-repeat fleet spans (max across ranks per repeat): the
            # SPREAD field every BENCH_r03+ artifact carries, here on
            # every bench_host row — what lets the sentinel resolve
            # regression vs trial noise instead of a fixed allowance
            fleet_spans = pg.all_reduce(np.asarray(spans), op="max")
            spread_gb = sorted(M.algbw_GBps(actual, float(s))
                               for s in fleet_spans)
            # fleet snapshot, OFF the timed window: every rank flushes a
            # final telemetry publish, the barrier orders them before
            # the leader aggregates — the record then carries per-rank
            # health and the bucket-exact merged verb histograms next to
            # the windowed wire counters
            pg.publish_telemetry()
            pg.barrier()
            if pg.rank == 0:
                fl = pg.fleet_stats()
                fleet = {k: fl[k] for k in
                         ("epoch", "health", "missing", "stale_dropped",
                          "worst_p99_us", "verb_p50_us", "verb_p99_us",
                          "verb_latency", "wire_totals")}
                algo = ("ring_rdma" if args.transport == "rdma"
                        and collective in ("allreduce", "reducescatter",
                                           "allgather") else "ring")
                # ragged verbs: the busbw factor comes from the actual
                # counts vector (the busiest rank's wire), not the
                # balanced-counts (n-1)/n approximation
                ragged = (counts.tolist()
                          if collective in ("allgatherv", "reducescatterv")
                          else None)
                # the model-conformance block: this sweep
                # point's own predicted-vs-measured cells (windowed,
                # like every gated counter — the warmup's joins stay
                # out), so a GB/s slide is attributable to "the model
                # stopped predicting this bucket" right on the record
                conf_delta = CONF.delta(conf_base)
                records.append(M.BenchRecord.measure(
                    "bench_host", collective, algo, pg.world_size, actual,
                    "float32", sec, platform=f"host-{args.plane}",
                    counts=ragged, iters=args.iters, repeats=args.repeats,
                    spread=[round(spread_gb[0], 4), round(spread_gb[-1], 4)],
                    wire=wire, verb_lat=VERBS.delta(verb_base),
                    store=store, fleet=fleet,
                    conf={"cells": _conformance.summarize(conf_delta),
                          "aux": conf_delta.get("aux", {})},
                    trace=_trace_summary(pg, collective)))
    pg.barrier()
    pg.destroy()
    if pg.rank == 0:
        for rec in records:
            print(rec.to_json())
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="bench_host",
        description="Benchmark the native host-plane (TCP QP) ring collectives",
        # no prefix abbreviations: the --smoke clash guard matches literal
        # flag strings, and an abbreviated `--plan tcp --smoke` slipping
        # past it would silently gate a config the run never touched
        allow_abbrev=False)
    p.add_argument("--ranks", type=int, default=4)
    p.add_argument("--plane", choices=("tcp", "shm"), default="tcp",
                   help="wire under the ring: TCP (cross-host) or shared "
                        "memory (intra-node)")
    p.add_argument("--transport", choices=("msg", "rdma"), default="msg",
                   help="data path for the reducing/gather rings "
                        "(allreduce, reducescatter, allgather): two-sided "
                        "send/recv or one-sided RDMA writes (put-based "
                        "ring); broadcast/alltoall(v) and the ragged "
                        "allgatherv/reducescatterv always ride send/recv")
    p.add_argument("--sizes", default="64K,1M")
    p.add_argument("--collectives", default=",".join(COLLECTIVES),
                   help="comma list, or the special value 'lanes': the "
                        "multi-tenant QoS scenario (P99 of a small "
                        "high-priority allreduce under a saturating "
                        "bulk allgather on a second lane)")
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--lat-iters", type=int, default=200,
                   help="lanes scenario: latency-lane allreduce samples "
                        "the P99 is computed over")
    p.add_argument("--bulk-size", default="32M",
                   help="lanes scenario: per-rank bulk allgather block")
    p.add_argument("--bulk-rounds", type=int, default=40,
                   help="lanes scenario: bulk allgather ops (same on "
                        "every rank — the bulk lane is a collective "
                        "too); size it to outlast the latency loop")
    p.add_argument("--small-ops", type=int, default=256,
                   help="coalesce scenario: small allreduces per timed "
                        "pass (each of the first --sizes entry)")
    p.add_argument("--bucket-size", default="4M",
                   help="coalesce scenario: the lane's bucket_bytes "
                        "flush knob (the tuner-pickable coalescer size)")
    p.add_argument("--node-map", default=None,
                   help="hier scenario / any run: comma list mapping "
                        "rank r to its NODE id (init_process_group's "
                        "node_of) — e.g. 0,0,1,1 simulates a 2-node x "
                        "2-rank split whose intra-node legs ride shm "
                        "and whose cross-node legs ride --plane")
    p.add_argument("--out", default=None, help="JSONL output path")
    p.add_argument("--sweep", action="store_true",
                   help="emit the wire-model fit corpus for --plane: "
                        "a --sizes ladder of allreduce rows "
                        "per pinned frame candidate (spread recorded), "
                        "then fit the per-plane alpha/beta model "
                        "(tuner.fit_host_rows), then measure model "
                        "picks vs the hand-tuned defaults row-wise; "
                        "corpus JSONL to --out, summary to --tune-out")
    p.add_argument("--sweep-frames", default="131072,524276,1048576,4194304",
                   help="--sweep only: comma list of pinned frame_bytes "
                        "(raw ints; 524276 is the exact MAX_FRAME "
                        "payload — the largest frame-path post)")
    p.add_argument("--sweep-depths", default="2",
                   help="--sweep only: comma list of pinned posting-"
                        "window depths (the depth axis — "
                        "varying it is what identifies the fitted "
                        "consume/depth coefficient separately from the "
                        "per-frame alpha; the default keeps the legacy "
                        "frames-only corpus shape)")
    p.add_argument("--tune-out", default=None,
                   help="--sweep only: write the tune summary (fit "
                        "params + default-vs-picked rows) to this path")
    p.add_argument("--smoke", action="store_true",
                   help="tier-1 perf gate: 2-rank 1 MiB allreduce on the "
                        "shm, tcp, AND rdma (put-based ring) paths plus "
                        "the lanes QoS scenario, the coalesce "
                        "many-small-ops scenario, the codec "
                        "quantized-wire scenario, and the hier "
                        "node-aware scenario (simulated 2-node x "
                        "2-rank mixed shm/tcp fleet); asserts ZERO steady-"
                        "path payload copies on every rank of every "
                        "fleet, algbw >= 0.8x each path's recorded "
                        f"floor ({SMOKE_FLOORS}), the latency "
                        f"lane's P99 <= {SMOKE_LANES_P99_US:.0f} us "
                        "under concurrent bulk load, coalesced "
                        f">= {SMOKE_COALESCE_SPEEDUP}x unbatched on "
                        "the small-op floor, and the int8-wire tcp "
                        f"allreduce >= {SMOKE_CODEC_X}x the fp32 tcp "
                        "floor with error feedback ON")
    p.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)

    if args.collectives == "hier" and not args.node_map:
        p.error("--collectives hier needs --node-map (e.g. 0,0,1,1: "
                "the simulated node split whose intra-node legs ride "
                "shm and whose cross-node legs ride --plane)")

    if args.worker:
        return worker(args)

    if args.sweep:
        if args.smoke:
            p.error("--sweep and --smoke are different modes: the sweep "
                    "measures the tuning corpus, the smoke gates the "
                    "recorded floors — run them separately")
        return _run_sweep(args)

    if args.smoke:
        # the gate measures the recorded configurations; silently ignoring
        # an explicit --plane tcp (etc.) would let a user believe they
        # gated a path the smoke run never touched — refuse the clash
        # (detected from argv: a default-valued explicit flag must clash
        # too, or `--plane tcp --smoke` would pass and mislead)
        given = {a.split("=", 1)[0]
                 for a in (sys.argv[1:] if argv is None else argv)
                 if a.startswith("--")}
        clash = sorted(given & {"--ranks", "--plane", "--transport",
                                "--sizes", "--collectives", "--repeats",
                                "--iters", "--lat-iters", "--bulk-size",
                                "--bulk-rounds", "--small-ops",
                                "--bucket-size", "--node-map"})
        if clash:
            p.error(f"--smoke runs the fixed recorded configs "
                    f"({' '.join(SMOKE_ARGS)}, then the tcp, rdma, and "
                    f"lanes twins); drop {'/'.join(clash)} or run a "
                    f"plain bench instead")
        records, failures = [], []
        for path in ("shm", "tcp", "rdma", "lanes", "coalesce", "codec",
                     "hier"):
            # each path is its own fleet: per-rank copy gates run inside
            # the workers, the throughput gate against the path's floor
            # runs here. ALL paths measure (and their records persist)
            # before any floor failure raises, so a regression report
            # carries the full wire counters and says whether the slide
            # is per-path or global.
            recs = _run_fleet(p.parse_args(_smoke_args(path)
                                           + ["--smoke"]))
            records.extend(recs)
            rec = recs[-1]  # coalesce: [unbatched, coalesced] — gate the
            #                 coalesced row (it carries the speedup)
            if path == "hier":
                # the node-aware gate: rows are [flat ring,
                # hier, hier + per-leg codec] on ONE mixed 2x2 fleet.
                # The hier arm must (a) have genuinely run the
                # two-level schedule with the verdict pinned on the
                # negotiation gauge and tuning ON, (b) beat the
                # same-run flat tcp ring by the recorded multiple,
                # (c) hold the absolute recorded floor, bitwise; the
                # codec arm must prove the CROSS leg compressed.
                rec = recs[1]
                ex = rec.extra.get("hier", {})
                wire = rec.extra.get("wire", {})
                cod = recs[2].extra.get("hier", {})
                if wire.get("algorithm") != "hier" \
                        or not wire.get("hier_ops"):
                    failures.append(
                        f"smoke gate [hier]: the hierarchical schedule "
                        f"did not engage (algorithm="
                        f"{wire.get('algorithm')}, hier_ops="
                        f"{wire.get('hier_ops')}) — the gate proved "
                        f"nothing about the node-aware path")
                elif wire.get("tuner_version") is None:
                    failures.append(
                        f"smoke gate [hier]: auto-tuning was not active "
                        f"on the hier arm (no tuner_version) — the "
                        f"floor was not measured with model picks "
                        f"(wire={wire})")
                elif not ex.get("bitwise_ok"):
                    failures.append(
                        f"smoke gate [hier]: the hierarchical result "
                        f"was NOT bitwise-equal to the exact oracle "
                        f"(extra={ex})")
                elif ex.get("speedup_best", 0.0) < SMOKE_HIER_MIN_X:
                    failures.append(
                        f"smoke gate [hier]: hierarchical allreduce is "
                        f"only {ex.get('speedup')}x the same-run flat "
                        f"ring ({ex.get('speedup_best')}x best trial "
                        f"< {SMOKE_HIER_MIN_X}x) — hier measurably "
                        f"SLOWER than flat means the legs serialized "
                        f"or degraded to the flat path (extra={ex})")
                elif rec.algbw_GBps < 0.8 * SMOKE_FLOORS_HIER:
                    failures.append(
                        f"smoke gate [hier]: {rec.algbw_GBps:.3f} GB/s "
                        f"is below 0.8x the recorded hier floor "
                        f"({SMOKE_FLOORS_HIER} GB/s) (extra={ex})")
                elif not cod.get("frames_encoded"):
                    failures.append(
                        f"smoke gate [hier]: the codec arm encoded no "
                        f"frames — the per-leg arbitration did not "
                        f"compress the cross-node leg (extra={cod})")
                else:
                    print(f"smoke gate ok [hier]: hierarchical "
                          f"{rec.algbw_GBps:.3f} GB/s >= "
                          f"{0.8 * SMOKE_FLOORS_HIER:.3f} "
                          f"({ex['speedup']}x same-run flat; the "
                          f"committed record holds the "
                          f">= {SMOKE_HIER_X}x capability bar; "
                          f"verdict {ex['verdict']}, crossover "
                          f"{ex['crossover_bytes']} B), bitwise oracle "
                          f"held, per-leg codec saved "
                          f"{cod.get('bytes_saved')} B on the cross "
                          f"leg, zero steady-path copies")
                continue
            if path == "codec":
                # the quantized-wire gate: the int8 arm (row 2 of
                # [fp32, int8, fp8]) must beat the committed fp32 tcp
                # floor by the recorded multiple with the codec
                # genuinely engaged (the negotiation gauge says what
                # the wire actually did)
                rec = recs[1]
                ex = rec.extra.get("codec", {})
                wire = rec.extra.get("wire", {})
                want_mean = 0.8 * SMOKE_CODEC_X  # the standard noise
                #             allowance every floor gate carries,
                #             applied to the codec bar's mean
                if wire.get("codec") != "int8" \
                        or not wire.get("frames_encoded"):
                    failures.append(
                        f"smoke gate [codec]: the int8 lane did not "
                        f"engage the wire codec (negotiated "
                        f"codec={wire.get('codec')}, frames_encoded="
                        f"{wire.get('frames_encoded')}) — the gate "
                        f"proved nothing about the quantized wire")
                elif ex.get("floor_x_best", 0.0) < SMOKE_CODEC_X \
                        or ex.get("floor_x", 0.0) < want_mean:
                    failures.append(
                        f"smoke gate [codec]: int8-wire allreduce at "
                        f"{rec.algbw_GBps:.3f} GB/s is only "
                        f"{ex.get('floor_x')}x the committed fp32 tcp "
                        f"floor mean / {ex.get('floor_x_best')}x best "
                        f"trial ({ex.get('floor_GBps')} GB/s; want "
                        f"best >= {SMOKE_CODEC_X}x and mean >= "
                        f"{want_mean}x) — the quantized wire has "
                        f"regressed (extra={ex})")
                else:
                    print(f"smoke gate ok [codec]: int8 wire "
                          f"{rec.algbw_GBps:.3f} GB/s = "
                          f"{ex['floor_x']}x the fp32 tcp floor "
                          f"(best trial {ex['floor_x_best']}x >= "
                          f"{SMOKE_CODEC_X}x; speedup {ex['speedup']}x "
                          f"same-run, max-abs-err {ex['max_abs_err']}, "
                          f"{ex['bytes_saved']} B saved), zero "
                          f"steady-path copies")
                continue
            if path == "coalesce":
                # the many-small-ops gate: fused buckets must beat the
                # unbatched per-op floor by the recorded multiple, and
                # the repacking must be bitwise-invisible
                ex = rec.extra.get("coalesce", {})
                if not ex.get("bitwise_ok"):
                    failures.append(
                        "smoke gate [coalesce]: fused bucket results "
                        "were NOT bitwise-equal to the unbatched ring "
                        f"(extra={ex})")
                elif ex.get("speedup", 0.0) < SMOKE_COALESCE_SPEEDUP:
                    failures.append(
                        f"smoke gate [coalesce]: coalesced algbw is "
                        f"only {ex.get('speedup')}x the unbatched "
                        f"small-op floor (< {SMOKE_COALESCE_SPEEDUP}x) "
                        f"— the coalescer has regressed (extra={ex})")
                else:
                    print(f"smoke gate ok [coalesce]: "
                          f"{ex['speedup']}x over unbatched at "
                          f"{rec.size_bytes} B x {ex['ops']} ops "
                          f"(fill {ex['fill_pct']}%), bitwise oracle "
                          f"preserved, zero steady-path copies")
                continue
            if path == "lanes":
                # the QoS gate: both tenants correct, the measurement
                # genuinely under load, the latency lane's P99 inside
                # the recorded ceiling, and the bulk lane not starved
                ex = rec.extra
                if not ex.get("lanes_ok"):
                    failures.append(
                        "smoke gate [lanes]: a lane's collective was "
                        "NOT bitwise/allclose-correct under concurrency "
                        f"(extra={ex})")
                elif not ex.get("overlap_ok"):
                    failures.append(
                        "smoke gate [lanes]: the bulk lane finished "
                        "before the latency loop — the P99 was not "
                        "measured under load; raise --bulk-rounds "
                        f"(extra={ex})")
                elif ex["p99_us"] > SMOKE_LANES_P99_US:
                    failures.append(
                        f"smoke gate [lanes]: latency-lane P99 "
                        f"{ex['p99_us']:.0f} us exceeds the recorded "
                        f"ceiling {SMOKE_LANES_P99_US:.0f} us under "
                        f"concurrent bulk load — the lane scheduler "
                        f"has regressed (extra={ex})")
                elif ex["bulk_GBps"] < SMOKE_LANES_BULK_GBPS:
                    failures.append(
                        f"smoke gate [lanes]: bulk lane moved only "
                        f"{ex['bulk_GBps']:.3f} GB/s during the latency "
                        f"window (< {SMOKE_LANES_BULK_GBPS}) — the "
                        f"priority lane is starving the bulk tenant "
                        f"(extra={ex})")
                else:
                    print(f"smoke gate ok [lanes]: latency P99 "
                          f"{ex['p99_us']:.0f} us <= "
                          f"{SMOKE_LANES_P99_US:.0f} us with the bulk "
                          f"lane at {ex['bulk_GBps']:.3f} GB/s "
                          f"({ex['bulk_lane_bytes']} B in window), both "
                          f"lanes correct, zero steady-path copies")
                continue
            floor = SMOKE_FLOORS[path]
            want = 0.8 * floor
            # the auto-tuning half of the gate: the msg-path
            # floors must hold with the wire tuner ACTIVE — a streamed
            # record whose negotiation gauge carries no model version
            # means the picks were bypassed and the gate proved nothing
            # about the self-tuning wire
            if (path in ("shm", "tcp")
                    and rec.extra.get("wire", {}).get("tuner_version")
                    is None):
                failures.append(
                    f"smoke gate [{path}]: auto-tuning was not active "
                    f"(no tuner_version on the negotiation gauge) — the "
                    f"floor was not measured with model picks "
                    f"(wire={rec.extra.get('wire')})")
            if rec.algbw_GBps < want:
                failures.append(
                    f"smoke gate [{path}]: {rec.algbw_GBps:.3f} GB/s is "
                    f"below 0.8x the recorded floor ({floor} GB/s); the "
                    f"zero-copy ring wire has regressed "
                    f"(wire={rec.extra.get('wire')})")
            else:
                print(f"smoke gate ok [{path}]: {rec.algbw_GBps:.3f} "
                      f"GB/s >= {want:.3f}, zero steady-path payload "
                      f"copies on every rank "
                      f"(wire={rec.extra.get('wire')})")
        if args.out:
            with open(args.out, "a") as fp:
                for rec in records:
                    rec.write(fp)
        print(M.format_host_table(records))
        if failures:
            raise SystemExit("\n".join(failures))
        return 0

    records = _run_fleet(args)
    if args.out:
        with open(args.out, "a") as fp:
            for rec in records:
                rec.write(fp)
    print(M.format_host_table(records))
    return 0


def _run_sweep(args) -> int:
    """The measure half of the measure→model→pick loop:

    1. CORPUS — for every (size, pinned frame) point on this plane, one
       allreduce fleet; each row carries its frame knob, mean, and the
       per-repeat fleet spread (the statistical field the sentinel and
       the fit both consume). Appended to ``--out`` as JSONL.
    2. FIT — ``tuner.fit_host_rows`` least-squares the plane's
       alpha/beta coefficients from the corpus (fallback ladder named
       via ``fit_note``); the fitted model is saved next to the
       summary so ``ROCNRDMA_HOST_TUNING`` can load it.
    3. PICK vs DEFAULT — per ladder size, one fleet with tuning
       disabled (the hand-tuned static wire) and one with the fitted
       model loaded; the summary's rows carry both arms' algbw+spread
       and the ratio, which is exactly what ``results/tune_r01.json``
       commits.
    """
    from rocnrdma_tpu_torch.transport import tuner as _tuner

    sizes = [parse_size(s) for s in args.sizes.split(",")]
    frames = [int(f) for f in args.sweep_frames.split(",")]
    one = argparse.Namespace(**vars(args))
    one.collectives = "allreduce"
    depths = [int(d) for d in args.sweep_depths.split(",")]
    corpus: list = []
    for size in sizes:
        for frame in frames:
            for depth in depths:
                one.sizes = str(size)
                # the depth axis: pinning the posting window
                # alongside the frame is what separates the fitted
                # consume/depth coefficient from the per-frame alpha —
                # a frames-only corpus identifies their SUM, not the
                # split (the ROADMAP carry-over this sweep closes)
                recs = _run_fleet(one, extra_env={
                    "ROCNRDMA_WIRE_FRAME": str(frame),
                    "ROCNRDMA_WIRE_DEPTH": str(depth),
                    # the fit converts rows via the GENERIC ring shape
                    # (2(n-1) hops of S/n): pin the 2-rank
                    # exchange-and-fold schedule OFF so the corpus
                    # measures what the regression models
                    "ROCNRDMA_WIRE_XFOLD": "0"})
                for rec in recs:
                    print(f"# corpus {args.plane} size={size} "
                          f"frame={frame} depth={depth}: "
                          f"{rec.algbw_GBps:.3f} GB/s "
                          f"spread={rec.extra.get('spread')}", flush=True)
                corpus.extend(recs)
    if args.out:
        with open(args.out, "a") as fp:
            for rec in corpus:
                rec.write(fp)
    rows = [{"plane": args.plane, "size_bytes": r.size_bytes,
             "n_ranks": r.n_ranks, "mean_s": r.mean_s,
             "algbw_GBps": r.algbw_GBps,
             "spread": r.extra.get("spread"),
             "frame_bytes": r.extra.get("wire", {}).get("frame_bytes"),
             "pipeline_depth": r.extra.get("wire", {}).get(
                 "pipeline_depth")}
            for r in corpus]
    planes = _tuner.fit_host_rows(rows)
    # the MEASURED winners supersede the analytic fit inside the swept
    # range (robust scoring: a bucket goes to the frame whose WORST
    # trial was fastest — the spread field doing statistics, not decor)
    tables = _tuner.measured_winners(rows)
    note = _tuner.fit_note(len(rows))
    model_path = (args.tune_out or "tune_sweep.json") + ".model"
    _tuner.save_host_model(model_path, planes, tables=tables, meta={
        "provenance": f"bench_host --sweep --plane {args.plane}",
        "fit": {args.plane: note}})
    print(f"# fitted {args.plane}: {note}, measured table "
          f"{tables.get(args.plane)} -> {model_path}", flush=True)
    compare = []
    picked_records = []
    for size in sizes:
        one.sizes = str(size)
        arms = {}
        for arm, env in (("default", {"ROCNRDMA_WIRE_TUNER": "0"}),
                         ("picked", {"ROCNRDMA_HOST_TUNING": model_path})):
            rec = _run_fleet(one, extra_env=env)[-1]
            if arm == "picked":
                # the full record rides the summary: its spread/fleet/
                # trace extras are what the sentinel's statistical
                # ratchet (and the wp99/cp-share drift checks) consume
                import dataclasses as _dc
                picked_records.append(_dc.asdict(rec))
            wire = rec.extra.get("wire", {})
            arms[arm] = {
                "algbw_GBps": round(rec.algbw_GBps, 4),
                "spread": rec.extra.get("spread"),
                "frame_bytes": wire.get("frame_bytes"),
                "pipeline_depth": wire.get("pipeline_depth"),
                "tuner_version": wire.get("tuner_version"),
                "mean_s": rec.mean_s,
            }
        ratio = (arms["picked"]["algbw_GBps"]
                 / max(1e-12, arms["default"]["algbw_GBps"]))
        compare.append({"size_bytes": size, "ratio": round(ratio, 3),
                        **{k: v for k, v in arms.items()}})
        print(f"# compare {args.plane} size={size}: default "
              f"{arms['default']['algbw_GBps']} "
              f"({arms['default']['frame_bytes']}B) vs picked "
              f"{arms['picked']['algbw_GBps']} "
              f"({arms['picked']['frame_bytes']}B) -> x{ratio:.2f}",
              flush=True)
    doc = {"schema": "tune_sweep_r1", "plane": args.plane,
           "n_ranks": args.ranks,
           "fit": {"note": note,
                   "params": {k: v.to_dict() for k, v in planes.items()},
                   "tables": {k: [[mx, f] for mx, f in v]
                              for k, v in tables.items()}},
           "rows": compare,
           "records": picked_records}
    payload = json.dumps(doc, indent=1, sort_keys=True)
    if args.tune_out:
        tmp = f"{args.tune_out}.tmp.{os.getpid()}"
        with open(tmp, "w") as fp:
            fp.write(payload)
        os.replace(tmp, args.tune_out)
        print(f"# wrote {args.tune_out}")
    else:
        print(payload)
    return 0


def _run_fleet(args, extra_env: dict | None = None) -> list:
    """Spawn the rank fleet for one bench configuration; returns the
    parsed BenchRecords from rank 0 (raises SystemExit on any nonzero
    worker — including a rank's copy-gate failure under --smoke).
    ``extra_env``: extra worker environment (the sweep's wire-model
    knobs: frame pins, tuner disable, fitted-artifact load)."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    cmd = [sys.executable, "-m", "rocnrdma_tpu_torch.bench.bench_host", "--worker",
           "--ranks", str(args.ranks), "--plane", args.plane,
           "--transport", args.transport, "--sizes", args.sizes,
           "--collectives", args.collectives, "--repeats", str(args.repeats),
           "--iters", str(args.iters), "--lat-iters", str(args.lat_iters),
           "--bulk-size", args.bulk_size,
           "--bulk-rounds", str(args.bulk_rounds),
           "--small-ops", str(args.small_ops),
           "--bucket-size", args.bucket_size] \
        + (["--node-map", args.node_map] if args.node_map else []) \
        + (["--smoke"] if args.smoke else [])
    procs = []
    try:
        for r in range(args.ranks):
            env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(args.ranks),
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                       **(extra_env or {}))
            # --smoke: every rank enforces the copy gate and its SystemExit
            # diagnostic (which rank, how many bytes) must reach the user,
            # so smoke runs keep ALL ranks' stderr attached
            procs.append(subprocess.Popen(
                cmd, env=env, text=True,
                stdout=subprocess.PIPE if r == 0 else subprocess.DEVNULL,
                stderr=None if r == 0 or args.smoke else subprocess.DEVNULL))
        out, _ = procs[0].communicate(timeout=600)
        codes = [p.wait(timeout=600) for p in procs]
    finally:
        # never orphan CPU-spinning workers: a wedged rank or a timeout
        # above must take the whole fleet down with it
        for p in procs:
            if p.poll() is None:
                p.kill()
    if any(codes):
        print(out, file=sys.stderr)
        raise SystemExit(f"worker exit codes {codes}")
    return [M.BenchRecord.from_json(line)
            for line in out.splitlines() if line.strip()]


if __name__ == "__main__":
    sys.exit(main())
