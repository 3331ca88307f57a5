"""Calibrate the host plane on this machine: the wire model and the smoke floors.

    python -m rocnrdma_tpu_torch.bench.host_tune \\
        --out rocnrdma_tpu_torch/results/host_tune_h100.json

1. ``bench_host --sweep`` on each plane (2 ranks, ``--sizes`` x the
   sweep's frame ladder x ``--depths``); the corpus goes to
   ``<out>.corpus.jsonl``;
2. ``tuner --fit-host`` over that corpus (``<out>.fit.json``): per-plane
   params and the measured winner tables (what ``COMMITTED_HOST_PLANES``
   holds);
3. ``--smoke-runs`` runs of ``bench_host --smoke`` (records to
   ``<out>.smoke<i>.jsonl``): each gate's value per run, and the floors
   the port's rule derives from the worst run: a GB/s floor at 0.625x the
   worst run (the gate's 0.8x allowance then sits at half of it), the
   lanes P99 ceiling at twice the worst, the bulk, coalesce and codec
   bars at half the worst (the hier-over-flat guard is the reference's
   0.9, not a measured floor);
4. with ``--compare-planes``: the committed wire model against the static
   wire (``ROCNRDMA_WIRE_TUNER=0``), one allreduce fleet per arm per
   round in the order static, committed, committed, static; a point is a
   loss (a win) where every committed fleet is slower (faster) than every
   static one, and unresolved where the two arms' fleets overlap;
5. the int8 and fp8 codecs' encode and decode-fold GB/s on one frame,
   fp8's cost over int8's (``codec.COST_FACTOR``), and each plane's
   ``codec_s_per_b`` (the fit keeps the seed): int8's encode + decode-fold
   seconds per decoded byte, ``1/encode + 1/decode_fold``.

The JSON names the host's CPU, its core count and, where there is one,
the card (``nvidia-smi``): these are the host's numbers, not the card's.
Its ``planes``/``tables`` load through ``ROCNRDMA_HOST_TUNING``. With
``--planes ""`` there is no sweep: the smoke runs and the comparison
measure the committed model, and the floors derived from them are the
ones to commit. Host-plane only: imports no torch until the codec step.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

MiB = 1 << 20
# the wire model's environment knobs (transport/tuner.py): the comparison
# unsets them all, so its committed arm runs COMMITTED_HOST_PLANES
WIRE_KNOBS = ("ROCNRDMA_WIRE_TUNER", "ROCNRDMA_HOST_TUNING",
              "ROCNRDMA_WIRE_FRAME", "ROCNRDMA_WIRE_DEPTH",
              "ROCNRDMA_WIRE_XFOLD")


def host_cpu() -> str:
    """The host's CPU model and core count; where the model name is
    missing (a virtual machine may print "unknown"), its vendor, family
    and model numbers."""
    info = {}
    with contextlib.suppress(OSError):
        for line in open("/proc/cpuinfo"):
            key, _, val = line.partition(":")
            info.setdefault(key.strip(), val.strip())
    model = info.get("model name", "unknown")
    if model in ("", "unknown"):
        model = (f"{info.get('vendor_id', 'unknown vendor')} family "
                 f"{info.get('cpu family', '?')} model {info.get('model', '?')}")
    return f"{model}, {os.cpu_count()} cores"


def smi_line() -> str | None:
    with contextlib.suppress(OSError, subprocess.SubprocessError):
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
        if r.returncode == 0:
            return r.stdout.strip()
    return None


def codec_rates(nbytes: int = MiB, reps: int = 20) -> dict:
    """Encode and decode-fold GB/s of the int8 and fp8 codecs on one
    seeded fp32 frame (best of ``reps``), and fp8's encode+decode cost
    per byte over int8's."""
    import numpy as np

    from rocnrdma_tpu_torch.transport import codec

    x = np.random.default_rng(3).standard_normal(nbytes // 4).astype(np.float32)
    out = {}
    for name in ("int8", "fp8"):
        c = codec.get(name)
        frame = np.frombuffer(bytes(c.encode(x)), np.uint8)
        dest = np.zeros_like(x)
        enc, dec = [], []
        for _ in range(reps):
            t0 = time.perf_counter()
            c.encode(x)
            enc.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            c.decode_fold(frame, dest.view(np.uint8), np.float32, np.add)
            dec.append(time.perf_counter() - t0)
        out[name] = {"encode_GBps": nbytes / min(enc) / 1e9,
                     "decode_fold_GBps": nbytes / min(dec) / 1e9}
    cost = {k: 1 / v["encode_GBps"] + 1 / v["decode_fold_GBps"]
            for k, v in out.items()}
    out["fp8_over_int8_cost"] = cost["fp8"] / cost["int8"]
    return out


def _records(path: str) -> list:
    with open(path) as fp:
        return [json.loads(line) for line in fp if line.strip()]


def smoke_values(records: list) -> dict:
    """Each gate's measured value from one ``bench_host --smoke --out``
    run's records: each path's row is the first of its (algo, plane,
    ranks); the tcp path's ring row precedes the codec scenario's."""
    first = {}
    for r in records:
        first.setdefault((r["algo"], r["platform"], r["n_ranks"]), r)

    def row(algo: str, plane: str, ranks: int = 2) -> dict:
        try:
            return first[(algo, f"host-{plane}", ranks)]
        except KeyError:
            raise ValueError(f"the smoke records hold no {algo} row on "
                             f"{plane} at {ranks} ranks") from None

    codec, hier = row("codec-int8", "tcp"), row("hier", "tcp", 4)
    lanes = row("lanes", "shm")["extra"]
    return {
        "shm_GBps": row("ring", "shm")["algbw_GBps"],
        "tcp_GBps": row("ring", "tcp")["algbw_GBps"],
        "rdma_GBps": row("ring_rdma", "shm")["algbw_GBps"],
        "lanes_p99_us": lanes["p99_us"],
        "lanes_bulk_GBps": lanes["bulk_GBps"],
        "coalesce_speedup":
            row("coalesced", "shm")["extra"]["coalesce"]["speedup"],
        "codec_int8_GBps": codec["algbw_GBps"],
        "codec_int8_best_GBps": codec["extra"]["spread"][-1],
        "hier_GBps": hier["algbw_GBps"],
        "hier_speedup_best": hier["extra"]["hier"]["speedup_best"],
    }


def derive_floors(runs: list) -> dict:
    """The smoke floors from the worst of ``runs`` (``smoke_values``)."""
    worst = {k: (max if k == "lanes_p99_us" else min)(r[k] for r in runs)
             for k in runs[0]}
    tcp_floor = round(0.625 * worst["tcp_GBps"], 3)
    return {
        "SMOKE_FLOORS": {p: round(0.625 * worst[f"{p}_GBps"], 3)
                         for p in ("shm", "tcp", "rdma")},
        "SMOKE_FLOORS_HIER": round(0.625 * worst["hier_GBps"], 3),
        "SMOKE_LANES_P99_US": round(2 * worst["lanes_p99_us"], -2),
        "SMOKE_LANES_BULK_GBPS": round(0.5 * worst["lanes_bulk_GBps"], 3),
        "SMOKE_COALESCE_SPEEDUP": round(0.5 * worst["coalesce_speedup"], 2),
        "SMOKE_CODEC_X": round(0.5 * min(r["codec_int8_best_GBps"]
                                         for r in runs) / tcp_floor, 2),
        "worst": worst,
    }


def _bench_host(args: list, log, env: dict | None = None) -> int:
    """``bench_host`` with ``args``; ``env`` overrides this process's
    environment (a ``None`` value unsets the variable)."""
    cmd = [sys.executable, "-m", "rocnrdma_tpu_torch.bench.bench_host", *args]
    print("$ " + " ".join(cmd[1:]), flush=True)
    full = dict(os.environ)
    for k, v in (env or {}).items():
        if v is None:
            full.pop(k, None)
        else:
            full[k] = v
    r = subprocess.run(cmd, stdout=log, stderr=subprocess.STDOUT, text=True,
                       timeout=3000, env=full)
    return r.returncode


def _sweep(args, meta: dict, log) -> tuple:
    """Steps 1-2: the sweep of every plane and the fit -> (planes, tables)."""
    from rocnrdma_tpu_torch.transport import tuner

    corpus = args.out + ".corpus.jsonl"
    with contextlib.suppress(FileNotFoundError):
        os.remove(corpus)
    t0 = time.perf_counter()
    for plane in args.planes.split(","):
        summary = f"{args.out}.sweep_{plane}.json"
        cmd = ["--sweep", "--ranks", "2", "--plane", plane,
               "--sizes", args.sizes, "--sweep-depths", args.depths,
               "--repeats", str(args.repeats), "--iters", str(args.iters),
               "--out", corpus, "--tune-out", summary]
        meta["commands"].append("bench_host " + " ".join(cmd).replace(
            args.out, "<out>"))
        if _bench_host(cmd, log) != 0:
            raise SystemExit(f"bench_host --sweep --plane {plane} failed "
                             f"(log: {log.name})")
        meta["sweeps"][plane] = json.load(open(summary))["rows"]
    meta["sweep_s"] = time.perf_counter() - t0
    fit = args.out + ".fit.json"
    meta["commands"].append("tuner --fit-host <out>.corpus.jsonl "
                            "--out <out>.fit.json")
    tuner._fit_host_main(corpus, fit)
    meta["fit"] = json.load(open(fit))["meta"]["fit"]
    return tuner.load_host_model(fit), tuner.load_host_tables(fit)


def _fleet_GBps(plane: str, ranks: int, size: str, args, env: dict,
                log) -> dict:
    """One ``bench_host`` allreduce fleet under ``env`` -> its GB/s (the
    trimmed mean over repeats) and the wire it negotiated."""
    out = f"{args.out}.fleet.jsonl"
    with contextlib.suppress(FileNotFoundError):
        os.remove(out)
    cmd = ["--ranks", str(ranks), "--plane", plane, "--sizes", size,
           "--collectives", "allreduce", "--repeats", str(args.repeats),
           "--iters", str(args.iters), "--out", out]
    if _bench_host(cmd, log, env) != 0:
        raise SystemExit(f"bench_host {' '.join(cmd)} failed "
                         f"(log: {log.name})")
    rec = _records(out)[-1]
    wire = rec["extra"].get("wire", {})
    return {"GBps": rec["algbw_GBps"], "frame_bytes": wire.get("frame_bytes"),
            "pipeline_depth": wire.get("pipeline_depth"),
            "tuner_version": wire.get("tuner_version")}


def verdict(committed: list, static: list) -> str:
    """``loss`` (``win``) where every committed fleet's GB/s is below
    (above) every static one's, else ``unresolved``."""
    if max(committed) < min(static):
        return "loss"
    if min(committed) > max(static):
        return "win"
    return "unresolved"


def compare(args, meta: dict, log) -> list:
    """Step 4: the committed wire model against the static wire, per
    plane, rank count and size, ``--compare-rounds`` rounds of one fleet
    per arm in the order static, committed, committed, static."""
    env_committed = {k: None for k in WIRE_KNOBS}
    env_static = {**env_committed, "ROCNRDMA_WIRE_TUNER": "0"}
    meta["commands"].append(
        f"bench_host --collectives allreduce --repeats {args.repeats} "
        f"--iters {args.iters}, ROCNRDMA_WIRE_TUNER=0 (static) and the "
        f"committed model, {args.compare_rounds} rounds of static, "
        f"committed, committed, static")
    rows = []
    for plane in args.compare_planes.split(","):
        for ranks in (int(r) for r in args.compare_ranks.split(",")):
            for size in args.sizes.split(","):
                arms = {"static": [], "committed": []}
                for _ in range(args.compare_rounds):
                    for arm in ("static", "committed", "committed", "static"):
                        env = env_static if arm == "static" else env_committed
                        arms[arm].append(
                            _fleet_GBps(plane, ranks, size, args, env, log))
                gb = {k: [f["GBps"] for f in v] for k, v in arms.items()}
                row = {"plane": plane, "ranks": ranks, "size": size,
                       "verdict": verdict(gb["committed"], gb["static"]),
                       "median_ratio": round(
                           statistics.median(gb["committed"])
                           / statistics.median(gb["static"]), 3),
                       **{k: {"GBps": [round(g, 4) for g in gb[k]],
                              "wire": {w: v[0][w] for w in
                                       ("frame_bytes", "pipeline_depth",
                                        "tuner_version")}}
                          for k, v in arms.items()}}
                rows.append(row)
                print(f"compare {plane} n={ranks} {size}: {row['verdict']} "
                      f"(x{row['median_ratio']}) committed {gb['committed']} "
                      f"static {gb['static']}", flush=True)
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", required=True)
    p.add_argument("--planes", default="shm,tcp",
                   help="planes to sweep and fit; empty: no sweep, the "
                        "smoke runs measure the committed wire model")
    p.add_argument("--sizes", default="256K,1M,4M,16M")
    p.add_argument("--depths", default="2,3")
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--smoke-runs", type=int, default=3)
    p.add_argument("--compare-planes", default="",
                   help="planes on which to compare the committed model "
                        "with the static wire at --sizes; empty: none")
    p.add_argument("--compare-ranks", default="2")
    p.add_argument("--compare-rounds", type=int, default=2)
    args = p.parse_args(argv)

    import dataclasses

    meta = {"host_cpu": host_cpu(), "cores": os.cpu_count(),
            "nvidia_smi": smi_line(), "commands": [], "sweeps": {}}
    runs = []
    with open(args.out + ".log", "w") as log:
        planes, tables = _sweep(args, meta, log) if args.planes else ({}, {})
        for i in range(args.smoke_runs):
            out = f"{args.out}.smoke{i}.jsonl"
            with contextlib.suppress(FileNotFoundError):
                os.remove(out)
            rc = _bench_host(["--smoke", "--out", out], log)
            vals = smoke_values(_records(out))
            vals["exit"] = rc
            runs.append(vals)
            print(f"smoke run {i}: " + json.dumps(vals), flush=True)
        versus = compare(args, meta, log) if args.compare_planes else None
    smoke = {"runs": runs,
             "floors": derive_floors([{k: v for k, v in r.items() if k != "exit"}
                                      for r in runs])} if runs else None
    rates = codec_rates()
    int8 = rates["int8"]
    codec_s = 1e-9 / int8["encode_GBps"] + 1e-9 / int8["decode_fold_GBps"]
    planes = {k: dataclasses.replace(v, codec_s_per_b=codec_s)
              for k, v in planes.items()}
    doc = {"schema": "host_wire_model_r2",
           "planes": {k: v.to_dict() for k, v in planes.items()},
           "tables": {k: [[int(mx), int(f)] for mx, f in v]
                      for k, v in tables.items()},
           "meta": meta, "smoke": smoke, "compare": versus, "codec": rates}
    with open(args.out, "w") as fp:
        json.dump(doc, fp, indent=1, sort_keys=True)
    print(f"wrote {args.out} ({meta['host_cpu']}; {meta['nvidia_smi']})")
    print(json.dumps({k: doc[k] for k in ("planes", "tables", "smoke",
                                          "compare", "codec")},
                     sort_keys=True))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
