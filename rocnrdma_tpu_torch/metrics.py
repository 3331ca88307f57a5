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

import dataclasses
import json
import time
from typing import IO

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
