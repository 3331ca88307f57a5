"""Timing discipline.

- warm-up calls run (and finish) before any timer starts;
- a repeat is ``calls_per_repeat`` back-to-back calls closed by ONE
  barrier, so host dispatch pipelines with device work instead of being
  billed per call;
- the reported number is a trimmed mean over repeats (drop the fastest
  and slowest repeat).

On the GPU a span is the device time between two ``torch.cuda.Event``s
recorded on the current stream around the calls, read after
``torch.cuda.synchronize()``; when the host cannot keep the card fed, the
span includes the card's idle time, which is what a caller waits. On the
CPU a span is ``time.perf_counter``.

Across processes (``span=``, the ``ProcessSpan`` of a mesh whose leading
axis spans processes), each span opens after a barrier on the span's
cross group, outside the timed window, and each span's time is the
maximum over the ranks: one ``all_reduce`` MAX of every span after the
last one, so every rank reports the same numbers. nccl-tests averages
over ranks by default; the maximum is kept here because a collective is
done only when its slowest rank is, and that is what the job waits.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch


@dataclasses.dataclass
class Timing:
    mean_s: float          # trimmed-mean seconds per call
    min_s: float
    max_s: float
    repeats: int
    calls_per_repeat: int


def trimmed_mean(xs: list[float]) -> float:
    if len(xs) > 2:
        xs = sorted(xs)[1:-1]
    return sum(xs) / len(xs)


def span_s(fn, device: torch.device) -> float:
    """Seconds ``fn()`` takes on ``device``, closed by a barrier."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def _fleet_device(span) -> torch.device:
    """Where a tensor on the span's cross group lives: the card for NCCL,
    else the host."""
    if span.backend == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def fleet_barrier(span) -> None:
    """Every rank of ``span`` has reached this point: an ``all_reduce`` of
    one element on its cross group, finished before the return."""
    t = torch.zeros(1, device=_fleet_device(span))
    torch.distributed.all_reduce(t, group=span.cross_group)
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def _fleet_reduce(values: list, span, op) -> list:
    t = torch.tensor([float(v) for v in values], dtype=torch.float64,
                     device=_fleet_device(span))
    torch.distributed.all_reduce(t, op=op, group=span.cross_group)
    return t.cpu().tolist()


def fleet_max(values: list, span) -> list:
    """Each of ``values`` (the same count on every rank) as its maximum
    over the ranks of ``span``: one ``all_reduce`` MAX on its cross group."""
    return _fleet_reduce(values, span, torch.distributed.ReduceOp.MAX)


def fleet_sum(values: list, span) -> list:
    """Each of ``values`` (the same count on every rank) as its sum over
    the ranks of ``span``: one ``all_reduce`` SUM on its cross group."""
    return _fleet_reduce(values, span, torch.distributed.ReduceOp.SUM)


def failed_ranks(failed: bool, span) -> list:
    """The ranks of ``span`` where ``failed`` holds, the same list on every
    rank: one ``fleet_max`` of a flag a rank, so a fleet agrees a step's
    outcome before it moves on."""
    flags = fleet_max([float(failed and i == span.index) for i in range(span.size)],
                      span)
    return [span.peers[i] for i, f in enumerate(flags) if f]


def agree(span, err: str | None, what: str) -> None:
    """Raise on every rank of ``span`` when any rank's check failed
    (``err``: this rank's failure, or None), naming the ranks that failed
    (``failed_ranks``). Without a span, raise ``err`` itself."""
    if span is None:
        if err is not None:
            raise AssertionError(err)
        return
    bad = failed_ranks(err is not None, span)
    if bad:
        raise AssertionError(
            f"{what}: the check failed on rank(s) {bad} of {span.size}"
            + (f"; here: {err}" if err else ""))


def _device_of(args) -> torch.device:
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    return torch.device("cpu")


def time_fn(fn, *args, warmup: int = 2, repeats: int = 5,
            calls_per_repeat: int = 10, span=None) -> Timing:
    """Time ``fn(*args)`` per the rules above, on the device of the first
    tensor argument; across the processes of ``span`` when given."""
    device = _device_of(args)

    def batch(k):
        def run():
            for _ in range(k):
                fn(*args)
        return run

    span_s(batch(max(1, warmup)), device)  # at least one untimed call
    spans = []
    for _ in range(repeats):
        if span is not None:
            fleet_barrier(span)
        spans.append(span_s(batch(calls_per_repeat), device) / calls_per_repeat)
    if span is not None:
        spans = fleet_max(spans, span)
    return Timing(mean_s=trimmed_mean(spans), min_s=min(spans), max_s=max(spans),
                  repeats=repeats, calls_per_repeat=calls_per_repeat)


def marginal_trials(make_chain, x0, k1: int, k2: int, repeats: int,
                    trials: int = 3, span=None) -> list[float]:
    """Per-trial marginal seconds per op: ``make_chain(k)`` returns a
    callable running the op k times; each pair's marginal is
    ``(t(k2) - t(k1)) / (k2 - k1)``, which cancels the fixed per-chain
    overhead. The two depths are timed in back-to-back pairs so both sample
    the same state of the machine; per trial the marginal is the median
    over pairs. A trial with no positive marginal contributes the floor
    ``min t(k2) / k2``. Across the processes of ``span`` each chain's time
    is the maximum over the ranks, as in ``time_fn``."""
    f1, f2 = make_chain(k1), make_chain(k2)
    device = _device_of(x0)
    span_s(lambda: f1(*x0), device)  # warm
    span_s(lambda: f2(*x0), device)
    spans = []
    for _ in range(trials * repeats):
        for f in (f1, f2):
            if span is not None:
                fleet_barrier(span)
            spans.append(span_s(lambda: f(*x0), device))
    if span is not None:
        spans = fleet_max(spans, span)
    pairs = iter(zip(spans[::2], spans[1::2]))
    out = []
    t2_min = float("inf")
    for _ in range(trials):
        pair_marginals = []
        for _ in range(repeats):
            t1, t2 = next(pairs)
            t2_min = min(t2_min, t2)
            m = (t2 - t1) / (k2 - k1)
            if m > 0:
                pair_marginals.append(m)
        out.append(float(np.median(pair_marginals)) if pair_marginals
                   else float("inf"))
    return [t2_min / k2 if not np.isfinite(v) else v for v in out]


def marginal_s_per_op(make_chain, x0, k1: int, k2: int, repeats: int,
                      trials: int = 3) -> float:
    """Min-over-trials marginal: the fastest state the card demonstrated."""
    return min(marginal_trials(make_chain, x0, k1, k2, repeats, trials))


def enqueue_s(fn, calls: int) -> float:
    """Host seconds per call to enqueue ``fn()`` on the card, with no
    synchronisation between the calls."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls


def device_s(fn, calls: int, enqueue: float) -> float:
    """Device seconds per call of ``fn()`` with the host out of the way: the
    calls are enqueued behind a kernel that spins for about three times
    their enqueue time (``enqueue`` seconds a call, at ~2e9 cycles/s), so
    the events around them time the card's work back to back."""
    torch.cuda.synchronize()
    torch.cuda._sleep(int(3 * enqueue * calls * 2e9) + 10**6)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 1e3 / calls
