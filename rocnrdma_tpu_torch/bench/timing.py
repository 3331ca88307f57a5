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


def _device_of(args) -> torch.device:
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    return torch.device("cpu")


def time_fn(fn, *args, warmup: int = 2, repeats: int = 5,
            calls_per_repeat: int = 10) -> Timing:
    """Time ``fn(*args)`` per the rules above, on the device of the first
    tensor argument."""
    device = _device_of(args)

    def batch(k):
        def run():
            for _ in range(k):
                fn(*args)
        return run

    span_s(batch(max(1, warmup)), device)  # at least one untimed call
    spans = [span_s(batch(calls_per_repeat), device) / calls_per_repeat
             for _ in range(repeats)]
    return Timing(mean_s=trimmed_mean(spans), min_s=min(spans), max_s=max(spans),
                  repeats=repeats, calls_per_repeat=calls_per_repeat)


def marginal_trials(make_chain, x0, k1: int, k2: int, repeats: int,
                    trials: int = 3) -> list[float]:
    """Per-trial marginal seconds per op: ``make_chain(k)`` returns a
    callable running the op k times; each pair's marginal is
    ``(t(k2) - t(k1)) / (k2 - k1)``, which cancels the fixed per-chain
    overhead. The two depths are timed in back-to-back pairs so both sample
    the same state of the machine; per trial the marginal is the median
    over pairs. A trial with no positive marginal contributes the floor
    ``min t(k2) / k2``."""
    f1, f2 = make_chain(k1), make_chain(k2)
    device = _device_of(x0)
    span_s(lambda: f1(*x0), device)  # warm
    span_s(lambda: f2(*x0), device)
    out = []
    t2_min = float("inf")
    for _ in range(trials):
        pair_marginals = []
        for _ in range(repeats):
            t1 = span_s(lambda: f1(*x0), device)
            t2 = span_s(lambda: f2(*x0), device)
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
