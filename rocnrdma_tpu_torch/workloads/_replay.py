"""Shared replay-timing scaffold for the trace workloads (ddp/fsdp).

Counterpart of ``rocnrdma_tpu/workloads/_replay.py``. Three timing
disciplines over a step's collective sequence, each a host-clock span
closed by ``torch.cuda.synchronize(device)`` (on the CPU every call is
synchronous):

- ``timed_sequential``: synchronize after every issue (zero overlap; the
  lower bound).
- ``timed_overlap``: issue without waiting, with a bounded window: one
  CUDA event is recorded after each issue, and after issue i the host waits
  on issue i - window + 1's event, so at most ``window - 1`` issues are in
  flight while the next is enqueued, as the reference's pending list
  bounds them. ``window=0``: unbounded.
- ``timed_fused``: the whole step in ONE Python function over every bucket
  with one synchronize at the end. The reference compiles it as one jit
  program; the port does not capture it as a CUDA graph, because the
  kernels' barrier epoch is a host-side launch argument
  (``ops/ring_cuda.py``, ``ops/alltoall_cuda.py``): a replayed graph would
  launch one epoch again and its barriers would pass early.

All three issue on one stream, so the card runs the collectives in issue
order in every mode: the modes differ only by the host's waits, which is
what they measure here (how much the host's synchronisation costs a step),
not comm/compute overlap.

Each returns the trimmed-mean seconds per step; callers warm every
distinct (verb, shape) pair first. ``out``: a list that receives the last
repeat's results, for checking them.
"""

from __future__ import annotations

import time

import torch

from rocnrdma_tpu_torch.bench.timing import trimmed_mean


def default_window(topo) -> int:
    """Overlap-window default: 4 on the CPU oracle (the reference's), and
    unbounded (0) on the card."""
    return 4 if topo.is_oracle else 0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(run, repeats: int, out: list | None) -> float:
    spans = []
    for _ in range(repeats):
        if out is not None:
            out.clear()  # one repeat's results alive at a time
        t0 = time.perf_counter()
        results = run()
        spans.append(time.perf_counter() - t0)
        if out is not None:
            out[:] = results
        del results
    return trimmed_mean(spans)


def timed_sequential(thunks, repeats: int, device: torch.device,
                     out: list | None = None) -> float:
    def run():
        results = []
        for th in thunks:
            results.append(th())
            _sync(device)
        return results
    return _timed(run, repeats, out)


def timed_overlap(thunks, repeats: int, window: int, device: torch.device,
                  out: list | None = None) -> float:
    on_card = device.type == "cuda"

    def run():
        results, events = [], []
        for i, th in enumerate(thunks):
            results.append(th())
            if on_card:
                ev = torch.cuda.Event()
                ev.record()
                events.append(ev)
                if window and i + 1 >= window:
                    events[i + 1 - window].synchronize()
        _sync(device)
        return results
    return _timed(run, repeats, out)


def timed_fused(fn, args, repeats: int, device: torch.device,
                out: list | None = None) -> float:
    """``fn(*args)`` runs the whole step; one synchronize closes it."""
    fn(*args)  # warm
    _sync(device)

    def run():
        results = fn(*args)
        _sync(device)
        return results
    return _timed(run, repeats, out)
