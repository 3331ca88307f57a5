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
repeat's results, for checking them. ``span``: the ``ProcessSpan`` of a
mesh whose ranks are processes; each repeat then starts after
``timing.fleet_barrier`` (outside the span) and each repeat's time is its
``timing.fleet_max`` over the ranks, as ``timing.time_fn(span=)`` times.
"""

from __future__ import annotations

import math
import time

import torch

from rocnrdma_tpu_torch.bench.timing import agree, fleet_barrier, fleet_max, trimmed_mean


def default_window(topo) -> int:
    """Overlap-window default: 4 on the CPU oracle (the reference's), and
    unbounded (0) on the card."""
    return 4 if topo.is_oracle else 0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed(run, repeats: int, out: list | None, span=None) -> float:
    """Trimmed-mean seconds of ``run()`` (which returns its results and
    waits for them), over ``repeats``."""
    spans = []
    for _ in range(repeats):
        if out is not None:
            out.clear()  # one repeat's results alive at a time
        if span is not None:
            fleet_barrier(span)
        t0 = time.perf_counter()
        results = run()
        spans.append(time.perf_counter() - t0)
        if out is not None:
            out[:] = results
        del results
    if span is not None:
        spans = fleet_max(spans, span)
    return trimmed_mean(spans)


def timed_sequential(thunks, repeats: int, device: torch.device,
                     out: list | None = None, span=None) -> float:
    def run():
        results = []
        for th in thunks:
            results.append(th())
            _sync(device)
        return results
    return timed(run, repeats, out, span)


def timed_overlap(thunks, repeats: int, window: int, device: torch.device,
                  out: list | None = None, span=None) -> float:
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
    return timed(run, repeats, out, span)


def timed_fused(fn, args, repeats: int, device: torch.device,
                out: list | None = None, span=None) -> float:
    """``fn(*args)`` runs the whole step; one synchronize closes it."""
    fn(*args)  # warm
    _sync(device)

    def run():
        results = fn(*args)
        _sync(device)
        return results
    return timed(run, repeats, out, span)


def run_modes(t, modes, replay_mode, plain: list | None, what: str) -> tuple:
    """``({mode: seconds}, {mode: its record's extra})`` of
    ``replay_mode(mode, out)`` (the replay's seconds; ``out`` receives its
    last repeat's results, or is None) in each of ``modes``: the kernels'
    launches on the card and, with ``plain`` (``--check-plain``), the
    results held to it bitwise (``check_plain``) and their max abs error."""
    means, extras = {}, {}
    for mode in modes:
        out = [] if plain is not None else None
        before = launch_counts(t.device)
        means[mode] = replay_mode(mode, out)
        extras[mode] = launched(t.device, before)
        if plain is not None:
            extras[mode]["plain_max_abs_err"] = check_plain(t, out, plain,
                                                            f"{what} {mode}")
        del out
    return means, extras


def check_plain(t, got: list, want: list, what: str) -> float:
    """Hold each result of ``got`` (this process's rows of ``t``'s mesh)
    to ``want`` (the same rows of its kernels' plain versions, flat a rank,
    on the host; each compared on the result's device) bitwise, agreed
    across the fleet: one rank's difference fails every rank, naming it.
    Returns the max abs error."""
    rows = math.prod(t.mesh.local_shape)
    err, worst = None, 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.reshape(rows, -1), w.to(g.device)
        worst = max(worst, float((g.float() - w.float()).abs().max()))
        if err is None and not torch.equal(g, w):
            err = f"{what}: result {i} is not bitwise its kernels' plain versions"
    agree(t.span, err, what)
    return worst


def launch_counts(device: torch.device) -> dict | None:
    """The kernels' launch counts on the card (None on the CPU)."""
    if device.type != "cuda":
        return None
    from rocnrdma_tpu_torch import ops
    return dict(ops.launch_counts())


def launched(device: torch.device, before: dict | None) -> dict:
    """``{"launches": ...}``: the kernel launches since ``before`` (a
    ``launch_counts``), where there were any."""
    if before is None:
        return {}
    now = launch_counts(device)
    ran = {k: now[k] - before[k] for k in now if now[k] > before[k]}
    return {"launches": ran} if ran else {}
