"""Schedule event tracing — the NPKit analogue for explicit schedules.

Counterpart of ``rocnrdma_tpu/trace.py``. The explicit schedules are DATA
(``collectives/schedule.py``), so their step structure can be laid out
exactly: which ranks exchange how many bytes at which step, with per-step
durations from the alpha-beta cost model the tuner uses. The output is a
Chrome-trace JSON (load in ``chrome://tracing`` or Perfetto): one row per
rank, one slice per schedule step. The event generators, ``_GENERATORS``,
``schedule_events``, ``to_chrome_trace``, ``measured_to_chrome`` and
``align_steps`` are the reference's, copied.

The measured lane comes from ``torch.profiler``: ``profile_collective``
runs the call once under a capture in which every schedule step opens a
step span (``collectives/_steps.py``), a ``record_function`` whose name
holds ``ppermute``, and ``measured_lanes`` reads the exported Chrome-trace
JSON. On the card a lane is one CUDA stream and a step's measured time is
its span's device time (the ``gpu_user_annotation`` event): the step's row
copies and its fold, where the reference's step is its permute alone. On
the CPU the lane is the host thread's ``user_annotation`` events.

CLI::

    python -m rocnrdma_tpu_torch.trace --collective allreduce --algo dtree \
        --ranks 8 --size 4M --out dtree.trace.json
    python -m rocnrdma_tpu_torch.trace --algo dtree --measured --align-steps \
        --fake-devices 8 --out dtree.trace.json       # on the card
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

from rocnrdma_tpu_torch.collectives import schedule as S
from rocnrdma_tpu_torch.transport.tuner import ALPHA_S, BETA_S_PER_B


@dataclasses.dataclass(frozen=True)
class Event:
    """One rank's participation in one schedule step."""

    name: str       # e.g. "rs step 3: send chunk 5 -> rank 2"
    rank: int
    step: int       # global step index (events with equal step run together)
    nbytes: int     # bytes this rank transmits during the step


def _dur_s(nbytes: int, alpha: float, beta: float) -> float:
    return alpha + nbytes * beta


# --------------------------------------------------------------------------
# Event generation per algorithm (pure; walks the schedule indices)


def ring_events(n: int, nbytes: int, bidir: bool = False) -> list[Event]:
    chunk = nbytes // n
    per_step = chunk // 2 if bidir else chunk
    out = []
    step = 0
    for phase, phase_name in (("rs", "reduce-scatter"), ("ag", "allgather")):
        for k in range(n - 1):
            for r in range(n):
                send = (S.ring_rs_send_chunk(n, k, r) if phase == "rs"
                        else S.ring_ag_send_chunk(n, k, r))
                arrow = "<->" if bidir else "->"
                out.append(Event(
                    f"{phase_name} step {k}: chunk {send} {arrow} rank {(r + 1) % n}",
                    r, step, per_step))
            step += 1
    return out


def hd_events(n: int, nbytes: int) -> list[Event]:
    out = []
    step = 0
    seg = nbytes
    for mask in S.hd_masks(n):  # recursive halving
        seg //= 2
        for r in range(n):
            out.append(Event(f"halving xchg mask {mask}: {seg} B with rank {r ^ mask}",
                             r, step, seg))
        step += 1
    for mask in reversed(S.hd_masks(n)):  # recursive doubling
        for r in range(n):
            out.append(Event(f"doubling xchg mask {mask}: {seg} B with rank {r ^ mask}",
                             r, step, seg))
        seg *= 2
        step += 1
    return out


def dtree_events(n: int, nbytes: int) -> list[Event]:
    half = nbytes // 2
    out = []
    step = 0
    for t, parents in enumerate(S.dbtree_parents(n)):
        up, down = S.dbtree_steps(parents)
        for pairs in up:
            for c, p in pairs:
                out.append(Event(f"tree{t} reduce: rank {c} -> {p}",
                                 c, step, half))
            step += 1
        for pairs in down:
            for p, c in pairs:
                out.append(Event(f"tree{t} bcast: rank {p} -> {c}",
                                 p, step, half))
            step += 1
    return out


def khd_events(n: int, nbytes: int, digits=None, bidir: bool = True,
               itemsize: int = 4, phases=("rs", "ag")) -> list[Event]:
    """Mixed-radix halving-doubling (khd.py). One Event STEP per ppermute
    in the exact order the jit program executes them, so ``align_steps``
    maps a profiled ``algo="khd"`` run 1:1: the registered form is bidir —
    for radix > 2 each (round, offset) substep is TWO permutes (first
    half +o, second half -o); d=2 rounds and 1-element parts stay single.
    ``itemsize``: the buffer's element width — khd.py's split/pad logic
    counts ELEMENTS (ceil-divided chunks; ``part < 2`` gate), so the
    byte-level accounting here must round and gate the same way or the
    step counts diverge at tiny/non-divisible sizes. The split predicate
    mirrors ``khd._split_offset`` exactly (incl. the self-inverse
    ``o = d/2`` offset, which cannot split: +o and -o are the same
    permutation there). ``phases``: subset of ("rs", "ag") — ("rs",)
    traces the standalone ``khd_reduce_scatter`` verb, ("ag",) the
    standalone ``khd_allgather`` (``nbytes`` = the full/gathered buffer
    in both conventions, matching the sweep size key).
    """
    from rocnrdma_tpu_torch.collectives.khd import _split_offset

    digits = tuple(S.khd_digits(n)) if digits is None else tuple(digits)
    out = []
    step = 0
    # one 1/n-th chunk in bytes, ceil-rounded in ELEMENTS like khd.py's pad
    chunk = -(-nbytes // (n * itemsize)) * itemsize

    def substep(t, d, o, frac, direction, tag):
        nonlocal step
        perm = S.khd_perm(n, digits, t, o)
        for r, dst in perm:
            out.append(Event(f"khd {tag} r{t} o{o}{direction}: "
                             f"{frac} B -> rank {dst}", r, step, frac))
        step += 1

    P = 1
    for t, d in enumerate(digits):          # reduce-scatter rounds
        P *= d
        part = (n // P) * chunk
        # the split halves in ELEMENTS exactly like khd.py (h1 =
        # part_elems // 2), then scale to bytes — a byte-level part // 2
        # diverges from the schedule's slice sizes for odd-element parts
        # (a 3-element fp32 part is 4/8 B, not 6/6)
        h1 = (part // itemsize // 2) * itemsize
        if "rs" not in phases:
            continue
        for o in range(1, d):
            if _split_offset(bidir, d, part // itemsize, o):
                substep(t, d, o, h1, "+", "rs")
                substep(t, d, d - o, part - h1, "-", "rs")
            else:
                substep(t, d, o, part, "", "rs")
    for t in range(len(digits) - 1, -1, -1):  # allgather rounds
        d = digits[t]
        part = (n // P) * chunk
        h1 = (part // itemsize // 2) * itemsize
        if "ag" in phases:
            for o in range(1, d):
                if _split_offset(bidir, d, part // itemsize, o):
                    substep(t, d, o, h1, "+", "ag")
                    substep(t, d, d - o, part - h1, "-", "ag")
                else:
                    substep(t, d, o, part, "", "ag")
        P //= d
    return out


def ptree_events(n: int, nbytes: int, chunks: int | None = None,
                 itemsize: int = 4) -> list[Event]:
    """Chunk-pipelined double tree (ptree.py). One Event STEP per ppermute
    in jit execution order (tick -> tree -> side-substep), so a profiled
    ``algo="ptree"`` run aligns 1:1; the pipeline structure — different
    chunk indices in flight at different depths within one tick — is
    visible in the event names. ``chunks`` defaults to ptree.py's
    size-scaled pick for this ``nbytes``; half/chunk sizes round in
    ELEMENTS exactly like ptree.py."""
    if chunks is None:
        from rocnrdma_tpu_torch.collectives.ptree import ptree_auto_chunks
        chunks = ptree_auto_chunks(nbytes // itemsize)
    half = -(-(nbytes // itemsize) // 2)
    csize = -(-half // chunks) * itemsize
    trees = [S.ptree_ticks(p, chunks) for p in S.dbtree_parents(n)]
    out = []
    step = 0
    n_ticks = len(trees[0][0])
    for phase, tag in ((0, "up"), (1, "down")):
        for t in range(n_ticks):
            for ti in (0, 1):
                for sub in trees[ti][phase][t]:
                    for a, b, i in sub:
                        out.append(Event(
                            f"ptree{ti} {tag} tick {t}: chunk {i} "
                            f"rank {a} -> {b}", a, step, csize))
                    step += 1
    return out


def rotation_a2a_events(n: int, nbytes: int) -> list[Event]:
    chunk = nbytes // n
    out = []
    for k in range(1, n):
        for r in range(n):
            out.append(Event(
                f"rotation step {k}: chunk {S.a2a_send_chunk(n, k, r)} -> "
                f"rank {(r + k) % n}", r, k - 1, chunk))
    return out


def bruck_a2a_events(n: int, nbytes: int) -> list[Event]:
    chunk = nbytes // n
    out = []
    for step, k in enumerate(S.bruck_phases(n)):
        moved = len(S.bruck_mask(n, k)) * chunk
        for r in range(n):
            out.append(Event(f"bruck phase {k}: {moved} B -> rank {(r + k) % n}",
                             r, step, moved))
    return out


def binomial_events(n: int, nbytes: int, kind: str, root: int = 0) -> list[Event]:
    out = []
    masks = S.binomial_masks(n)
    steps = list(enumerate(masks)) if kind == "broadcast" else \
        list(enumerate(reversed(masks)))
    for step, m in steps:
        pairs = S.bcast_pairs(n, m, root)
        if kind == "reduce":
            pairs = [(d, s) for s, d in pairs]
        for src, dst in pairs:
            out.append(Event(f"{kind} mask {m}: rank {src} -> {dst}",
                             src, step, nbytes))
    return out


def hierarchical_events(n_slices: int, per_slice: int,
                        nbytes: int) -> list[Event]:
    """Three sequential phases over the ('slice','intra') mesh; within a
    phase, all participating rings run concurrently."""
    out = []
    step = 0
    shard = nbytes // per_slice

    def ranks_of(s, i):
        return s * per_slice + i

    # phase 1: reduce-scatter over intra (per slice), n-1 ring steps
    for k in range(per_slice - 1):
        for s in range(n_slices):
            for i in range(per_slice):
                out.append(Event(f"ici rs step {k} (slice {s})",
                                 ranks_of(s, i), step, shard))
        step += 1
    # phase 2: allreduce of the shard across slices (ring over DCN)
    for k in range(2 * (n_slices - 1)):
        for s in range(n_slices):
            for i in range(per_slice):
                out.append(Event(f"dcn allreduce step {k}",
                                 ranks_of(s, i), step, shard // n_slices))
        step += 1
    # phase 3: allgather over intra
    for k in range(per_slice - 1):
        for s in range(n_slices):
            for i in range(per_slice):
                out.append(Event(f"ici ag step {k} (slice {s})",
                                 ranks_of(s, i), step, shard))
        step += 1
    return out


def hierarchical_a2a_events(n_slices: int, per_slice: int,
                            nbytes: int) -> list[Event]:
    """Two sequential phases of the DCN-light transpose: an intra-slice
    alltoall of destination-intra-index bundles (ICI rings per slice),
    then a cross-slice alltoall between same-index ranks (DCN columns)."""
    out = []
    step = 0
    for k in range(per_slice - 1):     # rotation alltoall over intra
        for s in range(n_slices):
            for i in range(per_slice):
                out.append(Event(f"ici a2a step {k} (slice {s})",
                                 s * per_slice + i, step,
                                 nbytes // per_slice))
        step += 1
    for k in range(n_slices - 1):      # rotation alltoall over slices
        for s in range(n_slices):
            for i in range(per_slice):
                out.append(Event(f"dcn a2a step {k} (column {i})",
                                 s * per_slice + i, step,
                                 nbytes // n_slices))
        step += 1
    return out


_GENERATORS = {
    ("allreduce", "ring"): lambda n, b: ring_events(n, b),
    ("allreduce", "ring_bidir"): lambda n, b: ring_events(n, b, bidir=True),
    ("allreduce", "tree"): hd_events,
    ("allreduce", "khd"): khd_events,
    ("allreduce", "dtree"): dtree_events,
    ("allreduce", "ptree"): ptree_events,
    # the standalone khd phase verbs (reducescatter spelling matches the
    # bench CLI collective names)
    ("reducescatter", "khd"): lambda n, b: khd_events(n, b, phases=("rs",)),
    ("allgather", "khd"): lambda n, b: khd_events(n, b, phases=("ag",)),
    ("alltoall", "ring"): rotation_a2a_events,
    ("alltoall", "bruck"): bruck_a2a_events,
    ("broadcast", "binomial"): lambda n, b: binomial_events(n, b, "broadcast"),
    ("reduce", "binomial"): lambda n, b: binomial_events(n, b, "reduce"),
}


def schedule_events(collective: str, algo: str, n: int, nbytes: int,
                    mesh2d: tuple[int, int] | None = None,
                    digits=None) -> list[Event]:
    """The full event list of one collective call's schedule.

    ``digits``: khd only — the round radices of the dispatch being
    predicted. The production dispatch resolves digits per size via the
    radix-ladder model (``Transport.khd_model_digits``), so aligning a
    capture of it requires pinning the same digits here; the default is
    the radix-8 factorization ``jit_fn(verb, "khd")`` (no knobs) runs."""
    if digits is not None:
        phases = {"allreduce": ("rs", "ag"), "reducescatter": ("rs",),
                  "allgather": ("ag",)}.get(collective)
        if algo != "khd" or phases is None:
            raise ValueError("digits pins the khd radices; use with "
                             "--algo khd and a khd-family collective")
        return khd_events(n, nbytes, digits=digits, phases=phases)
    if algo == "hierarchical":
        if collective not in ("allreduce", "alltoall") or mesh2d is None:
            raise ValueError("hierarchical tracing needs --collective "
                             "allreduce|alltoall and --mesh2d SLICESxPER")
        gen2 = (hierarchical_events if collective == "allreduce"
                else hierarchical_a2a_events)
        return gen2(*mesh2d, nbytes)
    if algo == "khd2d":
        # topology-mapped khd IS mixed-radix khd with digits = the mesh
        # shape — same rounds, substeps, split predicate, and byte sizes;
        # only the permutation carrier (per-axis rotation vs flat-rank
        # digit rotation, the same mapping on flattened ids) differs — so
        # its predicted lane is khd's with the digits pinned
        if collective != "allreduce" or mesh2d is None:
            raise ValueError("khd2d tracing needs --collective allreduce "
                             "and --mesh2d SLICESxPER")
        return khd_events(mesh2d[0] * mesh2d[1], nbytes, digits=mesh2d)
    gen = _GENERATORS.get((collective, algo))
    if gen is None:
        raise ValueError(
            f"no schedule tracer for ({collective}, {algo}); know "
            f"{sorted(_GENERATORS)} + (allreduce|alltoall, 'hierarchical')")
    return gen(n, nbytes)


def to_chrome_trace(events: list[Event], alpha: float = ALPHA_S,
                    beta: float = BETA_S_PER_B) -> dict:
    """Chrome-trace JSON: pid 0, one tid (row) per rank, one complete ("X")
    slice per event. Step k starts when step k-1's LONGEST slice ends (the
    schedule's barrier semantics — every exchange completes before the next
    step)."""
    if not events:
        return {"traceEvents": []}
    n_steps = max(e.step for e in events) + 1
    start_us = [0.0] * (n_steps + 1)
    for s in range(n_steps):
        dur = max((_dur_s(e.nbytes, alpha, beta) for e in events
                   if e.step == s), default=0.0)
        start_us[s + 1] = start_us[s] + dur * 1e6
    trace = []
    for e in sorted(events, key=lambda e: (e.step, e.rank)):
        trace.append({
            "name": e.name, "ph": "X", "pid": 0, "tid": e.rank,
            "ts": round(start_us[e.step], 3),
            "dur": round(_dur_s(e.nbytes, alpha, beta) * 1e6, 3),
            "args": {"bytes": e.nbytes, "step": e.step},
        })
    meta = [{"name": "thread_name", "ph": "M", "pid": 0, "tid": tid,
             "args": {"name": f"rank {tid}"}}
            for tid in sorted({e.rank for e in events})]
    return {"traceEvents": meta + trace,
            "displayTimeUnit": "ms",
            "otherData": {"total_us": round(start_us[-1], 3),
                          "n_steps": n_steps}}


# --------------------------------------------------------------------------
# Measured lane: per-step durations out of a torch.profiler capture (the
# NPKit concept proper — NPKit recorded MEASURED events, the model lane
# above only predicts them)

# substrings of event names that belong to a schedule's data path: the
# step spans, and the ops and kernels a step runs
_MEASURED_OP_HINTS = ("ppermute", "add", "roll", "index", "copy",
                      "elementwise", "reduce", "nccl")

# torch.profiler's Chrome-trace categories: the device's (CUDA kernels,
# copies, and each record_function range's span on the stream) and the
# host's ("python_function" frames are never read: a frame name like
# "add" would false-match the hints)
_DEVICE_CATS = ("gpu_user_annotation", "kernel", "gpu_memcpy", "gpu_memset")
_HOST_CATS = ("user_annotation", "cpu_op")


def measured_lanes(json_path: str, hints=_MEASURED_OP_HINTS,
                   device: bool | None = None) -> list:
    """Parse a Chrome-trace JSON that ``torch.profiler`` exported
    (``prof.export_chrome_trace``) into per-lane events:
    ``[(lane_label, [(name, start_ns, dur_ns), ...]), ...]``, keeping only
    complete events whose name matches ``hints``. A lane is one
    (process, thread) of the trace: a CUDA stream on the card, a host
    thread on the CPU. ``device``: read the device's events (True), the
    host's (False), or the device's when the trace has any (None)."""
    if json_path.endswith(".xplane.pb"):
        raise ValueError(f"{json_path}: an XProf .xplane.pb is the JAX "
                         f"package's capture; the port reads the Chrome-trace "
                         f"JSON that torch.profiler exports")
    with open(json_path) as fp:
        doc = json.load(fp)
    evs = doc["traceEvents"] if isinstance(doc, dict) else doc
    names = {}
    for e in evs:
        if e.get("ph") == "M" and e.get("name") in ("process_name", "thread_name"):
            key = (e.get("pid"), None if e["name"] == "process_name" else e.get("tid"))
            names[key] = str(e.get("args", {}).get("name", ""))
    if device is None:
        device = any(e.get("cat") in _DEVICE_CATS for e in evs)
    cats = _DEVICE_CATS if device else _HOST_CATS
    lanes: dict = {}
    for e in evs:
        if e.get("ph") != "X" or e.get("cat") not in cats:
            continue
        name = str(e.get("name", ""))
        if any(h in name.lower() for h in hints):
            lanes.setdefault((e.get("pid"), e.get("tid")), []).append(
                (name, int(round(float(e["ts"]) * 1e3)),
                 int(round(float(e.get("dur", 0)) * 1e3))))
    out = []
    for (pid, tid), lane in lanes.items():
        lane.sort(key=lambda t: t[1])
        label = (f"{names.get((pid, None)) or f'pid {pid}'}/"
                 f"{names.get((pid, tid)) or f'tid {tid}'}")
        out.append((label, lane))
    return sorted(out)


def measured_to_chrome(lanes: list, pid: int = 1) -> list:
    """Chrome-trace slices for the measured lane (pid 1 next to the
    predicted pid 0), timestamps rebased so the earliest matched event is
    t=0 — which lines the two lanes up for eyeball diffing."""
    if not lanes:
        return []
    t0 = min(ev[1] for _, evs in lanes for ev in evs)
    out = []
    for tid, (label, evs) in enumerate(sorted(lanes)):
        out.append({"name": "thread_name", "ph": "M", "pid": pid,
                    "tid": tid, "args": {"name": f"measured {label}"}})
        for name, start, dur in evs:
            out.append({"name": name, "ph": "X", "pid": pid, "tid": tid,
                        "ts": round((start - t0) / 1e3, 3),
                        "dur": round(dur / 1e3, 3)})
    return out


# op-name substrings identifying the wire step proper (one per ppermute)
_PERMUTE_HINTS = ("ppermute", "collective-permute")


def align_steps(events: list[Event], lanes: list,
                alpha: float = ALPHA_S, beta: float = BETA_S_PER_B) -> tuple:
    """Map measured step spans onto schedule steps — the NPKit diff proper:
    for every lane whose ``ppermute`` event count equals the schedule's
    step count, the k-th ``ppermute`` event IS schedule step k (the port's
    schedules open one step span per step, in program order,
    ``collectives/_steps.py``). Returns ``(chrome_events, diff_rows)``:

    - ``chrome_events``: a pid-2 "aligned" lane with one slice per step at
      the MEASURED start/duration (max across ranks — the schedule's
      barrier semantics), named with the schedule step's own name;
    - ``diff_rows``: per step ``{step, name, predicted_us,
      measured_max_us, measured_mean_us, lanes}`` — the predicted lane's
      alpha-beta duration next to what the profiler recorded.

    Lanes whose permute count differs from the step count are skipped (a
    capture that caught extra calls would misalign);
    if NO lane matches, returns ``([], [])`` and the caller reports it.
    """
    if not events or not lanes:
        return [], []
    n_steps = max(e.step for e in events) + 1
    step_names = {}
    for e in sorted(events, key=lambda e: (e.step, e.rank)):
        step_names.setdefault(e.step, e.name)
    per_lane = []
    for label, evs in lanes:
        pevs = [ev for ev in evs
                if any(h in ev[0].lower() for h in _PERMUTE_HINTS)]
        if len(pevs) == n_steps:
            per_lane.append((label, pevs))
    if not per_lane:
        return [], []
    diff = []
    chrome = [{"name": "thread_name", "ph": "M", "pid": 2, "tid": 0,
               "args": {"name": f"aligned steps ({len(per_lane)} lanes)"}}]
    t0 = min(pevs[0][1] for _, pevs in per_lane)
    for k in range(n_steps):
        pred_us = max((_dur_s(e.nbytes, alpha, beta) for e in events
                       if e.step == k), default=0.0) * 1e6
        durs = [pevs[k][2] for _, pevs in per_lane]
        start = min(pevs[k][1] for _, pevs in per_lane)
        end = max(pevs[k][1] + pevs[k][2] for _, pevs in per_lane)
        diff.append({
            "step": k, "name": step_names.get(k, f"step {k}"),
            "predicted_us": round(pred_us, 3),
            "measured_max_us": round(max(durs) / 1e3, 3),
            "measured_mean_us": round(sum(durs) / len(durs) / 1e3, 3),
            "lanes": len(per_lane),
        })
        chrome.append({
            "name": f"step {k}: {step_names.get(k, '?')}",
            "ph": "X", "pid": 2, "tid": 0,
            "ts": round((start - t0) / 1e3, 3),
            "dur": round((end - start) / 1e3, 3),
            "args": {"predicted_us": round(pred_us, 3),
                     "measured_max_us": round(max(durs) / 1e3, 3)},
        })
    return chrome, diff


def _bitwise_equal(a, b) -> bool:
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    return torch.equal(a.contiguous().view(torch.uint8),
                       b.contiguous().view(torch.uint8))


def profile_collective(collective: str, algo: str, ranks: int,
                       nbytes: int, mesh2d, fake_devices, platform: str,
                       dtype: str = "float32", digits=None,
                       json_out: str | None = None) -> list:
    """Run the collective once on the live backend under a
    ``torch.profiler`` capture and return its measured lanes (the card's
    streams on the GPU, the host thread on the CPU). Shares the bench
    runner's input builder and the Transport's callable, so the profiled
    call is the one the sweeps time. The call runs once before the capture
    (warm-up: caches, kernel builds) and its output there must equal, bit
    for bit, the output under the capture; else this raises. On the card
    the step spans must carry device time; a capture without it raises
    rather than fall back to host time. ``json_out``: keep the exported
    Chrome-trace JSON there (default: a temporary file, removed)."""
    import tempfile

    import torch

    from rocnrdma_tpu_torch.bench.cli_common import build_mesh, setup_backend
    from rocnrdma_tpu_torch.bench.runner import _build_input
    from rocnrdma_tpu_torch.collectives._steps import capturing
    from rocnrdma_tpu_torch.transport import Transport

    topo = setup_backend(fake_devices, platform, ranks)
    mesh = build_mesh("x".join(map(str, mesh2d)) if mesh2d else None,
                      ranks, topo)
    t = Transport(mesh)
    verb = {"reducescatter": "reduce_scatter"}.get(collective, collective)
    x, _, _ = _build_input(t, collective, nbytes, dtype)
    fn = t.jit_fn(verb, algo, **({"digits": tuple(digits)}
                                 if digits is not None else {}))
    on_card = t.device.type == "cuda"
    want = fn(x)  # warm outside the capture
    acts = [torch.profiler.ProfilerActivity.CPU]
    if on_card:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
        torch.cuda.synchronize(t.device)
    with torch.profiler.profile(activities=acts) as prof, capturing():
        got = fn(x)
        if on_card:
            torch.cuda.synchronize(t.device)
    if not _bitwise_equal(got, want):
        raise RuntimeError(f"({collective}, {algo}): the output under the "
                           f"capture differs from the output without it")
    tmp = None
    if json_out is None:
        fd, tmp = tempfile.mkstemp(prefix="rnr_trace_", suffix=".json")
        os.close(fd)
    path = json_out or tmp
    try:
        prof.export_chrome_trace(path)
        lanes = measured_lanes(path, device=on_card)
    finally:
        if tmp is not None:
            os.remove(tmp)
    if on_card and not any("ppermute" in name.lower()
                           for _, evs in lanes for name, _, _ in evs):
        raise RuntimeError(
            f"({collective}, {algo}): the capture holds no device time for "
            f"the step spans (no gpu_user_annotation 'ppermute' event); "
            f"refusing to fall back to host time")
    return lanes


def main(argv=None) -> int:
    from rocnrdma_tpu_torch.bench.runner import parse_size

    p = argparse.ArgumentParser(
        prog="rocnrdma_trace",
        description="Emit a Chrome-trace timeline of an explicit schedule "
                    "(the NPKit analogue; model-predicted durations, plus "
                    "a measured lane from a live torch.profiler capture "
                    "with --measured)")
    p.add_argument("--collective", default="allreduce")
    p.add_argument("--algo", default="ring")
    p.add_argument("--ranks", type=int, default=8)
    p.add_argument("--size", default="4M", help="buffer bytes (e.g. 4M, 64K)")
    p.add_argument("--mesh2d", default=None, metavar="SLICESxPER",
                   help="for --algo hierarchical / khd2d")
    p.add_argument("--alpha", type=float, default=ALPHA_S,
                   help="per-step latency seconds (tuner default)")
    p.add_argument("--beta", type=float, default=BETA_S_PER_B,
                   help="seconds per byte (tuner default)")
    p.add_argument("--out", default=None, help="output path (default stdout)")
    p.add_argument("--measured", action="store_true",
                   help="also run the collective on the live backend under "
                        "a torch.profiler capture and emit a second lane "
                        "(pid 1) with the measured per-event durations")
    p.add_argument("--profile-json", default=None, metavar="PATH",
                   help="with --measured: parse this existing torch.profiler "
                        "Chrome-trace JSON instead of running the collective")
    p.add_argument("--align-steps", action="store_true",
                   help="with --measured: map the capture's step spans onto "
                        "schedule steps (k-th span = step k) and emit a "
                        "pid-2 aligned lane + per-step predicted-vs-measured "
                        "diff rows (the NPKit diff)")
    p.add_argument("--fake-devices", type=int, default=None,
                   help="with --measured: ranks hosted on the one device")
    p.add_argument("--platform", choices=("auto", "cpu"), default="auto")
    p.add_argument("--digits", default=None, metavar="D0,D1,...",
                   help="khd only: pin the round radices to the dispatch "
                        "being predicted (algo='khd' without digits runs "
                        "Transport.khd_model_digits' pick at the size); "
                        "with --measured the live run dispatches these "
                        "digits too, so the lanes align")
    args = p.parse_args(argv)

    mesh2d = None
    if args.mesh2d:
        s, per = args.mesh2d.lower().split("x")
        mesh2d = (int(s), int(per))
        args.ranks = mesh2d[0] * mesh2d[1]
    digits = (tuple(int(d) for d in args.digits.split(","))
              if args.digits else None)
    events = schedule_events(args.collective, args.algo, args.ranks,
                             parse_size(args.size), mesh2d, digits=digits)
    doc = to_chrome_trace(events, args.alpha, args.beta)
    doc["otherData"]["config"] = {
        "collective": args.collective, "algo": args.algo, "ranks": args.ranks,
        "size_bytes": parse_size(args.size), "mesh2d": mesh2d,
        "digits": list(digits) if digits else None}

    measured_note = ""
    if args.measured:
        if args.profile_json:
            lanes = measured_lanes(args.profile_json)
        else:
            from rocnrdma_tpu_torch import hw
            from rocnrdma_tpu_torch.runtime import detect_topology
            lanes = profile_collective(args.collective, args.algo, args.ranks,
                                       parse_size(args.size), mesh2d,
                                       args.fake_devices, args.platform,
                                       digits=digits)
            topo = detect_topology(args.platform)
            doc["otherData"]["device"] = topo.device_name
            if topo.platform == "gpu":
                doc["otherData"]["nvidia_smi"] = hw.smi_line()
            # profile_collective raised otherwise
            doc["otherData"]["capture_bitwise_equal"] = True
        if not lanes:
            raise SystemExit(
                "--measured: no schedule-data-path events matched in the "
                "capture (try a bigger --size, or check the trace JSON)")
        doc["traceEvents"] += measured_to_chrome(lanes)
        n_ev = sum(len(evs) for _, evs in lanes)
        meas_us = max(ev[1] + ev[2] for _, evs in lanes for ev in evs)
        meas_us = (meas_us - min(ev[1] for _, evs in lanes for ev in evs)) / 1e3
        doc["otherData"]["measured_us"] = round(meas_us, 3)
        doc["otherData"]["measured_events"] = n_ev
        measured_note = (f"; measured lane: {n_ev} events across "
                         f"{len(lanes)} lanes, {meas_us:.0f} us")
        if args.align_steps:
            aligned, diff = align_steps(events, lanes, args.alpha, args.beta)
            if not diff:
                counts = {label: sum(any(h in ev[0].lower() for h in _PERMUTE_HINTS)
                                     for ev in evs) for label, evs in lanes}
                raise SystemExit(
                    "--align-steps: no lane's step-span count matches the "
                    "schedule's step count (the capture caught extra calls, "
                    "or the schedule opens no spans) — cannot align; "
                    f"the schedule has {max(e.step for e in events) + 1} "
                    f"steps, the lanes' step spans: {counts}")
            doc["traceEvents"] += aligned
            doc["otherData"]["step_diff"] = diff
            tot_meas = sum(r["measured_max_us"] for r in diff)
            tot_pred = sum(r["predicted_us"] for r in diff)
            measured_note += (
                f"; aligned {len(diff)} steps across {diff[0]['lanes']} "
                f"lanes: predicted {tot_pred:.0f} us vs measured "
                f"{tot_meas:.0f} us (x{tot_meas / max(tot_pred, 1e-9):.1f})")
    elif args.align_steps:
        raise SystemExit("--align-steps requires --measured")

    payload = json.dumps(doc)
    if args.out:
        with open(args.out, "w") as fp:
            fp.write(payload)
        print(f"# {len(events)} events, {doc['otherData']['n_steps']} steps, "
              f"predicted {doc['otherData']['total_us']:.0f} us"
              f"{measured_note} -> {args.out}", file=sys.stderr)
    else:
        print(payload)
    return 0


if __name__ == "__main__":
    sys.exit(main())
