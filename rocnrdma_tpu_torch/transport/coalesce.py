"""Collective coalescing — async verbs and bucketed fused frame streams.

Real training/serving steps issue hundreds of SMALL collectives
(per-parameter gradients, per-layer activations), and small sizes are
where the host wire's latency floors bite hardest (the reference's
first record: a 4-rank tcp allreduce at 1 MiB ran well under its 16 MiB
rate — pure per-op overhead, the classic bucketing win, and the same
reason the
rccl-net plugin world coalesces many ops under one plugin ``isend``).
This module is the coalescer behind the async verb surface
(:meth:`~rocnrdma_tpu_torch.distributed.ChannelHandle.allreduce_async` and
siblings): pending tensors of one ``(lane, verb, dtype, op)`` bucket
are packed into ONE fused frame stream — one header stream, one fold
pass over the concatenated payload, one credit negotiation — and the
callers' :class:`Future`\\ s resolve with per-tensor VIEWS sliced from
the landed fused buffer (zero-copy: the slice-and-reshape of a
contiguous range never copies).

**Bucket identity (retry-as-one-op).** A flushed bucket executes as
exactly ONE collective on its lane: one per-lane committed-op id, one
``obs.trace`` op span (carrying the member-op count), one epoch-fenced
wire stream. The recovery machinery therefore sees the bucket
as a single collective — a mid-bucket death heals the group and
retries the WHOLE bucket bitwise (the fused input is built before the
verb runs and the verb's own input-copy-until-commit contract covers
it), lane credit accounting paces the fused stream like any
other laned post, and critical paths attribute the one fused op.

**Flush triggers.** A bucket flushes when

- *size*: its pending payload reaches ``bucket_bytes`` (the knob
  surfaced on :meth:`~rocnrdma_tpu_torch.distributed.ProcessGroup.channel`,
  tuner-pickable via :func:`transport.tuner.pick_bucket_bytes`);
- *time*: a submit finds the bucket older than ``bucket_timeout_s``
  (opt-in — wall-clock triggers are OFF by default so chaos replays
  stay a pure function of the seed);
- *barrier*: an explicit :meth:`Coalescer.flush` (or a
  :meth:`Future.wait`, which force-flushes the bucket it belongs to).

**Ordering.** One lane is one ordered stream of collectives (the
ChannelHandle mutex serializes fused executions). With one submitting
thread per lane — the intended shape — buckets therefore execute in
submission order on every rank. Concurrent submitters to ONE lane are
under the same contract as concurrent callers of a handle's blocking
verbs always were: the cross-rank submission/flush order is theirs to
make identical (mutex acquisition order is not a cross-rank
agreement). Every rank must submit the SAME sequence of (verb, shape,
dtype, op) per lane between flushes — the usual collective contract,
applied to buckets.

The blocking surface here (``submit``/``flush``/``Future.wait``) is
deadline-disciplined (``timeout_s``, analyzer pass #0) and records
entry/abort flight events on every flush path (pass #4's coalesce
rule): a wedged fused stream must name itself on the timeline.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from rocnrdma_tpu_torch import lockwitness as _lockwitness
from rocnrdma_tpu_torch.metrics import WIRE as _WIRE
from rocnrdma_tpu_torch.obs import FLIGHT as _FLIGHT
from rocnrdma_tpu_torch.obs import trace as _trace

# flush-trigger labels (the per-trigger bucket counters key by these)
TRIGGERS = ("size", "time", "barrier")


def _coalesce_entry(point: str, **ctx) -> float:
    """Record a coalescer flush path's entry event; returns the
    timestamp the completion/abort side measures from (the analyzer's
    coalesce rule pins that every public blocking function here calls
    this on its flush path)."""
    _FLIGHT.record(point, **ctx)
    return time.perf_counter()


def _coalesce_done(point: str, t0: float, **ctx) -> None:
    """Record a flush path's completion with the wall as ``dur``."""
    _FLIGHT.record(point + "-done", dur=time.perf_counter() - t0, **ctx)


def _coalesce_abort(point: str, t0: float, **ctx) -> None:
    """Record a flush path's abort (the record-and-reraise half of the
    analyzer's coalesce rule) with the partial wall as ``dur``."""
    _FLIGHT.record(point + "-abort", dur=time.perf_counter() - t0, **ctx)


class Future:
    """The handle of one submitted async collective. Resolves to the
    same value the blocking verb would have returned — for a fused
    bucket member, a zero-copy VIEW sliced from the landed fused
    buffer. ``wait(timeout_s)`` blocks to resolution (force-flushing
    the owning bucket if it is still pending — the barrier trigger)
    and is idempotent; ``timeout_s`` is MANDATORY (analyzer pass #0:
    the async surface's one blocking point must carry a caller-chosen
    deadline). A future whose bucket FAILED re-raises the bucket's
    error on every wait — the whole bucket is one op, so one member's
    failure is every member's failure."""

    __slots__ = ("_bucket", "_index", "verb")

    def __init__(self, bucket: "_Bucket", index: int, verb: str):
        self._bucket = bucket
        self._index = index
        self.verb = verb

    def done(self) -> bool:
        """True once the owning bucket committed or failed."""
        return self._bucket.event.is_set()

    def wait(self, timeout_s: float):
        """Block until the owning bucket's fused collective resolves;
        returns this member's result (a view of the fused landing
        buffer). Flushes the bucket if no other trigger fired yet.
        ``timeout_s=None`` falls back to the bucket's largest submitted
        deadline, then the group default — the wait is ALWAYS bounded
        (a None reaching the event wait would hang unbounded, the
        exact class pass #0 exists to kill)."""
        b = self._bucket
        if timeout_s is None:
            timeout_s = b.timeout_s
        if timeout_s is None:
            timeout_s = b.coalescer.handle._pg.timeout_s
        if not b.event.is_set():
            t0 = _coalesce_entry("coalesce-wait", verb=self.verb,
                                 lane=b.lane_name, members=len(b.entries))
            try:
                b.coalescer._flush_for(b, timeout_s)
            except BaseException as e:
                _coalesce_abort("coalesce-wait", t0,
                                error=type(e).__name__)
                raise
            _coalesce_done("coalesce-wait", t0, lane=b.lane_name)
        if b.error is not None:
            raise b.error
        return b.results[self._index]


class _Bucket:
    """One pending fused op: the member entries of a single
    ``(verb, dtype, op)`` key on one lane, plus the resolution state
    the members' futures block on. Ownership discipline: a bucket
    lives in the coalescer's pending dict until exactly one thread
    TAKES it (under the coalescer lock); the taker alone runs the
    fused collective and sets the event."""

    __slots__ = ("coalescer", "key", "lane_name", "entries", "shapes",
                 "nbytes", "born", "timeout_s", "event", "results",
                 "error")

    def __init__(self, coalescer: "Coalescer", key: tuple):
        self.coalescer = coalescer
        self.key = key
        self.lane_name = coalescer.lane_name
        self.entries: list[np.ndarray] = []   # flattened member inputs
        self.shapes: list[tuple] = []
        self.nbytes = 0
        self.born = time.monotonic()
        self.timeout_s: float | None = None   # max of submitted deadlines
        self.event = threading.Event()
        self.results: list | None = None
        self.error: BaseException | None = None


class Coalescer:
    """The per-lane coalescer (one per
    :class:`~rocnrdma_tpu_torch.distributed.ChannelHandle` that uses the
    async verbs). ``handle`` supplies the lane context + per-lane
    mutex (its ``_run``) and the group's verbs; ``bucket_bytes`` is
    the size trigger, ``bucket_timeout_s`` the (opt-in) age trigger."""

    def __init__(self, handle, bucket_bytes: int,
                 bucket_timeout_s: float | None = None):
        if bucket_bytes <= 0:
            raise ValueError(f"bucket_bytes must be positive, "
                             f"got {bucket_bytes}")
        self.handle = handle
        self.lane_name = handle.name
        self.bucket_bytes = int(bucket_bytes)
        self.bucket_timeout_s = bucket_timeout_s
        self._lock = _lockwitness.make_lock("coalesce.py::Coalescer._lock")
        self._pending: dict[tuple, _Bucket] = {}

    # -- submission ---------------------------------------------------------

    def submit(self, verb: str, x, op: str = "",
               timeout_s: float | None = None) -> Future:
        """Queue one member op onto its ``(verb, dtype, op)`` bucket;
        returns the member's :class:`Future`. Runs the fused collective
        INLINE (on this thread) when the submit fires the size or age
        trigger — the async surface defers work, it never spawns
        threads (flush order, and with it the chaos replay digest,
        stays a pure function of the submission sequence)."""
        if verb not in _FUSE:
            raise ValueError(f"unknown async verb {verb!r}; "
                             f"know {sorted(_FUSE)}")
        arr = np.asarray(x)
        key = (verb, arr.dtype.str, op)
        with self._lock:
            b = self._pending.get(key)
            if b is None:
                b = self._pending[key] = _Bucket(self, key)
            fut = Future(b, len(b.entries), verb)
            b.entries.append(arr.ravel())
            b.shapes.append(arr.shape)
            b.nbytes += arr.nbytes
            if timeout_s is not None:
                b.timeout_s = (timeout_s if b.timeout_s is None
                               else max(b.timeout_s, timeout_s))
            trigger = None
            if b.nbytes >= self.bucket_bytes:
                trigger = "size"
            elif (self.bucket_timeout_s is not None
                  and time.monotonic() - b.born >= self.bucket_timeout_s):
                trigger = "time"
            if trigger is not None:
                del self._pending[key]
        if trigger is not None:
            t0 = _coalesce_entry("coalesce-flush", trigger=trigger,
                                 verb=verb, lane=self.lane_name,
                                 members=len(b.entries), nbytes=b.nbytes)
            try:
                self._execute(b, trigger, timeout_s)
            except BaseException as e:
                _coalesce_abort("coalesce-flush", t0, trigger=trigger,
                                error=type(e).__name__)
                raise
            _coalesce_done("coalesce-flush", t0, trigger=trigger,
                           lane=self.lane_name)
        return fut

    def pending(self) -> int:
        """Member ops currently queued (across every bucket)."""
        with self._lock:
            return sum(len(b.entries) for b in self._pending.values())

    # -- flushing -----------------------------------------------------------

    def flush(self, timeout_s: float | None = None) -> int:
        """Force-flush every pending bucket of this lane (the barrier
        trigger), in deterministic key order; returns the number of
        buckets flushed (0 = the empty no-op — nothing runs, nothing
        commits). Each bucket is one fused collective bounded by
        ``timeout_s`` (falling back to the largest deadline its
        members submitted, then the group default)."""
        flushed = 0
        while self._pending:
            with self._lock:
                if not self._pending:
                    break
                key = min(self._pending)
                b = self._pending.pop(key)
            t0 = _coalesce_entry("coalesce-flush", trigger="barrier",
                                 verb=key[0], lane=self.lane_name,
                                 members=len(b.entries), nbytes=b.nbytes)
            try:
                self._execute(b, "barrier", timeout_s)
            except BaseException as e:
                _coalesce_abort("coalesce-flush", t0, trigger="barrier",
                                error=type(e).__name__)
                raise
            _coalesce_done("coalesce-flush", t0, trigger="barrier",
                           lane=self.lane_name)
            flushed += 1
        return flushed

    def _flush_for(self, b: _Bucket, timeout_s: float) -> None:
        """:meth:`Future.wait`'s path: take ``b`` if it is still
        pending and run it (the barrier trigger); when another thread
        already took it, wait for that flusher's resolution instead —
        two waiters must never run one bucket twice."""
        with self._lock:
            mine = self._pending.get(b.key) is b
            if mine:
                del self._pending[b.key]
        if mine:
            self._execute(b, "barrier", timeout_s)
        elif not b.event.wait(timeout_s):
            raise TimeoutError(
                f"coalesced {b.key[0]} bucket on lane "
                f"{b.lane_name!r} ({len(b.entries)} member ops) did not "
                f"resolve within {timeout_s}s")

    def _execute(self, b: _Bucket, trigger: str,
                 timeout_s: float | None) -> None:
        """Run one taken bucket as ONE fused collective on the lane
        and resolve its futures (exclusive: the caller holds the only
        reference outside the futures). Commit-side telemetry: the
        member count and fill fraction land on ``metrics.WIRE`` and
        the op's trace span."""
        verb = b.key[0]
        t = timeout_s
        if t is None:
            t = b.timeout_s
        if t is None:
            t = self.handle._pg.timeout_s
        try:
            with _trace.bucket_members(len(b.entries)):
                b.results = _FUSE[verb](self.handle, b, t)
        except BaseException as e:
            b.error = e
            b.event.set()
            raise
        _WIRE.coalesced(members=len(b.entries),
                        fill=b.nbytes / self.bucket_bytes,
                        trigger=trigger)
        b.event.set()


# ---------------------------------------------------------------------------
# The fused executions: one lane collective per bucket, per-member views
# sliced from the landed buffer. Every rank derives the same fused
# layout from the same submission sequence (the collective contract).
# ---------------------------------------------------------------------------


def _fused_allreduce(handle, b: _Bucket, timeout_s: float) -> list:
    op = b.key[2]
    fused = np.concatenate(b.entries) if len(b.entries) > 1 \
        else b.entries[0]
    out = handle.all_reduce(fused, op=op, timeout_s=timeout_s)
    views, off = [], 0
    for shape, e in zip(b.shapes, b.entries):
        views.append(out[off:off + e.size].reshape(shape))
        off += e.size
    return views


def _fused_allgather(handle, b: _Bucket, timeout_s: float) -> list:
    fused = np.concatenate(b.entries) if len(b.entries) > 1 \
        else b.entries[0]
    rows = handle.all_gather(fused, timeout_s=timeout_s)  # (n, total)
    n = rows.shape[0]
    views, off = [], 0
    for shape, e in zip(b.shapes, b.entries):
        # a column range of the row-major (n, total) landing is n
        # contiguous runs — splitting the run axis reshapes as a VIEW
        views.append(rows[:, off:off + e.size].reshape((n,) + shape))
        off += e.size
    return views


def _fused_reduce_scatter(handle, b: _Bucket, timeout_s: float) -> list:
    """Fused reduce-scatter rides the RAGGED verb: the fused buffer is
    packed so each rank's output chunk is the concatenation of every
    member's own floor-balanced shard — member i's future then resolves
    to exactly what ``reduce_scatter(x_i)`` would have returned, and
    the exchange is still one stream with one fold pass."""
    op = b.key[2]
    pg = handle._pg
    n = pg.world_size
    # per-member floor-balanced bounds (the dense verb's layout)
    bounds = [[e.size * r // n for r in range(n + 1)] for e in b.entries]
    chunks = [np.concatenate([e[bd[r]:bd[r + 1]]
                              for e, bd in zip(b.entries, bounds)])
              if len(b.entries) > 1 else b.entries[0][bounds[0][r]:
                                                      bounds[0][r + 1]]
              for r in range(n)]
    counts = np.array([c.size for c in chunks], np.int64)
    fused = np.concatenate(chunks) if n > 1 else chunks[0]
    out = handle._run("reduce_scatter", lambda: pg.reduce_scatter_v(
        fused, counts, op=op, timeout_s=timeout_s))
    views, off = [], 0
    r = pg.rank
    for bd in bounds:
        size = bd[r + 1] - bd[r]
        views.append(out[off:off + size])
        off += size
    return views


_FUSE = {
    "allreduce": _fused_allreduce,
    "allgather": _fused_allgather,
    "reduce_scatter": _fused_reduce_scatter,
}
