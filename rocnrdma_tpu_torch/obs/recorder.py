"""The flight recorder proper: a lock-disciplined event ring buffer.

Design constraints, in order:

1. **Cheap enough to stay ON** under the ``bench_host --smoke`` tier-1
   perf gate: ``record()`` is one ``perf_counter`` read, one short
   critical section, and one tuple store into a preallocated list — no
   allocation proportional to history, no formatting, no I/O. Events are
   only rendered when something asks (a postmortem, a Chrome dump).
2. **Lock-disciplined** (the ``tools/analyze/races.py`` discipline):
   every touch of the shared ring state — producers on any thread
   (progress hooks run from watchdog-adjacent contexts), consumers at
   dump time — holds the recorder's one ``_lock``. "Bumped under the
   GIL" is an accident, not a contract.
3. **Bounded**: a fixed-capacity ring (default 4096 events, env
   ``ROCNRDMA_FLIGHT_EVENTS``) so an always-on recorder can never grow a
   long soak's memory; wraparound drops the OLDEST events, which is what
   a postmortem wants anyway (the last N are the story).

Event shape: ``(t, kind, args)`` — ``t`` is ``time.perf_counter()`` (the
same clock the latency histograms use), ``kind`` a short dash-separated
string (``isend-post``, ``frame-landed``, ``fault-comm-dead``, ...),
``args`` the keyword dict the producer passed. Producers keep ``args``
values to ints/strings so any event serializes.

Cross-rank clock alignment: host-plane ranks are OS processes with
independent ``perf_counter`` origins, so :meth:`FlightRecorder.mark_sync`
stamps a named sync point — the bootstrap ring records one right after
its ``wired`` store barrier, which every rank exits within one store
poll interval — and the Chrome merger shifts each rank's timeline so the
sync points coincide (see ``obs.chrome``).
"""

from __future__ import annotations

import os
import sys
import threading
import time

from rocnrdma_tpu_torch import lockwitness as _lockwitness


class FlightRecorder:
    """Fixed-capacity event ring with a cheap thread-safe ``record``."""

    def __init__(self, capacity: int = 4096, enabled: bool = True):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.enabled = enabled
        self._lock = _lockwitness.make_lock(
            "recorder.py::FlightRecorder._lock")
        self._buf: list = [None] * capacity
        self._head = 0        # next write slot
        self._recorded = 0    # lifetime event count (wraps never reset it)
        self._saturated = False  # the ring wrapped: oldest events evicted
        self._sync_ts: float | None = None

    # -- hot path ----------------------------------------------------------

    def record(self, kind: str, **args) -> None:
        """Append one event. THE hot-path call: safe from any thread, no
        allocation beyond the event tuple/dict, a few hundred ns."""
        if not self.enabled:
            return
        t = time.perf_counter()
        with self._lock:
            self._buf[self._head] = (t, kind, args)
            self._head = (self._head + 1) % self.capacity
            self._recorded += 1
            if not self._saturated and self._recorded > self.capacity:
                # first eviction: the ring is now dropping its oldest
                # events — marked ONCE so a digest-bearing chaos run
                # can warn (RINGFULL) instead of silently losing
                # replay-relevant history, and durable in `saturated`
                # (the marker event itself can later be evicted; it is
                # meta, so it does not count toward the lifetime total)
                self._saturated = True
                self._buf[self._head] = (t, "flight-ring-saturated",
                                         {"capacity": self.capacity})
                self._head = (self._head + 1) % self.capacity

    # -- sync / introspection ---------------------------------------------

    def mark_sync(self, **args) -> float:
        """Stamp the cross-rank clock-sync point (recorded as a
        ``clock-sync`` event too, so it shows on the timeline). The LAST
        mark wins — re-wired groups re-sync."""
        t = time.perf_counter()
        with self._lock:
            self._sync_ts = t
            if self.enabled:
                self._buf[self._head] = (t, "clock-sync", args)
                self._head = (self._head + 1) % self.capacity
                self._recorded += 1
        return t

    @property
    def sync_ts(self) -> float | None:
        with self._lock:
            return self._sync_ts

    @property
    def saturated(self) -> bool:
        """True once the ring has wrapped (oldest events evicted) —
        the capacity guard a digest-bearing chaos run checks before
        trusting the buffered history."""
        with self._lock:
            return self._saturated

    def recorded(self) -> int:
        """Lifetime events recorded (NOT capped by capacity)."""
        with self._lock:
            return self._recorded

    def events(self) -> list:
        """The buffered events, oldest first (at most ``capacity``)."""
        with self._lock:
            if self._recorded < self.capacity:
                return [e for e in self._buf[:self._head]]
            return ([e for e in self._buf[self._head:]]
                    + [e for e in self._buf[:self._head]])

    def tail(self, n: int) -> list:
        """The last ``n`` events, oldest first (empty for n <= 0 —
        ``ev[-0:]`` would be the WHOLE buffer)."""
        if n <= 0:
            return []
        ev = self.events()
        return ev[-n:] if n < len(ev) else ev

    def reset(self) -> None:
        with self._lock:
            self._buf = [None] * self.capacity
            self._head = 0
            self._recorded = 0
            self._saturated = False
            self._sync_ts = None


def _from_env() -> FlightRecorder:
    # this runs at import time underneath the whole transport stack: a
    # typo'd env var must degrade to the default, never crash the import
    try:
        cap = int(os.environ.get("ROCNRDMA_FLIGHT_EVENTS", "4096"))
    except ValueError:
        print("obs: ignoring malformed ROCNRDMA_FLIGHT_EVENTS="
              f"{os.environ['ROCNRDMA_FLIGHT_EVENTS']!r} (want an int); "
              "using 4096", file=sys.stderr)
        cap = 4096
    enabled = os.environ.get("ROCNRDMA_FLIGHT", "1") != "0"
    return FlightRecorder(capacity=max(1, cap), enabled=enabled)


# THE process-wide recorder (one per rank process — host-plane ranks are
# OS processes, like metrics.WIRE/FaultCounters). Always on unless
# ROCNRDMA_FLIGHT=0; capacity via ROCNRDMA_FLIGHT_EVENTS.
FLIGHT = _from_env()


def postmortem(reason: str, last_n: int = 64, out=None,
               recorder: FlightRecorder | None = None) -> str:
    """Dump the recorder's last ``last_n`` events to ``out`` (default
    stderr) with ``reason`` in the header — the hang postmortem. Callers
    are the stall paths that already KNOW something is wrong (a ring-wire
    frame wait timed out, ``monitored_barrier`` triaged a dead rank, the
    watchdog fired), so the dump is the wire-level story leading up to
    it: which hop/frame/verb the time went to, what was injected, what
    never completed. Returns the rendered text (tests assert on it).

    Timestamps print relative to the dump (``-0.004512s`` = 4.5 ms before
    the postmortem) — absolute perf_counter origins mean nothing to a
    reader."""
    rec = FLIGHT if recorder is None else recorder
    now = time.perf_counter()
    events = rec.tail(last_n)
    lines = [f"=== FLIGHT POSTMORTEM pid={os.getpid()} reason: {reason} ==="]
    for t, kind, args in events:
        kv = " ".join(f"{k}={v}" for k, v in args.items())
        lines.append(f"  {t - now:+12.6f}s {kind}" + (f" {kv}" if kv else ""))
    lines.append(f"=== end postmortem ({len(events)} of "
                 f"{rec.recorded()} recorded events) ===")
    text = "\n".join(lines)
    print(text, file=sys.stderr if out is None else out, flush=True)
    return text
