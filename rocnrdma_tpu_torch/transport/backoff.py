"""Shared wait/retry discipline for the host planes.

One module owns how this stack waits: the yield-first poll backoff that
every doorbell/completion spin uses (grown out of ``transport.plugin``'s
private ``_Backoff``), the jittered store-poll profile that replaced the
bootstrap client's fixed 10 ms sleeps, and the retry-with-backoff helper
the rendezvous paths use to survive transient refusals (a peer that has
not bound its listener yet, an injected connect refusal from
``transport.faults.FaultNet``, a briefly-dropped store connection).

Two profiles, because the two wait classes want opposite things:

- :class:`Backoff` (default profile) — completion waits on a timeshared
  core: ``sleep(0)`` (sched_yield) for the first ~500 misses so the peer
  process runs NOW, then constant short sleeps so a dead peer doesn't
  burn 100% CPU until the caller's deadline fires.
- :func:`poll_backoff` — store polling over RPCs: start near a
  millisecond and grow geometrically with jitter, so N ranks hammering
  one rendezvous server neither synchronise into thundering herds nor
  add 10 ms of fixed latency to every key publication.

Jitter draws never touch fault-injection determinism: the replayable
schedules in ``transport.faults`` key every decision off their own seeded
streams and local op counts, not wall-clock arrival order.
"""

from __future__ import annotations

import random
import time

from rocnrdma_tpu_torch.obs import FLIGHT as _FLIGHT


class Backoff:
    """Yield-first poll backoff for doorbell/completion waits.

    The peers of a host-plane ring are OS processes very often timesharing
    ONE core (the reference's container had one), so the fastest "wait"
    is to give the core away immediately — ``sleep(0)`` (sched_yield) lets
    the predecessor run NOW instead of after a 0.2 ms timer quantum, which
    the reference measured as a large win on the 16 MiB shm allreduce.
    Only after sustained misses
    fall back to real sleeps so a genuinely dead peer doesn't burn 100%
    CPU until the caller's timeout fires.

    ``growth``/``max_s``/``jitter`` generalise the profile for cheap RPC
    polling (see :func:`poll_backoff`); the defaults reproduce the
    original hot-path behavior exactly (constant 0.2 ms after the yield
    window, no jitter).
    """

    __slots__ = ("misses", "yield_cycles", "max_s", "growth", "jitter",
                 "_cur", "_rng")

    def __init__(self, yield_cycles: int = 500, base_s: float = 0.0002,
                 max_s: float | None = None, growth: float = 1.0,
                 jitter: float = 0.0):
        self.misses = 0
        self.yield_cycles = yield_cycles
        self.max_s = base_s if max_s is None else max_s
        self.growth = growth
        self.jitter = jitter
        self._cur = base_s
        self._rng = random.Random() if jitter else None

    def pause(self) -> None:
        self.misses += 1
        if self.misses <= self.yield_cycles:
            time.sleep(0.0)
            return
        d = self._cur
        if self._rng is not None:
            d *= 1.0 + self.jitter * (2.0 * self._rng.random() - 1.0)
        time.sleep(d)
        self._cur = min(self.max_s, self._cur * self.growth)


def poll_backoff() -> Backoff:
    """The store-poll profile: one immediate yield, then jittered sleeps
    growing ~1 ms -> 20 ms. Replaces the bootstrap client's fixed
    ``time.sleep(0.01)`` loops: faster when the key is about to appear,
    gentler on the server when it is not, and jittered so rank fleets
    don't poll in lockstep."""
    return Backoff(yield_cycles=1, base_s=0.001, max_s=0.02, growth=1.6,
                   jitter=0.3)


def retry_with_backoff(fn, timeout_s: float, what: str,
                       retry_on=(OSError,), backoff: Backoff | None = None):
    """Call ``fn()`` until it returns, retrying ``retry_on`` errors with
    backoff until ``timeout_s`` elapses — then raise ``TimeoutError``
    naming ``what``, the attempt count, and the last underlying error
    (chained). The named-error discipline: a flaky dependency surfaces as
    one clean diagnosis, never as a hang or a bare traceback from the
    Nth retry.

    ``fn`` should bound its own per-attempt blocking (pass it a per-call
    timeout); this helper bounds the overall retry budget.
    """
    deadline = time.monotonic() + timeout_s
    back = backoff if backoff is not None else poll_backoff()
    attempt = 0
    while True:
        attempt += 1
        try:
            return fn()
        except retry_on as e:
            # failure-path only (the happy path records nothing): every
            # absorbed refusal shows on the flight timeline next to the
            # fault that caused it, so a chaos trace reads injection ->
            # absorption instead of silence
            _FLIGHT.record("retry", what=what, attempt=attempt,
                           error=type(e).__name__)
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"{what}: still failing after {timeout_s}s "
                    f"({attempt} attempts): {e!r}") from e
            back.pause()
