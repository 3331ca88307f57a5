"""obs — the host-plane flight recorder (the NPKit-of-the-host-stack).

The device plane has :mod:`rocnrdma_tpu_torch.trace` (predicted schedule lanes
diffed against XProf); the host transport plane — bootstrap, verbs,
streaming ring wire, fault injection — had only aggregate counters
(``metrics.WIRE``, ``FaultCounters``). This package is the event-level
half: a per-rank, always-on ring-buffer **flight recorder** with a cheap
``record(kind, **args)`` hot-path call, instrumented at every layer of
the host stack (net-vtable verb entry/completion in ``transport.plugin``,
``_RingWire`` frame lifecycle, bootstrap connect/retry attempts, every
fault ``FaultNet`` injects), plus:

- :func:`postmortem` — dump the last-N events to stderr when something
  hangs (ring-wire stalls, ``monitored_barrier`` triage, the watchdog),
  naming the stalled hop/frame/peer instead of a bare timeout;
- :mod:`rocnrdma_tpu_torch.obs.chrome` — per-rank serialization and a
  multi-rank merger emitting one clock-aligned Chrome-trace JSON
  (Perfetto-loadable), the host twin of ``trace.py``'s device lanes —
  including the ``membership`` track (epoch bumps, heal/grow/promotion
  spans, device-heal restart phases, fleet-health transitions);
- :mod:`rocnrdma_tpu_torch.obs.fleet` — the FLEET telemetry plane: a per-rank
  agent piggybacking windowed counter snapshots onto the liveness
  heartbeat via epoch-qualified store keys, a leader-side aggregator
  merging them (bucket-exact cross-rank verb P50/P99, per-rank health),
  exposed as ``ProcessGroup.fleet_stats()`` and the
  ``python -m rocnrdma_tpu_torch.obs.fleet`` CLI (``--watch`` for live);
- :mod:`rocnrdma_tpu_torch.obs.trace` — causal collective tracing: sampled
  per-op spans over the wire's frame events, assembled cross-rank into
  critical paths with per-rank wall-time attribution ({compute-fold,
  wire, credit-stall, lane-admit, recv-wait}) and a straggler
  scoreboard — ``ProcessGroup.trace_stats()``, the
  ``python -m rocnrdma_tpu_torch.obs.trace`` CLI, and the Perfetto merge's
  ``critical-path`` lane.

``FLIGHT`` is THE process-wide recorder instance (one per rank process,
like ``metrics.WIRE``); producers import it, consumers snapshot it.
"""

from __future__ import annotations

from rocnrdma_tpu_torch.obs.recorder import (  # noqa: F401
    FLIGHT,
    FlightRecorder,
    postmortem,
)
