"""Step spans: one named profiler range per schedule step.

In the reference every step of an explicit schedule is one
``lax.ppermute``, so a profile's k-th permute op is step k
(``trace.align_steps``). The port's schedules move rows with tensor
indexing and have no such op, so each step that ``trace.py`` has a
generator for runs inside ``step_span(name)``: a
``torch.profiler.record_function`` range whose name holds ``ppermute``,
which the reference's match rules find. On the card the profiler also
records the range's device time (a ``gpu_user_annotation`` event).

A span costs nothing unless a capture asked for it: ``step_span`` opens a
range only inside ``capturing()`` (which ``trace.profile_collective``
enters), and is a no-op context otherwise, so the host-bound schedules pay
no profiler call per step. ktree shares dtree's level helpers and so names
its steps too; ``trace.py`` has no generator for it and never captures it.
"""

from __future__ import annotations

import contextlib

import torch

_CAPTURING = False


@contextlib.contextmanager
def capturing():
    """Open step spans for the calls made inside this context."""
    global _CAPTURING
    prev, _CAPTURING = _CAPTURING, True
    try:
        yield
    finally:
        _CAPTURING = prev


def step_span(name: str):
    """The context one schedule step runs in: ``record_function("ppermute
    <name>")`` while capturing, else a no-op."""
    if not _CAPTURING:
        return contextlib.nullcontext()
    return torch.profiler.record_function(f"ppermute {name}")
