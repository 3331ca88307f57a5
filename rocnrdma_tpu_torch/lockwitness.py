"""Runtime lock witness — observed acquisition order vs. the static graph.

The analyzer's ``locks`` pass (pass #6) builds the package's lock-
acquisition-order graph STATICALLY. A static graph is only as good as
its call-graph approximation, so this module is its runtime cross-check:
with ``ROCNRDMA_LOCK_WITNESS=1`` every lock built through
:func:`make_lock`/:func:`make_rlock` is wrapped to record, per thread,
which witnessed locks were already held at each successful acquire. The
witness test (``tests/test_lock_witness.py``) drives the tier-1
concurrency scenarios and diffs: an edge observed at runtime but absent
from the static graph is a PASS bug (the analyzer's closure missed a
real code path), not a code bug — the contract fails either way.

Witness names are the static pass's node ids
(``<module>::<Class>.<attr>`` / ``<module>::<GLOBAL>``), assigned at the
construction site, so the diff needs no name translation.

Disabled (the default), the factories return plain ``threading`` locks —
zero overhead, zero behaviour change. Enabled, each acquire costs one
thread-local list push and, for a first-time edge, one set insert under
the witness's own (unwitnessed, terminal) lock.

Cross-process runs (the chaos workers) set ``ROCNRDMA_LOCK_WITNESS_OUT``
to a directory: each process dumps its observed edges to
``lockwitness-<pid>.json`` at interpreter exit (killed-by-SIGKILL ranks
dump nothing; the survivors' files carry the scenario's edges).

Stdlib-only on purpose: the pure host-plane modules (bootstrap, plugin,
faults, the native QPs) import this and must stay importable without
pulling torch into the process.
"""

from __future__ import annotations

import atexit
import json
import os
import threading

_ENABLED = os.environ.get("ROCNRDMA_LOCK_WITNESS", "") == "1"
_OUT_DIR = os.environ.get("ROCNRDMA_LOCK_WITNESS_OUT", "")

_edges: set = set()          # (held_name, acquired_name)
_edges_lock = threading.Lock()  # terminal: guards _edges, never witnessed
_held = threading.local()       # per-thread stack of held witness names


def enabled() -> bool:
    return _ENABLED


def enable(on: bool) -> None:
    """Test hook: flip the witness for locks constructed AFTER this call
    (already-built plain locks stay plain — the witness only ever speaks
    about locks it wrapped)."""
    global _ENABLED
    _ENABLED = bool(on)


def edges() -> set:
    """Snapshot of the observed acquisition-order edges."""
    with _edges_lock:
        return set(_edges)


def reset() -> None:
    with _edges_lock:
        _edges.clear()


def _stack() -> list:
    st = getattr(_held, "stack", None)
    if st is None:
        st = _held.stack = []
    return st


class _WitnessLock:
    """A named lock recording who was held when it was taken. Mirrors the
    ``threading.Lock``/``RLock`` surface the repo uses (context manager,
    ``acquire(blocking=, timeout=)``, ``release``, ``locked``)."""

    __slots__ = ("name", "_inner")

    def __init__(self, name: str, inner):
        self.name = name
        self._inner = inner

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            st = _stack()
            if st:
                new = {(h, self.name) for h in st if h != self.name}
                if new:
                    with _edges_lock:
                        _edges.update(new)
            st.append(self.name)
        return ok

    def release(self) -> None:
        self._inner.release()
        st = _stack()
        # pop the most recent matching entry — release order may
        # interleave for explicitly paired acquire/release sites
        for i in range(len(st) - 1, -1, -1):
            if st[i] == self.name:
                del st[i]
                break

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False

    def __repr__(self) -> str:
        return f"<witnessed {self._inner!r} name={self.name!r}>"


def make_lock(name: str):
    """A ``threading.Lock`` (or its witnessed wrapper), named with the
    static pass's node id for this construction site."""
    if not _ENABLED:
        return threading.Lock()
    return _WitnessLock(name, threading.Lock())


def make_rlock(name: str):
    if not _ENABLED:
        return threading.RLock()
    return _WitnessLock(name, threading.RLock())


def dump(path: str | None = None) -> str | None:
    """Write this process's observed edges as JSON; returns the path (or
    None when there is nowhere to write). Called automatically at exit
    when ``ROCNRDMA_LOCK_WITNESS_OUT`` names a directory."""
    out_dir = _OUT_DIR
    if path is None:
        if not out_dir:
            return None
        path = os.path.join(out_dir, f"lockwitness-{os.getpid()}.json")
    with _edges_lock:
        data = sorted([a, b] for a, b in _edges)
    with open(path, "w") as fp:
        json.dump({"pid": os.getpid(), "edges": data}, fp)
    return path


def load_dumps(out_dir: str) -> set:
    """Union of the edges every process dumped into ``out_dir``."""
    got: set = set()
    for f in sorted(os.listdir(out_dir)):
        if f.startswith("lockwitness-") and f.endswith(".json"):
            with open(os.path.join(out_dir, f)) as fp:
                got.update((a, b) for a, b in json.load(fp)["edges"])
    return got


if _ENABLED and _OUT_DIR:
    atexit.register(dump)
