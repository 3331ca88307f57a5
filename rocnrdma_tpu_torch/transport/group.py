"""Grouped collectives, the ncclGroupStart/End analogue.

Counterpart of ``rocnrdma_tpu/transport/group.py``. Verbs queued in a
``with t.group()`` block are validated when queued and run when the block
exits, in queue order, on the device's current stream; the group runs one
callable per distinct signature (the verbs, their resolved algorithms and
knobs), cached on the Transport like every other schedule::

    t = Transport(mesh)
    with t.group() as g:
        h1 = g.allreduce(x1)                 # returns a GroupHandle
        h2 = g.reduce_scatter(x2, algo="ring")
        h3 = g.sendrecv(x3, shift=2)
    y1, y2 = h1.result(), h2.result()        # materialised at group exit

Touching ``.result()`` before the block closes raises, as an in-group
call's result is undefined in RCCL until the group ends.
"""

from __future__ import annotations

import torch


class GroupError(RuntimeError):
    pass


class GroupHandle:
    """Deferred result of one queued verb (resolves at group exit)."""

    def __init__(self, group: "Group", index: int):
        self._group = group
        self._index = index

    def result(self) -> torch.Tensor:
        if self._group._results is None:
            raise GroupError(
                "group not executed yet — leave the `with transport.group()` "
                "block before reading results")
        return self._group._results[self._index]


class Group:
    """Queue of collective calls, launched together at ``with``-exit."""

    def __init__(self, transport):
        self._t = transport
        self._calls: list[tuple] = []  # (verb, algo, knobs, input)
        self._results: list[torch.Tensor] | None = None
        self._entered = False

    # -- queueing (mirrors the Transport verb surface) ---------------------

    def _queue(self, verb: str, x, algo: str, **knobs) -> GroupHandle:
        if self._results is not None:
            raise GroupError("group already executed; start a new group()")
        # schedule-specific knobs force their schedule under auto/model,
        # exactly as on the direct verb methods
        algo = self._t._force_algo(algo, **knobs)
        knobs = self._t._normalize_knobs(**knobs)
        resolved = self._t._resolve(algo, verb, self._t._msg_bytes(verb, x))
        # validate the (verb, algo, knobs) combination now, as the direct
        # verbs do at call time, so a bad call cannot poison the batch
        self._t._jit(verb, resolved, **knobs)
        self._calls.append((verb, resolved, tuple(sorted(knobs.items())), x))
        return GroupHandle(self, len(self._calls) - 1)

    def allreduce(self, x, algo: str = "auto", op: str = "sum",
                  acc=None, premul=None, cross_dtype=None, intra_algo=None,
                  chunks=None) -> GroupHandle:
        """Knobs as on ``Transport.allreduce`` (cross_dtype/intra_algo:
        hierarchical; chunks: ptree; each forces its schedule under
        auto)."""
        return self._queue("allreduce", x, algo, op=op, acc=acc,
                           premul=premul, cross_dtype=cross_dtype,
                           intra_algo=intra_algo, chunks=chunks)

    def reduce_scatter(self, x, algo: str = "auto", op: str = "sum",
                       acc=None, premul=None) -> GroupHandle:
        return self._queue("reduce_scatter", x, algo, op=op, acc=acc,
                           premul=premul)

    def allgather(self, x, algo: str = "auto") -> GroupHandle:
        return self._queue("allgather", x, algo)

    def alltoall(self, x, algo: str = "auto") -> GroupHandle:
        return self._queue("alltoall", x, algo)

    # Rooted verbs: ``root=None`` defers to the transport's re-rooting hook
    # (``Transport.root_hint``; 0 when unset), an explicit int pins it.

    def broadcast(self, x, algo: str = "auto",
                  root: int | None = None) -> GroupHandle:
        root = self._t._default_root() if root is None else root
        return self._queue("broadcast", x, algo, root=root)

    def reduce(self, x, algo: str = "auto", root: int | None = None,
               op: str = "sum", acc=None, premul=None) -> GroupHandle:
        root = self._t._default_root() if root is None else root
        return self._queue("reduce", x, algo, root=root, op=op, acc=acc,
                           premul=premul)

    def gather(self, x, algo: str = "auto",
               root: int | None = None) -> GroupHandle:
        root = self._t._default_root() if root is None else root
        return self._queue("gather", x, algo, root=root)

    def scatter(self, x, algo: str = "auto",
                root: int | None = None) -> GroupHandle:
        root = self._t._default_root() if root is None else root
        return self._queue("scatter", x, algo, root=root)

    def sendrecv(self, x, algo: str = "auto", shift: int = 1) -> GroupHandle:
        return self._queue("sendrecv", x, algo, shift=shift)

    # -- context manager ---------------------------------------------------

    def __enter__(self) -> "Group":
        if self._entered:
            raise GroupError("a Group is single-use; start a new group()")
        self._entered = True
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is None:
            self._execute()
        return False

    # -- execution ---------------------------------------------------------

    def _execute(self) -> None:
        if not self._calls:
            self._results = []
            return
        sig = tuple((verb, algo, knobs) for verb, algo, knobs, _ in self._calls)
        fn = self._t._group_fn(sig)
        for verb, algo, _, x in self._calls:
            self._t._count(verb, algo, x)
        self._results = list(fn(*(x for _, _, _, x in self._calls)))
        self._calls.clear()  # drop input references; results carry the data
