"""Bootstrap rendezvous store — the NCCL-bootstrap / TCPStore analogue.

The reference's plugin era begins with an out-of-band handle exchange: every
rank publishes its listen handle and learns its peers' before any queue pair
exists. RCCL does this over a bootstrap TCP ring seeded by a root address;
torch does it with TCPStore. This module is that piece for the host planes
here: a tiny key-value store served by rank 0 over the native TCP queue
pairs, so N processes that share ONE ``"host:port"`` string can wire any
topology — no filesystem, no shared memory, exactly what crossing real
hosts requires.

Protocol: length-framed JSON requests over a ``TcpQueuePair``, strict
request→reply lockstep per client. Ops: ``set`` / ``get`` (non-blocking;
client polls) / ``barrier_arrive`` + ``barrier_done`` / ``live`` / ``bye``.
Every request carries the client's ``rank``; the server keeps a last-seen
stamp per rank (the passive liveness table ``live`` reads back), and
barrier arrival is keyed by rank — idempotent, so a client that retries an
RPC over a dropped connection can never double-count a barrier.

Failure model: the client survives transient connection drops by
reconnecting with jittered backoff and replaying the request (safe: every
op is idempotent per rank). A reply that never comes surfaces as a named
``TimeoutError`` bounded by the caller's deadline — polls never hang.

Usage::

    srv = BootstrapServer(n_ranks=4)          # rank 0 (or a sidecar)
    # share srv.handle out of band (argv, env, scheduler)
    c = BootstrapClient(handle, rank)
    peers = c.exchange("qp", my_qp_handle, n_ranks)   # all ranks' handles
    c.barrier("wired", n_ranks)
"""

from __future__ import annotations

import contextlib
import itertools
import json
import threading
import time

from rocnrdma_tpu_torch import lockwitness as _lockwitness
from rocnrdma_tpu_torch import native
from rocnrdma_tpu_torch.metrics import STORE as _STORE
from rocnrdma_tpu_torch.obs import FLIGHT as _FLIGHT
from rocnrdma_tpu_torch.transport import keyspace
from rocnrdma_tpu_torch.transport.backoff import (
    poll_backoff,
    retry_with_backoff,
)

# Store-identity bases for ranks that are NOT (yet) members of the group:
# warm spares and grow() joiners heartbeat the liveness table under
# prefixed ids so ``dead_ranks(world_size)`` — which scans only
# ``range(world_size)`` — can never confuse a waiting spare with a member,
# and a member's death can never be masked by a spare's heartbeat. The
# bases are far above any plausible world size; prune's ``spares`` op
# clears the prefixed footprint when an id is promoted (or burned).
SPARE_RANK_BASE = 1 << 20
JOINER_RANK_BASE = 1 << 21

# -- the store-ops ledger -----------------------------------------
# Every client round-trip is attributed to ONE metrics.STORE_CLASSES
# traffic class at the _rpc choke point. Resolution order: (1) ops whose
# class is intrinsic (a prune is hygiene whoever sends it; hb/live are
# the liveness protocol; setnx is a first-writer-wins election), (2) the
# calling thread's store_traffic() override (the fleet agent's publishes
# ride a heartbeat-classed watchdog client), (3) the client's own
# default class (construction-time: what this connection exists for).

_OP_CLASS = {"prune": "prune", "hb": "heartbeat", "live": "heartbeat",
             "setnx": "election"}

# -- large-value chunking ---------------------------------------------------
# The store protocol's blocking receives post 64 KiB buffers (one per
# connection — a bigger post would tax every idle watchdog client for
# the rare big value), so any single RPC payload must stay under it.
# Values that don't (the telemetry tree's root digest grows O(n) in
# BYTES even though reading it is O(log n) in ROUND-TRIPS) are split
# transparently: ``set`` writes ``key#chunk/<i>`` parts first and a
# small ``__rocn_chunks__:<n>`` marker under the key LAST (readers see
# the marker only once every part is durable; a reader racing a
# re-publish can at worst join a torn value, which JSON consumers
# already treat as missing — telemetry is best-effort by contract),
# and ``try_get``/``get`` reassemble. Each part is one counted
# round-trip — the ledger reports chunked traffic honestly.

_CHUNK_BYTES = 48 << 10   # per-part budget on the ESCAPED (wire) size:
#                           headroom under the 64 KiB posted-recv bound
#                           for the rest of the JSON envelope
_CHUNK_MAGIC = "__rocn_chunks__:"


def _chunk_key(key: str, i: int) -> str:
    # shares the value key's prefix, so every prefix-guarded kv sweep
    # (the heal prune) retires a chunked value's parts with its marker
    return f"{key}#chunk/{i}"


def _split_value(value: str, budget: int = _CHUNK_BYTES) -> list:
    """Split ``value`` so each part's JSON-ESCAPED wire size stays
    under ``budget`` — the wire message is ``json.dumps(req)``, and a
    quote/backslash-dense slice (a digest's rows are mostly quoted
    short strings) can escape to well past its raw length; sizing on
    raw bytes would overflow the 64 KiB posted recv exactly on the
    payloads chunking exists for. Greedy: start at the raw budget and
    shrink proportionally to the measured inflation (converges in a
    couple of probes per part)."""
    parts = []
    i, n = 0, len(value)
    while i < n:
        j = min(n, i + budget)
        while j > i + 1:
            escaped = len(json.dumps(value[i:j]))
            if escaped <= budget:
                break
            j = i + max(1, int((j - i) * budget / escaped))
        parts.append(value[i:j])
        i = j
    return parts

_TRAFFIC_TLS = threading.local()


@contextlib.contextmanager
def store_traffic(traffic_class: str):
    """Classify this thread's store round-trips as ``traffic_class``
    for the duration of the block (nests and restores; intrinsic op
    classes still win — see the resolution order above)."""
    prev = getattr(_TRAFFIC_TLS, "cls", None)
    _TRAFFIC_TLS.cls = traffic_class
    try:
        yield
    finally:
        _TRAFFIC_TLS.cls = prev


class BootstrapServer:
    """Rank-0-side store. One daemon thread per client connection (rendezvous
    fan-in is small and short-lived); state is a dict + per-rank barrier
    arrival sets + a last-seen liveness table."""

    # replica forwarding bounds: how often the condensed liveness sync
    # piggybacks on mutation traffic, and the per-forward reply budget
    # (a slow replica must not stall the primary's serve threads past it)
    _REPL_LIVE_S = 0.25
    _REPL_TIMEOUT_S = 2.0

    def __init__(self, n_ranks: int, port: int = 0, host: str | None = None):
        self.n_ranks = n_ranks
        self._listener = native.TcpListener(port=port, host=host)
        self.handle = self._listener.handle
        self._kv: dict[str, str] = {}
        self._barriers: dict[str, set] = {}  # key -> set of arrived ranks
        # (scope, rank) -> monotonic stamp: liveness is namespaced like
        # every other piece of store state — two groups sharing one store
        # (a split() child next to its parent) must not read each other's
        # ranks as their own (the rank numbers collide, the scopes don't)
        self._last_seen: dict[tuple, float] = {}
        self._lock = _lockwitness.make_lock(
            "bootstrap.py::BootstrapServer._lock")
        # the per-shard store-ops ledger (server side of metrics.STORE):
        # every request this store actually served, by op — the scale
        # harness (tools/simfleet) proves the proxy condensation from
        # exactly these counters
        self._served_n = 0
        self._served_by_op: dict[str, int] = {}
        # replication plumbing (attach_replica): the shared replica
        # client is lockstep, so forwards serialize under their own
        # lock — NEVER nested inside self._lock (serve threads forward
        # AFTER _handle returns; see _dispatch)
        self._repl_lock = _lockwitness.make_lock(
            "bootstrap.py::BootstrapServer._repl_lock")
        self._replica: BootstrapClient | None = None
        self._live_sync_t = 0.0
        self._closed = False
        self._threads: list[threading.Thread] = []
        self._conn_ids = itertools.count()  # distinguishes rank-less clients
        self._acceptor = threading.Thread(target=self._accept_loop, daemon=True)
        self._acceptor.start()

    # -- server side -------------------------------------------------------

    def _accept_loop(self):
        while not self._closed:
            try:
                conn = self._listener.accept(timeout_s=0.25)
            except TimeoutError:
                continue
            except OSError:
                return  # listener closed under us
            t = threading.Thread(target=self._serve, args=(conn,), daemon=True)
            t.start()
            with self._lock:
                # prune the finished under the same lock that guards the
                # append: unbounded growth (and the append-vs-snapshot race
                # with wait_idle) both die here
                self._threads = [x for x in self._threads if x.is_alive()]
                self._threads.append(t)

    def _serve(self, conn):
        conn_id = next(self._conn_ids)
        try:
            while not self._closed:
                try:
                    req = json.loads(conn.recv(timeout_s=0.5))
                except TimeoutError:
                    continue
                except OSError:
                    return  # client went away
                resp = self._dispatch(req, conn_id)
                if resp is None or self._closed:
                    # the dispatcher dropped the conversation (a proxy
                    # whose upstream is gone) or the store closed under
                    # us: close the conn instead of answering, so the
                    # client's reconnect-replay/failover path — not an
                    # error reply it may not expect — takes over
                    return
                conn.send(json.dumps(resp).encode())
                if req.get("op") == "bye":
                    return
        finally:
            conn.close()

    def _dispatch(self, req: dict, conn_id: int) -> dict:
        """Serve one request: the locked table mutation (``_handle``),
        then — OUTSIDE the table lock — the replica forward. Ordering is
        the replication contract: the client's ack is sent only after
        the forward returns, so an acked critical mutation is on the
        replica (or the replica has been declared dead and detached —
        the one weakening, recorded on the flight timeline). Subclasses
        (``NodeProxyStore``) override this to route between local
        termination and upstream forwarding; returning ``None`` makes
        ``_serve`` drop the conversation instead of replying."""
        resp = self._handle(req, conn_id)
        self._replicate(req, resp, conn_id)
        return resp

    def _handle(self, req: dict, conn_id: int = -1) -> dict:
        op = req.get("op")
        rank = req.get("rank")
        scope = req.get("scope", "")
        with self._lock:
            self._served_n += 1
            self._served_by_op[op] = self._served_by_op.get(op, 0) + 1
            if rank is not None:
                self._last_seen[(scope, int(rank))] = time.monotonic()
            if op == "set":
                self._kv[req["key"]] = req["value"]
                return {"ok": True}
            if op == "setnx":  # set-if-absent: first writer wins, atomically
                if req["key"] in self._kv:
                    return {"ok": False, "value": self._kv[req["key"]]}
                self._kv[req["key"]] = req["value"]
                return {"ok": True, "value": req["value"]}
            if op == "get":
                if req["key"] in self._kv:
                    return {"ok": True, "value": self._kv[req["key"]]}
                return {"ok": False}
            if op == "barrier_arrive":
                # keyed by rank (conn id for rank-less callers): arrival is
                # IDEMPOTENT, so an RPC replayed over a reconnect cannot
                # count twice and release a barrier early
                who = rank if rank is not None else ("conn", conn_id)
                self._barriers.setdefault(req["key"], set()).add(who)
                return {"ok": True}
            if op == "barrier_done":
                return {"ok": len(self._barriers.get(req["key"], ()))
                              >= req["n"]}
            if op == "live":
                # liveness table: seconds since each rank's last RPC (the
                # store-state evidence monitored_barrier/shrink name the
                # dead from). Heartbeats are implicit — every RPC stamps —
                # plus the explicit ``hb`` no-op for idle ranks.
                now = time.monotonic()
                return {"ok": True,
                        "ages": {str(r): now - t
                                 for (sc, r), t in self._last_seen.items()
                                 if sc == scope}}
            if op == "hb":
                return {"ok": True}  # the stamp above was the point
            if op == "hb_bulk":
                # condensed liveness: a node proxy (or a replicating
                # primary) delivers its whole table in ONE round-trip —
                # ``scopes`` maps scope -> {rank: age_s}, stamped back
                # into monotonic time, never regressing a fresher stamp
                # (the rank may have spoken here directly since the
                # sender snapshotted). ``kv`` carries the batched beat
                # keys so cross-node neighbour watching reads them from
                # one place.
                now = time.monotonic()
                for sc, ages in (req.get("scopes") or {}).items():
                    for r, age in ages.items():
                        k = (sc, int(r))
                        t = now - max(0.0, float(age))
                        if t > self._last_seen.get(k, float("-inf")):
                            self._last_seen[k] = t
                self._kv.update(req.get("kv") or {})
                return {"ok": True}
            if op == "barrier_bulk":
                # condensed arrivals: idempotent per rank set like
                # barrier_arrive, so a replayed or re-flushed batch can
                # never double-count
                self._barriers.setdefault(req["key"], set()).update(
                    int(r) for r in req.get("ranks", ()))
                return {"ok": True}
            if op == "sync":
                # replica bootstrap (attach_replica): merge one batch of
                # the primary's critical state. Non-destructive on
                # purpose — a mutation forwarded DURING the attach
                # window may already be here and is newer than the
                # snapshot, so kv fills gaps only, barriers union, and
                # liveness keeps the freshest stamp.
                for k, v in (req.get("kv") or {}).items():
                    self._kv.setdefault(k, v)
                for k, ranks in (req.get("barriers") or {}).items():
                    self._barriers.setdefault(k, set()).update(
                        int(r) for r in ranks)
                now = time.monotonic()
                for sc, r, age in req.get("ages", ()):
                    k = (sc, int(r))
                    t = now - max(0.0, float(age))
                    if t > self._last_seen.get(k, float("-inf")):
                        self._last_seen[k] = t
                return {"ok": True}
            if op == "prune":
                # epoch-bump hygiene (ProcessGroup.heal): drop the named
                # rank ids' liveness stamps for this scope and their
                # arrivals from every barrier under ``prefix``, so a
                # rank id orphaned (or freed by a death) in one group
                # generation can re-register in the next without a stale
                # stamp branding it dead or a stale arrival tripping the
                # duplicate-arrival guard. Idempotent per rank set, like
                # every other op — safe to replay over a reconnect.
                ranks = {int(r) for r in req.get("ranks", ())}
                prefix = req.get("prefix")
                # spare-prefixed footprint (the elastic-grow fix): a
                # promoted — or burned — spare/joiner leaves liveness
                # stamps under its PREFIXED id plus a stale listener
                # handle; left behind, the stale heartbeat reads as
                # alive and the handle points at a gone endpoint. The
                # ``slot`` and ``admit`` keys are deliberately KEPT:
                # the registry scan walks slot ids densely from 0
                # (``_scan_standby_registry``), so popping a slot would
                # hide every live standby at a higher sid, and the
                # admit record is the slot's permanent burn mark — slot
                # ids are consumed monotonically, never reused.
                # ``spares``/``joiners`` name the slot ids to clear;
                # both liveness and barrier arrivals are swept through
                # the same rank set below.
                for base, key_name, sub in (
                        (SPARE_RANK_BASE, "spares", "spares"),
                        (JOINER_RANK_BASE, "joiners", "join")):
                    for sid in req.get(key_name, ()):
                        ranks.add(base + int(sid))
                        if prefix:
                            self._kv.pop(
                                f"{prefix}{sub}/h/{int(sid)}", None)
                # kv sweep: whole key prefixes a membership change
                # obsoleted — the device-plane coordinator-election keys
                # (pg/<group>/deviceheal/e<N>/coord) and the fleet
                # telemetry snapshots (pg/<group>/fleet/e<N>/<orig>,
                # one per rank per generation, re-written every
                # heartbeat tick) are epoch-qualified, so the heal that
                # mints epoch N+1 sweeps every older generation's keys
                # before its own start publishing; a long-lived sidecar
                # store can accrete neither dead coordinator handles
                # nor orphaned snapshot keys per heal. Guarded to the caller's
                # prefix: a prune may only sweep its own group's keys,
                # and a prune that declares NO prefix may sweep none at
                # all (an unprefixed request bypassing the guard would
                # let any client of a shared store delete another
                # group's live election). The sweep must also target a
                # REGISTERED namespace (transport/keyspace.py) — a
                # typo'd prefix deletes nothing, not the wrong thing.
                for sub_prefix in req.get("kv", ()):
                    if not keyspace.sweepable(sub_prefix, prefix):
                        continue
                    for k in [k for k in self._kv
                              if k.startswith(sub_prefix)]:
                        del self._kv[k]
                for r in ranks:
                    self._last_seen.pop((scope, r), None)
                if prefix:
                    for key, arrived in self._barriers.items():
                        if key.startswith(prefix):
                            arrived -= ranks
                return {"ok": True}
            if op == "bye":
                return {"ok": True}
        return {"ok": False, "error": f"unknown op {op!r}"}

    def stats(self) -> dict:
        """The per-shard server-side ops ledger: how many requests this
        store actually served, by op — the counterpart of the client-side
        ``metrics.STORE`` ledger, counted where the load lands."""
        with self._lock:
            return {"served": self._served_n,
                    "by_op": dict(self._served_by_op)}

    def attach_replica(self, handle: str, timeout_s: float = 10.0) -> None:
        """Attach the deterministic successor's store as this primary's
        replica (DESIGN.md §5n): dial it, merge-sync the current critical
        state (``keyspace.REPLICATED`` kv, their barrier arrivals, the
        liveness table), and from then on forward every critical mutation
        before acking it. The replica pointer is installed BEFORE the
        snapshot is taken, so a racing mutation either sees the pointer
        and forwards or lands in the snapshot — possibly both, which the
        replica's non-destructive ``sync`` absorbs (kv fills gaps only,
        so the forwarded/newer value wins). ``timeout_s`` bounds the
        whole attach (dial plus every sync batch)."""
        deadline = time.monotonic() + timeout_s
        client = BootstrapClient(handle, rank=None, timeout_s=timeout_s,
                                 traffic_class="replication")
        try:
            with self._repl_lock:
                self._replica = client
            with self._lock:
                kv = {k: v for k, v in self._kv.items()
                      if keyspace.replicated(k.partition("#chunk/")[0])}
                barriers = {k: sorted(r for r in arr if isinstance(r, int))
                            for k, arr in self._barriers.items()
                            if keyspace.replicated(k)}
                now = time.monotonic()
                ages = [[sc, r, max(0.0, now - t)]
                        for (sc, r), t in self._last_seen.items()]
            with self._repl_lock:
                batch, size = {}, 0
                items = sorted(kv.items())
                for i, (k, v) in enumerate(items):
                    batch[k] = v
                    size += len(k) + len(v)
                    if size >= 32 << 10 or i == len(items) - 1:
                        client._rpc(op="sync", kv=batch,
                                    _budget_s=max(
                                        0.1, deadline - time.monotonic()))
                        batch, size = {}, 0
                client._rpc(op="sync", barriers=barriers, ages=ages,
                            _budget_s=max(0.1, deadline - time.monotonic()))
        except (OSError, TimeoutError) as e:
            with self._repl_lock:
                self._replica = None
            _close_quietly(client)
            _FLIGHT.record("store-replica-abort", error=type(e).__name__)
            raise
        # no snapshot sizes in the event args: how many keys/barriers
        # happened to exist at attach time is wall-clock-shaped (racing
        # barrier arrivals land before or after the snapshot), and this
        # event rides the replay-equal STORELOG digest — table sizes are
        # queryable from the replica's stats() when a postmortem wants
        # them
        _FLIGHT.record("store-replica-attach")

    def _drop_replica(self, err: Exception) -> None:
        """Declare the replica dead and stop forwarding — the one
        weakening of acked⇒replicated, always on the flight timeline."""
        with self._repl_lock:
            repl, self._replica = self._replica, None
        if repl is not None:
            _close_quietly(repl)
            _FLIGHT.record("store-replica-abort", error=type(err).__name__)

    def _replicate(self, req: dict, resp: dict, conn_id: int = -1) -> None:
        """Forward one served mutation to the attached replica (called
        from ``_dispatch`` AFTER ``_handle`` released the table lock).
        Only ``keyspace.replicated`` namespaces forward; a ``setnx``
        forwards the WINNING value as a plain set so the replica
        converges regardless of forward interleaving. Piggybacked on the
        same serialized forward: a condensed liveness sync at most every
        ``_REPL_LIVE_S`` — the replica's table stays warm enough that a
        post-failover ``dead_ranks`` names only the actually-dead."""
        op = req.get("op")
        fwd = None
        if op in ("set", "setnx"):
            key = req.get("key", "")
            if resp.get("ok") and keyspace.replicated(
                    key.split("#chunk/", 1)[0]):
                fwd = {"op": "set", "key": key,
                       "value": (req["value"] if op == "set"
                                 else resp["value"])}
        elif op == "barrier_arrive":
            key = req.get("key", "")
            if keyspace.replicated(key):
                rank = req.get("rank")
                # rank-less arrivals replicate under a synthetic id
                # derived from the (stable for this conversation) conn
                # id — counts stay right after a failover even for
                # observer-style callers
                fwd = {"op": "barrier_bulk", "key": key,
                       "ranks": [int(rank) if rank is not None
                                 else -(conn_id + 1)]}
        elif op == "prune":
            fwd = dict(req)
        try:
            with self._repl_lock:
                repl = self._replica
                if repl is None:
                    return
                now = time.monotonic()
                live_due = now - self._live_sync_t >= self._REPL_LIVE_S
                if fwd is None and not live_due:
                    return
                if live_due:
                    self._live_sync_t = now
                    with self._lock:
                        snap = dict(self._last_seen)
                    scopes: dict[str, dict] = {}
                    for (sc, r), t in snap.items():
                        scopes.setdefault(sc, {})[str(r)] = \
                            max(0.0, now - t)
                    repl._rpc(op="hb_bulk", scopes=scopes,
                              _budget_s=self._REPL_TIMEOUT_S)
                if fwd is not None:
                    repl._rpc(_budget_s=self._REPL_TIMEOUT_S, **fwd)
        except (OSError, TimeoutError) as e:
            self._drop_replica(e)

    def wait_idle(self, timeout_s: float = 5.0) -> None:
        """Block until every client connection has wound down (sent ``bye``
        or disconnected) — the orderly-shutdown handshake: close the server
        only after this returns, so no client's in-flight RPC is cut."""
        deadline = time.monotonic() + timeout_s
        with self._lock:
            threads = list(self._threads)  # snapshot under the append lock
        for t in threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()))

    def close(self):
        self._closed = True
        # detach the replica link first (clean bye, no abort event): its
        # connection counts against the REPLICA's own wait_idle, and a
        # closing primary must not pin the surviving sidecar open
        with self._repl_lock:
            repl, self._replica = self._replica, None
        if repl is not None:
            with contextlib.suppress(Exception):
                repl.close()
        # join the acceptor BEFORE closing the listener: it may be blocked
        # inside accept() on the native handle, and rtcp_close_listener
        # frees that handle — close-under-accept is a use-after-free, and
        # the kernel socket (the master port) stays bound until the thread
        # lets go. The acceptor re-checks _closed every 0.25 s.
        self._acceptor.join(timeout=2.0)
        self._listener.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class NodeProxyStore(BootstrapServer):
    """Per-node shard of the bootstrap store (DESIGN.md §5n): the node's
    elected agent hosts one of these, its ranks point their store
    clients here, and the heartbeat/telemetry fan-in that used to land
    O(world) on the primary's one socket terminates locally.

    Termination rule (``keyspace.proxy_local``): heartbeat stamps, the
    watchdog's per-rank beat keys, barrier arrivals, and the node's own
    per-rank fleet snapshots are served from the proxy's tables; what
    the rest of the fleet must see (beats for cross-node neighbour
    watching, barrier arrivals) is batched upstream as ONE condensed
    ``hb_bulk``/``barrier_bulk`` per flush window — per-node, not
    per-rank, round-trips. Everything else (rendezvous, elections,
    heal/grow admission, liveness QUERIES — the global table lives
    upstream) forwards verbatim under the proxy's serialized upstream
    client, which carries the caller's rank so the primary's liveness
    stamping still sees the true origin.

    Survivability composes: the upstream client accepts the same
    ``arm_failover`` successor list as any other, so a primary death
    re-points the whole node through its proxy in one place, and a
    proxy death re-points only that node's ranks (their clients' own
    failover lists name the primary) — no other node's traffic moves."""

    def __init__(self, upstream: str, node: int, flush_s: float = 0.25,
                 timeout_s: float = 10.0, port: int = 0,
                 host: str | None = None, failover=()):
        self.node = node
        self._flush_s = flush_s
        self._up_timeout_s = timeout_s
        self._up_lock = _lockwitness.make_lock(
            "bootstrap.py::NodeProxyStore._up_lock")
        self._up = BootstrapClient(upstream, rank=None, timeout_s=timeout_s,
                                   traffic_class="proxy-upstream",
                                   tag=f"proxy-up/{node}")
        if failover:
            self._up.arm_failover(list(failover))
        self._pending_beats: dict[str, str] = {}   # beat key -> value
        self._pending_barriers: dict[str, set] = {}
        self._last_flush = time.monotonic()
        self.forwarded = 0
        self.flushes = 0
        super().__init__(n_ranks=0, port=port, host=host)

    def _dispatch(self, req: dict, conn_id: int) -> dict:
        op = req.get("op")
        if op in ("set", "setnx", "get"):
            loc = keyspace.proxy_local(req.get("key", ""))
            if loc is not None:
                if op == "get":
                    resp = self._handle(req, conn_id)
                    if resp.get("ok"):
                        self._maybe_flush()
                        return resp
                    # absent in this shard: the key may belong to
                    # ANOTHER node (cross-node neighbour watching reads
                    # the boundary ranks' beats) — the condensed copy
                    # lives upstream, at most one flush window stale
                    return self._forward(req)
                resp = self._handle(req, conn_id)
                if loc == "beat" and op == "set":
                    with self._lock:
                        self._pending_beats[req["key"]] = req["value"]
                self._maybe_flush()
                return resp
            return self._forward(req)
        if op in ("hb", "bye"):
            resp = self._handle(req, conn_id)  # local stamp is the point
            self._maybe_flush()
            return resp
        if op == "barrier_arrive":
            resp = self._handle(req, conn_id)  # idempotent local record
            rank = req.get("rank")
            with self._lock:
                self._pending_barriers.setdefault(
                    req["key"], set()).add(
                        int(rank) if rank is not None else -(conn_id + 1))
            return resp
        if op == "barrier_done":
            # a done-poll implies "my node's arrivals must be upstream":
            # flush pending arrivals inline first, so barrier latency is
            # one poll interval, not one flush window
            self._flush_now(self._up_timeout_s)
            return self._forward(req)
        if op == "prune":
            self._handle(req, conn_id)  # sweep the local shard too
            return self._forward(req)
        return self._forward(req)

    def _stamp(self, req: dict) -> None:
        rank, scope = req.get("rank"), req.get("scope", "")
        if rank is not None:
            with self._lock:
                self._last_seen[(scope, int(rank))] = time.monotonic()

    def _forward(self, req: dict, timeout_s: float | None = None) -> dict:
        """One verbatim upstream round-trip (serialized — the upstream
        client is lockstep). The caller's rank rides along, so the
        primary's implicit liveness stamping is unchanged for the
        low-frequency ops that still reach it. Upstream failure (after
        the upstream client's own reconnect/failover budget) surfaces
        by DROPPING the caller's conversation (``None`` return — see
        ``_serve``): the client's own reconnect-replay/failover path
        decides what answers next, and the abort is on the flight
        timeline. A proxy with no store left is degraded, not wedged."""
        self._stamp(req)
        budget = self._up_timeout_s if timeout_s is None else timeout_s
        with self._up_lock:
            self.forwarded += 1
            try:
                return self._up._rpc(_budget_s=budget, **req)
            except (OSError, TimeoutError) as e:
                _FLIGHT.record("store-proxy-abort", node=self.node,
                               op=req.get("op"), error=type(e).__name__)
                return None

    def _maybe_flush(self) -> None:
        if time.monotonic() - self._last_flush >= self._flush_s:
            self._flush_now(self._up_timeout_s)

    def flush(self, timeout_s: float | None = None) -> None:
        """Push the condensed window upstream now: one ``hb_bulk`` with
        the node's whole liveness table plus batched beat keys, and one
        ``barrier_bulk`` per barrier with pending arrivals. Failed
        batches re-merge (arrivals MUST not be lost; ages are refreshed
        next window anyway). ``timeout_s`` bounds the whole flush."""
        self._flush_now(self._up_timeout_s if timeout_s is None
                        else timeout_s)

    def _flush_now(self, timeout_s: float) -> None:
        deadline = time.monotonic() + timeout_s
        with self._lock:
            beats = dict(self._pending_beats)
            self._pending_beats.clear()
            barriers = {k: set(v)
                        for k, v in self._pending_barriers.items() if v}
            self._pending_barriers.clear()
            now = time.monotonic()
            scopes: dict[str, dict] = {}
            for (sc, r), t in self._last_seen.items():
                scopes.setdefault(sc, {})[str(r)] = max(0.0, now - t)
        self._last_flush = time.monotonic()
        with self._up_lock:
            self.flushes += 1
            try:
                if scopes or beats:
                    self._up._rpc(op="hb_bulk", scopes=scopes, kv=beats,
                                  _budget_s=max(
                                      0.1, deadline - time.monotonic()))
                for k, ranks in sorted(barriers.items()):
                    self._up._rpc(op="barrier_bulk", key=k,
                                  ranks=sorted(ranks),
                                  _budget_s=max(
                                      0.1, deadline - time.monotonic()))
                    barriers.pop(k)
            except (OSError, TimeoutError) as e:
                with self._lock:
                    for k, ranks in barriers.items():
                        self._pending_barriers.setdefault(
                            k, set()).update(ranks)
                _FLIGHT.record("store-proxy-abort", node=self.node,
                               op="flush", error=type(e).__name__)

    def arm_upstream_failover(self, handles) -> None:
        """Name the upstream successor list (the replica): a primary
        death re-points this whole node's traffic in one place."""
        with self._up_lock:
            self._up.arm_failover(list(handles))

    def stats(self) -> dict:
        s = super().stats()
        s["forwarded"] = self.forwarded
        s["flushes"] = self.flushes
        return s

    def close(self):
        with contextlib.suppress(Exception):
            with self._up_lock:
                self._up.close()
        super().close()


class BootstrapClient:
    """One rank's connection to the store.

    Connection failures are survivable: the initial dial retries refused
    connects with backoff (the server may not be listening yet), and a
    connection dropped mid-conversation is re-dialed and the request
    replayed — safe because every op is idempotent per rank (see the
    barrier-arrival keying in the server). A reply that never comes in
    ``timeout_s`` surfaces as ``TimeoutError``. One thread per client:
    the wire protocol is strict request→reply lockstep."""

    def __init__(self, handle: str, rank: int, timeout_s: float = 30.0,
                 scope: str = "", traffic_class: str = "rendezvous",
                 failover=(), fault_schedule=None, tag: str | None = None):
        self.rank = rank
        self.timeout_s = timeout_s
        # liveness namespace: clients of one group pass one scope (the
        # ring's store namespace), so live/dead queries see only peers of
        # THAT group — rank numbers collide across groups, scopes don't
        self.scope = scope
        # the store-ops ledger's default attribution for this
        # connection's round-trips (metrics.STORE_CLASSES): what this
        # client exists for — the watchdog's is "heartbeat", observers'
        # "telemetry-read", the wiring/heal client "rendezvous"
        self.traffic_class = traffic_class
        self._handle = handle
        # the ordered successor list (arm_failover): where to re-point
        # when the current store stops answering — the survivable-store
        # half of DESIGN.md §5n. ``tag`` names THIS connection in the
        # deterministic store-failover flight events (ranks own several
        # clients; digests must not depend on which one noticed first).
        self._failover: list[str] = [h for h in failover
                                     if h and h != handle]
        self._tag = tag
        self._faults = fault_schedule
        self._said_bye = False
        self._qp = (self._redial(time.monotonic() + timeout_s)
                    if self._failover else self._dial(timeout_s))

    def arm_failover(self, handles) -> None:
        """Name the successor stores, in election order (today: the one
        replica). Takes effect on the NEXT reconnect — the live
        connection is never torn down preemptively."""
        self._failover = [h for h in handles if h and h != self._handle]

    def _dial(self, timeout_s: float):
        # refused dials retry with backoff: rank 0 may still be binding the
        # master port when rank N-1 starts (the races every launcher has)
        return retry_with_backoff(
            lambda: native.TcpQueuePair.connect(
                self._handle, min(5.0, timeout_s)),
            timeout_s, f"bootstrap dial {self._handle}",
            retry_on=(OSError,))

    def _redial(self, deadline: float):
        """Reconnect, rotating through the armed successor list: the
        current target gets a short dial budget per sweep, then each
        successor in order; sweeps repeat under the shared jittered
        backoff until the deadline. A successful dial to a successor
        RE-POINTS the client (sticky — the old primary is dead, not
        slow; the epoch discipline fences anything it might still say)
        and leaves a deterministic ``store-failover`` event. With no
        successors armed this is exactly the old single-target dial."""
        if not self._failover:
            return self._dial(max(0.1, deadline - time.monotonic()))
        back = poll_backoff()
        last: Exception | None = None
        while True:
            for h in [self._handle, *self._failover]:
                # short per-target budget: the native dial retries
                # refusals INTERNALLY until its timeout, so this budget
                # is the floor on how long a dead target delays the
                # sweep reaching the live successor
                budget = min(0.35, max(0.1, deadline - time.monotonic()))
                try:
                    qp = native.TcpQueuePair.connect(h, budget)
                except (OSError, TimeoutError) as e:
                    last = e
                    continue
                try:
                    if h != self._handle:
                        self._failover = [x for x in self._failover
                                          if x != h]
                        self._handle = h
                        _FLIGHT.record("store-failover", rank=self.rank,
                                       tag=self._tag)
                except BaseException:
                    qp.close()
                    _FLIGHT.record("store-dial-abort", rank=self.rank,
                                   tag=self._tag)
                    raise
                return qp
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"bootstrap redial: no store answered "
                    f"(primary + {len(self._failover)} successor(s)): "
                    f"{last!r}") from last
            back.pause()

    def _rpc(self, _budget_s: float | None = None, **req) -> dict:
        """One request→reply, surviving a dropped/hung connection by
        re-dialing and replaying (never resending on the same connection —
        a late reply to the first copy would desync the lockstep).

        ``_budget_s`` bounds the WHOLE call — the reply wait of each
        attempt AND the reconnect/replay retries — so the deadline-
        honoring callers (get/barrier polls, ``fleet_stats``) passing
        their remaining time can neither inflate a 2 s deadline into
        30 s of re-dialing against a dead store NOR block a full
        ``self.timeout_s`` in one recv against a merely-slow one (the
        module contract: polls never hang past the caller's deadline).
        The first attempt always runs, and every attempt's reply wait
        is floored at min(1 s, ``self.timeout_s``): a 0 budget means
        "one bounded try, no retries", NOT "give the server 100 ms" —
        the watchdog's beat probes ride exactly that shape, and a
        sub-second reply SLA on a busy store reads healthy peers as
        silent (a spurious-death source, measured). Without a budget a
        round-trip is bounded by ``self.timeout_s`` as before."""
        req.setdefault("rank", self.rank)
        req.setdefault("scope", self.scope)
        # ledger attribution resolved ONCE per call (op-intrinsic class,
        # else the thread's store_traffic override, else this client's
        # default); counted once per ATTEMPT below — a blocking poll or
        # a reconnect replay is real load on the store, and the ledger
        # exists to count load, not intentions
        op = req.get("op")
        traffic = (_OP_CLASS.get(op)
                   or getattr(_TRAFFIC_TLS, "cls", None)
                   or self.traffic_class)
        payload = json.dumps(req).encode()
        # seeded fault injection (FaultSchedule.store_fault): drop the
        # live connection BEFORE the Nth store round-trip of this rank,
        # so the reconnect-replay path below runs at a deterministic,
        # replay-equal coordinate — the store plane's analogue of the
        # data plane's op_fault
        if self._faults is not None and self._faults.store_fault():
            with contextlib.suppress(OSError):
                self._qp.close()
        deadline = time.monotonic() + (self.timeout_s if _budget_s is None
                                       else max(0.0, _budget_s))
        back = None  # built on the FIRST failure: the happy path (every
        last: Exception | None = None  # poll iteration) allocates nothing
        while True:
            try:
                recv_s = (self.timeout_s if _budget_s is None
                          else max(min(1.0, self.timeout_s),
                                   min(self.timeout_s,
                                       deadline - time.monotonic())))
                _STORE.count(traffic, op=op)
                self._qp.send(payload)
                return json.loads(self._qp.recv(timeout_s=recv_s))
            except (OSError, TimeoutError) as e:
                last = e
                if back is None:
                    back = poll_backoff()
                # a dropped/hung store connection entering the reconnect-
                # replay path: on the flight timeline (failure path only —
                # the lockstep happy path records nothing per RPC)
                _FLIGHT.record("rpc-retry", op=req.get("op"),
                               error=type(e).__name__)
                if self._said_bye or time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"bootstrap rpc {req.get('op')!r} failed "
                        f"(retry budget spent): {last!r}") from last
                back.pause()
                try:
                    self._qp.close()
                except OSError:
                    pass
                # re-dial rotates through any armed successors: the
                # replayed request lands wherever the control plane
                # still answers (every op is idempotent per rank — the
                # replay-over-failover guarantee is the same one
                # reconnect-replay always had)
                self._qp = self._redial(deadline)

    def set(self, key: str, value: str,
            timeout_s: float | None = None) -> None:
        """``timeout_s``: optional retry budget for surviving a dropped
        connection (default: the client-level ``self.timeout_s``) — the
        deadline-honoring callers (exchange) pass their remaining time.
        Values past the wire's per-message bound are chunked
        transparently (parts first, marker last — see the module's
        chunking note); ``timeout_s`` bounds the WHOLE multi-part
        write."""
        # the chunk trigger is escape-aware like the split: a value
        # whose RAW length fits can still escape past the wire bound
        # (worst case 6 bytes per char for \\uXXXX); short values skip
        # the measurement entirely — they cannot overflow even fully
        # escaped
        wire_len = (len(value) if len(value) * 6 + 2 <= _CHUNK_BYTES
                    else len(json.dumps(value)))
        if wire_len > _CHUNK_BYTES:
            budget = self.timeout_s if timeout_s is None else timeout_s
            deadline = time.monotonic() + budget
            parts = _split_value(value)
            for i, part in enumerate(parts):
                resp = self._rpc(op="set", key=_chunk_key(key, i),
                                 value=part,
                                 _budget_s=max(0.0, deadline
                                               - time.monotonic()))
                if not resp.get("ok"):
                    raise OSError(
                        f"bootstrap set({key!r}) chunk {i} failed: "
                        f"{resp}")
            value = f"{_CHUNK_MAGIC}{len(parts)}"
            timeout_s = max(0.0, deadline - time.monotonic())
        resp = self._rpc(op="set", key=key, value=value,
                         _budget_s=timeout_s)
        if not resp.get("ok"):
            raise OSError(f"bootstrap set({key!r}) failed: {resp}")

    def _join_chunks(self, key: str, marker: str,
                     timeout_s: float | None) -> str | None:
        """Reassemble a chunked value (``try_get``/``get`` found the
        marker). A missing part reads as the whole value ABSENT — the
        torn-write disposition every JSON consumer here already has."""
        try:
            n = int(marker[len(_CHUNK_MAGIC):])
        except ValueError:
            return None  # a user value masquerading as a marker: torn
        budget = self.timeout_s if timeout_s is None else timeout_s
        deadline = time.monotonic() + budget
        parts = []
        for i in range(n):
            resp = self._rpc(op="get", key=_chunk_key(key, i),
                             _budget_s=max(0.0, deadline
                                           - time.monotonic()))
            if not resp.get("ok"):
                return None
            parts.append(resp["value"])
        return "".join(parts)

    def set_if_absent(self, key: str, value: str) -> str:
        """Atomic first-writer-wins: returns the value actually stored
        (ours if we won the race, the incumbent's otherwise)."""
        return self._rpc(op="setnx", key=key, value=value)["value"]

    def try_get(self, key: str,
                timeout_s: float | None = None) -> str | None:
        """One idempotent lookup: the value if present, ``None`` if the
        key is ABSENT. A transport failure raises (after the client retry
        budget) instead of masquerading as absence — callers deciding
        membership (``ProcessGroup.shrink``) or naming the dead must not
        read a flaky wire as a missing rank. ``timeout_s``: optional
        whole-call bound (reply wait + retries — see ``_rpc``) for
        callers holding their own deadline (``fleet_stats``); default is
        the client-level ``self.timeout_s``."""
        resp = self._rpc(op="get", key=key, _budget_s=timeout_s)
        if not resp.get("ok"):
            return None
        value = resp.get("value")
        if isinstance(value, str) and value.startswith(_CHUNK_MAGIC):
            return self._join_chunks(key, value, timeout_s)
        return value

    def get(self, key: str, timeout_s: float = 30.0) -> str:
        """Blocking get: polls (jittered backoff) until the key appears or
        the deadline passes."""
        deadline = time.monotonic() + timeout_s
        back = poll_backoff()
        while True:
            resp = self._rpc(op="get", key=key,
                             _budget_s=deadline - time.monotonic())
            if resp.get("ok"):
                value = resp["value"]
                if isinstance(value, str) \
                        and value.startswith(_CHUNK_MAGIC):
                    joined = self._join_chunks(
                        key, value,
                        max(0.0, deadline - time.monotonic()))
                    if joined is not None:
                        return joined
                    # a part vanished under the marker (a re-publish in
                    # flight): poll again like an absent key
                else:
                    return value
            if time.monotonic() >= deadline:
                raise TimeoutError(f"bootstrap key {key!r} never published")
            back.pause()

    def barrier(self, key: str, n: int, timeout_s: float = 30.0) -> None:
        deadline = time.monotonic() + timeout_s
        self._rpc(op="barrier_arrive", key=key, _budget_s=timeout_s)
        back = poll_backoff()
        while True:
            if self._rpc(op="barrier_done", key=key, n=n,
                         _budget_s=deadline - time.monotonic()).get("ok"):
                return
            if time.monotonic() >= deadline:
                raise TimeoutError(f"bootstrap barrier {key!r} timed out")
            back.pause()

    def prune(self, ranks, prefix: str | None = None,
              spares=(), joiners=(), kv=()) -> None:
        """Remove ``ranks``' liveness-table entries for this client's
        scope (and, with ``prefix``, their arrivals from every barrier
        key under it) — the epoch-bump cleanup ``ProcessGroup.heal``'s
        leader runs so re-ranked survivors can re-register the freed
        rank ids cleanly. ``spares``/``joiners``: slot ids whose
        SPARE/JOINER-prefixed liveness stamps, barrier arrivals, and
        stale listener handles (``{prefix}spares|join/h/{sid}``) are
        cleared too — a promoted-then-dead spare's orphaned ids must
        not read as a live candidate. The ``slot``/``admit`` keys
        stay: slots are consumed monotonically (the dense registry
        scan depends on it) and the admit record is the burn mark.
        ``kv``: whole kv-key prefixes to sweep (each must start with
        ``prefix`` — a group prunes only its own keys); the heal leader
        passes the dead generations' device-plane coordinator-election
        namespace (``{prefix}deviceheal/e<k>/``) AND the fleet
        telemetry namespace (``{prefix}fleet/e<k>/`` — the per-rank
        snapshot keys ``obs.fleet``'s agent publishes each heartbeat
        tick) through this, both strictly below the minted epoch, so a
        long-lived sidecar store accretes neither dead coordinator
        handles nor healed-away generations' snapshot keys."""
        self._rpc(op="prune", ranks=sorted(int(r) for r in ranks),
                  prefix=prefix, spares=sorted(int(s) for s in spares),
                  joiners=sorted(int(j) for j in joiners),
                  kv=sorted(kv))

    def heartbeat(self) -> None:
        """Stamp this rank's liveness without any other side effect (every
        RPC stamps implicitly; this is for idle ranks that want to stay
        visibly alive)."""
        self._rpc(op="hb")

    def live_ages(self) -> dict[int, float]:
        """Seconds since each rank's last store RPC, from the server's
        passive liveness table. A rank absent from the dict has never
        spoken to the store through a rank-tagged client."""
        ages = self._rpc(op="live").get("ages", {})
        return {int(r): float(a) for r, a in ages.items()}

    def dead_ranks(self, n_ranks: int, max_age_s: float) -> list[int]:
        """Ranks the STORE's evidence says are gone: never seen, or silent
        for more than ``max_age_s``. This is circumstantial (a rank busy in
        a long compute makes no RPCs) — callers use it to NAME suspects in
        errors, not to act unilaterally."""
        ages = self.live_ages()
        return [r for r in range(n_ranks)
                if r not in ages or ages[r] > max_age_s]

    def exchange(self, prefix: str, my_value: str, n: int,
                 timeout_s: float = 30.0) -> list[str]:
        """Publish ``my_value`` under ``prefix/rank``; return all n values
        in rank order (the all-gather every bootstrap needs).
        ``timeout_s`` is ONE overall deadline for the whole exchange, not
        a per-key allowance — n keys can no longer stretch one nominal
        timeout n-fold."""
        deadline = time.monotonic() + timeout_s
        self.set(f"{prefix}/{self.rank}", my_value, timeout_s=timeout_s)
        return [self.get(f"{prefix}/{r}",
                         max(0.0, deadline - time.monotonic()))
                for r in range(n)]

    def close(self):
        try:
            # deliver the goodbye to whoever still answers: with
            # successors armed the bye itself may rotate once (small
            # bounded budget — the bye clears this rank's liveness
            # claim, and the SURVIVOR store is the one that must see
            # it, or it later brands the departed rank dead). Without
            # successors: one bounded try, never a full-timeout stall
            # against a store that already died.
            self._rpc(op="bye", _budget_s=1.0 if self._failover else 0.0)
        except Exception:
            pass
        finally:
            self._said_bye = True  # no reconnect-replay past this point
            self._qp.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _close_quietly(res) -> None:
    """Best-effort teardown of a half-made endpoint on a failure path —
    the original error is the diagnosis; a close() raising over it (peer
    already gone, segment already unlinked) would mask it."""
    try:
        res.close()
    except Exception:
        pass


def bootstrap_ring(net, store_handle: str, rank: int, n_ranks: int,
                   timeout_s: float = 30.0, ns: str = "ring",
                   failover=(), fault_schedule=None):
    """Wire the ring every net collective here expects, from ONE shared
    address: listen, publish my handle, dial my successor, accept my
    predecessor. Returns ``(send_comm, recv_comm, client)`` — close the
    client after the job, the comms via ``net.close()``.

    ``timeout_s`` is ONE overall deadline for the whole wiring (store
    dial, handle exchange, connect, accept, barrier). Refused connects
    and accepts retry with backoff inside the deadline — the peer's
    listener may not be up yet, and fault-injecting planes
    (``transport.faults.FaultNet``) refuse the first k attempts by
    design; what never succeeds surfaces as a named ``TimeoutError``.

    ``ns`` namespaces this ring's store keys: distinct groups sharing one
    long-lived store MUST use distinct namespaces (keys and barrier
    counters persist for the store's lifetime).

    ``failover``: replica handles for the survivable-store rotation
    (DESIGN.md §5n) — a ring wired AFTER a primary's death (a healed
    hierarchy rebuilding its sub-rings) must not hang dialing the dead
    handle. ``fault_schedule``: the seeded chaos schedule whose
    ``store_conn_drop_ops`` sever this client's connection at
    deterministic points of its own RPC stream."""
    deadline = time.monotonic() + timeout_s
    remaining = lambda: max(0.1, deadline - time.monotonic())
    client = BootstrapClient(store_handle, rank, timeout_s, scope=ns,
                             failover=failover,
                             fault_schedule=fault_schedule)
    listener = send_comm = recv_comm = None
    try:
        handle, listener = net.listen()
        handles = client.exchange(f"{ns}/h", handle, n_ranks, remaining())
        send_comm = retry_with_backoff(
            lambda: net.connect(0, handles[(rank + 1) % n_ranks],
                                min(5.0, remaining())),
            remaining(), f"ring wiring: connect to rank {(rank + 1) % n_ranks}",
            retry_on=(ConnectionRefusedError, ConnectionResetError))
        recv_comm = retry_with_backoff(
            lambda: net.accept(listener, min(5.0, remaining())),
            remaining(), f"ring wiring: accept rank {(rank - 1) % n_ranks}",
            retry_on=(ConnectionRefusedError, ConnectionResetError,
                      TimeoutError))
        client.barrier(f"{ns}/wired", n_ranks, remaining())
        # the cross-rank clock-sync mark: every rank exits the wired
        # barrier within one store poll interval, so the flight-trace
        # merger (obs.chrome) aligns rank timelines on this event — the
        # bootstrap handshake doubling as the clock handshake
        _FLIGHT.mark_sync(ns=ns, rank=rank)
    except BaseException as e:
        # a failed wiring must not leak what it made: any half-wired comm,
        # the listener when nothing was ever accepted on it (on the shm
        # plane the listener IS a queue pair holding a segment; once
        # accepted it became recv_comm, closed above — TCP listeners are
        # net-tracked either way), and the store connection. Closes are
        # idempotent, so the net-level close() of registered comms later
        # is a harmless second no-op. The abort leaves a flight event
        # (the analyzer's abort-path rule): which wiring step died is
        # exactly what the next postmortem needs.
        _FLIGHT.record("bootstrap-abort", ns=ns, rank=rank,
                       error=type(e).__name__)
        if send_comm is not None:
            _close_quietly(send_comm)
        if recv_comm is not None:
            _close_quietly(recv_comm)
        elif listener is not None:
            _close_quietly(listener)
        client.close()
        raise
    return send_comm, recv_comm, client
