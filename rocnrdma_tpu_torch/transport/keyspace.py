"""Store-key namespace registry — the ONE table the key grammar reads.

Every bootstrap-store key this package mints lives under a group root
(``pg/<group>/``) followed by a REGISTERED namespace token. This module
is the single source of truth for that table (DESIGN.md §6f): the
static key-grammar pass (``tools/analyze/keys.py``) loads it to parse
every key literal in the tree, and the store server's prune guard
(``bootstrap.BootstrapServer._handle``) consults it so a kv sweep can
only ever target a namespace the repo actually mints — a typo'd sweep
prefix deletes nothing instead of silently deleting the wrong thing.

Kept deliberately import-light (stdlib only, no torch): the pure
host-plane modules (bootstrap/plugin/faults) import it and must stay
importable at once, and the analyzer loads it by file path without
running the package ``__init__``.
"""

from __future__ import annotations

GROUP_PREFIX = "pg/"

# namespace token (the segment right after ``pg/<group>/``) -> what
# lives under it. Adding a key family to the code without adding its
# namespace here is a pass-#7 finding — the table and the keyspace
# cannot drift apart.
NAMESPACES = {
    "ring": "rendezvous handles + wired barrier (bootstrap_ring ns; "
            "watchdog and fleet-poller client scope)",
    "nodemap": "host placement map published at init",
    "hier": "hierarchy rendezvous, epoch/gen-scoped "
            "(hier/e<N>/g<G>/{burned,n<i>,x<l>,ready})",
    "heal": "heal rendezvous (heal/e<N>/{alive,members,h,wired})",
    "grow": "grow rendezvous, generation-scoped (grow/g<N>/...)",
    "evade": "straggler-evasion reshape rendezvous (evade/e<N>/...)",
    "hb": "watchdog heartbeat plane (hb/e<N>/{<rank>,dead/<p>,dead_v})",
    "fleet": "fleet telemetry tree (fleet/meta, fleet/e<N>/...)",
    "deviceheal": "device-plane coordinator elections "
                  "(deviceheal/e<N>/coord)",
    "spares": "warm-spare registry ({slot,admit,h}/<sid>)",
    "join": "elastic-grow joiner registry ({slot,admit,h}/<sid>)",
    "split": "split rendezvous, counter-suffixed (split<N>/...)",
    "shrink": "shrink rendezvous, counter-suffixed (shrink<N>/...)",
    "store": "control-plane-of-the-control-plane: replica handle "
             "(store/replica), primary election (store/primary/e<N>), "
             "per-node proxy handles (store/proxy/e<N>/<node>)",
    "destroy": "teardown barrier",
    "e": "epoch-direct keys: barrier waves (e<N>/{b,mb}<i>) and p2p "
         "resume handles (e<N>/p2p/<lo>-<hi>)",
}

# namespaces whose token carries a numeric counter suffix in the key
# itself (``split3``, ``shrink1``, ``e42``) rather than a sub-segment
NUMBERED = frozenset({"split", "shrink", "e"})

# namespaces whose keys are epoch-qualified — minted under the group's
# COMMITTED epoch and swept strictly below it on membership changes
EPOCH_QUALIFIED = frozenset({"hier", "heal", "evade", "hb", "fleet",
                             "deviceheal", "e"})

# the two standby registries (ProcessGroup._scan_standby_registry et al.
# address them through registry_ns, never through raw f-strings)
REGISTRIES = ("spares", "join")

# namespaces whose kv mutations a primary store forwards to its attached
# replica (DESIGN.md §5n): the state an in-flight heal/grow needs to
# COMPLETE after the primary dies — admission registries, rendezvous
# handles, grow generations, the nodemap, and the store plane's own
# election keys. Deliberately NOT replicated: hb (liveness regenerates —
# every surviving client's first post-failover RPC re-stamps it within
# one watchdog tick), fleet/evade/hier/deviceheal/e (telemetry and
# per-epoch scratch; best-effort by contract, re-published next tick or
# re-minted under the next epoch).
REPLICATED = frozenset({"ring", "nodemap", "heal", "grow", "spares",
                        "join", "split", "shrink", "destroy", "store"})


def replicated(key: str) -> bool:
    """True iff a kv mutation on ``key`` must reach the replica before
    the primary acks it (see REPLICATED). Never raises — the server
    consults it per mutation and a malformed key simply isn't critical."""
    if not key.startswith(GROUP_PREFIX):
        return False
    parts = key.split("/")
    if len(parts) < 3:
        return False
    return namespace_of(parts[2]) in REPLICATED


def proxy_local(key: str) -> str | None:
    """Per-node proxy termination rule: which keys a ``NodeProxyStore``
    may serve from its OWN tables instead of forwarding upstream.

    Returns ``"beat"`` for watchdog heartbeat-beat keys
    (``hb/e<N>/<rank>`` — stored locally AND batched upstream in the
    next condensed flush, so cross-node neighbour watching still sees
    them), ``"local"`` for per-rank fleet snapshot keys
    (``fleet/e<N>/<orig>`` — read back only by the node's own agent;
    never forwarded, the agent's tree digest is the condensed upstream
    form), and ``None`` for everything else (forward verbatim). The
    hb plane's shared flags (``dead/<p>``, ``dead_v``) and the fleet
    tree/meta keys are global state every node must see — always
    ``None``."""
    if not key.startswith(GROUP_PREFIX):
        return None
    parts = key.split("/")
    if len(parts) < 4:
        return None
    ns = namespace_of(parts[2])
    if ns == "hb":
        # pg/<g>/hb/e<N>/<rank> is a beat; dead/<p> and dead_v are global
        if len(parts) == 5 and parts[4].isdigit():
            return "beat"
        return None
    if ns == "fleet":
        # pg/<g>/fleet/e<N>/<orig> is node-local; tree/<i> and meta are
        # the condensed/global layer (chunk parts inherit the base key's
        # locality so a chunked snapshot stays whole on one store)
        base = key.split("#chunk/", 1)[0]
        bparts = base.split("/")
        if len(bparts) == 5 and bparts[3].startswith("e") \
                and bparts[4].isdigit():
            return "local"
        return None
    return None


def namespace_of(token: str) -> str:
    """The registry head of a key's namespace token (``split3`` ->
    ``split``; ``fleet`` -> ``fleet``). Pure string surgery — no
    registration check."""
    head = token.rstrip("0123456789")
    return head


def is_registered(token: str) -> bool:
    """True iff ``token`` is a registered namespace token: a bare entry
    of NAMESPACES, or a NUMBERED entry with its counter suffix."""
    head = namespace_of(token)
    if head not in NAMESPACES:
        return False
    if head != token and head not in NUMBERED:
        return False  # "ring3" is not a namespace, "split3" is
    return True


def check_key(key: str) -> str:
    """Validate a full store key (or sweep prefix) against the table and
    return its namespace head. Raises ``ValueError`` — a named error, so
    a caller minting an unregistered key dies loudly at mint time, not
    as an orphaned store entry nobody ever reads."""
    if not key.startswith(GROUP_PREFIX):
        raise ValueError(f"store key {key!r} is outside the "
                         f"{GROUP_PREFIX!r} root")
    parts = key.split("/")
    if len(parts) < 3 or not parts[1]:
        raise ValueError(f"store key {key!r} has no namespace segment "
                         f"(want pg/<group>/<namespace>/...)")
    token = parts[2]
    if not is_registered(token):
        raise ValueError(
            f"store key {key!r} uses unregistered namespace {token!r} "
            f"(registered: {sorted(NAMESPACES)}; add it to "
            f"transport/keyspace.py NAMESPACES or fix the key)")
    return namespace_of(token)


def registry_ns(group: str, sub: str) -> str:
    """The standby-registry root for ``sub`` ("spares" or "join") — the
    sanctioned constructor for the one key family whose namespace segment is
    a runtime variable."""
    if sub not in REGISTRIES:
        raise ValueError(f"unknown standby registry {sub!r} "
                         f"(know {REGISTRIES})")
    return f"{GROUP_PREFIX}{group}/{sub}"


def sweepable(sub_prefix: str, prefix: str) -> bool:
    """The server-side prune-guard predicate: a kv sweep prefix must sit
    under the caller's declared group prefix AND name a registered
    namespace. Never raises — the store serves many group generations
    and must not let one malformed request kill the serve thread."""
    if not (prefix and sub_prefix.startswith(prefix)):
        return False
    token = sub_prefix[len(prefix):].split("/", 1)[0]
    return is_registered(token)
