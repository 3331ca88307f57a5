"""Predictive straggler evasion — the policy engine (DESIGN.md §5m).

A rank that is slow-but-alive drags every ring collective's critical
path long before the watchdog can confirm death: the watchdog's
heartbeat lease only fires on silence, and a degrading host keeps
heartbeating right up to the moment it matters. The causal trace
scoreboard already names the rank that owns the critical path and WHY;
the group holds warm spares and re-wires both planes in place. This
module closes the loop ("act on the scoreboard before the watchdog
does") with a deterministic two-tier policy:

* **Tier 1 — reshape.** A rank chronically cp-dominant (``reshape_strikes``
  consecutive scored windows at or above ``share_threshold``) is rotated
  to the TAIL of the ring neighbour order (epoch-fenced through the same
  ``set_epoch``/rewire path a heal uses), rooted verbs are re-rooted away
  from it (``ProcessGroup.preferred_root``), and its lane credits are
  capped so its frames stop monopolising the gate.
* **Tier 2 — proactive promotion.** Past the harder ``promote_threshold``
  for ``promote_strikes`` consecutive windows — and only when the rank
  was already reshaped AND a live warm spare exists — the degrading rank
  is drained at an op boundary and the spare is promoted into its
  ORIGINAL identity *before* any death confirmation, the promotion
  path driven from the front. The drained rank demotes itself to a
  standby slot.

Replay purity: the engine is a pure function of the trace stream. All
thresholds are committed policy constants (a frozen dataclass), shares
arrive from the windowed scoreboard whose tie-breaks are pinned to the
lowest rank, candidates are scanned in ascending ORIGINAL-rank order,
and at most one action fires per tick. The engine itself runs on rank 0
only; every tick rank 0 broadcasts the decision plus its full state and
all ranks adopt it (the ``tune_wire`` lockstep-commit shape), so a
freshly promoted spare inherits the strike history instead of diverging.
The structural decision log (tick, epoch, action, victim — no
wall-clock fields) feeds ``digest()``, the EVASIONLOG replay check.

Deliberately NOT evaded: ranks that never cross the soft threshold for
``reshape_strikes`` windows in a row (one bad window is weather, not
climate); a second reshape of an already-reshaped rank (it is already
off the critical chain — re-rotating would thrash the epoch); tier-2
promotion when no live unburned spare exists (evasion never shrinks the
world — that is the watchdog/heal's job, with death confirmed);
anything during a window with fewer than ``min_window_ops`` sampled ops
(strikes hold, they neither advance nor reset — no data is not
exoneration); and anything inside the ``settle_ticks`` windows right
after the engine's own action (the first post-reshape window measures
the rewire, not the straggler — scoring it would couple the next
decision's tick to scheduling noise).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json


@dataclasses.dataclass(frozen=True)
class EvasionPolicy:
    """Pure policy constants — committed so decisions are a replay-pure
    function of the trace stream. ``window_ops`` is the scoreboard
    window (last N assembled ops of the current epoch);
    ``share_threshold``/``reshape_strikes`` arm tier 1,
    ``promote_threshold``/``promote_strikes`` arm tier 2;
    ``credit_cap_bytes`` is the lane-credit cap a reshape applies on
    the straggler (the gate shrink)."""

    window_ops: int = 8
    min_window_ops: int = 1
    share_threshold: float = 0.45
    reshape_strikes: int = 2
    promote_threshold: float = 0.60
    promote_strikes: int = 2
    credit_cap_bytes: int = 1 << 16
    # windows to sit out after the engine's OWN action: the first
    # post-reshape window measures the rewire (re-dials, first-op
    # setup), not the steady straggler — its shares smear across
    # ranks, and scoring it would make the NEXT decision's tick a
    # function of scheduling noise instead of the trace stream
    settle_ticks: int = 1


class EvasionEngine:
    """The deterministic straggler scorer. Strikes are keyed by
    ORIGINAL rank (trace records carry current ranks; the caller's
    member list converts), so identities survive reshapes and heals."""

    def __init__(self, policy: EvasionPolicy | None = None):
        self.policy = policy or EvasionPolicy()
        self.tick = 0
        self._soft: dict[int, int] = {}   # consecutive >= share_threshold
        self._hard: dict[int, int] = {}   # consecutive >= promote_threshold
        self._settle = 0                  # post-action windows to sit out
        self.reshaped: set[int] = set()
        self.promoted: set[int] = set()
        self.log: list[dict] = []

    # -- scoring -----------------------------------------------------------

    def observe(self, scoreboard: dict, ranks: list[int],
                spares_free: int) -> dict | None:
        """Score one windowed scoreboard; return the single decision
        this tick warrants (``{"action": "reshape"|"promote",
        "victim": <original rank>, ...}``) or None. ``ranks`` maps
        current index -> original id (``ProcessGroup._ranks``);
        ``spares_free`` gates tier 2."""
        self.tick += 1
        if self._settle > 0:
            # the window right after our own reshape/promote measures
            # the rewire, not the straggler: hold strikes, score nothing
            self._settle -= 1
            return None
        if scoreboard.get("ops", 0) < self.policy.min_window_ops:
            # no sampled ops is not exoneration: hold strikes as-is
            return None
        share = {ranks[int(k)]: v
                 for k, v in scoreboard.get("share", {}).items()
                 if 0 <= int(k) < len(ranks)}
        for g in sorted(ranks):
            s = share.get(g, 0.0)
            self._soft[g] = (self._soft.get(g, 0) + 1
                             if s >= self.policy.share_threshold else 0)
            self._hard[g] = (self._hard.get(g, 0) + 1
                             if s >= self.policy.promote_threshold else 0)
        # ascending ORIGINAL-rank scan = the pinned lowest-rank
        # tie-break; tier 2 outranks tier 1, one action per tick
        for g in sorted(ranks):
            if (self._hard.get(g, 0) >= self.policy.promote_strikes
                    and g in self.reshaped and g not in self.promoted
                    and spares_free > 0):
                return self._decide("promote", g)
        for g in sorted(ranks):
            if (self._soft.get(g, 0) >= self.policy.reshape_strikes
                    and g not in self.reshaped):
                return self._decide("reshape", g)
        return None

    def _decide(self, action: str, victim: int) -> dict:
        decision = {"tick": self.tick, "action": action, "victim": victim}
        # structural log only (no wall-clock fields): two same-seed
        # chaos runs must produce identical digests
        self.log.append(dict(decision))
        if action == "reshape":
            # both counters reset: the reshape gets promote_strikes
            # fresh windows to prove itself before tier 2 escalates
            self.reshaped.add(victim)
            self._soft[victim] = 0
            self._hard[victim] = 0
        else:  # promote: the slot gets fresh hardware — clean slate
            self.promoted.add(victim)
            self.reshaped.discard(victim)
            self._soft[victim] = 0
            self._hard[victim] = 0
        self._settle = self.policy.settle_ticks
        return decision

    # -- lockstep mirroring (rank 0 broadcasts, everyone adopts) -----------

    def state(self) -> dict:
        return {
            "tick": self.tick,
            "soft": dict(self._soft),
            "hard": dict(self._hard),
            "settle": self._settle,
            "reshaped": sorted(self.reshaped),
            "promoted": sorted(self.promoted),
            "log": [dict(e) for e in self.log],
        }

    def adopt(self, state: dict) -> None:
        self.tick = int(state["tick"])
        self._soft = {int(k): int(v) for k, v in state["soft"].items()}
        self._hard = {int(k): int(v) for k, v in state["hard"].items()}
        self._settle = int(state.get("settle", 0))
        self.reshaped = set(state["reshaped"])
        self.promoted = set(state["promoted"])
        self.log = [dict(e) for e in state["log"]]

    def digest(self) -> str:
        """EVASIONLOG: sha256 over the structural decision log."""
        return hashlib.sha256(
            json.dumps(self.log, sort_keys=True).encode()).hexdigest()
