"""Algorithm selection: the alpha-beta cost model and the measured autotuner.

Counterpart of the device half of ``rocnrdma_tpu/transport/tuner.py``:

- ``model_time(verb, algo, n, nbytes, alpha, beta, hbm_beta)`` - the
  three-term cost of each explicit schedule of ``collectives/``,
  ``T = steps * alpha + wire * S * beta + hbm * S * hbm_beta``, priced as
  the schedules are implemented; ``model_pick`` takes the cheapest, with
  ``fused_model_time`` pricing the library call. ``khd_model_digits`` is the
  radix ladder's pick of khd's digits, which ``Transport`` dispatches.
- ``Autotuner.sweep(...)`` - times every compatible arm at a size grid on
  a live ``Transport`` and keeps the winners.
- ``TuningTable`` - persisted winners (the reference's JSON layout),
  consulted by ``Transport(tuning=...)`` under ``algo="auto"``.
  ``model_table`` derives one from the model instead of a sweep.

Constants (``constants_for``): on a card with a ``hw.CHIPS`` row, alpha is
the measured per-launch dispatch time and the betas come from the card's
HBM rate times its measured fraction. With every rank on one card, which
is the port's layout, no byte crosses NVLink: a wire byte is a copy in
device memory (read once, written once), and all the card's ranks share
its one memory, so both betas scale with the ranks on the card. A mesh of
one rank per card takes the NVLink data-sheet figure (per direction) and
the hop latency. On any other device (``cpu`` among them) the generic
``ALPHA_S``/``BETA_S_PER_B`` and no HBM term price it: ranking ratios, as
in the reference, so the CPU's picks equal the reference's.

The fold ladder (``hw.fold_rate_scale``) is measured on the fold the
port's schedules run: w-1 pairwise in-place adds, where the reference's
XLA fuses a w-operand fold. The reference's HBM formulas stay; the ladder
carries the difference (its scale rises above 1 with the width).

Size keys are the bench sweeps' ``size_bytes`` (``Transport._msg_bytes``):
the message size S per rank; for allgather the gathered total.

CLI: ``python -m rocnrdma_tpu_torch.transport.tuner`` sweeps (or, with
``--model-table KIND``, models) and writes a table; ``--measure-alpha``
measures the dispatch alpha. Under a launcher (``runtime.multiprocess.
run_cli`` or torchrun) it runs across the fleet's processes, one rank a
process: the sweep on ``rank_mesh(world, group=WORLD)``, each point's
time the slowest rank's (so every rank keeps the same winners), its table
keyed by the layout (``table_platform``); ``--measure-alpha`` the median
of the ranks' medians, written once. Rank 0 prints and writes. Each
sweep also prints the cost model's pick beside every winner
(``policy_agreement``).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import sys

from rocnrdma_tpu_torch import lockwitness as _lockwitness

# Generic constants (seconds, seconds/byte) for a device without a hw.CHIPS
# row: the reference's ranking ratios, not any device's figures. Every
# ranking rests on alpha/beta (the latency-bandwidth crossover), not on the
# absolute scale.
ALPHA_S = 1.5e-6
BETA_S_PER_B = 1.0e-11

# verbs whose schedules also fold (pay an HBM combine term)
_REDUCING_VERBS = frozenset({"allreduce", "reduce_scatter", "reduce"})


def constants_for(device_kind: str, verb: str | None = None,
                  ranks_per_card: int = 1,
                  dispatch_alpha: float | None = None
                  ) -> tuple[float, float, float]:
    """(alpha, beta, hbm_beta) for this device, or the generics.

    ``ranks_per_card``: how many of the mesh's ranks share one card. Above
    1 every wire byte is a device-memory copy (2 HBM bytes) and every byte
    of each of those ranks goes through the one memory, so beta is
    ``2 * ranks_per_card / rate`` and hbm_beta ``ranks_per_card / rate``
    (``rate``: datasheet HBM times the measured fraction), and alpha is the
    dispatch alone. At 1, beta is one NVLink direction's data-sheet rate
    and alpha adds the hop latency. hbm_beta is nonzero only for the
    reducing verbs. ``dispatch_alpha`` overrides the measured dispatch
    component (the alpha-sensitivity audit's knob)."""
    from rocnrdma_tpu_torch import hw

    chip = hw.chip_for(device_kind)
    if chip is None:
        return ALPHA_S, BETA_S_PER_B, 0.0
    disp = hw.dispatch_alpha_s(device_kind) if dispatch_alpha is None else dispatch_alpha
    rate = chip.hbm_GBps * hw.hbm_frac(device_kind) * 1e9
    hbm_beta = ranks_per_card / rate if verb in _REDUCING_VERBS else 0.0
    if ranks_per_card > 1:
        return disp, 2.0 * ranks_per_card / rate, hbm_beta
    return chip.link_hop_s + disp, 1.0 / (chip.link_GBps / 2 * 1e9), hbm_beta


def dcn_constants_for(device_kind: str) -> tuple[float, float]:
    """(alpha, beta) of one cross-node hop: the price the 2-D mesh's slice
    axis pays when it crosses the network (the card's NIC data-sheet rate
    and hop latency). A device without a ``hw.CHIPS`` row has no network
    figure: its slice axis is priced like the others, with the generics."""
    from rocnrdma_tpu_torch import hw

    chip = hw.chip_for(device_kind)
    if chip is None:
        return ALPHA_S, BETA_S_PER_B
    return (chip.nic_hop_s + hw.dispatch_alpha_s(device_kind),
            1.0 / (chip.nic_GBps * 1e9))


def measure_alpha(size_bytes: int = 4096, k1: int = 512, k2: int = 4096,
                  repeats: int = 5, trials: int = 3, device=None) -> float:
    """The per-launch dispatch alpha on ``device`` (default: the GPU): the
    chained marginal seconds per op of a tiny in-place add
    (``timing.marginal_s_per_op``). At 4 KiB the add's memory time is a
    few nanoseconds, so the marginal is what one launch costs the card's
    caller, the host's enqueue included when the card waits on it. A
    schedule step of the port is several such launches (the ring takes four
    copies a step), so this is a lower bound on a step's alpha."""
    import numpy as np
    import torch

    from rocnrdma_tpu_torch.bench.timing import marginal_s_per_op
    from rocnrdma_tpu_torch.runtime.mesh import resolve_device

    dev = resolve_device() if device is None else torch.device(device)
    rng = np.random.default_rng(0)
    elems = max(1, size_bytes // 4)
    x, b = (torch.from_numpy(rng.standard_normal(elems, dtype=np.float32)).to(dev)
            for _ in range(2))

    def mk(k):
        def chain(x, b):
            for _ in range(k):
                x.add_(b)
        return chain

    return marginal_s_per_op(mk, (x, b), k1, k2, repeats, trials)


# ---------------------------------------------------------------------------
# The khd radix model and the schedule prices (the reference's, verbatim in
# their arithmetic, so the CPU's floats are bitwise the reference's).

# ---------------------------------------------------------------------------
# Host-plane wire model  — the measure→model→pick loop closed
# on the host plane, the way the radix-ladder model above closes it on
# the device plane. ONE fitted alpha-beta-per-plane model now owns every
# host tuning constant: the streaming wire's frame_bytes / pipeline_depth
# (replacing the static negotiated MAX_FRAME/LG_CHUNK constants in
# ``_RingWire``), the LG-vs-frame-path cutover (a frame past LG_MIN IS
# the put path), and the coalescer's bucket_bytes pick (whose earlier
# hand-set alpha/beta are absorbed as this model's SEED constants).
#
# The per-hop cost of streaming S bytes at frame F, posting window D:
#
#   t_hop(S, F, D) = alpha_hop                        (hop latency floor)
#                  + nf * alpha_frame                 (per-frame CPU work:
#                                                      pack/post/poll)
#                  + nf * alpha_lg · [lg]             (the put path's EXTRA
#                                                      per-frame round:
#                                                      iwrite + descriptor
#                                                      frame + credit ACK —
#                                                      the term that prices
#                                                      the LG-vs-frame-path
#                                                      CUTOVER; the
#                                                      reference's first
#                                                      sweep found the
#                                                      frame path faster
#                                                      for 512 KiB hops)
#                  + S * beta * (1 + stall_x·[lg])    (serialized wire; the
#                                                      credit-stall penalty
#                                                      inflates put-path
#                                                      candidates only — the
#                                                      arena credit is where
#                                                      stalls live)
#                  + (S/nf) * consume * (1+recv_x)/D  (the consume/fold
#                                                      remainder no earlier
#                                                      frame can hide; a
#                                                      deeper posting window
#                                                      overlaps it across
#                                                      hops)
#
#   with nf = ceil(S/F), [lg] = 1 iff F >= LG_MIN.  Larger frames shrink
#   the nf·alpha_frame term, smaller frames shrink the remainder, and
#   the alpha_lg surcharge decides where the put path earns its bulk
#   copy — the interior optimum one static frame cannot hit at all
#   sizes on both planes.
#
# Fitting: ``fit_host_rows`` least-squares the four coefficients per
# plane from bench_host --sweep rows (size × frame ladder, spread
# recorded); ``HostWireModel.refit_attribution`` is the ONLINE half —
# the causal stall shares {credit-stall, recv-wait} become the
# quantized stall_x / recv_x biases (credit-stall-dominant → the put
# path's candidates price worse, so picks move to deeper pipelines and
# frame-path frames; recv-wait-dominant → the consume remainder prices
# worse, so picks move to smaller frames).
#
# Determinism: every pick is a PURE function of (inputs, committed model
# version) — no clock, no RNG, no environ at pick time (the analyzer's
# purity pass pins this). Versions bump only at epoch-style commit
# points (``ProcessGroup.tune_wire``'s broadcast commit; ``set_epoch``
# fences stale pending proposals), each recorded as a flight event, so
# same-seed chaos runs replay equal with auto-tuning ON.
# ---------------------------------------------------------------------------

# SEED constants (version-0 model): the reference's hand readings of its
# first bench_host record, fitted as one alpha/beta ring — kept as the
# seed, never the port's measurement (COMMITTED_HOST_PLANES below is the
# card machine's own fit, and it supersedes the seed). These live HERE
# and nowhere else: pick_bucket_bytes and the wire's frame defaults both
# read whatever model is committed, seed or fitted (the second
# hand-set copy is gone).
HOST_ALPHA_S = 3.0e-4       # seed per-hop host-wire latency floor (seconds)
HOST_BETA_GBPS = 0.4        # seed steady large-message host wire rate (GB/s)
HOST_FRAME_ALPHA_S = 1.5e-4  # seed per-frame CPU work (one pack+post+poll
#                              round — the documented dominant msg-plane
#                              cost, the reason MAX_FRAME grew to 512 KiB
#                              in r3 and ring hops to 4 MiB puts in r4;
#                              the seed keeps the pick at those shapes
#                              until a sweep fit says otherwise)
HOST_CONSUME_S_PER_B = 1.0e-10  # seed per-byte land/fold remainder (the
#                                 memcpy+fold — the numpy in-place add rate)
HOST_LG_ALPHA_S = 2.5e-4    # seed EXTRA per-frame cost of a put-path frame
#                             (iwrite + descriptor + credit round) — sized
#                             so the seed cutover sits where the first
#                             sweep measured it: frame path wins 512 KiB
#                             hops, single puts win multi-MiB hops
HOST_CODEC_S_PER_B = 1.3e-9  # seed encode+decode CPU cost per DECODED byte
#                              of the reference (int8) wire codec — the
#                              compressed-beta term pick_codec weighs the
#                              wire saving against. The reference's
#                              seed (its int8 encode + decode in numpy,
#                              the scale pass and per-frame Python). Sized
#                              so the seed pick matches the reference's
#                              measurement: compression loses on shm
#                              under its committed beta (1.5e-9: saving
#                              1.1 ns/B < 1.3 cost) and wins on tcp (beta
#                              2.1e-9: saving 1.6 > 1.3)
#                              — off where beta is cheap, on for the slow
#                              leg. Other codecs scale this by their
#                              measured codec.COST_FACTOR (fp8's
#                              torch conversion, measured on the
#                              card machine's host).
BUCKET_CANDIDATES = tuple(1 << p for p in range(17, 25))  # 128 KiB..16 MiB


@dataclasses.dataclass(frozen=True)
class PlaneParams:
    """One plane's fitted wire coefficients (immutable: a committed
    model version is a value, never mutated in place)."""

    alpha_hop_s: float = HOST_ALPHA_S
    alpha_frame_s: float = HOST_FRAME_ALPHA_S
    alpha_lg_s: float = HOST_LG_ALPHA_S
    beta_s_per_b: float = 1.0 / (HOST_BETA_GBPS * 1e9)
    consume_s_per_b: float = HOST_CONSUME_S_PER_B
    stall_x: float = 0.0    # credit-stall bias on LG-path candidates
    recv_x: float = 0.0     # recv-wait bias on the consume remainder
    codec_s_per_b: float = HOST_CODEC_S_PER_B  # compressed-beta term:
    #                         encode+decode cost per decoded byte of the
    #                         reference wire codec (pick_codec weighs it
    #                         against the wire-byte saving per plane)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "PlaneParams":
        return cls(**{f.name: float(d[f.name])
                      for f in dataclasses.fields(cls) if f.name in d})


@dataclasses.dataclass(frozen=True)
class WirePick:
    """One per-call wire decision: the frame size, the posting-window
    depth, whether the frame rides the put (LG) path, and the model
    version it was derived from (on the record, so a regression is
    attributable to a model change, not just observable)."""

    frame_bytes: int
    pipeline_depth: int
    lg: bool
    version: int


class HostWireModel:
    """The host plane's committed wire model: per-plane coefficients +
    a version counter that bumps only at commit points.

    Thread discipline: picks read one immutable ``(version, params)``
    snapshot (a single attribute load — the hot path pays no lock);
    commits/fences swap the snapshot under the model lock and record a
    flight event. Proposals carry the version they were fitted AGAINST
    and commit only if that version is still current — a stale proposal
    (e.g. computed before a heal's epoch fence) is dropped, named.
    """

    # the frame ladder picks choose from: the frame path's sizes up to
    # MAX_FRAME, then the put-path (LG) chunks; capped at 8 MiB so two
    # credit windows always fit the 16 MiB LG arena. The exact
    # MAX_FRAME payload (plugin.HostQPNet.MAX_FRAME) is represented by
    # its 512 KiB-minus-header value — the largest single-frame post.
    FRAME_LADDER = (64 << 10, 128 << 10, 256 << 10, (1 << 19) - 12,
                    1 << 20, 2 << 20, 4 << 20, 8 << 20)
    DEPTH_LADDER = (2, 3, 4)   # the cross-hop posting window; 2 is the
    #                            engine's structural double buffer, the
    #                            pick only ever deepens it
    PICK_TOL = 1.05            # smallest-within-5%-of-best (flat optima
    #                            resolve to the cheaper-memory choice,
    #                            deterministically)

    def __init__(self, plane: str, params: PlaneParams | None = None,
                 lg_min: int | None = None, lg_arena: int | None = None,
                 enabled: bool = True, pin_frame: int | None = None,
                 pin_depth: int | None = None, table=None):
        self.plane = plane
        # plugin constants, importable without a cycle: default to the
        # HostQPNet values ((1<<19)-12 frame cap → LG_MIN just past it)
        self.lg_min = (1 << 19) - 11 if lg_min is None else int(lg_min)
        self.lg_arena = 16 << 20 if lg_arena is None else int(lg_arena)
        self.enabled = enabled
        # operator pins (bench sweep corpus knobs): a pinned frame/depth
        # short-circuits the pick — resolved at CONSTRUCTION (env reads
        # happen in host_wire_model, never at pick time)
        self.pin_frame = pin_frame
        self.pin_depth = pin_depth
        # whether the 2-rank exchange-and-fold schedule may be picked
        # (plugin._prefer_exchange_fold consults this): resolved at
        # construction like every env knob (ROCNRDMA_WIRE_XFOLD=0 —
        # the sweep corpus pins it off so fitted rows measure the
        # generic ring shape the fit's hop conversion assumes)
        self.exchange_fold = True
        # MEASURED pick table: sorted [(max_hop_bytes, frame_bytes)]
        # buckets of sweep winners (``measured_winners``). Within its
        # range the table supersedes the analytic model — the same
        # precedence the device plane gives the Autotuner sweep over
        # model_table; beyond it the fitted model extrapolates. Part
        # of the committed artifact (save/load_host_model), fixed at
        # construction like the pins.
        self.table = sorted((int(mx), int(f)) for mx, f in (table or ()))
        self._lock = _lockwitness.make_lock("tuner.py::HostWireModel._lock")
        # THE committed snapshot picks read: (version, params, epoch)
        self._state = (0, params or PlaneParams(), 0)
        self._pending: tuple | None = None  # (base_version, params, note)

    # -- read side (pure; the pick surface) --------------------------------

    @property
    def version(self) -> int:
        return self._state[0]

    @property
    def params(self) -> PlaneParams:
        return self._state[1]

    def _is_lg(self, frame_bytes: int, nbytes: int) -> bool:
        """Whether posts at this (frame, message) ride the put path —
        decided by the ACTUAL post size min(frame, message)."""
        return min(max(1, int(frame_bytes)),
                   max(1, int(nbytes))) >= self.lg_min

    def hop_time(self, nbytes: int, frame_bytes: int, depth: int,
                 params: PlaneParams | None = None,
                 codec: tuple | None = None) -> float:
        """Modeled seconds for one ring hop of ``nbytes`` at this frame
        and posting window — the formula in the section comment. Pure
        function of its arguments and the committed params.

        ``codec``: None (uncompressed), or ``(itemsize, cost_factor,
        hdr_bytes)`` — the compressed arm: the serialized wire bytes
        shrink to one per element (plus the per-frame scale header),
        and every decoded byte additionally pays the compressed-beta
        term ``codec_s_per_b * cost_factor`` (the encode+decode CPU
        work). The LG-vs-frame cutover is decided on the WIRE sizes —
        what actually posts."""
        p = self.params if params is None else params
        S = max(1, int(nbytes))
        F = max(1, int(frame_bytes))
        nf = -(-S // F)
        # the per-frame work scales with what a frame CARRIES: a
        # sub-frame tail (the 12-byte remainder a header-adjusted
        # frame leaves on a power-of-two hop) costs its byte share of
        # the pack/post/poll round, not a full one — integral pricing
        # made the model prefer schedules that merely avoid tails
        nf_alpha = max(1.0, S / F)
        codec_s = 0.0
        if codec is not None:
            itemsize, cost_x, hdr = codec
            S_wire = S // max(1, int(itemsize)) + nf * int(hdr)
            F_wire = F // max(1, int(itemsize)) + int(hdr)
            codec_s = S * p.codec_s_per_b * float(cost_x)
        else:
            S_wire, F_wire = S, F
        # the path is decided by the ACTUAL post size (a frame cap past
        # the message still posts message-sized frames): min(F, S)
        lg = min(F_wire, S_wire) >= self.lg_min
        per_frame = p.alpha_frame_s + (p.alpha_lg_s if lg else 0.0)
        wire = S_wire * p.beta_s_per_b * (1.0 + (p.stall_x if lg else 0.0))
        remainder = (S / nf) * p.consume_s_per_b * (1.0 + p.recv_x) \
            / max(1, depth)
        return (p.alpha_hop_s + nf_alpha * per_frame + wire + remainder
                + codec_s)

    def pick(self, nbytes: int, world: int = 2,
             credit_bytes: int | None = None) -> WirePick:
        """The per-call wire pick for a message/hop of ``nbytes`` on
        this plane: cheapest modeled (frame, depth) over the ladders,
        ties broken smallest-first (frame, then depth) within PICK_TOL
        — so a flat optimum resolves deterministically to the choice
        holding the least memory. ``credit_bytes`` (the lane's pacing
        quantum) caps the frame exactly as the lane gate caps the wire
        quantum; ``world`` bounds the depth (a ring of H hops cannot
        post deeper than H — the engine clamps again at stream time).

        PURE function of (inputs, committed model version): same inputs
        and version give the same pick on every rank, which is what
        keeps both ends' frame tags in agreement (the analyzer's purity
        pass pins that no clock/RNG/environ sneaks in here)."""
        state = self._state  # one atomic snapshot: version+params agree
        version, p = state[0], state[1]
        if not self.enabled:
            # tuning OFF: the legacy static pick (LG_CHUNK on put-capable
            # planes), depth 2 — the earlier wire, named
            f = 4 << 20 if self.lg_arena else (1 << 19) - 12
            if credit_bytes:
                f = max(1, min(f, credit_bytes))
            return WirePick(f, 2, self._is_lg(f, nbytes), version)
        if self.pin_frame is not None:
            f = int(self.pin_frame)
            d = int(self.pin_depth) if self.pin_depth is not None else 2
            if credit_bytes:
                f = max(1, min(f, credit_bytes))
            return WirePick(f, d, self._is_lg(f, nbytes), version)
        # the measured table first (sweep winners supersede the model
        # inside the swept range — the Autotuner-over-model_table
        # precedence, host edition); the analytic ladder handles sizes
        # past the largest swept bucket
        for mx, f in self.table:
            if nbytes <= mx:
                if credit_bytes:
                    f = max(1, min(f, credit_bytes))
                d = int(self.pin_depth) if self.pin_depth is not None \
                    else 2
                return WirePick(f, d, self._is_lg(f, nbytes), version)
        cands = [f for f in self.FRAME_LADDER if f <= self.lg_arena // 2]
        if credit_bytes:
            cands = [min(f, credit_bytes) for f in cands]
        max_depth = max(2, min(max(self.DEPTH_LADDER),
                               2 * (max(2, world) - 1)))
        best = None
        best_t = float("inf")
        for f in sorted(set(cands)):
            for d in (d for d in self.DEPTH_LADDER if d <= max_depth):
                t = self.hop_time(nbytes, f, d, p)
                if t < best_t:
                    best, best_t = (f, d), t
        # smallest-within-tolerance: walk the ladder in (frame, depth)
        # order and take the first candidate within PICK_TOL of best
        for f in sorted(set(cands)):
            for d in (d for d in self.DEPTH_LADDER if d <= max_depth):
                if self.hop_time(nbytes, f, d, p) <= self.PICK_TOL * best_t:
                    if self.pin_depth is not None:
                        d = int(self.pin_depth)
                    return WirePick(f, d, self._is_lg(f, nbytes), version)
        f, d = best  # unreachable in practice (best is within its own tol)
        return WirePick(f, d, self._is_lg(f, nbytes), version)

    def pick_codec(self, nbytes: int, itemsize: int,
                   world: int = 2) -> str | None:
        """The per-call COMPRESSION pick for a hop of ``nbytes`` of
        ``itemsize``-byte elements on this plane: the cheapest wire
        codec (``transport.codec.WIRE_CODECS``, in that deterministic
        order) whose best modeled hop time — encoded wire bytes under
        this plane's beta plus the compressed-beta encode/decode term
        — beats the best UNCOMPRESSED hop time; None when compression
        does not pay (the seeds place that where the reference measured
        it: off on shm where beta is cheap, on for the slow tcp leg).

        PURE function of (inputs, committed model version), like every
        pick: a lane's ``codec="auto"`` knob resolves through this on
        every rank from the same (size_key, dtype, world, version), so
        both ends of every hop chunk AND decode identically — the
        purity pass pins it and the broadcast-commit version rules
        govern when the answer may change."""
        if not self.enabled or int(itemsize) <= 0:
            return None
        from rocnrdma_tpu_torch.transport import codec as _codec
        p = self._state[1]
        cands = sorted({f for f in self.FRAME_LADDER
                        if f <= self.lg_arena // 2})
        max_depth = max(2, min(max(self.DEPTH_LADDER),
                               2 * (max(2, world) - 1)))
        depths = [d for d in self.DEPTH_LADDER if d <= max_depth]

        def best(codec_tuple):
            return min(self.hop_time(nbytes, f, d, p, codec=codec_tuple)
                       for f in cands for d in depths)

        name, t = None, best(None)
        for cand in _codec.WIRE_CODECS:
            tc = best((int(itemsize), _codec.COST_FACTOR[cand], _codec.HDR))
            if tc < t:
                name, t = cand, tc
        return name

    # -- write side (commit points only) -----------------------------------

    def propose(self, params: PlaneParams, note: str = "") -> int:
        """Stage a refit computed against the CURRENT version; returns
        that base version (the commit token). A later ``commit`` with
        this token applies it; an epoch fence in between drops it."""
        with self._lock:
            base = self._state[0]
            self._pending = (base, params, note)
            return base

    def commit(self, params: PlaneParams, base_version: int,
               note: str = "") -> int | None:
        """Commit ``params`` fitted against ``base_version``: bumps the
        model version and records the ``tuner-commit`` flight event.
        Returns the NEW version, or None when the base is stale (an
        epoch fence or another commit landed in between) — the stale
        proposal is dropped, named on the flight timeline."""
        from rocnrdma_tpu_torch.obs import FLIGHT
        with self._lock:
            cur, _p, epoch = self._state
            if base_version != cur:
                FLIGHT.record("tuner-stale", plane=self.plane,
                              base=base_version, version=cur)
                return None
            new = cur + 1
            self._state = (new, params, epoch)
            self._pending = None
        FLIGHT.record("tuner-commit", plane=self.plane, version=new,
                      note=note)
        return new

    def commit_pending(self) -> int | None:
        """Commit the staged proposal, if it survived (same semantics
        as :meth:`commit`); None when nothing is pending or it went
        stale."""
        with self._lock:
            pending = self._pending
        if pending is None:
            return None
        return self.commit(pending[1], pending[0], pending[2])

    def fence_epoch(self, epoch: int) -> None:
        """The epoch-change fence (wired into the net's ``set_epoch``,
        so every heal/grow crosses it): a pending proposal computed
        under the old generation is dropped — its attribution window
        mixes pre-heal wiring — and the fence lands on the flight
        timeline. The COMMITTED model survives (it was agreed at a
        protocol point; membership change does not un-fit it)."""
        from rocnrdma_tpu_torch.obs import FLIGHT
        with self._lock:
            version, params, old = self._state
            if old == int(epoch):
                return
            self._state = (version, params, int(epoch))
            dropped = self._pending is not None
            self._pending = None
        FLIGHT.record("tuner-fence", plane=self.plane, epoch=int(epoch),
                      version=version, dropped_pending=dropped)

    # -- the online refit (pure; tune_wire broadcasts + commits it) --------

    REFIT_QUANTUM = 0.05  # stall shares quantize to 5% steps: two ranks
    #                       reading marginally different windows still
    #                       derive the same biases

    def refit_attribution(self, shares: dict,
                          params: PlaneParams | None = None) -> PlaneParams:
        """New params from a trace-attribution window (the causal tracer's
        five-bucket shares, fractions of op wall): the credit-stall
        share becomes the put-path bias ``stall_x`` (stall-dominant →
        LG candidates price worse → picks move toward deeper pipelines
        and frame-path frames), the recv-wait share becomes the consume
        bias ``recv_x`` (recv-wait-dominant → the remainder prices
        worse → picks move toward smaller frames). Shares quantize to
        ``REFIT_QUANTUM`` so the refit is stable against window noise.
        Pure: returns the params, commits nothing."""
        p = self.params if params is None else params
        q = self.REFIT_QUANTUM

        def quant(x):
            return round(min(1.0, max(0.0, float(x))) / q) * q

        stall = quant(shares.get("credit-stall", 0.0))
        recv = quant(shares.get("recv-wait", 0.0))
        # the bias scale: a bucket owning the whole wall doubles its
        # term's price — strong enough to move a pick across one ladder
        # step, bounded enough never to leave the ladder
        return dataclasses.replace(p, stall_x=round(2.0 * stall, 6),
                                   recv_x=round(2.0 * recv, 6))

    # -- introspection / persistence ---------------------------------------

    def block(self) -> dict:
        """The ``tuner`` block for wire_stats()/bench records: the
        committed version, the plane's coefficients, and the knobs."""
        version, p, epoch = self._state
        return {"plane": self.plane, "version": version, "epoch": epoch,
                "enabled": self.enabled,
                "pinned": {"frame_bytes": self.pin_frame,
                           "depth": self.pin_depth},
                "table": [[mx, f] for mx, f in self.table],
                "params": {k: float(v) for k, v in p.to_dict().items()}}


def fit_host_rows(rows, seed: PlaneParams | None = None
                  ) -> dict[str, PlaneParams]:
    """Least-squares fit of the per-plane wire coefficients from a
    bench sweep corpus — the offline half of the loop. ``rows`` are
    bench_host-shaped dicts; each must carry ``plane`` ("shm"/"tcp"),
    ``size_bytes`` (the collective's buffer), ``n_ranks``, ``mean_s``,
    and the ``frame_bytes`` the row ran at (the sweep's pinned knob);
    ``pipeline_depth`` when the sweep varied the posting window (the
    depth axis — without depth-varied rows the consume/depth
    coefficient is only identified through the frame ladder's nf
    variation, which is exactly the weak identification the ROADMAP
    carried; absent rows fit at the engine default 2). Rows are
    converted to per-hop observations via the ring shape (2(n-1) hops
    of S/n bytes) and regressed on the model's features
    ``[1, nf, nf·[lg], S_hop, S_hop/nf/depth]`` — the lg column is what
    lets the fit place the put-path cutover where the corpus measured
    it.

    Fallback ladder, each step NAMED in the returned params' fit note
    (see ``fit_note``):

    - >= 5 rows on a plane → the full least-squares fit (coefficients
      clamped non-negative; a clamped fit refits the surviving terms);
    - 1..4 rows → proportional calibration: the seed shape scaled by
      the median measured/predicted ratio (a single point cannot
      separate five coefficients — it should not pretend to);
    - 0 rows → the seed constants unchanged (empty corpus falls back
      to the current defaults, named).

    Pure function of its inputs; plane keys never bleed into each
    other (conflicting planes fit independently)."""
    import numpy as np

    seed = seed or PlaneParams()
    lg_min = HostWireModel("_fit").lg_min
    by_plane: dict[str, list] = {}
    for r in rows:
        plane = r.get("plane")
        if plane is None:
            raise ValueError(f"fit_host_rows: row without a plane: {r}")
        by_plane.setdefault(plane, []).append(r)
    out: dict[str, PlaneParams] = {}
    for plane, rs in sorted(by_plane.items()):
        feats, ts = [], []
        for r in rs:
            n = max(2, int(r["n_ranks"]))
            hops = 2 * (n - 1)
            s_hop = max(1, int(r["size_bytes"]) // n)
            f = max(1, int(r.get("frame_bytes") or 4 << 20))
            nf = -(-s_hop // f)
            lg = 1.0 if min(f, s_hop) >= lg_min else 0.0
            # the consume column carries the SAME /depth divisor
            # hop_time applies — the row's OWN pinned posting depth
            # when the sweep varied it (the depth axis is what
            # separates the consume coefficient from the per-frame
            # alpha), the engine default 2 otherwise — so the fitted
            # coefficient means what hop_time(…, depth) later assumes
            depth = max(1, int(r.get("pipeline_depth") or 2))
            # fractional per-frame column, matching hop_time's pricing
            # (a tail frame costs its byte share)
            nf_alpha = max(1.0, s_hop / f)
            feats.append([1.0, nf_alpha, nf_alpha * lg, float(s_hop),
                         float(s_hop) / nf / depth])
            ts.append(float(r["mean_s"]) / hops)
        if len(rs) >= 5:
            A = np.asarray(feats)
            b = np.asarray(ts)
            coef, *_ = np.linalg.lstsq(A, b, rcond=None)
            # non-negativity: a negative coefficient is the regression
            # borrowing one term against another — zero it and refit
            # the surviving columns so the model stays physical
            keep = [i for i, c in enumerate(coef) if c > 0]
            if len(keep) < len(coef) and keep:
                sub, *_ = np.linalg.lstsq(A[:, keep], b, rcond=None)
                coef = np.zeros(A.shape[1])
                for i, c in zip(keep, np.maximum(sub, 0.0)):
                    coef[i] = c
            coef = np.maximum(coef, 0.0)
            floor = 1e-12  # a zero beta would divide a later bucket pick
            out[plane] = PlaneParams(
                alpha_hop_s=max(floor, float(coef[0])),
                alpha_frame_s=max(floor, float(coef[1])),
                alpha_lg_s=float(coef[2]),
                beta_s_per_b=max(floor, float(coef[3])),
                consume_s_per_b=max(floor, float(coef[4])),
                stall_x=seed.stall_x, recv_x=seed.recv_x,
                codec_s_per_b=seed.codec_s_per_b)
        else:
            # proportional calibration off the seed shape
            model = HostWireModel(plane, params=seed)
            ratios = sorted(
                t / model.hop_time(
                    max(1, int(r["size_bytes"]) // max(2, int(r["n_ranks"]))),
                    int(r.get("frame_bytes") or 4 << 20),
                    max(1, int(r.get("pipeline_depth") or 2)))
                for r, t in zip(rs, ts))
            scale = ratios[len(ratios) // 2]
            out[plane] = PlaneParams(
                alpha_hop_s=seed.alpha_hop_s * scale,
                alpha_frame_s=seed.alpha_frame_s * scale,
                alpha_lg_s=seed.alpha_lg_s * scale,
                beta_s_per_b=seed.beta_s_per_b * scale,
                consume_s_per_b=seed.consume_s_per_b * scale,
                stall_x=seed.stall_x, recv_x=seed.recv_x,
                codec_s_per_b=seed.codec_s_per_b)
    return out


def measured_winners(rows) -> dict[str, list]:
    """The sweep's MEASURED pick table per plane: for every swept hop
    size, the frame whose trials were robustly fastest — scored by the
    spread's LOWER bound when the row carries one (maximize the worst
    trial: a noisy arm's lucky best cannot win a bucket), by the mean
    algbw otherwise; ties break to the smaller frame. Returns
    ``{plane: [(max_hop_bytes, frame_bytes), ...]}`` sorted by bucket
    edge, adjacent same-frame buckets collapsed — the ``table`` the
    committed :class:`HostWireModel` consults before the analytic
    ladder. Pure function of its rows."""
    by_point: dict[tuple, list] = {}
    for r in rows:
        plane = r.get("plane")
        if plane is None:
            raise ValueError(f"measured_winners: row without a plane: {r}")
        frame = r.get("frame_bytes")
        if not frame:
            continue
        n = max(2, int(r["n_ranks"]))
        hop = max(1, int(r["size_bytes"]) // n)
        sp = r.get("spread")
        if isinstance(sp, (list, tuple)) and len(sp) == 2:
            score = float(min(sp))
        elif r.get("algbw_GBps"):
            score = float(r["algbw_GBps"])
        else:
            score = (int(r["size_bytes"]) / float(r["mean_s"]) / 1e9
                     if r.get("mean_s") else 0.0)
        by_point.setdefault((plane, hop), []).append((score, int(frame)))
    out: dict[str, list] = {}
    for (plane, hop), cands in sorted(by_point.items()):
        best = max(cands, key=lambda sf: (sf[0], -sf[1]))[1]
        buckets = out.setdefault(plane, [])
        if buckets and buckets[-1][1] == best:
            buckets[-1] = (hop, best)  # adjacent same-frame: widen
        else:
            buckets.append((hop, best))
    return out


def fit_note(n_rows: int) -> str:
    """The fallback-ladder step a fit of ``n_rows`` took, NAMED (the
    provenance string tune artifacts and commits carry)."""
    if n_rows == 0:
        return "seed-defaults (empty corpus)"
    if n_rows < 5:
        return f"proportional-calibration ({n_rows} row(s))"
    return f"least-squares ({n_rows} rows)"


def save_host_model(path: str, planes: dict[str, PlaneParams],
                    meta: dict | None = None,
                    tables: dict[str, list] | None = None) -> None:
    """Persist the committed host wire model (the sweep/``--fit-host``
    artifact; ``ROCNRDMA_HOST_TUNING`` loads it at net construction):
    fitted per-plane params plus the measured pick tables
    (``measured_winners``)."""
    doc = {"schema": "host_wire_model_r2",
           "planes": {k: v.to_dict() for k, v in planes.items()},
           "tables": {k: [[int(mx), int(f)] for mx, f in v]
                      for k, v in (tables or {}).items()},
           "meta": meta or {}}
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as fp:
        json.dump(doc, fp, indent=1, sort_keys=True)
    os.replace(tmp, path)


def load_host_model(path: str) -> dict[str, PlaneParams]:
    with open(path) as fp:
        doc = json.load(fp)
    return {k: PlaneParams.from_dict(v)
            for k, v in doc.get("planes", {}).items()}


def load_host_tables(path: str) -> dict[str, list]:
    """The measured pick tables of a saved host model artifact
    (``{plane: [(max_hop_bytes, frame_bytes), ...]}``; empty for r1
    artifacts, which carried only fitted params)."""
    with open(path) as fp:
        doc = json.load(fp)
    return {k: [(int(mx), int(f)) for mx, f in v]
            for k, v in doc.get("tables", {}).items()}


# The COMMITTED defaults: the card machine's own fit,
# rocnrdma_tpu_torch/results/host_tune_h100.json, written by
# `python -m rocnrdma_tpu_torch.bench.host_tune` on the host of an
# "NVIDIA H100 80GB HBM3, 700.00 W" (an 8-core Intel host, family 6 model
# 207): bench_host --sweep, 2 ranks, 256 KiB..16 MiB x 4 frames x depths
# 2,3 per plane (32 rows each), fit_host_rows' least squares and the
# measured winner tables. These are what every rank runs until a newer
# artifact supersedes them via ROCNRDMA_HOST_TUNING — the same "a
# measured sweep supersedes the seed" ladder as the device plane's
# tuning tables. ``codec_s_per_b`` (the fit keeps the seed) is the same
# host's int8 encode + decode-fold cost per decoded byte (the JSON's
# "codec": 1/3.80 + 1/5.15 GB/s): compression then pays on the tcp plane
# and not on shm, the reference's split. host_tune --compare-planes (the
# committed model against ROCNRDMA_WIRE_TUNER=0, 6 allreduce fleets an
# arm, rocnrdma_tpu_torch/results/host_compare_h100.json) then measured
# two losses outside the spreads on that host. shm, 2 ranks, 4 MiB
# (0.856x): its size key's bucket, (2 MiB, 4 MiB], takes the static
# wire's 4 MiB frame; (4 MiB, 8 MiB] keeps the fitted frame, as a lane
# paced at 1 MiB credit there would carry 1 MiB frames and stall the
# latency lane behind them (the --smoke lanes gate). tcp, 2 ranks, 1 MiB
# (0.767x) keeps the fitted table: the static frame for (256 KiB,
# 512 KiB] also moves the hierarchical allreduce's cross leg, whose
# --smoke arm then fell below its floor (PERF.md).
COMMITTED_HOST_PLANES: dict[str, dict] = {
    "shm": {
        "params": {"alpha_hop_s": 7.2566e-4,
                   "alpha_frame_s": 4.6658e-5, "alpha_lg_s": 2.4535e-4,
                   "beta_s_per_b": 4.8385e-10,
                   "consume_s_per_b": 1e-12, "codec_s_per_b": 4.5711e-10},
        # hop-size buckets -> measured winner frame
        "table": [[131072, 1048576], [524288, 131072],
                  [2097152, 524276], [4194304, 4194304],
                  [8388608, 524276]],
    },
    "tcp": {
        "params": {"alpha_hop_s": 2.2530e-4,
                   "alpha_frame_s": 2.9276e-4, "alpha_lg_s": 6.0387e-4,
                   "beta_s_per_b": 1.3181e-9,
                   "consume_s_per_b": 3.1093e-11,
                   "codec_s_per_b": 4.5711e-10},
        "table": [[131072, 4194304], [524288, 524276],
                  [8388608, 4194304]],
    },
}


# the process-wide committed models, one per host plane — created on
# first touch by the net planes (plugin.HostQPNet/TCPNet construction).
# Env knobs are read HERE, once, at construction time (the purity rule:
# pick() itself may never read os.environ):
#   ROCNRDMA_WIRE_TUNER=0      → picks disabled (legacy static wire)
#   ROCNRDMA_HOST_TUNING=path  → load fitted params for the planes
#   ROCNRDMA_WIRE_FRAME=bytes  → pin every pick's frame (sweep corpus knob)
#   ROCNRDMA_WIRE_DEPTH=n      → pin every pick's posting depth
_HOST_MODELS: dict[str, HostWireModel] = {}
_HOST_MODELS_LOCK = _lockwitness.make_lock("tuner.py::_HOST_MODELS_LOCK")


def host_wire_model(plane: str) -> HostWireModel:
    """THE committed wire model for ``plane`` ("shm" / "tcp"), one per
    process (like metrics.WIRE) so every comm's picks and every
    tune_wire commit see the same version stream."""
    with _HOST_MODELS_LOCK:
        m = _HOST_MODELS.get(plane)
        if m is None:
            enabled = os.environ.get("ROCNRDMA_WIRE_TUNER", "1") != "0"
            # fallback ladder: operator artifact > committed tune_r01
            # defaults > seed constants (each step a strict supersede,
            # like the device plane's tuning-table precedence)
            committed = COMMITTED_HOST_PLANES.get(plane, {})
            params = (PlaneParams.from_dict(committed["params"])
                      if "params" in committed else None)
            table = committed.get("table")
            path = os.environ.get("ROCNRDMA_HOST_TUNING")
            if path:
                try:
                    loaded = load_host_model(path).get(plane)
                    if loaded is not None:
                        params = loaded
                        table = load_host_tables(path).get(plane)
                except (OSError, ValueError, KeyError):
                    pass  # a bad artifact falls back, committed/seed named

            def _int_env(name):
                raw = os.environ.get(name)
                try:
                    return int(raw) if raw else None
                except ValueError:
                    return None
            m = _HOST_MODELS[plane] = HostWireModel(
                plane, params=params, enabled=enabled,
                pin_frame=_int_env("ROCNRDMA_WIRE_FRAME"),
                pin_depth=_int_env("ROCNRDMA_WIRE_DEPTH"),
                table=table)
            m.exchange_fold = \
                os.environ.get("ROCNRDMA_WIRE_XFOLD", "1") != "0"
        return m


def _reset_host_models() -> None:
    """Test hook: drop the process-wide models so a test can re-read
    the env knobs (mirrors metrics counters' reset discipline)."""
    with _HOST_MODELS_LOCK:
        _HOST_MODELS.clear()


def coalesce_per_op_time(n_ranks: int, bucket_bytes: int,
                         small_bytes: int = 64 << 10,
                         alpha: float | None = None,
                         beta_GBps: float | None = None,
                         model: HostWireModel | None = None) -> float:
    """Modeled per-member seconds when ops of ``small_bytes`` ride fused
    allreduce buckets of ``bucket_bytes``: one ring stream of
    ``2(n-1)`` hops pays the per-hop alpha ONCE for the whole bucket,
    so the per-op share falls as the bucket fills. With no explicit
    ``alpha``/``beta_GBps`` (the what-if/test override path), the price
    is the committed host wire model's OWN ``hop_time`` at the model's
    own frame pick — the full per-hop cost including the per-frame
    alphas, not the hop-latency floor alone (the committed fits carry
    most fixed cost in ``alpha_frame_s``, so pricing on ``alpha_hop_s``
    would collapse the bucket pick to the smallest candidate and defeat
    the amortization the coalescer exists for). One model, one price."""
    if n_ranks <= 1:
        return 0.0
    ops = max(1, bucket_bytes // max(1, small_bytes))
    hops = 2 * (n_ranks - 1)
    if alpha is None and beta_GBps is None:
        m = model or host_wire_model("shm")
        hop_bytes = max(1, bucket_bytes // n_ranks)
        pk = m.pick(hop_bytes, world=n_ranks)
        return hops * m.hop_time(hop_bytes, pk.frame_bytes,
                                 pk.pipeline_depth) / ops
    if alpha is None or beta_GBps is None:
        p = (model or host_wire_model("shm")).params
        alpha = p.alpha_hop_s if alpha is None else alpha
        if beta_GBps is None:
            beta_GBps = 1.0 / (p.beta_s_per_b * 1e9)
    t_fused = hops * alpha + hops * (bucket_bytes / n_ranks) \
        / (beta_GBps * 1e9)
    return t_fused / ops


def pick_bucket_bytes(n_ranks: int, small_bytes: int = 64 << 10,
                      alpha: float | None = None,
                      beta_GBps: float | None = None,
                      candidates=None,
                      model: HostWireModel | None = None) -> int:
    """The tuner's bucket-size pick for a lane's coalescer: the
    SMALLEST candidate within 10% of the best modeled per-op time.
    Smallest-within-tolerance, not argmin — past the latency crossover
    the curve is nearly flat, and a smaller bucket fills (and so
    flushes) sooner, which is latency the model does not see. Pure
    function of its inputs and the committed model version: every rank
    of a job derives the same pick with no rendezvous (the same reason
    lane ids are hashes). Constants resolve through the one fitted
    host wire model (consolidation — the hand-set
    alpha/beta pair here is gone; the seed constants live only in
    :class:`PlaneParams`)."""
    cands = tuple(candidates) if candidates is not None \
        else BUCKET_CANDIDATES
    if not cands:
        raise ValueError("pick_bucket_bytes: empty candidate list")
    if n_ranks <= 1:
        return min(cands)
    times = {b: coalesce_per_op_time(n_ranks, b, small_bytes,
                                     alpha, beta_GBps, model=model)
             for b in cands}
    best = min(times.values())
    return min(b for b in cands if times[b] <= 1.1 * best)


def _best_hop_time(model: HostWireModel, nbytes: int,
                   world: int = 2,
                   credit_bytes: int | None = None) -> float:
    """Modeled seconds for ONE ring hop of ``nbytes`` on ``model``'s
    plane at the model's own pick — the hop price every schedule cost
    below is built from. Pure function of (inputs, committed model
    version), like the pick it rides."""
    if nbytes <= 0:
        return 0.0
    p = model.pick(nbytes, world=world, credit_bytes=credit_bytes)
    return model.hop_time(nbytes, p.frame_bytes, p.pipeline_depth)


def _ring_allreduce_time(model: HostWireModel, nbytes: int, world: int,
                         credit_bytes: int | None = None) -> float:
    """Modeled seconds for a generic ring allreduce of ``nbytes`` over
    ``world`` ranks on ``model``'s plane: ``2(world-1)`` hops of the
    max chunk. The 2-rank degenerate ring prices BOTH schedules the
    wire can run (one whole-buffer exchange-and-fold vs two pipelined
    half-hops — ``plugin.exchange_fold_preferred``'s arbitration) and
    takes the cheaper, since that is what the wire will actually do."""
    if world <= 1 or nbytes <= 0:
        return 0.0
    if world == 2:
        half = -(-nbytes // 2)
        return min(_best_hop_time(model, nbytes, 2, credit_bytes),
                   2.0 * _best_hop_time(model, half, 2, credit_bytes))
    chunk = -(-nbytes // world)
    return 2.0 * (world - 1) * _best_hop_time(model, chunk, world,
                                              credit_bytes)


def pick_algorithm(nbytes: int, node_sizes, flat: HostWireModel,
                   intra: HostWireModel,
                   inter: HostWireModel | None = None,
                   credit_bytes: int | None = None,
                   verb: str = "allreduce") -> str:
    """The node-aware ALGORITHM pick for a host-plane collective of
    ``nbytes``: ``"ring"`` — one flat ring over the plane
    the comm was built on (``flat``) — or ``"hier"`` — the two-level
    schedule of ``distributed.hier_*``: node-local legs over the
    ``intra`` plane, cross-node legs over the ``inter`` plane (one
    shard-parallel ring per local index when every node is the same
    size; the leaders' full-buffer ring otherwise).

    ``verb`` prices the schedule the caller will actually run — the
    three verbs' wire patterns differ, and pricing everything as an
    allreduce would deterministically pick the slower path for the
    others (a flat reduce-scatter is HALF a flat allreduce, while the
    hierarchical one runs the full allreduce schedule plus a slice;
    a flat allgather of an ``nbytes`` contribution moves
    ``(n-1)*nbytes``, not an allreduce's traffic):

    - ``"allreduce"``: flat ``2(n-1)`` hops of the ~1/n chunk (2-rank
      exchange-fold arbitration included) vs local RS + shard-parallel
      cross AR + local AG (relay arms for unequal nodes);
    - ``"reduce_scatter"``: flat ``(n-1)`` hops vs the FULL
      hierarchical allreduce (the implementation slices its result);
    - ``"allgather"``: ``nbytes`` is the per-rank CONTRIBUTION — flat
      ``(n-1)`` hops of it vs local AG + cross AG of the node block
      (+ the relay broadcast of the assembled rows when unequal).

    ``node_sizes`` is the rank count per node of the CURRENT
    membership (any deterministic order). ``inter`` defaults to
    ``flat`` — the cross-node leg rides the same plane the flat ring
    would have.

    PURE function of (inputs, committed model versions) like every
    pick here — the verdict must be identical on every rank (the hier
    path wires sub-rings only when picked, so a split verdict would
    strand half the group in a rendezvous) — and broadcast-committed
    like every other pick: the models it prices from only change at
    ``tune_wire``'s lockstep commit points, never per-rank. Ties keep
    ``"ring"`` (the incumbent whose floors are committed); a >= 10%
    modeled win is required to move, the same margin as the
    exchange-fold arbitration."""
    inter = flat if inter is None else inter
    sizes = [int(s) for s in node_sizes if int(s) > 0]
    n = sum(sizes)
    m = len(sizes)
    if n < 2 or m < 2 or nbytes <= 0:
        return "ring"
    if verb not in ("allreduce", "reduce_scatter", "allgather"):
        raise ValueError(f"pick_algorithm: unknown verb {verb!r}")
    uniform = len(set(sizes)) == 1
    ln = sizes[0] if uniform else max(sizes)

    def chain(model, size):
        # (ln-1) frame-pipelined relay hops ~ one hop plus the extra
        # hops' latency floors (the root-concentrated chain legs)
        if ln <= 1 or size <= 0:
            return 0.0
        return (_best_hop_time(model, size, ln, credit_bytes)
                + max(0, ln - 2) * model.params.alpha_hop_s)

    if verb == "allgather":
        # nbytes = the per-rank contribution; flat relays (n-1) chunks
        t_flat = (n - 1) * _best_hop_time(flat, nbytes, n, credit_bytes)
        if uniform:
            # local AG, then each per-index cross ring carries only
            # its 1/ln SHARD of the node block (== one contribution),
            # then a second local AG reassembles the m shards
            t_hier = ((ln - 1) * _best_hop_time(intra, nbytes, ln,
                                                credit_bytes)
                      + (m - 1) * _best_hop_time(inter, nbytes, m,
                                                 credit_bytes))
            if ln > 1:
                t_hier += (ln - 1) * _best_hop_time(
                    intra, m * nbytes, ln, credit_bytes)
        else:
            # leaders' ragged allgatherv of whole blocks + the relay
            # broadcast of the assembled rows
            t_hier = ((ln - 1) * _best_hop_time(intra, nbytes, ln,
                                                credit_bytes)
                      + (m - 1) * _best_hop_time(inter, ln * nbytes, m,
                                                 credit_bytes)
                      + chain(intra, n * nbytes))
        return "hier" if t_hier < 0.9 * t_flat else "ring"
    # the reducing verbs: the hierarchical arm is the allreduce
    # schedule either way (reduce_scatter slices its result)
    if uniform:
        shard = -(-nbytes // ln) if ln > 1 else nbytes
        t_local = 2.0 * (ln - 1) * _best_hop_time(intra, shard, ln,
                                                  credit_bytes)
        t_cross = _ring_allreduce_time(inter, shard, m, credit_bytes)
    else:
        t_local = 2.0 * chain(intra, nbytes)
        t_cross = _ring_allreduce_time(inter, nbytes, m, credit_bytes)
    t_hier = t_local + t_cross
    if verb == "reduce_scatter":
        # flat RS is the allreduce's first phase alone: (n-1) hops
        chunk = -(-nbytes // n)
        t_flat = (n - 1) * _best_hop_time(flat, chunk, n, credit_bytes)
    else:
        t_flat = _ring_allreduce_time(flat, nbytes, n, credit_bytes)
    return "hier" if t_hier < 0.9 * t_flat else "ring"


def _L(n: int) -> int:
    """ceil(log2 n): step count of the log-depth schedules."""
    return max(1, math.ceil(math.log2(n)))


def _ktree_arity() -> int:
    from rocnrdma_tpu_torch.collectives.ktree import KTREE_ARITY
    return KTREE_ARITY


def _khd_digits(n: int):
    from rocnrdma_tpu_torch.collectives.schedule import khd_digits
    return khd_digits(n)


def _fold_scale(d: int, device_kind: str = "") -> float:
    """HBM-time multiplier of a d-wide fold against the pairwise anchor
    (``hw.fold_rate_scale``: this device's measured ladder, flat when it
    has none)."""
    from rocnrdma_tpu_torch import hw
    return hw.fold_rate_scale(d, device_kind)


# The radix is a modelled choice: candidates are the distinct digit tuples
# khd_digits yields as the radix cap ladders up, capped at 64, the widest
# fold the ladder measures (fold_rate_scale clamps there).
KHD_RADIX_LADDER = (2, 4, 8, 16, 32, 64)


def khd_radix_candidates(n: int) -> list[tuple[int, ...]]:
    """Distinct digit tuples the radix ladder yields for n ranks."""
    from rocnrdma_tpu_torch.collectives.schedule import khd_digits
    out: list[tuple[int, ...]] = []
    for mr in KHD_RADIX_LADDER:
        d = khd_digits(n, mr)
        if d not in out:
            out.append(d)
    return out


def _khd_time(verb: str, n: int, nbytes: int, digits, alpha: float,
              beta: float, hbm_beta: float, embedding: str = "switch",
              device_kind: str = "") -> float:
    """Three-term time of khd with these digits for this verb (allreduce =
    both phases; reduce_scatter/allgather = one). ``embedding``: "switch"
    (one link crossing per permutation) or "ring" (the rank axis on a
    physical n-ring; see _khd_round_shape)."""
    steps, wire, hbm = (_khd_steps(n, digits),
                        _khd_wire(n, digits, embedding),
                        _khd_hbm(n, digits, device_kind))
    if verb == "reduce_scatter":
        steps, wire = steps // 2, wire / 2
    elif verb == "allgather":
        steps, wire, hbm = steps // 2, wire / 2, 0.0
    return steps * alpha + wire * nbytes * beta + hbm * nbytes * hbm_beta


def _khd2d_round_torus(d: int) -> tuple[int, float]:
    """(dispatches, per-direction torus-hop-weighted part fractions) of one
    radix-d round of khd2d on a physical d-ring: a rotation by o loads its
    busiest link min(o, d-o)-fold; split offsets ship half a part each way,
    the self-inverse o = d/2 a full part one way."""
    if d == 2:
        return 1, 1.0
    disp, load = 0, 0.0
    for o in range(1, d):
        hops = min(o, d - o)
        if 2 * o == d:
            disp += 1
            load += float(hops)
        else:
            disp += 2
            load += hops * 0.5
    return disp, load


def khd2d_axis_terms(mesh_shape, dcn_axis: int | None = None,
                     device_kind: str = ""
                     ) -> tuple[list[tuple[int, float]], float]:
    """Per-axis ([(steps, wire), ...], hbm) of khd2d on this mesh shape,
    both phases (digits are the axis sizes). Each axis takes the torus row;
    the ``dcn_axis`` (a network crossing, not a ring) takes the switch row,
    priced by the caller with the network's constants."""
    shape = tuple(int(d) for d in mesh_shape)
    P, per_axis = 1, []
    for a, d in enumerate(shape):
        P *= d
        ds, ld = (_khd_round_shape(d) if a == dcn_axis
                  else _khd2d_round_torus(d))
        per_axis.append((2 * ds, 2 * ld / P))
    return per_axis, _khd_hbm(P, shape, device_kind)


def khd2d_terms(mesh_shape) -> tuple[int, float, float]:
    """(steps, per-direction wire factor, hbm factor) of khd2d: the
    single-beta sum of ``khd2d_axis_terms``."""
    per_axis, hbm = khd2d_axis_terms(mesh_shape)
    return (sum(s for s, _ in per_axis),
            sum(w for _, w in per_axis), hbm)


def khd_model_digits(verb: str, n: int, nbytes: int, alpha: float,
                     beta: float, hbm_beta: float,
                     embedding: str = "switch",
                     device_kind: str = "") -> tuple[int, ...]:
    """The radix ladder's cheapest digit tuple at this point: the digits
    ``algo="khd"`` dispatches when none are given and the terms
    ``model_time("khd")`` prices, so pick and dispatch cannot diverge.
    Ties go to the first (narrowest-cap) candidate."""
    cands = khd_radix_candidates(n)
    best, best_t = cands[0], float("inf")
    for digs in cands:
        t = _khd_time(verb, n, nbytes, digs, alpha, beta, hbm_beta,
                      embedding, device_kind)
        if t < best_t:
            best, best_t = digs, t
    return best


def _khd_round_shape(d: int, stride: int = 1,
                     embedding: str = "switch") -> tuple[int, float]:
    """(dispatches, per-direction busiest-link part fractions) of one
    radix-d round of the registered (bidir) khd, as ``khd._split_offset``
    runs it: offsets with 2o != d split over both rotations (2 dispatches,
    half a part each way); the self-inverse o = d/2 ships a full part one
    way. ``embedding`` "switch" weighs each exchange 1; "ring" (the rank
    axis on a physical n-ring) weighs the digit-o exchange at stride s by
    s * min(o, d-o)."""
    h = ((lambda o: 1.0) if embedding == "switch"
         else (lambda o: float(stride * min(o, d - o))))
    if d == 2:
        return 1, h(1)
    disp, load = 0, 0.0
    for o in range(1, d):
        if 2 * o == d:
            disp += 1
            load += h(o)
        else:
            disp += 2
            load += 0.5 * h(o)
    return disp, load


def _khd_steps(n: int, digits=None) -> int:
    # dispatches across both phases (each pays alpha)
    return 2 * sum(_khd_round_shape(d)[0]
                   for d in (digits or _khd_digits(n)))


def _khd_wire(n: int, digits=None, embedding: str = "switch") -> float:
    # per-direction busiest-link bytes per buffer byte, both phases; round
    # t runs at stride prod(d_0..d_{t-1})
    P, total = 1, 0.0
    for d in (digits or _khd_digits(n)):
        stride = P
        P *= d
        total += _khd_round_shape(d, stride, embedding)[1] / P
    return 2 * total


def _khd_hbm(n: int, digits=None, device_kind: str = "") -> float:
    # RS round t folds the kept part (S/prod(d_0..d_t)) d_t wide: (d_t+1)
    # accounted bytes per part byte, at the ladder's rate for that width
    # (the port folds pairwise, which the ladder's rate carries)
    P, total = 1, 0.0
    for d in (digits or _khd_digits(n)):
        P *= d
        total += (d + 1) / P * _fold_scale(d, device_kind)
    return total


def _hier_allreduce_time(mesh_shape, nbytes: int, alpha: float, beta: float,
                         hbm_beta: float, dcn=None, fused_steps: bool = False,
                         device_kind: str = "") -> float:
    """The hierarchical allreduce on an (m slices, n intra) mesh: ring RS
    over intra, ring AR of the S/n shard over slice (``dcn``'s (alpha,
    beta) when given), ring AG over intra, in program order.
    ``fused_steps`` halves every step alpha (the fused convention)."""
    if len(mesh_shape) != 2:
        raise KeyError(f"hierarchical is modeled on 2-D meshes, got "
                       f"shape {tuple(mesh_shape)}")
    m, n_in = (int(d) for d in mesh_shape)
    a_d, b_d = dcn if dcn is not None else (alpha, beta)
    half = 0.5 if fused_steps else 1.0
    shard = nbytes / max(1, n_in)
    t = 2 * (n_in - 1) * alpha * half                 # intra RS+AG steps
    t += 2 * (n_in - 1) / n_in * nbytes * beta        # intra RS+AG wire
    t += 3 * (n_in - 1) / n_in * nbytes * hbm_beta    # intra RS pairwise folds
    t += 2 * (m - 1) * a_d * half                     # cross ring-AR steps
    t += 2 * (m - 1) / m * shard * b_d                # cross wire
    t += 3 * (m - 1) / m * shard * hbm_beta           # cross folds
    return t


def _hier_alltoall_time(mesh_shape, nbytes: int, alpha: float, beta: float,
                        dcn=None) -> float:
    """The hierarchical alltoall on an (m, n) mesh: one intra-slice and one
    cross-slice alltoall, each at the fused convention (alpha/2)."""
    if len(mesh_shape) != 2:
        raise KeyError(f"hierarchical is modeled on 2-D meshes, got "
                       f"shape {tuple(mesh_shape)}")
    m, n_in = (int(d) for d in mesh_shape)
    a_d, b_d = dcn if dcn is not None else (alpha, beta)
    return (alpha / 2 + (n_in - 1) / n_in * nbytes * beta
            + a_d / 2 + (m - 1) / m * nbytes * b_d)


def fused_model_time(verb: str, n: int, nbytes: int, alpha: float,
                     beta: float, hbm_beta: float, mesh_shape=None,
                     dcn=None, device_kind: str = "") -> float | None:
    """The one price of the library call (``fused``), shared by model_table
    and model_pick. 1-D: the ``_FUSED_MODEL`` shape at alpha/2 a step. 2-D:
    the hierarchical decomposition at fused alphas. None = no fused price
    for this verb/mesh."""
    if mesh_shape is not None:
        if verb == "allreduce":
            return _hier_allreduce_time(mesh_shape, nbytes, alpha, beta,
                                        hbm_beta, dcn, fused_steps=True,
                                        device_kind=device_kind)
        if verb == "alltoall":
            return _hier_alltoall_time(mesh_shape, nbytes, alpha, beta, dcn)
        if verb in ("reduce_scatter", "allgather") and len(mesh_shape) == 2:
            m, n_in = (int(d) for d in mesh_shape)
            a_d, b_d = dcn if dcn is not None else (alpha, beta)
            shard = nbytes / max(1, n_in)
            hbm = (3 * (n_in - 1) / n_in * nbytes
                   + 3 * (m - 1) / m * shard) * hbm_beta
            if verb == "allgather":
                hbm = 0.0
            return ((n_in - 1) * alpha / 2
                    + (n_in - 1) / n_in * nbytes * beta
                    + (m - 1) * a_d / 2 + (m - 1) / m * shard * b_d + hbm)
        return None
    shape = _FUSED_MODEL.get(verb)
    if shape is None:
        return None
    steps, wire, hbm = shape(n)
    return steps * alpha / 2 + wire * nbytes * beta + hbm * nbytes * hbm_beta


def _ptree_cost(n: int, nbytes: int | None = None, itemsize: int = 4,
                device_kind: str = "") -> tuple[int, float, float]:
    # C chunks stream through both trees: per phase C+D-1 ticks x up to 4
    # substeps x S/(2C), two phases; every rank runs every tick's gated
    # 3-operand fold. C is ptree's own size-scaled pick over the element
    # count; nbytes=None keeps the fixed depth of the size-free _MODEL row.
    from rocnrdma_tpu_torch.collectives.ptree import PTREE_CHUNKS, ptree_auto_chunks
    c = (PTREE_CHUNKS if nbytes is None
         else ptree_auto_chunks(max(1, nbytes // max(1, itemsize))))
    ticks = c + _L(n) - 1
    return (8 * ticks, 4.0 * ticks / c,
            4.0 * ticks / c * _fold_scale(3, device_kind))


def _dtree_terms(n: int, device_kind: str = "") -> tuple[int, float, float]:
    # level-synchronous double binary tree: ~2 substeps a level x D levels
    # x 2 phases x 2 trees x S/2 serialized; every rank runs every level's
    # gated 3-operand fold
    return (8 * _L(n), 2.0 * _L(n),
            4.0 * _L(n) * _fold_scale(3, device_kind))


def _ktree_terms(n: int, device_kind: str = "") -> tuple[int, float, float]:
    k = _ktree_arity()
    levels = max(1, math.ceil(math.log(n, k)))
    # up to k child substeps a level x 2 phases; each up level takes k
    # whole buffers serialized and a gated (k+1)-wide fold on every rank
    return (2 * k * levels, 2.0 * k * levels,
            (k + 2.0) * levels * _fold_scale(k + 1, device_kind))


# The port's direct kernels (ops/csrc/ring.cu, alltoall.cu), as implemented:
# one launch with one barrier inside (2 steps), then one pass that reads
# each input element once and writes each output element once, folding in
# registers. Bytes per rank per buffer byte S (the chip_smoke bound's):
# allreduce reads S and writes S; reduce-scatter reads S and writes S/n;
# allgather (S the gathered total) reads S/n and writes S; alltoall reads S
# and writes S. Each is one device-memory access, half of the copy that
# beta prices on a shared card, so the wire factor is half the bytes and
# there is no separate fold term.
_CUDA_RING_BYTES = {
    "allreduce": lambda n: 2.0,
    "reduce_scatter": lambda n: (n + 1) / n,
    "allgather": lambda n: (n + 1) / n,
    "alltoall": lambda n: 2.0,
}


def _cuda_ring_terms(verb: str, n: int) -> tuple[int, float, float]:
    return 2, _CUDA_RING_BYTES[verb](n) / 2, 0.0


# (steps, wire, hbm) per (verb, algo): T = steps*alpha + wire*S*beta +
# hbm*S*hbm_beta. ``wire``: serialized bytes on the critical link per buffer
# byte, for the schedules as implemented (substeps in program order; the
# one overlap assumed is full duplex, for ring_bidir and bidir khd).
# ``hbm``: the schedule's fold traffic per buffer byte (reducing verbs).
# Declaration order is model_pick's last tie-break: it is the reference's,
# with its pallas_ring rows as the port's cuda_ring rows.
_MODEL = {
    ("allreduce", "ring"): lambda n: (
        2 * (n - 1), 2 * (n - 1) / n, 3 * (n - 1) / n),
    ("allreduce", "ring_bidir"): lambda n: (
        2 * (n - 1), (n - 1) / n, 3 * (n - 1) / n),
    ("allreduce", "tree"): lambda n: (
        2 * _L(n), 2 * (n - 1) / n, 3 * (n - 1) / n),
    ("allreduce", "khd"): lambda n: (
        _khd_steps(n), _khd_wire(n), _khd_hbm(n)),
    # 2-D only, priced per mesh shape in model_time; the sentinel keeps the
    # key enumerable for model_pick
    ("allreduce", "khd2d"): None,
    ("allreduce", "hierarchical"): None,
    ("allreduce", "dtree"): lambda n: _dtree_terms(n),
    ("allreduce", "ktree"): lambda n: _ktree_terms(n),
    ("allreduce", "ptree"): lambda n: _ptree_cost(n),
    ("allreduce", "cuda_ring"): lambda n: _cuda_ring_terms("allreduce", n),
    ("reduce_scatter", "ring"): lambda n: (
        n - 1, (n - 1) / n, 3 * (n - 1) / n),
    ("reduce_scatter", "khd"): lambda n: (
        _khd_steps(n) // 2, _khd_wire(n) / 2, _khd_hbm(n)),
    ("reduce_scatter", "khd2d"): None,
    ("reduce_scatter", "cuda_ring"): lambda n: _cuda_ring_terms("reduce_scatter", n),
    ("allgather", "ring"): lambda n: (n - 1, (n - 1) / n, 0.0),
    ("allgather", "khd"): lambda n: (
        _khd_steps(n) // 2, _khd_wire(n) / 2, 0.0),
    ("allgather", "khd2d"): None,
    ("allgather", "cuda_ring"): lambda n: _cuda_ring_terms("allgather", n),
    ("alltoall", "ring"): lambda n: (n - 1, (n - 1) / n, 0.0),  # rotation
    ("alltoall", "bruck"): lambda n: (_L(n), _L(n) / 2, 0.0),
    ("alltoall", "hierarchical"): None,
    ("alltoall", "cuda_ring"): lambda n: _cuda_ring_terms("alltoall", n),
    ("broadcast", "binomial"): lambda n: (_L(n), _L(n), 0.0),
    ("reduce", "binomial"): lambda n: (_L(n), _L(n), 3.0 * _L(n)),
    ("gather", "binomial"): lambda n: (_L(n), (n - 1) / n, 0.0),
    ("scatter", "binomial"): lambda n: (_L(n), (n - 1) / n, 0.0),
    ("sendrecv", "fused"): lambda n: (1, 1.0, 0.0),
}


def model_time(verb: str, algo: str, n: int, nbytes: int,
               alpha: float = ALPHA_S, beta: float = BETA_S_PER_B,
               hbm_beta: float = 0.0, mesh_shape=None, dcn=None,
               embedding: str = "switch", device_kind: str = "",
               itemsize: int = 4) -> float:
    """Predicted seconds for ``algo`` moving an ``nbytes`` buffer over ``n``
    ranks; KeyError for pairs the model does not cover (``fused`` is
    ``fused_model_time``). khd's digits (``khd_model_digits``) and ptree's
    depth (``ptree_auto_chunks``, from ``itemsize``) resolve as the
    dispatch resolves them. ``khd2d``/``hierarchical`` need ``mesh_shape``;
    ``dcn``: (alpha, beta) of the slice axis when it crosses the network.
    ``device_kind`` selects the fold ladder."""
    if algo == "khd2d":
        if (verb, algo) not in _MODEL:
            raise KeyError((verb, algo))
        if mesh_shape is None:
            raise KeyError("khd2d is modeled per mesh shape; pass "
                           "mesh_shape=(d0, d1, ...)")
        per_axis, hbm = khd2d_axis_terms(
            mesh_shape, dcn_axis=0 if dcn is not None else None,
            device_kind=device_kind)
        halve = verb in ("reduce_scatter", "allgather")
        if verb == "allgather":
            hbm = 0.0
        t = hbm * nbytes * hbm_beta
        for a, (steps, wire) in enumerate(per_axis):
            a_a, b_a = (dcn if (a == 0 and dcn is not None)
                        else (alpha, beta))
            if halve:
                steps, wire = steps // 2, wire / 2
            t += steps * a_a + wire * nbytes * b_a
        return t
    if algo == "hierarchical":
        if (verb, algo) not in _MODEL:
            raise KeyError((verb, algo))
        if mesh_shape is None:
            raise KeyError("hierarchical is modeled per mesh shape; pass "
                           "mesh_shape=(n_slices, n_intra)")
        if verb == "allreduce":
            return _hier_allreduce_time(mesh_shape, nbytes, alpha, beta,
                                        hbm_beta, dcn,
                                        device_kind=device_kind)
        return _hier_alltoall_time(mesh_shape, nbytes, alpha, beta, dcn)
    if algo == "khd" and (verb, algo) in _MODEL:
        digits = khd_model_digits(verb, n, nbytes, alpha, beta, hbm_beta,
                                  embedding, device_kind)
        return _khd_time(verb, n, nbytes, digits, alpha, beta, hbm_beta,
                         embedding, device_kind)
    if (verb, algo) == ("allreduce", "ptree"):
        steps, wire, hbm = _ptree_cost(n, nbytes, itemsize, device_kind)
        return steps * alpha + wire * nbytes * beta + hbm * nbytes * hbm_beta
    # the other fold-bearing trees price their HBM term on the same
    # per-kind ladder as khd
    if (verb, algo) == ("allreduce", "ktree"):
        steps, wire, hbm = _ktree_terms(n, device_kind)
        return steps * alpha + wire * nbytes * beta + hbm * nbytes * hbm_beta
    if (verb, algo) == ("allreduce", "dtree"):
        steps, wire, hbm = _dtree_terms(n, device_kind)
        return steps * alpha + wire * nbytes * beta + hbm * nbytes * hbm_beta
    steps, wire, hbm = _MODEL[(verb, algo)](n)
    return steps * alpha + wire * nbytes * beta + hbm * nbytes * hbm_beta


def model_pick(verb: str, n: int, nbytes: int, candidates=None,
               alpha: float = ALPHA_S, beta: float = BETA_S_PER_B,
               hbm_beta: float = 0.0, mesh_shape=None, dcn=None,
               embedding: str = "switch", device_kind: str = "",
               itemsize: int = 4) -> str | None:
    """Cheapest modelled algorithm for this point, or None. ``fused``
    competes when the candidates allow it. Ties go to fused, then to a
    schedule over the ``cuda_ring`` kernel arm, then to declaration order.
    ``khd2d``/``hierarchical`` compete only with ``mesh_shape``."""
    best, best_key = None, (float("inf"), True, True)
    for (v, algo), _ in _MODEL.items():
        if v != verb or (candidates is not None and algo not in candidates):
            continue
        if algo in ("khd2d", "hierarchical") and mesh_shape is None:
            continue
        key = (model_time(verb, algo, n, nbytes, alpha, beta, hbm_beta,
                          mesh_shape=mesh_shape, dcn=dcn,
                          embedding=embedding, device_kind=device_kind,
                          itemsize=itemsize),
               True, algo == "cuda_ring")
        if key < best_key:
            best, best_key = algo, key
    if candidates is None or "fused" in candidates:
        ft = fused_model_time(verb, n, nbytes, alpha, beta, hbm_beta,
                              mesh_shape=mesh_shape, dcn=dcn,
                              device_kind=device_kind)
        if ft is not None and (ft, False, False) < best_key:
            best = "fused"
    return best


# The shape the library call approximates per verb: bandwidth-optimal
# bidirectional rings with pairwise folds; alltoall a direct exchange.
_FUSED_MODEL = {
    "allreduce": lambda n: _MODEL[("allreduce", "ring_bidir")](n),
    "reduce_scatter": lambda n: (
        n - 1, (n - 1) / (2 * n), 3 * (n - 1) / n),
    "allgather": lambda n: (n - 1, (n - 1) / (2 * n), 0.0),
    "alltoall": lambda n: (1, (n - 1) / n, 0.0),
}


# ---------------------------------------------------------------------------
# Tables

@dataclasses.dataclass
class Bucket:
    max_bytes: int  # covers sizes <= max_bytes (the last bucket: beyond too)
    algo: str


def table_platform(platform: str, span=None) -> str:
    """The platform of a tuning table's key for a mesh on ``platform``
    (``runtime.detect_topology``'s "gpu" or "cpu") whose leading axis
    crosses the processes of ``span`` (a ``ProcessSpan``, or None): the
    platform itself for ranks in one process; across processes
    ``<platform>/<link>`` with the link ``cli_common.link_of`` names:
    "gpu/nvlink" (NCCL, a GPU a process), "gpu/host-loopback" (processes
    sharing a GPU, their exchanges staged through gloo) and
    "cpu/cpu-loopback". So a table swept across processes never answers a
    one-process mesh of the same rank count, nor the reverse: their arms
    cost different things."""
    if span is None:
        return platform
    from rocnrdma_tpu_torch.bench.cli_common import link_of
    return f"{platform}/{link_of(platform, span)}"


class TuningTable:
    """Measured winners: (verb, n_ranks, mesh_ndim, platform) -> [Bucket].
    The platform is ``table_platform``'s: "gpu" or "cpu" in one process,
    "gpu/nvlink", "gpu/host-loopback" or "cpu/cpu-loopback" across
    processes, so a reference table keyed "tpu" never matches."""

    def __init__(self, entries: dict | None = None, meta: dict | None = None):
        # key: "verb|n|ndim|platform" -> sorted [Bucket]
        self._entries: dict[str, list[Bucket]] = entries or {}
        # provenance, persisted under "_meta", never consulted by lookup()
        self.meta: dict = meta or {}

    @staticmethod
    def _key(verb: str, n_ranks: int, mesh_ndim: int, platform: str) -> str:
        return f"{verb}|{n_ranks}|{mesh_ndim}|{platform}"

    def set_buckets(self, verb: str, n_ranks: int, mesh_ndim: int,
                    platform: str, buckets: list[Bucket]) -> None:
        self._entries[self._key(verb, n_ranks, mesh_ndim, platform)] = sorted(
            buckets, key=lambda b: b.max_bytes)

    def lookup(self, verb: str, nbytes: int, n_ranks: int, mesh_ndim: int,
               platform: str) -> str | None:
        buckets = self._entries.get(self._key(verb, n_ranks, mesh_ndim, platform))
        if not buckets:
            return None
        for b in buckets:
            if nbytes <= b.max_bytes:
                return b.algo
        return buckets[-1].algo  # beyond the largest measured size

    def merge(self, other: "TuningTable") -> None:
        """Later tables win (re-tuning overwrites)."""
        self._entries.update(other._entries)

    def to_dict(self) -> dict:
        out = {k: [[b.max_bytes, b.algo] for b in v]
               for k, v in self._entries.items()}
        if self.meta:
            out["_meta"] = self.meta
        return out

    @classmethod
    def from_dict(cls, d: dict) -> "TuningTable":
        meta = d.get("_meta") or {}
        return cls({k: [Bucket(int(mb), a) for mb, a in v]
                    for k, v in d.items() if k != "_meta"}, meta=meta)

    def save(self, path: str) -> None:
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as fp:
            json.dump(self.to_dict(), fp, indent=1, sort_keys=True)
        os.replace(tmp, path)  # a concurrent reader never sees a torn file

    @classmethod
    def load(cls, path: str) -> "TuningTable":
        with open(path) as fp:
            return cls.from_dict(json.load(fp))

    def __len__(self) -> int:
        return len(self._entries)


class Autotuner:
    """Times every compatible algorithm per (verb, size) on a live
    Transport and keeps the winners as a TuningTable."""

    def __init__(self, transport, warmup: int = 1, repeats: int = 3,
                 calls_per_repeat: int = 3):
        self.t = transport
        self.warmup = warmup
        self.repeats = repeats
        self.calls = calls_per_repeat

    def _candidates(self, verb: str, algos=None) -> list[str]:
        from rocnrdma_tpu_torch.transport.api import SCHEDULES, supports
        cands = [a for a in SCHEDULES[verb]
                 if supports(verb, a, self.t.is_2d)]
        if algos is not None:
            return [a for a in cands if a in algos]
        # the kernel arm is opt-in: on the CPU it runs the plain version,
        # whose time would poison the table
        return [a for a in cands if a != "cuda_ring"]

    def _example(self, verb: str, size_bytes: int, dtype: str):
        # the bench runner owns each collective's shape and divisibility
        # rules, so tuner sizes mean what sweep sizes mean
        import torch

        from rocnrdma_tpu_torch.bench.runner import (DTYPES, _build_input,
                                                     _shape_and_bytes)
        collective = verb.replace("_", "")
        if self.t.span is None:
            x, _, _ = _build_input(self.t, collective, size_bytes, dtype)
            return x
        # across processes each rank draws its own rows on its device: the
        # sweep checks no values, and a row of the runner's whole draw
        # would cost every rank every rank's bytes
        shape, _ = _shape_and_bytes(collective, self.t.n_ranks, size_bytes, dtype)
        gen = torch.Generator(self.t.device).manual_seed(self.t.span.index)
        return torch.randn(self.t._local + shape[1:], generator=gen,
                           device=self.t.device).to(DTYPES[dtype])

    def sweep(self, verbs, sizes, dtype: str = "float32",
              algos=None, progress=None) -> TuningTable:
        """Measure; return a table with one bucket list per swept verb and
        every arm's time under ``_meta["times_s"]`` (on a mesh that spans
        processes the slowest rank's, so every rank keeps the same
        table), and this process's kernel launches under
        ``_meta["launches"]``."""
        from rocnrdma_tpu_torch import ops
        from rocnrdma_tpu_torch.bench.timing import time_fn

        plat = self.t.table_platform
        ndim = len(self.t.axes)
        times: dict = {}
        table = TuningTable(meta={
            "provenance": f"measured Autotuner sweep (platform={plat}, "
                          f"n_ranks={self.t.n_ranks}, mesh_ndim={ndim})",
            "device": self.t.device_kind, "dtype": dtype, "times_s": times})
        before = ops.launch_counts()
        for verb in verbs:
            buckets = []
            for size in sorted(sizes):
                x = self._example(verb, size, dtype)
                best, best_s = None, float("inf")
                row = times.setdefault(verb, {})[str(size)] = {}
                for algo in self._candidates(verb, algos):
                    # khd's radix is size-dependent: time the digits the
                    # auto/model policies dispatch at this size, so the
                    # table's "khd" names the program that ran
                    knobs = ({"digits": self.t.khd_model_digits(verb, size)}
                             if algo == "khd" else {})
                    fn = self.t.jit_fn(verb, algo, **knobs)
                    timing = time_fn(fn, x, warmup=self.warmup,
                                     repeats=self.repeats,
                                     calls_per_repeat=self.calls, span=self.t.span)
                    row[algo] = timing.mean_s
                    if progress:
                        progress(verb, size, algo, timing.mean_s)
                    if timing.mean_s < best_s:
                        best, best_s = algo, timing.mean_s
                del x
                if best is not None:
                    buckets.append(Bucket(size, best))
            if buckets:
                table.set_buckets(verb, self.t.n_ranks, ndim, plat,
                                  _coalesce(buckets))
        launched = {k: v - before[k] for k, v in ops.launch_counts().items()
                    if v > before[k]}
        if launched:
            table.meta["launches"] = launched  # this process's, the kernels'
        return table


def alpha_sensitivity(device_kind: str, rank_counts, verbs, sizes,
                      platform: str | None = None,
                      per_card: int | None = None) -> dict:
    """The model-table rows that move inside the kind's measured dispatch
    alpha range: ``{table_key: {"alpha_lo": buckets, "alpha_hi": buckets}}``
    for every key whose buckets differ at the two ends; {} when every bucket
    is stable, or when the kind has no measured range."""
    from rocnrdma_tpu_torch import hw
    rng = hw.dispatch_alpha_range_s(device_kind)
    if rng is None:
        return {}
    lo, hi = rng
    t_lo = model_table(device_kind, rank_counts, verbs, sizes, platform,
                       dispatch_alpha_s=lo, _audit=False, per_card=per_card)
    t_hi = model_table(device_kind, rank_counts, verbs, sizes, platform,
                       dispatch_alpha_s=hi, _audit=False, per_card=per_card)
    out = {}
    for k in sorted(set(t_lo._entries) | set(t_hi._entries)):
        blo = [[b.max_bytes, b.algo] for b in t_lo._entries.get(k, [])]
        bhi = [[b.max_bytes, b.algo] for b in t_hi._entries.get(k, [])]
        if blo != bhi:
            out[k] = {"alpha_lo": blo, "alpha_hi": bhi}
    return out


def model_table(device_kind: str, rank_counts, verbs, sizes,
                platform: str | None = None,
                dispatch_alpha_s: float | None = None,
                _audit: bool = True, mesh_shapes=None,
                per_card: int | None = None) -> TuningTable:
    """A tuning table from the cost model, no hardware needed: every
    per-size pick is ``model_pick`` with fused in the candidates, each row
    priced for its ranks sharing one card (the port's layout; generic
    constants on a kind without a ``hw.CHIPS`` row, where the ``cuda_ring``
    kernel arm does not compete). ``platform``: the table key's, by default
    "gpu" for a known card and "cpu" otherwise; for a mesh that spans
    processes, ``table_platform``'s name of its layout, with ``per_card``
    its ranks on a card (``ProcessSpan.per_card``: 1 with a GPU a
    process), which prices every row in place of its rank count.
    ``mesh_shapes``: (slices, intra) shapes whose ndim=2 rows take the 2-D
    candidates, the slice axis at network constants. ``dispatch_alpha_s``
    overrides the measured dispatch alpha; ``_audit`` records
    ``alpha_sensitivity`` in ``_meta``."""
    from rocnrdma_tpu_torch import hw
    from rocnrdma_tpu_torch.transport.api import SCHEDULES, supports

    on_card = hw.chip_for(device_kind) is not None
    platform = platform or ("gpu" if on_card else "cpu")
    table = TuningTable(meta={
        "provenance": "model-derived (tuner.model_table); supersede with a "
                      "measured Autotuner sweep",
        "device_kind": device_kind,
        "layout": ("every rank of a row on one card" if per_card is None
                   else f"{platform}, {per_card} rank(s) a card"),
    })
    if per_card is not None:
        table.meta["per_card"] = per_card
    for n in sorted(rank_counts):
        for verb in verbs:
            alpha, beta, hbm_beta = constants_for(device_kind, verb, per_card or n,
                                                  dispatch_alpha_s)
            table.meta[f"alpha_beta[{verb}]"] = [alpha, beta, hbm_beta]
            cands = [a for a in SCHEDULES.get(verb, ())
                     if supports(verb, a, False) and (verb, a) in _MODEL
                     and (on_card or a != "cuda_ring")]
            if not cands:
                continue
            buckets = []
            for size in sorted(sizes):
                best = model_pick(verb, n, size, candidates=cands + ["fused"],
                                  alpha=alpha, beta=beta, hbm_beta=hbm_beta,
                                  device_kind=device_kind)
                buckets.append(Bucket(size, best))
            table.set_buckets(verb, n, 1, platform, _coalesce(buckets))
    dcn = dcn_constants_for(device_kind)
    for shape in (mesh_shapes or ()):
        shape = tuple(int(d) for d in shape)
        N = math.prod(shape)
        for verb in verbs:
            alpha, beta, hbm_beta = constants_for(device_kind, verb, per_card or N,
                                                  dispatch_alpha_s)
            cands2 = [a for a in SCHEDULES.get(verb, ())
                      if supports(verb, a, True)
                      and ((verb, a) in _MODEL or a == "fused")]
            if not cands2:
                continue
            buckets = []
            for size in sorted(sizes):
                best = model_pick(verb, N, size, candidates=cands2,
                                  alpha=alpha, beta=beta, hbm_beta=hbm_beta,
                                  mesh_shape=shape, dcn=dcn,
                                  device_kind=device_kind)
                if best is not None:
                    buckets.append(Bucket(size, best))
            if buckets:
                table.set_buckets(verb, N, 2, platform, _coalesce(buckets))
    if mesh_shapes:
        table.meta["dcn_alpha_beta"] = list(dcn)
        table.meta["mesh_shapes"] = [list(s) for s in mesh_shapes]
    if "allreduce" in verbs:
        # the radix picks under both wire pricings at the 1 GiB point
        picks = {}
        for n in (64, 256):
            a_, b_, hb_ = constants_for(device_kind, "allreduce", n)
            picks[f"allreduce n={n} @1GiB"] = {
                emb: list(khd_model_digits("allreduce", n, 1 << 30, a_, b_,
                                           hb_, emb, device_kind))
                for emb in ("switch", "ring")}
        table.meta["embedding_picks"] = picks
    if _audit:
        rng = hw.dispatch_alpha_range_s(device_kind)
        table.meta["alpha_sensitivity"] = {
            "dispatch_alpha_range_s": list(rng) if rng else None,
            # {} = every bucket stable across the measured range
            "unstable_keys": alpha_sensitivity(device_kind, rank_counts,
                                               verbs, sizes, platform, per_card),
        }
    return table


def merge_tables(base: TuningTable, new: TuningTable) -> TuningTable:
    """Merge ``new`` over ``base`` (new rows win); when the provenances
    differ the result is labelled mixed."""
    old_prov = base.meta.get("provenance")
    new_prov = new.meta.get("provenance")
    base.merge(new)
    base.meta.update(new.meta)
    if old_prov and new_prov and old_prov != new_prov:
        base.meta["provenance"] = (
            f"mixed: [{new_prov}] merged over [{old_prov}]")
    return base


def _coalesce(buckets: list[Bucket]) -> list[Bucket]:
    """Adjacent same-algo buckets collapse to the larger threshold."""
    out: list[Bucket] = []
    for b in sorted(buckets, key=lambda b: b.max_bytes):
        if out and out[-1].algo == b.algo:
            out[-1] = Bucket(b.max_bytes, b.algo)
        else:
            out.append(b)
    return out


def _fit_host_main(corpus: str, out: str) -> int:
    """``--fit-host``: fit the host wire model from a ``bench_host --sweep``
    corpus (JSONL; a torn tail line is skipped) and write it to ``out``."""
    rows = []
    with open(corpus) as fp:
        for line in fp:
            line = line.strip()
            if not line:
                continue
            try:
                d = json.loads(line)
            except json.JSONDecodeError:
                continue  # torn tail line from an interrupted sweep
            plane = d.get("platform", "").removeprefix("host-")
            ex = d.get("extra", {})
            frame = (ex.get("wire", {}).get("frame_bytes")
                     or ex.get("frame_bytes"))
            if plane and frame:
                rows.append({"plane": plane,
                             "size_bytes": d["size_bytes"],
                             "n_ranks": d["n_ranks"],
                             "mean_s": d["mean_s"],
                             "algbw_GBps": d.get("algbw_GBps"),
                             "spread": ex.get("spread"),
                             "frame_bytes": frame})
    planes = fit_host_rows(rows)
    counts = {p: sum(1 for r in rows if r["plane"] == p) for p in planes}
    save_host_model(out, planes, tables=measured_winners(rows), meta={
        "provenance": f"fit_host_rows over {corpus}",
        "fit": {p: fit_note(n) for p, n in counts.items()}})
    print(f"wrote {out}: " + ", ".join(f"{p}={fit_note(n)}"
                                       for p, n in sorted(counts.items())))
    return 0


ALPHA_RUNS = 5  # measure_alpha runs of --measure-alpha; the median is kept


def main(argv=None) -> int:
    """Tune on the live device and write the table:

    python -m rocnrdma_tpu_torch.transport.tuner --fake-devices 8 \\
        --verbs allreduce,alltoall --sizes 4K,64K,1M --out tuning.json
    torchrun --nproc-per-node 4 -m rocnrdma_tpu_torch.transport.tuner \\
        --algos fused,ring,cuda_ring --out tuning_4gpu.json   # a GPU a process
    """
    import argparse

    from rocnrdma_tpu_torch import hw
    from rocnrdma_tpu_torch.bench import cli_common
    from rocnrdma_tpu_torch.bench.runner import DTYPES, parse_size
    from rocnrdma_tpu_torch.transport import Transport

    p = argparse.ArgumentParser(description=main.__doc__)
    p.add_argument("--verbs", default="allreduce,alltoall,allgather")
    p.add_argument("--sizes", default="4K,64K,1M,16M")
    p.add_argument("--dtype", default="float32", choices=tuple(DTYPES))
    p.add_argument("--algos", default=None,
                   help="comma list of candidate algorithms (cuda_ring "
                        "competes only when named here)")
    p.add_argument("--ranks", type=int, default=None)
    p.add_argument("--mesh2d", default=None, metavar="SLICESxPER")
    p.add_argument("--fake-devices", type=int, default=None)
    p.add_argument("--platform", default="auto", choices=("auto", "cpu"))
    p.add_argument("--out", default="tuning.json")
    p.add_argument("--merge", action="store_true",
                   help="merge into an existing --out instead of replacing")
    p.add_argument("--measure-alpha", action="store_true",
                   help=f"measure the per-launch dispatch alpha "
                        f"{ALPHA_RUNS} times (measure_alpha), print each and "
                        f"the median, and exit")
    p.add_argument("--save-calibration", action="store_true",
                   help="with --measure-alpha: write the median into this "
                        "card's calibration file (hw.save_calibration)")
    p.add_argument("--fit-host", default=None, metavar="CORPUS_JSONL",
                   help="no sweep: least-squares the HOST wire model "
                        "(per-plane frame/depth coefficients) from a "
                        "bench_host --sweep corpus and write it to --out "
                        "(load via ROCNRDMA_HOST_TUNING)")
    p.add_argument("--model-table", default=None, metavar="DEVICE_KIND",
                   help="no sweep: derive the table from the cost model for "
                        "this device kind (e.g. 'NVIDIA H100 80GB HBM3', cpu)")
    p.add_argument("--table-ranks", default="4,8,16,32,64,256",
                   help="rank counts for --model-table")
    p.add_argument("--mesh-shapes", default="2x4,2x64,8x32,2x128",
                   metavar="MxN[,MxN...]",
                   help="--model-table only: (slices x intra) shapes of the "
                        "ndim=2 rows; empty string disables")
    args = p.parse_args(argv)

    if args.fit_host is not None:
        return _fit_host_main(args.fit_host, args.out)

    if args.model_table is not None:
        sizes = [parse_size(s) for s in args.sizes.split(",")]
        shapes = [tuple(int(d) for d in s.split("x"))
                  for s in args.mesh_shapes.split(",") if s]
        table = model_table(args.model_table,
                            [int(r) for r in args.table_ranks.split(",")],
                            args.verbs.split(","), sizes, mesh_shapes=shapes)
        if args.merge and os.path.exists(args.out):
            table = merge_tables(TuningTable.load(args.out), table)
        table.save(args.out)
        print(f"wrote {args.out} (model-derived, {len(table)} entries)")
        return 0

    topo = cli_common.setup_backend(args.fake_devices, args.platform, args.ranks or 1,
                                    across=True)
    smi = hw.smi_line() if topo.platform == "gpu" else ""
    lead = cli_common.is_lead()
    if args.measure_alpha:
        # each rank on its own card; across processes the fleet's median
        # of the ranks' medians, written once
        span = cli_common.fleet_span(topo)
        runs = [measure_alpha(device=topo.device) for _ in range(ALPHA_RUNS)]
        per_rank = cli_common.gather_rows(runs, span)
        med = cli_common.fleet_median([statistics.median(runs)], span)[0]
        everyone = [a for rank_runs in per_rank for a in rank_runs]
        if lead:
            for r, rank_runs in enumerate(per_rank):
                print(f"dispatch alpha on {topo.device_name} "
                      f"{'' if span is None else f'(rank {r} of {span.size}) '}"
                      f"({smi or 'no nvidia-smi'}): runs "
                      f"{[round(a * 1e9, 1) for a in rank_runs]} ns, median "
                      f"{statistics.median(rank_runs) * 1e9:.1f} ns/launch")
            if span is not None:
                print(f"dispatch alpha, the median of the {span.size} ranks' medians: "
                      f"{med * 1e9:.1f} ns/launch")
        if args.save_calibration:
            if hw.chip_for(topo.device_name) is None:
                raise SystemExit(f"no hw.CHIPS row for {topo.device_name!r}: "
                                 f"its calibration would price nothing")
            path = cli_common.save_calibration(topo.device_name, {
                "dispatch_alpha_s": med,
                "dispatch_alpha_range_s": [min(everyone), max(everyone)],
                "provenance_alpha": f"tuner --measure-alpha on {smi}"
                                    + ("" if span is None else f" x {span.size} processes")},
                span)
            if lead:
                print(f"wrote {path}")
        return 0

    # --ranks as asked in one process (ranks may share a card); under a
    # process group the world's, one rank a process
    mesh = cli_common.mesh_for(
        cli_common.parse_mesh2d(args.mesh2d) if args.mesh2d else None,
        args.ranks or topo.n_devices, topo)
    t = Transport(mesh)
    sizes = [parse_size(s) for s in args.sizes.split(",")]

    def progress(verb, size, algo, sec):
        if lead:
            print(f"  {verb:>14} {size:>12} B {algo:>12} {sec * 1e6:>12.1f} us",
                  flush=True)

    verbs = args.verbs.split(",")
    table = Autotuner(t).sweep(verbs, sizes, args.dtype,
                               args.algos.split(",") if args.algos else None,
                               progress=progress)
    table.meta["command"] = ("python -m rocnrdma_tpu_torch.transport.tuner "
                             + " ".join(sys.argv[1:] if argv is None else argv))
    table.meta.update(cli_common.link_extra(topo, t.span, t.n_ranks))
    if smi:
        table.meta["nvidia_smi"] = smi
    agreement = policy_agreement(t, table, verbs, sizes, DTYPES[args.dtype].itemsize)
    table.meta["policy_agreement"] = agreement
    if not lead:
        return 0
    print(f"policy agreement on {t.table_platform} ({t.n_ranks} ranks): the cost "
          f"model's pick (Transport._resolve('model')) is the sweep's winner at "
          f"{agreement['agree']} of {agreement['points']} points")
    for verb, by_size in agreement["picks"].items():
        for size, (won, picked) in by_size.items():
            print(f"  {verb:>14} {size:>12} B winner {won:>12} model {picked:>12}"
                  f"{'' if won == picked else '  (differs)'}")
    if args.merge and os.path.exists(args.out):
        table = merge_tables(TuningTable.load(args.out), table)
    table.save(args.out)
    print(f"wrote {args.out}: "
          + json.dumps({k: v for k, v in table.to_dict().items() if k != "_meta"},
                       sort_keys=True))
    return 0


def policy_agreement(t, table: TuningTable, verbs, sizes, itemsize: int = 4) -> dict:
    """The cost model's pick on ``t``'s mesh (``Transport._resolve("model",
    ...)``, with its layout's constants) beside the measured winner of
    ``table``'s ``_meta["times_s"]`` at each swept (verb, size): ``{"picks":
    {verb: {size: [winner, model pick]}}, "agree": n, "points": n}``."""
    picks, agree, points = {}, 0, 0
    for verb in verbs:
        for size in sorted(sizes):
            arms = table.meta["times_s"].get(verb, {}).get(str(size))
            if not arms:
                continue
            won = min(arms, key=arms.get)
            picked = t._resolve("model", verb, size, itemsize)
            picks.setdefault(verb, {})[str(size)] = [won, picked]
            agree += won == picked
            points += 1
    return {"picks": picks, "agree": agree, "points": points}


if __name__ == "__main__":
    from rocnrdma_tpu_torch.bench import cli_common as _cli

    sys.exit(_cli.main(main))
