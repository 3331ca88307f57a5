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
measures the dispatch alpha.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import sys

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


class TuningTable:
    """Measured winners: (verb, n_ranks, mesh_ndim, platform) -> [Bucket].
    The platform is ``runtime.detect_topology``'s: "gpu" or "cpu", so a
    reference table keyed "tpu" never matches."""

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
        cands = [a for a in SCHEDULES[verb] if supports(verb, a, self.t.is_2d)]
        if algos is not None:
            return [a for a in cands if a in algos]
        # the kernel arm is opt-in: on the CPU it runs the plain version,
        # whose time would poison the table
        return [a for a in cands if a != "cuda_ring"]

    def _example(self, verb: str, size_bytes: int, dtype: str):
        # the bench runner owns each collective's shape and divisibility
        # rules, so tuner sizes mean what sweep sizes mean
        from rocnrdma_tpu_torch.bench.runner import _build_input
        x, _, _ = _build_input(self.t, verb.replace("_", ""), size_bytes, dtype)
        return x

    def sweep(self, verbs, sizes, dtype: str = "float32",
              algos=None, progress=None) -> TuningTable:
        """Measure; return a table with one bucket list per swept verb and
        every arm's time under ``_meta["times_s"]``."""
        from rocnrdma_tpu_torch.bench.timing import time_fn

        plat = self.t.platform
        ndim = len(self.t.axes)
        times: dict = {}
        table = TuningTable(meta={
            "provenance": f"measured Autotuner sweep (platform={plat}, "
                          f"n_ranks={self.t.n_ranks}, mesh_ndim={ndim})",
            "device": self.t.device_kind, "dtype": dtype, "times_s": times})
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
                                     calls_per_repeat=self.calls)
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
        return table


def alpha_sensitivity(device_kind: str, rank_counts, verbs, sizes,
                      platform: str | None = None) -> dict:
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
                       dispatch_alpha_s=lo, _audit=False)
    t_hi = model_table(device_kind, rank_counts, verbs, sizes, platform,
                       dispatch_alpha_s=hi, _audit=False)
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
                _audit: bool = True, mesh_shapes=None) -> TuningTable:
    """A tuning table from the cost model, no hardware needed: every
    per-size pick is ``model_pick`` with fused in the candidates, each row
    priced for its ranks sharing one card (the port's layout; generic
    constants on a kind without a ``hw.CHIPS`` row, where the ``cuda_ring``
    kernel arm does not compete). ``platform``: the table key's, by default
    "gpu" for a known card and "cpu" otherwise. ``mesh_shapes``: (slices,
    intra) shapes whose ndim=2 rows take the 2-D candidates, the slice axis
    at network constants. ``dispatch_alpha_s`` overrides the measured
    dispatch alpha; ``_audit`` records ``alpha_sensitivity`` in ``_meta``."""
    from rocnrdma_tpu_torch import hw
    from rocnrdma_tpu_torch.transport.api import SCHEDULES, supports

    on_card = hw.chip_for(device_kind) is not None
    platform = platform or ("gpu" if on_card else "cpu")
    table = TuningTable(meta={
        "provenance": "model-derived (tuner.model_table); supersede with a "
                      "measured Autotuner sweep",
        "device_kind": device_kind,
        "layout": "every rank of a row on one card",
    })
    for n in sorted(rank_counts):
        for verb in verbs:
            alpha, beta, hbm_beta = constants_for(device_kind, verb, n,
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
            alpha, beta, hbm_beta = constants_for(device_kind, verb, N,
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
                                               verbs, sizes, platform),
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


ALPHA_RUNS = 5  # measure_alpha runs of --measure-alpha; the median is kept


def main(argv=None) -> int:
    """Tune on the live device and write the table:

    python -m rocnrdma_tpu_torch.transport.tuner --fake-devices 8 \\
        --verbs allreduce,alltoall --sizes 4K,64K,1M --out tuning.json
    """
    import argparse

    from rocnrdma_tpu_torch import hw
    from rocnrdma_tpu_torch.bench import cli_common
    from rocnrdma_tpu_torch.bench.runner import DTYPES, parse_size
    from rocnrdma_tpu_torch.runtime import rank_mesh, slice_mesh
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

    topo = cli_common.setup_backend(args.fake_devices, args.platform, args.ranks or 1)
    smi = hw.smi_line() if topo.platform == "gpu" else ""
    if args.measure_alpha:
        runs = [measure_alpha(device=topo.device) for _ in range(ALPHA_RUNS)]
        med = statistics.median(runs)
        print(f"dispatch alpha on {topo.device_name} ({smi or 'no nvidia-smi'}): "
              f"runs {[round(a * 1e9, 1) for a in runs]} ns, median "
              f"{med * 1e9:.1f} ns/launch")
        if args.save_calibration:
            if hw.chip_for(topo.device_name) is None:
                raise SystemExit(f"no hw.CHIPS row for {topo.device_name!r}: "
                                 f"its calibration would price nothing")
            path = hw.save_calibration(topo.device_name, {
                "dispatch_alpha_s": med,
                "dispatch_alpha_range_s": [min(runs), max(runs)],
                "provenance_alpha": f"tuner --measure-alpha on {smi}"})
            print(f"wrote {path}")
        return 0

    if args.mesh2d:
        s, per = cli_common.parse_mesh2d(args.mesh2d)
        mesh = slice_mesh(s, per, topo.device)
    else:
        mesh = rank_mesh(args.ranks or topo.n_devices, topo.device)
    t = Transport(mesh)
    sizes = [parse_size(s) for s in args.sizes.split(",")]

    def progress(verb, size, algo, sec):
        print(f"  {verb:>14} {size:>12} B {algo:>12} {sec * 1e6:>12.1f} us",
              flush=True)

    table = Autotuner(t).sweep(args.verbs.split(","), sizes, args.dtype,
                               args.algos.split(",") if args.algos else None,
                               progress=progress)
    table.meta["command"] = ("python -m rocnrdma_tpu_torch.transport.tuner "
                             + " ".join(sys.argv[1:] if argv is None else argv))
    if smi:
        table.meta["nvidia_smi"] = smi
    if args.merge and os.path.exists(args.out):
        table = merge_tables(TuningTable.load(args.out), table)
    table.save(args.out)
    print(f"wrote {args.out}: "
          + json.dumps({k: v for k, v in table.to_dict().items() if k != "_meta"},
                       sort_keys=True))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
