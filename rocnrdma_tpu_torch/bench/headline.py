"""``headline`` - the scored benchmark: ONE JSON line with the headline
metric, counterpart of the repository's ``bench.py``.

    python -m rocnrdma_tpu_torch.bench.headline                    # one rank
    python -m rocnrdma_tpu_torch.bench.headline --fake-devices 8   # 8 ranks
    python -m rocnrdma_tpu_torch.bench.headline --platform cpu     # plumbing only

The scored line prints first, on stdout; the extra legs print afterwards
on stderr, so a cut run keeps its headline.

**One rank (the default): the on-card half of the algorithm.** With no
wire, the headline is the HBM-bound fold a schedule step runs, best of the
``KERNELS`` (ring2: a ring/tree step's 2-operand fold; khd8..khd64: the
khd round folds of radix 8..64) against 0.9 x the card's HBM rate
(``local_reduce_GBps``). The scored fold is the fold the port's schedules
run: ``bench_local``'s ``torchN`` chain, N-1 pairwise ``torch.add``s, the
fold ``collectives/khd.py`` runs and ``bench/fold_ladder.py`` measures (the
reference scores XLA's fused N-operand add because that is what its khd
runs). The accounting stays the reference's, (N+1) bytes per element; the
bytes the pairwise fold really moves, 3(N-1) per element, print on stderr
beside it. Operands are sized as ``fold_ladder.ladder_op_elems`` sizes them
(a radix-N round at size S folds N parts of about S/N), 1 GiB per operand
first and 256 MiB if that leg fails; the chain is timed by the two-depth
marginal, re-measured deeper when a candidate beats the HBM roofline, and
dropped if it still does; the winner (by median) is run again and the
scored value is the median of the pooled trials. The cost model's pick at
the contract point (``tuner.model_pick`` / ``khd_model_digits`` with the
card's constants) prints beside it.

**N ranks on the one card (``--fake-devices N``, N >= 2): the allreduce.**
Bus bandwidth per rank at 1 GiB fp32 (256 MiB if no candidate survives),
best by median of ``fused``, ``ring_bidir``, ``khd`` (bidirectional),
``khd2d`` on the balanced 2-D factor, and ``cuda_ring``, the hand-written
ring kernel in place (``ring_cuda.hbm_ring_allreduce``, tiles from
``transport.api.cuda_ring_tile_rows``; the reference's ``pallas_hbm``). The
ranks share one card, so every byte goes through its HBM: the roofline is
the kernel's bound, 2 n S bytes at the HBM rate, which caps busbw at
HBM x (n-1)/n^2 per rank, and the line says ``"ranks_per_card": N``. Each
chain op is the allreduce alone: the reference rescales by 1/n inside the
same XLA fusion, which here would be a pass of its own. The alltoall algbw
(``metrics.scored_algbw_row``) is written to ``--out`` (default
``rocnrdma_tpu_torch/results/alltoall_algbw.json``).

**N processes, a GPU each (a launcher's environment,
``bench/cli_common.py``): the allreduce across processes**, the
counterpart of ``bench.py``'s multi-chip branch. Each process is one rank
of ``rank_mesh(N, group=WORLD)``; busbw per rank at 1 GiB fp32 (256 MiB
if no candidate survives), best by median of ``fused`` (NCCL),
``ring_bidir``, ``khd`` and ``cuda_ring``, the reduce kernel across
processes in place (``ring_cuda.hbm_ring_allreduce_across``, the arm's
tiles); ``khd2d`` only where the spanning 2-D mesh holds the balanced
factor (one slice a process), else skipped with a stderr line. Each chain
is timed across the fleet (``timing.marginal_trials(span=)``: a barrier
before each chain, the maximum over the ranks). Rank 0 prints the scored
line, ``"ranks_per_card": 1`` and ``"processes": N``, against 0.9 x
NVLink's datasheet rate each way (``hw.CHIPS`` link / 2: 450 GB/s on an
H100; busbw counts one direction), which the line names as a datasheet
figure. Where the processes share a GPU (gloo staged through the host)
the line says ``"link": "host-loopback"`` and is scored against the
one-card HBM bound. The alltoall row is taken across processes too; then
the group is torn down and rank 0 alone runs the MFU leg.

**Every branch: the MFU leg** (stderr), the one-expert MoE layer
(``moe_topk_step`` with ``ffn_expert``): bf16, T=4096, d=2048, ffn=8192 on
the card (fp32 256/256/512 on the CPU), forward at 4 T d ffn FLOPs and a
train step (forward, ``torch.autograd.grad`` on the two expert weights,
SGD) at 10 T d ffn, against the H100's bf16 data-sheet peak, with the
full step's host enqueue and device time beside the MFU.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
from statistics import median

import numpy as np
import torch

from rocnrdma_tpu_torch import collectives as C
from rocnrdma_tpu_torch import hw
from rocnrdma_tpu_torch import metrics as M
from rocnrdma_tpu_torch.bench import cli_common
from rocnrdma_tpu_torch.bench.bench_local import make_combine_chain
from rocnrdma_tpu_torch.bench.fold_ladder import ADDEND_BUDGET, ladder_op_elems
from rocnrdma_tpu_torch.bench.timing import (device_s, enqueue_s, failed_ranks,
                                             marginal_s_per_op, marginal_trials)
from rocnrdma_tpu_torch.ops import ring_cuda
from rocnrdma_tpu_torch.runtime import rank_mesh
from rocnrdma_tpu_torch.transport import Transport
from rocnrdma_tpu_torch.transport.api import cuda_ring_tile_rows

_CPU_FALLBACK_HBM_GBPS = 50.0  # keeps vs_baseline finite on the CPU
_CPU_FALLBACK_LINK_GBPS = 5.0  # the same, for the line across processes
RESULTS_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "results")

# (name, bench_local kernel, operands, the schedule that folds it): bench.py's
# registry, with its XLA adds (xlaN) as the port's torch adds (torchN)
KERNELS = (("ring2", "torch2", 2, "ring/ring_bidir/tree step"),
           ("khd8", "torch8", 8, "khd radix-8 round fold"),
           ("khd16", "torch16", 16, "khd radix-16 round fold"),
           ("khd32", "torch32", 32, "khd radix-32 round fold"),
           ("khd64", "torch64", 64, "khd radix-64 round fold"))


def _randn(shape, device: torch.device, seed: int) -> torch.Tensor:
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=g, device=device, dtype=torch.float32)


def _balanced_factor(m: int):
    """(s, p) with s*p = m, s as close to sqrt(m) as divisors allow and both
    >= 2; None when m is prime or < 4."""
    import math
    for s in range(math.isqrt(m), 1, -1):
        if m % s == 0:
            return s, m // s
    return None


# -- N ranks on one card ------------------------------------------------------

def _inplace_tile_rows(y: torch.Tensor, n: int) -> int:
    """The in-place kernel's ``tile_rows`` for n ranks of rows like ``y``:
    the ``cuda_ring`` arm's tiles, and where its chunk fits one tile, the
    tile is the chunk."""
    tr = cuda_ring_tile_rows(y, "allreduce", n)
    return -(-(-(-y[0].numel() // n)) // ring_cuda.LANES) if tr is None else tr


def _cuda_ring_inplace(y: torch.Tensor) -> torch.Tensor:
    return ring_cuda.hbm_ring_allreduce(y, tile_rows=_inplace_tile_rows(y, y.shape[0]))


def _chain(k: int, ar):
    """``ar`` applied k times to a copy of its input, so an in-place arm
    leaves the input intact (the copy is a fixed cost the marginal
    cancels). The reference rescales each allreduce by 1/n inside the
    same XLA fusion; here a rescale would be a pass of its own over the
    buffers, so the chain does not rescale: the values grow n-fold an op
    (8^32 at the deep chain, still finite in float32), which changes no
    time on the card."""
    def chain(x):
        y = x.clone()
        for _ in range(k):
            y = ar(y)
        return y
    return chain


def _write_row(row: dict, out_path: str) -> None:
    try:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        with open(out_path, "w") as fp:
            json.dump(row, fp)
    except OSError as e:  # a read-only checkout: the stderr line still reports
        print(f"# could not write {out_path}: {e}", file=sys.stderr)


def _agreed(failed: bool, span) -> list:
    """The ranks where ``failed`` holds: across the processes of ``span``
    agreed (``failed_ranks``), so every rank drops the same candidate and
    falls back to the same size; without a span, this process's own."""
    if span is None:
        return [0] if failed else []
    return failed_ranks(failed, span)


def _best_of(run_leg, on_cpu: bool, alloc, span=None) -> tuple:
    """``(seconds per candidate, elements a rank, x0)`` of the first size
    (1 GiB a rank, then 256 MiB; 8 MiB on the CPU) at which a candidate
    survives ``run_leg(x0)``, ``x0 = alloc(nbytes)``. A failure loses the
    best-of, never the run; across the processes of ``span`` each size's
    allocation is agreed (``_agreed``), as ``run_leg``'s candidates are.
    A rank that fails inside a candidate's collectives leaves its peers
    to the group's timeout; what fails before or after them is agreed."""
    secs, elems, x0 = {}, 0, None
    for nbytes in ([8 * M.MiB] if on_cpu else [M.GiB, 256 * M.MiB]):
        elems = nbytes // 4
        err, x0 = None, None
        try:
            x0 = alloc(nbytes)
        except RuntimeError as e:  # e.g. the buffer itself did not fit
            err = f"{type(e).__name__}: {str(e)[:160]}"
        bad = _agreed(err is not None, span)
        if bad:
            print(f"# {nbytes >> 20} MiB/rank leg failed"
                  + (f" on rank(s) {bad}" if span is not None else "")
                  + (f": {err}" if err else ""), file=sys.stderr)
        else:
            secs = run_leg(x0)
        if secs:
            break
        print(f"# {nbytes >> 20} MiB/rank: no surviving candidate, trying the "
              f"next size", file=sys.stderr)
    if not secs:
        raise RuntimeError("every allreduce candidate failed")
    return secs, elems, x0


def _run_candidates(algos: dict, x0: torch.Tensor, depth: dict, span=None) -> dict:
    """Each candidate's marginal trials; one that fails on any rank of
    ``span`` is dropped on every rank (``_agreed``)."""
    leg = {}
    for name, ar in algos.items():
        err = None
        try:
            trials = marginal_trials(functools.partial(_chain, ar=ar), (x0,),
                                     **depth, span=span)
        except (RuntimeError, ValueError) as e:  # loses the best-of, never the run
            err = f"{type(e).__name__}: {str(e)[:200]}"
        bad = _agreed(err is not None, span)
        if bad:
            print(f"# algo {name} failed"
                  + (f" on rank(s) {bad}" if span is not None else "")
                  + (f": {err}" if err else ""), file=sys.stderr)
        else:
            leg[name] = trials
    return leg


def _depth(on_cpu: bool) -> dict:
    return dict(k1=2, k2=8 if on_cpu else 32, repeats=3 if on_cpu else 5,
                trials=1 if on_cpu else 3)


def multi_rank(n: int, device: torch.device, kind: str, on_cpu: bool,
               hbm_bw: float, extras: list, out_path: str) -> dict:
    """The scored allreduce busbw line of n ranks on ``device``; appends the
    alltoall extra leg to ``extras``."""
    algos = {
        "fused": C.fused_allreduce,
        "ring_bidir": lambda y: C.ring_allreduce(y, bidir=True),
        # the registered algo="khd" form is bidirectional
        "khd": lambda y: C.khd_allreduce(y, bidir=True),
    }
    fac = _balanced_factor(n)
    if fac is not None:  # the 2-D mesh's flagship, over the same ranks
        algos["khd2d"] = lambda y: C.khd2d_allreduce(y, fac, bidir=True)
    algos["cuda_ring"] = _cuda_ring_inplace
    depth = _depth(on_cpu)

    secs, elems, x0 = _best_of(
        lambda x0: _run_candidates(algos, x0, depth), on_cpu,
        lambda nbytes: _randn((n, nbytes // 4), device, seed=0))
    winner = min(secs, key=lambda a: median(secs[a]))
    print(f"# allreduce @ {elems * 4 >> 20} MiB/rank, {n} ranks on one card: winner "
          f"{winner} ({', '.join(f'{a}={median(s) * 1e6:.0f}us med' for a, s in secs.items())})",
          file=sys.stderr)
    wt = sorted(M.busbw_GBps("allreduce", n, elems * 4, s) for s in secs[winner])
    value = median(wt)
    # one card: the kernel's bound moves 2 n S bytes through HBM, so busbw
    # per rank is at most HBM x (n-1)/n^2
    target = 0.9 * hbm_bw * (n - 1) / n ** 2
    out = {"metric": "allreduce_busbw_GBps_per_chip", "value": round(value, 3),
           "unit": "GB/s", "vs_baseline": round(value / target, 4),
           "algo": winner, "stat": "median-of-trials",
           "spread": [round(wt[0], 3), round(wt[-1], 3)],
           "ranks_per_card": n, "link": "hbm-loopback", "device": kind}

    def alltoall_extra():
        def a2a(y):
            return C.fused_alltoall(y.reshape(n, n, -1)).reshape(y.shape)
        tr = marginal_trials(functools.partial(_chain, ar=a2a), (x0,), **depth)
        row = M.scored_algbw_row(tr, elems * 4, n, "fused", on_cpu)
        row.update(ranks_per_card=n, link="hbm-loopback", device=kind)
        _write_row(row, out_path)
        return "# alltoall scored artifact: " + json.dumps(row)
    extras.append(alltoall_extra)
    return out


# -- N processes, one rank each -------------------------------------------------

NVLINK_SOURCE = "datasheet: NVLink 4, 900 GB/s a GPU, 450 GB/s each way (not measured)"


def across_processes(topo, kind: str, on_cpu: bool, hbm_bw: float, extras: list,
                     out_path: str) -> dict:
    """The scored allreduce busbw line of the fleet's ranks, one a process
    (printed by rank 0); appends the alltoall leg across processes to
    ``extras``."""
    n = topo.n_processes
    t = Transport(rank_mesh(n, topo.device, group=torch.distributed.group.WORLD))
    span = t.span
    algos = {a: t.jit_fn("allreduce", a) for a in ("fused", "ring_bidir", "khd")}
    fac = _balanced_factor(n)
    if fac is not None:
        # a spanning 2-D mesh is one slice a process: it holds the factor
        # (s, p) only as s processes of p ranks, and a process here holds one
        print(f"# algo khd2d skipped: the spanning 2-D mesh is one slice a "
              f"process; the balanced factor {fac[0]}x{fac[1]} of {n} ranks needs "
              f"{fac[0]} processes of {fac[1]} ranks, and each of the {n} holds one",
              file=sys.stderr)

    def inplace(y):
        return ring_cuda.hbm_ring_allreduce_across(y, span, _inplace_tile_rows(y, n))
    algos["cuda_ring"] = inplace
    depth = _depth(on_cpu)

    secs, elems, x0 = _best_of(
        lambda x0: _run_candidates(algos, x0, depth, span), on_cpu,
        lambda nbytes: _randn((1, nbytes // 4), topo.device, seed=span.index), span)
    winner = min(secs, key=lambda a: median(secs[a]))
    if span.index == 0:
        print(f"# allreduce @ {elems * 4 >> 20} MiB/rank, {n} processes: winner "
              f"{winner} ({', '.join(f'{a}={median(s) * 1e6:.0f}us med' for a, s in secs.items())})",
              file=sys.stderr)
    wt = sorted(M.busbw_GBps("allreduce", n, elems * 4, s) for s in secs[winner])
    value = median(wt)
    chip = hw.chip_for(kind)
    out = {"metric": "allreduce_busbw_GBps_per_chip", "value": round(value, 3),
           "unit": "GB/s", "algo": winner, "stat": "median-of-trials",
           "spread": [round(wt[0], 3), round(wt[-1], 3)],
           "ranks_per_card": span.per_card, "processes": n, "device": kind}
    if span.staged:  # the processes share a GPU: its HBM carries every byte
        target = 0.9 * hbm_bw * (n - 1) / n ** 2
        out.update(link="host-loopback")
    else:
        each_way = chip.link_GBps / 2 if chip else _CPU_FALLBACK_LINK_GBPS
        target = 0.9 * each_way
        out.update(link="nvlink" if topo.platform == "gpu" else "cpu-loopback",
                   bound_GBps=each_way,
                   bound_source=NVLINK_SOURCE if chip else "placeholder (no datasheet row)")
    out["vs_baseline"] = round(value / target, 4)

    def alltoall_extra():
        c = elems // n
        a2a = t.jit_fn("alltoall", "fused")
        tr = marginal_trials(functools.partial(_chain, ar=a2a),
                             (x0[:, :n * c].reshape(1, n, c),), **depth, span=span)
        row = M.scored_algbw_row(tr, n * c * 4, n, "fused", on_cpu)
        row.update(ranks_per_card=span.per_card, processes=n, link=out["link"],
                   device=kind)
        if span.index != 0:
            return None
        _write_row(row, out_path)
        return "# alltoall scored artifact: " + json.dumps(row)
    extras.append(alltoall_extra)
    return out


# -- one rank -----------------------------------------------------------------

def _model_pick_lines(kind: str) -> str:
    """The cost model's pick at the contract point (64 ranks, 1 GiB) with
    this card's constants, one rank a card: the schedule the scored fold
    belongs to, and the ring-embedded khd digits where they differ."""
    from rocnrdma_tpu_torch.transport.tuner import (constants_for, khd_model_digits,
                                                    model_pick)
    a_, b_, hb_ = constants_for(kind, "allreduce")
    mp = model_pick("allreduce", 64, M.GiB,
                    candidates=("ring", "ring_bidir", "tree", "khd", "dtree", "ktree",
                                "ptree"),
                    alpha=a_, beta=b_, hbm_beta=hb_, device_kind=kind)
    digs = (khd_model_digits("allreduce", 64, M.GiB, a_, b_, hb_, device_kind=kind)
            if mp == "khd" else None)
    lines = [f"# model pick @ 1 GiB, n=64, card constants (one rank a card): {mp}"
             + (f" digits {digs}" if digs else "")
             + " (the schedule the scored fold belongs to; switch-priced)"]
    ring_digs = khd_model_digits("allreduce", 64, M.GiB, a_, b_, hb_,
                                 embedding="ring", device_kind=kind)
    if digs is not None and ring_digs != digs:
        lines.append(f"# ring-embedded second opinion: digits {ring_digs}")
    return "\n".join(lines)


def one_rank(device: torch.device, kind: str, on_cpu: bool, hbm_bw: float) -> dict:
    """The scored ``local_reduce_GBps`` line of the fold on ``device``."""
    target = 0.9 * hbm_bw
    # the roofline guard needs a real roofline (a hw.CHIPS row)
    guard_roofline = not on_cpu and hw.chip_for(kind) is not None
    budget = ADDEND_BUDGET if not on_cpu else 8 * M.MiB
    floor = 4 * M.MiB if not on_cpu else 64 * M.KiB

    def op_elems(n_ops: int, nbytes: int) -> int:
        return ladder_op_elems(n_ops, nbytes, budget, floor)

    def gen_args(n_ops: int, nbytes: int):
        return tuple(_randn((op_elems(n_ops, nbytes),), device, seed=j) for j in range(n_ops))

    def trials_gbps(kernel, n_ops, args, k1, k2):
        elems = args[0].numel()
        tr = marginal_trials(lambda k: make_combine_chain(kernel, k), args,
                             k1=k1, k2=k2, repeats=5, trials=4)
        return sorted((n_ops + 1) * elems * 4 / s / 1e9 for s in tr)

    def run_leg(nbytes):
        leg = {}
        for name, kernel, n_ops, _why in KERNELS:
            args = gen_args(n_ops, nbytes)
            for k1, k2 in ((8, 128), (32, 256)):
                span = trials_gbps(kernel, n_ops, args, k1, k2)
                if not guard_roofline or span[-1] <= hbm_bw:
                    leg[name] = (median(span), span, args[0].numel())
                    break
                print(f"# {name}@k2={k2}: {span[-1]:.0f} GB/s exceeds the "
                      f"{hbm_bw:.0f} GB/s HBM roofline", file=sys.stderr)
            else:
                print(f"# {name}: dropped (exceeds the roofline at every chain depth)",
                      file=sys.stderr)
            del args
        return leg

    cands, nbytes = {}, 0
    for nbytes in ([8 * M.MiB] if on_cpu else [M.GiB, 256 * M.MiB]):
        try:
            cands = run_leg(nbytes)
            if cands:
                break
            print(f"# {nbytes >> 20} MiB leg: every candidate dropped (roofline "
                  f"guard), trying the next size", file=sys.stderr)
        except RuntimeError as e:  # allocation refused at this size
            print(f"# {nbytes >> 20} MiB leg failed: {type(e).__name__}: "
                  f"{str(e)[:200]}", file=sys.stderr)
    if not cands:
        raise RuntimeError("every one-rank fold leg failed")
    winner = max(cands, key=lambda a: cands[a][0])
    listing = ", ".join(f"{a}={v:.0f}GB/s span {t[0]:.0f}-{t[-1]:.0f}"
                        for a, (v, t, _) in cands.items())
    print(f"# local fold @ {nbytes >> 20} MiB: winner {winner} ({listing})", file=sys.stderr)
    if guard_roofline:
        print(_model_pick_lines(kind), file=sys.stderr)
    _, trials, w_elems = cands[winner]
    w_kernel, w_nops, w_why = next((k, o, why) for nm, k, o, why in KERNELS if nm == winner)
    if not on_cpu:
        # the winner runs a second time so the pool samples more than one
        # state of the machine; the scored value is the pooled median
        more = trials_gbps(w_kernel, w_nops, gen_args(w_nops, nbytes), 8, 128)
        trials = sorted(trials + [g for g in more if not guard_roofline or g <= hbm_bw])
        print(f"# winner rerun: pooled span {trials[0]:.0f}-{trials[-1]:.0f} GB/s",
              file=sys.stderr)
    value = median(trials)
    moved = value * 3 * (w_nops - 1) / (w_nops + 1)
    print(f"# {winner}: {value:.1f} GB/s at the reference's (N+1) = {w_nops + 1} "
          f"bytes/element; the pairwise fold moves 3(N-1) = {3 * (w_nops - 1)} "
          f"bytes/element, {moved:.1f} GB/s of device memory traffic "
          f"({w_elems * 4 >> 20} MiB operands)", file=sys.stderr)
    return {"metric": "local_reduce_GBps", "value": round(value, 3), "unit": "GB/s",
            "vs_baseline": round(value / target, 4), "kernel": winner,
            "n_ops": w_nops, "schedule": w_why, "stat": "median-of-trials",
            "spread": [round(trials[0], 3), round(trials[-1], 3)],
            "fold": "pairwise", "device": kind}


# -- the MFU leg ----------------------------------------------------------------

def mfu_shape(on_cpu: bool) -> tuple[int, int, int, torch.dtype]:
    """(T, d, ffn, dtype) of the MFU leg."""
    return (256, 256, 512, torch.float32) if on_cpu else (4096, 2048, 8192, torch.bfloat16)


def mfu_inputs(T: int, d: int, ffn: int, dtype: torch.dtype, device: torch.device):
    """``(w_in, w_out, tokens, logits)``: bench.py's draws from
    ``default_rng(7)``, made in float64 by numpy and cast once."""
    from rocnrdma_tpu_torch.workloads import from_numpy
    rng = np.random.default_rng(7)
    w_in = rng.standard_normal((1, d, ffn)) / np.sqrt(d)
    w_out = rng.standard_normal((1, ffn, d)) / np.sqrt(ffn)
    tokens = rng.standard_normal((1, T, d))
    logits = rng.standard_normal((1, T, 1))
    return (*from_numpy((w_in, w_out, tokens), device, dtype),
            from_numpy(logits, device, torch.float32))


def one_expert_step(t: Transport, T: int, w_in, w_out):
    """The one-expert MoE layer with the FFN expert: router -> dispatch ->
    FFN -> combine on one rank, the ``auto`` (fused) alltoall."""
    from rocnrdma_tpu_torch.workloads.moe import ffn_expert, moe_topk_step
    return moe_topk_step(t, "auto", True, 1, T, 1, expert=ffn_expert(w_in, w_out))


def train_grads(t: Transport, T: int, ws, tokens, logits):
    """Gradients of ``sum(out**2)`` (in float32) in the two expert weights;
    the tokens are not differentiated."""
    wi, wo = (w.detach().requires_grad_(True) for w in ws)
    with torch.enable_grad():
        out, _ = one_expert_step(t, T, wi, wo)(tokens, logits)
        out = out.float()
        return torch.autograd.grad((out * out).sum(), (wi, wo))


def train_step(t: Transport, T: int, ws, tokens, logits, lr: float = 1e-4):
    """One SGD step of the two expert weights."""
    grads = train_grads(t, T, ws, tokens, logits)
    with torch.no_grad():
        return tuple((w - lr * g).to(w.dtype) for w, g in zip(ws, grads))


def mfu_leg(on_cpu: bool, device: torch.device, kind: str) -> str:
    """Forward and train-step time and MFU of the one-expert layer."""
    T, d, ffn, dtype = mfu_shape(on_cpu)
    t = Transport(rank_mesh(1, device))
    w_in, w_out, tokens, logits = mfu_inputs(T, d, ffn, dtype, device)
    step = one_expert_step(t, T, w_in, w_out)

    def make_chain(k):
        def chain(tok, lg):
            y = tok
            for _ in range(k):
                y = step(y, lg)[0].to(dtype)
            return y
        return chain

    with torch.no_grad():
        sec = marginal_s_per_op(make_chain, (tokens, logits), k1=2,
                                k2=8 if on_cpu else 48, repeats=3 if on_cpu else 5,
                                trials=1 if on_cpu else 3)
    flops = 4 * T * d * ffn  # two matmuls, 2 flops per MAC
    chip = hw.chip_for(kind)
    peak = chip.bf16_tflops * 1e12 if chip else 1e12
    vs = (f"vs the bf16 data-sheet peak ({peak / 1e12:.0f} TFLOP/s)" if chip else
          f"vs a 1 TFLOP/s placeholder ({kind} has no data-sheet row: not an MFU)")
    dname = str(dtype).removeprefix("torch.")
    lines = [f"# flagship step (moe-ffn fwd, T={T} d={d} ffn={ffn} {dname}): "
             f"{sec * 1e6:.0f} us/step, {flops / sec / 1e12:.1f} TFLOP/s, "
             f"MFU {flops / sec / peak:.2f} {vs}"]
    if not on_cpu:
        # is the step host-bound? host enqueue vs the card's own time
        with torch.no_grad():
            def one():
                return step(tokens, logits)
            for _ in range(3):
                one()
            h = enqueue_s(one, 20)
            dv = device_s(one, 20, h)
        lines.append(f"# flagship step split: host enqueue {h * 1e6:.0f} us, device "
                     f"{dv * 1e6:.0f} us per step (device-only MFU "
                     f"{flops / dv / peak:.2f})")

    def make_train_chain(k):
        def chain(wi, wo, tok, lg):
            ws = (wi, wo)
            for _ in range(k):
                ws = train_step(t, T, ws, tok, lg)
            return ws[0]
        return chain

    # fwd 4 T d ffn + bwd 6 T d ffn (dW of both matmuls, dx through the
    # second only: the tokens are not differentiated)
    tflops = 10 * T * d * ffn
    guard_peak = not on_cpu and chip is not None
    depths = ((2, 4),) if on_cpu else ((4, 32), (8, 64))
    tsec, mfu = 0.0, float("inf")
    for i, (k1, k2) in enumerate(depths):
        tsec = marginal_s_per_op(make_train_chain, (w_in, w_out, tokens, logits),
                                 k1=k1, k2=k2, repeats=3 if on_cpu else 5,
                                 trials=1 if on_cpu else 3)
        mfu = tflops / tsec / peak
        if not guard_peak or mfu <= 1.0:
            break
        if i + 1 < len(depths):
            print(f"# train-step MFU {mfu:.2f} > 1 at k2={k2} (impossible): "
                  f"deepening the chain", file=sys.stderr)
    lines.append(f"# flagship TRAIN step (fwd+bwd+sgd, same layer): "
                 f"{tsec * 1e6:.0f} us/step, {tflops / tsec / 1e12:.1f} TFLOP/s, "
                 f"MFU {mfu:.2f} {vs}"
                 + (" [UNRELIABLE: exceeds peak at max depth]"
                    if guard_peak and mfu > 1.0 else ""))
    return "\n".join(lines)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="headline", description=__doc__.split("\n\n")[0])
    p.add_argument("--fake-devices", type=int, default=None,
                   help="host N ranks on the one device: N >= 2 scores the allreduce")
    p.add_argument("--platform", choices=("auto", "cpu"), default="auto")
    p.add_argument("--out", default=None,
                   help="the alltoall artifact of the N-rank branch (default "
                        "rocnrdma_tpu_torch/results/alltoall_algbw.json)")
    args = p.parse_args(argv)

    across = cli_common.join(args.platform)
    n = args.fake_devices or 1
    topo = cli_common.setup_backend(args.fake_devices if across else n, args.platform,
                                   across=True)
    device, kind, on_cpu = topo.device, topo.device_name, topo.is_oracle
    chip = hw.chip_for(kind)
    hbm_bw = chip.hbm_GBps if chip else _CPU_FALLBACK_HBM_GBPS
    out_path = args.out or os.path.join(RESULTS_DIR, "alltoall_algbw.json")
    lead = cli_common.is_lead()
    extras = []
    if across:
        out = across_processes(topo, kind, on_cpu, hbm_bw, extras, out_path)
    elif n >= 2:
        out = multi_rank(n, device, kind, on_cpu, hbm_bw, extras, out_path)
    else:
        out = one_rank(device, kind, on_cpu, hbm_bw)
    # the scored line first: a run cut during the extras keeps it
    if lead:
        print(json.dumps(out), flush=True)
    for extra in extras:
        try:
            line = extra()
            if line:
                print(line, file=sys.stderr, flush=True)
        except (RuntimeError, ValueError) as e:  # an extra never costs the headline
            print(f"# extra leg failed: {type(e).__name__}: {str(e)[:200]}",
                  file=sys.stderr)
    if across:
        # the MFU leg is one rank's: the group goes first, so no peer
        # waits on rank 0 through it
        from rocnrdma_tpu_torch.runtime.init import shutdown_runtime
        shutdown_runtime()
    if lead:
        try:
            print(mfu_leg(on_cpu, device, kind), file=sys.stderr, flush=True)
        except (RuntimeError, ValueError) as e:
            print(f"# extra leg failed: {type(e).__name__}: {str(e)[:200]}",
                  file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(cli_common.main(main))
