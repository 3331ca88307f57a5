"""``fold_ladder`` - the fold-width ladder on one card: how fast the card
folds w operands into one, as the port's schedules fold them.

Counterpart of ``rocnrdma_tpu/bench/fold_ladder.py``. The khd radix choice
(``tuner.khd_model_digits``) prices a radix-d round's fold at (d+1) bytes
per part byte and the ladder's rate for width d (``hw.fold_rate_scale``).
The reference times XLA's fused w-operand fold; the port's schedules fold
pairwise (``collectives/khd.py``: one in-place ``reduce_op.fold_`` per
arriving operand), so each width here is timed as exactly that: w-1
in-place adds into one accumulator. The accounting stays the reference's,
(w+1) bytes per element per fold, so the accounted rate falls as w grows
(the adds move 3(w-1) bytes per element) and the ladder's scale carries
the pairwise cost into the model.

Protocol, as the reference's: every width in one process, back to back,
each by the two-depth chained marginal (``timing.marginal_trials``);
operands shrink as the width grows under a fixed total addend budget
(``ladder_op_elems``), the shape of a real radix-d round, which folds d
parts of S/d. Sizes differ from the reference's for the H100's 50 MB L2:
each pairwise add streams the accumulator and one operand, so every
operand is at least ``OP_FLOOR`` = 64 MiB (128 MiB an add, well out of
the cache at every width) under a 4 GiB budget (64 widths of 64 MiB).

    python -m rocnrdma_tpu_torch.bench.fold_ladder [--widths 2,3,4,8,16,32,64]

Under a launcher's fleet (one process a card) every process runs the
ladder on its own card, the gates agreed across the fleet; rank 0 prints
and writes one row a (rank, width), each naming its rank and card, and
``--save-calibration`` writes the fleet's median of each width once.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys

import torch

from rocnrdma_tpu_torch import hw
from rocnrdma_tpu_torch import metrics as M
from rocnrdma_tpu_torch.bench import cli_common
from rocnrdma_tpu_torch.bench.runner import DTYPES, parse_size
from rocnrdma_tpu_torch.bench.timing import agree, fleet_barrier, marginal_trials
from rocnrdma_tpu_torch.collectives.reduce_op import fold_

# the reference's widths: the khd radices of n = 64 plus the narrow anchors
# (2 = a ring step, 3 = the dtree fold, 9 = the ktree fold)
DEFAULT_WIDTHS = (2, 3, 4, 8, 9, 12, 16, 24, 32, 48, 64)

ADDEND_BUDGET = 4 * M.GiB   # total addend footprint per width
OP_FLOOR = 64 * M.MiB       # per-operand floor: out of the 50 MB L2


def ladder_op_elems(n_ops: int, per_op_cap: int,
                    budget: int = ADDEND_BUDGET,
                    floor: int = OP_FLOOR) -> int:
    """Per-operand fp32 element count for an ``n_ops``-wide fold."""
    per = min(per_op_cap, max(floor, budget // max(1, n_ops - 1)))
    return (per // 4) // 1024 * 1024


def fold_chain(n_ops: int, k: int):
    """A callable folding its operands 2..n_ops into the first, in place,
    ``k`` times over: the fold the port's schedules run, one pairwise
    ``fold_`` per operand."""
    def chain(acc, *bs):
        for _ in range(k):
            for b in bs[:n_ops - 1]:
                fold_(acc, b, "sum")
        return acc
    return chain


def run_ladder(widths, addend_budget: int, per_op_cap: int, k1: int, k2: int,
               repeats: int, trials: int, device: torch.device,
               dtype: str = "float32", floor: int = OP_FLOOR,
               span=None) -> list[dict]:
    """Measure each width on ``device``; returns rows, each printed as it
    comes in one process. Each width is first checked on a slice, bitwise
    against the same adds on the host. Across the processes of ``span``
    (each on its own card) each gate is agreed, so one rank's failure fails
    every rank, named, each width starts after a barrier, and nothing is
    printed here: the caller gathers the rows."""
    tdt = DTYPES[dtype]
    isz = tdt.itemsize
    name = (torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu")
    rows = []
    for w in widths:
        elems = ladder_op_elems(w, per_op_cap, addend_budget, floor) * 4 // isz
        g = torch.Generator(device=device).manual_seed(w)
        args = tuple(torch.randn(elems, generator=g, device=device).to(tdt)
                     for _ in range(w))
        # the gate: a 2-deep chain on copies of a slice, bitwise against
        # the same adds out of place on the host (each add rounds once)
        part = min(elems, 32768)
        got = fold_chain(w, 2)(*(a[:part].clone() for a in args)).cpu()
        host = [a[:part].cpu() for a in args]
        want = host[0]
        for _ in range(2):
            for b in host[1:]:
                want = want + b
        agree(span, None if torch.equal(got, want) else f"fold{w}: self-check failed",
              f"fold{w} self-check", exc=SystemExit)
        if span is not None:
            fleet_barrier(span)  # the cards fold at the same time
        tr = marginal_trials(lambda k: fold_chain(w, k), args, k1, k2,
                             repeats, trials)
        rates = sorted((w + 1) * elems * isz / s / 1e9 for s in tr)
        med = statistics.median(rates)
        row = {"bench": "fold_ladder", "n_ops": w, "dtype": dtype,
               "size_bytes": elems * isz, "GBps": rates[-1], "GBps_median": med,
               "spread": [rates[0], rates[-1]], "k1": k1, "k2": k2,
               "device": name, "platform": "gpu" if device.type == "cuda" else "cpu"}
        rows.append(row)
        if span is None:  # a fleet's rows are printed once gathered
            print(format_row(row), flush=True)
        del args
    return rows


def format_row(row: dict) -> str:
    lo, hi = row["spread"]
    where = "" if "rank" not in row else f"  rank {row['rank']} ({row['device']})"
    return (f"fold{row['n_ops']:<3d} {row['dtype']:9s} {row['size_bytes'] / M.MiB:8.1f} "
            f"MiB/operand {row['GBps']:9.1f} GB/s best {row['GBps_median']:9.1f} "
            f"median  span {lo:.1f}-{hi:.1f}{where}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="fold_ladder",
        description="fold-width ladder of the port's pairwise folds "
                    "(khd radix calibration)")
    p.add_argument("--widths", default=None,
                   help=f"comma list of operand counts (default "
                        f"{','.join(map(str, DEFAULT_WIDTHS))})")
    p.add_argument("--budget", default="4G",
                   help="total addend footprint per width (default 4 GiB)")
    p.add_argument("--per-op-cap", default="1G", help="per-operand size cap")
    p.add_argument("--k1", type=int, default=2)
    p.add_argument("--k2", type=int, default=10)
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--trials", type=int, default=3)
    p.add_argument("--dtype", choices=tuple(DTYPES), default="float32")
    p.add_argument("--platform", choices=("auto", "cpu"), default="auto")
    p.add_argument("--out", default=None, help="append JSONL rows here")
    p.add_argument("--save-calibration", action="store_true",
                   help="write the medians (and the width-2 rung's HBM "
                        "fraction) into this card's calibration file")
    args = p.parse_args(argv)

    topo = cli_common.setup_backend(None, args.platform, default_ranks=1, across=True)
    span = cli_common.fleet_span(topo)
    lead = cli_common.is_lead()
    widths = ([int(w) for w in args.widths.split(",")] if args.widths
              else list(DEFAULT_WIDTHS))
    if topo.is_oracle:
        # the CPU checks the plumbing only: shrink so it stays fast
        budget, cap, floor = 1 * M.MiB, 256 * M.KiB, 64 * M.KiB
        k2, repeats, trials = max(args.k1 + 2, 4), 2, 1
    else:
        budget, cap, floor = parse_size(args.budget), parse_size(args.per_op_cap), OP_FLOOR
        k2, repeats, trials = args.k2, args.repeats, args.trials
    chip = hw.chip_for(topo.device_name)
    if args.save_calibration and (chip is None or 2 not in widths):
        raise SystemExit(f"--save-calibration needs a card with a hw.CHIPS row "
                         f"(got {topo.device_name!r}) and width 2, the anchor")
    smi = hw.smi_line() if topo.platform == "gpu" else ""
    fleet = "" if span is None else f" x {span.size} processes"
    if lead:
        print(f"# fold ladder on {topo.device_name}" + (f" ({smi})" if smi else "")
              + fleet)
    rows = run_ladder(widths, budget, cap, args.k1, k2, repeats, trials,
                      topo.device, args.dtype, floor, span)
    if span is not None:
        extra = cli_common.link_extra(topo, span, span.size)
        for row in rows:
            row.update(rank=span.index, device_index=topo.device.index, **extra)
    every = [row for rank_rows in cli_common.gather_rows(rows, span)
             for row in rank_rows]
    if span is not None and lead:
        for row in every:
            print(format_row(row), flush=True)
    if args.out and lead:
        with open(args.out, "a") as fp:
            for row in every:
                fp.write(json.dumps(row) + "\n")
    if args.save_calibration:
        meds = cli_common.fleet_median([r["GBps_median"] for r in rows], span)
        lad = {str(r["n_ops"]): m for r, m in zip(rows, meds)}
        path = cli_common.save_calibration(topo.device_name, {
            "fold_ladder": lad, "hbm_frac": lad["2"] / chip.hbm_GBps,
            "provenance_ladder": f"bench.fold_ladder on {smi}{fleet}"
                                 + ("" if span is None else ", the ranks' median")}, span)
        if lead:
            print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(cli_common.main(main))
