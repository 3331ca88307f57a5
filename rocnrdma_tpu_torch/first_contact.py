"""``first_contact`` — the one-command bring-up runbook on a new machine.

Counterpart of ``rocnrdma_tpu/first_contact.py``: the sequence of checks
and measurements a new machine needs before its numbers mean anything, as
one command::

    python -m rocnrdma_tpu_torch.first_contact [--outdir DIR]

runs, in order:

0. **calibrate_chip** — ``fold_ladder`` + ``measure_alpha`` on the live
   card, persisted as this card's calibration artifact
   (``hw.save_calibration``), so the tuner's radix picks ride THIS card's
   measured constants. On the card it lands at the default path
   (``rocnrdma_tpu_torch/results/hw_<card>.json``, or under
   ``RNR_HW_CAL_DIR``), where it overrides ``hw.MEASURED`` for every later
   process on the machine; on the CPU it lands in ``--outdir``.
1. **dryrun** — ``graft_entry.dryrun_multichip(n)`` in a fresh subprocess
   on the device the platform names: the training step's collectives over
   n ranks, each checked against numpy.
2. **cli_smoke** — ``bench_allreduce`` / ``bench_alltoall`` /
   ``bench_allgather`` at a small size on the live mesh (on the card with
   the ``cuda_ring`` arm): every layer (CLI -> transport -> schedule ->
   kernel) runs and self-checks against numpy.
3. **measured_sweep** — ``Autotuner.sweep`` over the live mesh at the size
   grid, every arm (on the card ``cuda_ring`` too): the empirical table
   that supersedes the model's.
3b. **alltoall_scored** — alltoall algbw at the largest size, median of
   trials and spread (``metrics.scored_algbw_row``).
4. **table_merge** — ``merge_tables`` of the measured table over the model
   table (default: the one ``tuner.model_table`` derives for this card,
   written to ``tuning_model.json``): provenance becomes ``mixed``;
   ``algo="auto"`` users point ``RNR_TUNING`` at the output.
5. **align_steps** — one ``trace --measured --align-steps`` capture of an
   explicit schedule: per-step predicted-vs-measured rows.

The sweep's rows (every (verb, size, algo) with its busbw) land in
``first_contact_baseline.jsonl``. Each run starts a fresh
``<outdir>/report.jsonl`` and each step appends its row there
(``{"step": ..., "ok": ..., ...}``, with the kernels' launches of the
step where there were any); a failed step records its error and the run
goes on. Exit code = number of failed steps. ``--outdir`` defaults to
``rocnrdma_tpu_torch/results/first_contact`` (gitignored).

Under a launcher's fleet (``runtime.multiprocess.run_cli`` or torchrun)
every step runs in every process, one rank a process: step 0 on each
card, its calibration the fleet's median, written once; step 1 in a
fresh subprocess on each card; steps 2-5 on the mesh that spans the
processes (the sweep's and the scored alltoall's times the slowest
rank's, the model table keyed by the layout). Each step's ok is agreed
across the fleet, the failed ranks named, so the exit code is the same
on every rank; rank 0 alone writes the files and ``report.jsonl``.

    torchrun --nproc-per-node 4 -m rocnrdma_tpu_torch.first_contact
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_DEFAULT_OUTDIR = os.path.join(_ROOT, "rocnrdma_tpu_torch", "results",
                               "first_contact")


def _report(outdir: str, row: dict) -> None:
    with open(os.path.join(outdir, "report.jsonl"), "a") as fp:
        fp.write(json.dumps(row) + "\n")


def _step(outdir, name, fn, span=None):
    """Run one runbook step; record ok/error, wall seconds and the kernels'
    launches; never raise. Across the processes of ``span`` the ok is
    agreed (``timing.failed_ranks``): a step that failed on any rank fails
    on every rank, the ranks named, and rank 0 alone reports it."""
    from rocnrdma_tpu_torch import ops
    from rocnrdma_tpu_torch.bench.timing import failed_ranks

    t0 = time.monotonic()
    lead = span is None or span.index == 0
    if lead:
        print(f"[first_contact] {name} ...", file=sys.stderr, flush=True)
    before = ops.launch_counts()
    try:
        extra = fn() or {}
        row = {"step": name, "ok": True, **extra}
    except BaseException as e:  # SystemExit from argparse'd sub-CLIs too
        if isinstance(e, KeyboardInterrupt):
            raise
        row = {"step": name, "ok": False,
               "error": f"{type(e).__name__}: {str(e)[:300]}"}
    launched = {k: v - before[k] for k, v in ops.launch_counts().items()
                if v > before[k]}
    if launched:
        row["launches"] = launched  # this process's
    if span is not None:
        bad = failed_ranks(not row["ok"], span)
        if bad:
            where = f"failed on rank(s) {bad} of {span.size}"
            row = ({"step": name, "ok": False, "error": where} if row["ok"]
                   else {**row, "error": f"{where}; here: {row['error']}"})
    row["seconds"] = round(time.monotonic() - t0, 2)
    if lead:
        _report(outdir, row)
    if lead or not row["ok"]:
        print(f"[first_contact] {name}: "
              f"{'ok' if row['ok'] else 'FAILED — ' + row['error']} "
              f"({row['seconds']}s)", file=sys.stderr, flush=True)
    return row


# the launcher's variables: a step's subprocess runs on its own, outside
# the fleet
_LAUNCHER_ENV = ("COORDINATOR_ADDRESS", "WORLD_SIZE", "RANK", "LOCAL_RANK",
                 "MASTER_ADDR", "MASTER_PORT", "TORCHELASTIC_USE_AGENT_STORE")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="first_contact", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--outdir", default=_DEFAULT_OUTDIR)
    p.add_argument("--ranks", type=int, default=None,
                   help="rank count (default: every rank the backend hosts)")
    p.add_argument("--mesh2d", default=None, metavar="SLICESxPER",
                   help="2-D ('slice','intra') mesh shape")
    p.add_argument("--platform", choices=("auto", "cpu"), default="auto")
    p.add_argument("--fake-devices", type=int, default=None,
                   help="host this many ranks on the one device")
    p.add_argument("--smoke-size", default="1M",
                   help="CLI smoke leg size (small on purpose)")
    p.add_argument("--sizes", default="4K,64K,1M,16M",
                   help="measured-sweep size grid")
    p.add_argument("--verbs",
                   default="allreduce,alltoall,allgather,reduce_scatter")
    p.add_argument("--align-algo", default=None,
                   help="schedule for the step-alignment capture "
                        "(default: khd on a 1-D mesh, khd2d on --mesh2d)")
    p.add_argument("--align-size", default="4M")
    p.add_argument("--model-table", default=None,
                   help="tuning table to merge under the measured sweep "
                        "(default: tuner.model_table for this card)")
    p.add_argument("--skip-dryrun", action="store_true",
                   help="skip step 1 (e.g. when it already ran)")
    p.add_argument("--skip-calibrate", action="store_true",
                   help="skip step 0 (e.g. when a trusted hw_<card>.json "
                        "already exists)")
    p.add_argument("--calibrate-widths", default="2,3,4,8,16,32,48,64",
                   help="fold-ladder widths for step 0 on the card (width 2, "
                        "the pairwise anchor, is always measured)")
    args = p.parse_args(argv)

    if args.align_algo is None:
        # the 1-D explicit schedules don't resolve on a 2-D mesh; align
        # the topology-mapped khd there instead
        args.align_algo = "khd2d" if args.mesh2d else "khd"
    from rocnrdma_tpu_torch import metrics as M
    from rocnrdma_tpu_torch.bench import cli_common
    from rocnrdma_tpu_torch.bench.runner import parse_size
    from rocnrdma_tpu_torch.transport import Transport
    from rocnrdma_tpu_torch.transport.tuner import (
        Autotuner, TuningTable, merge_tables, model_table)

    topo = cli_common.setup_backend(args.fake_devices, args.platform, args.ranks,
                                    across=True)
    on_cpu = topo.is_oracle
    n = args.ranks or topo.n_devices
    span = cli_common.fleet_span(topo)  # None in one process
    lead = cli_common.is_lead()
    os.makedirs(args.outdir, exist_ok=True)
    if lead:  # this run's rows only
        open(os.path.join(args.outdir, "report.jsonl"), "w").close()
    rows = []

    # -- 0. calibrate THIS card: the fold-rate ladder and the dispatch
    # alpha, persisted so every later tuner pick rides them
    if not args.skip_calibrate:
        def calibrate():
            from rocnrdma_tpu_torch import hw
            from rocnrdma_tpu_torch.bench.fold_ladder import OP_FLOOR, run_ladder
            from rocnrdma_tpu_torch.transport.tuner import measure_alpha
            kind = topo.device_name
            if on_cpu:  # plumbing proof, not calibration
                budget, cap, floor, k1, k2, reps, trials = (
                    M.MiB, 256 * M.KiB, 64 * M.KiB, 2, 4, 2, 1)
                widths = (2, 4, 8)
                alpha_kw = {"k1": 32, "k2": 512, "repeats": 2, "trials": 1}
            else:  # fold_ladder's and tuner --measure-alpha's defaults
                budget, cap, floor, k1, k2, reps, trials = (
                    4 * M.GiB, M.GiB, OP_FLOOR, 2, 10, 3, 3)
                widths = tuple(int(w) for w in args.calibrate_widths.split(","))
                alpha_kw = {}
            if 2 not in widths:
                # the pairwise anchor is load-bearing: hw.fold_ladder_for
                # rejects an anchorless artifact
                widths = (2,) + tuple(widths)
            lad_rows = run_ladder(widths, budget, cap, k1, k2, reps, trials,
                                  topo.device, dtype="float32", floor=floor,
                                  span=span)
            # each rank's card measured on its own; the fleet's median
            # (one process: its own numbers)
            *meds, alpha = cli_common.fleet_median(
                [r["GBps_median"] for r in lad_rows]
                + [measure_alpha(device=topo.device, **alpha_kw)], span)
            ladder = {str(r["n_ops"]): m for r, m in zip(lad_rows, meds)}
            # hbm_frac is the pairwise anchor's rate over the datasheet
            # peak (hw.MEASURED's definition)
            chip = hw.chip_for(kind)
            frac = float(ladder["2"]) / chip.hbm_GBps if chip else None
            fleet = "" if span is None else f", the median of {span.size} processes"
            data = {"fold_ladder": ladder, "dispatch_alpha_s": alpha,
                    "provenance": "first_contact step 0 (fold_ladder + "
                                  "measure_alpha on the live card"
                                  + (f", {hw.smi_line()}" if not on_cpu else "")
                                  + fleet + ")"}
            if frac is not None and 0 < frac < 1:
                data["hbm_frac"] = round(frac, 4)
            # the CPU's artifact goes to --outdir (a fake-card ladder must
            # not shadow the real defaults); the card's to the default path
            path = cli_common.save_calibration(
                kind, data, span, base_dir=args.outdir if on_cpu else None)
            return {"artifact": path, "device_kind": kind,
                    "widths": len(ladder),
                    "dispatch_alpha_ns": round(alpha * 1e9, 1)}
        rows.append(_step(args.outdir, "calibrate_chip", calibrate, span))

    # -- 1. dryrun: the training step's collectives over n ranks, fresh
    # process (across processes: each rank's, on its own card)
    if not args.skip_dryrun:
        def dryrun():
            env = {k: v for k, v in os.environ.items() if k not in _LAUNCHER_ENV}
            env["PYTHONPATH"] = _ROOT + os.pathsep + env.get("PYTHONPATH", "")
            dev = "'cpu'" if on_cpu else repr(str(topo.device))
            res = subprocess.run(
                [sys.executable, "-c",
                 "from rocnrdma_tpu_torch import graft_entry as g; "
                 f"g.dryrun_multichip({n}, device={dev})"],
                capture_output=True, text=True, timeout=900, cwd=_ROOT,
                env=env)
            if res.returncode != 0:
                raise RuntimeError(res.stderr[-300:])
            return {"stdout": res.stdout.strip()[-200:]}
        rows.append(_step(args.outdir, "dryrun", dryrun, span))

    # -- 2. CLI family smoke on the live mesh (self-checks vs numpy; on the
    # card each cuda_ring point also bitwise its kernels' plain versions)
    def cli_smoke():
        from rocnrdma_tpu_torch.bench import (
            bench_allgather, bench_allreduce, bench_alltoall)
        out = os.path.join(args.outdir, "cli_smoke.jsonl")
        common = ["--sizes", args.smoke_size, "--warmup", "1", "--repeats",
                  "2", "--iters", "2", "--out", out,
                  "--platform", args.platform]
        if args.mesh2d:
            common += ["--mesh2d", args.mesh2d]
        elif args.ranks:
            common += ["--ranks", str(args.ranks)]
        if args.fake_devices:
            common += ["--fake-devices", str(args.fake_devices)]
        if not on_cpu:  # the kernel arm too (on the CPU it is its plain version)
            common += ["--algos", "fused,ring,cuda_ring", "--check-plain"]
        if lead and os.path.exists(out):
            os.remove(out)  # this run's records only (the CLIs append)
        for cli in (bench_allreduce, bench_alltoall, bench_allgather):
            rc = cli.main(list(common))
            if rc:
                raise RuntimeError(f"{cli.__name__} exited {rc}")
        return {"jsonl": out}
    rows.append(_step(args.outdir, "cli_smoke", cli_smoke, span))

    # -- 3. measured sweep over the live mesh, collecting the busbw rows
    mesh = cli_common.build_mesh(args.mesh2d, args.ranks, topo)
    t = Transport(mesh)
    sizes = [parse_size(s) for s in args.sizes.split(",")]
    verbs = args.verbs.split(",")
    baseline_path = os.path.join(args.outdir, "first_contact_baseline.jsonl")
    measured_path = os.path.join(args.outdir, "tuning_measured.json")
    sweep_rows = []
    measured = []  # the sweep's table, the same on every rank

    def sweep():
        def progress(verb, size, algo, sec):
            coll = verb.replace("_", "")
            sweep_rows.append(
                {"bench": "first_contact", "collective": coll, "algo": algo,
                 "n_ranks": t.n_ranks, "size_bytes": size,
                 "s_per_call": sec,
                 "busbw_GBps": round(M.busbw_GBps(coll, t.n_ranks, size,
                                                  sec), 3),
                 "device_kind": t.device_kind})
        # on the card every arm competes, the kernels' too; on the CPU the
        # kernel arm would time its plain version, so it sits out
        from rocnrdma_tpu_torch.transport.api import ALGOS
        table = Autotuner(t, warmup=1, repeats=2, calls_per_repeat=2).sweep(
            verbs, sizes, algos=None if on_cpu else ALGOS, progress=progress)
        measured.append(table)
        if lead:
            table.save(measured_path)
            with open(baseline_path, "w") as fp:
                for r in sweep_rows:
                    fp.write(json.dumps(r) + "\n")
        return {"table": measured_path, "baseline_rows": len(sweep_rows),
                "jsonl": baseline_path, "layout": t.table_platform}
    rows.append(_step(args.outdir, "measured_sweep", sweep, span))

    # -- 3b. the alltoall algbw as a scored artifact (median of trials and
    # their spread, the headline's discipline)
    def alltoall_scored():
        from rocnrdma_tpu_torch.bench.runner import _build_input
        from rocnrdma_tpu_torch.bench.timing import marginal_trials
        fn = t.jit_fn("alltoall", "fused")
        x, _, _ = _build_input(t, "alltoall", max(sizes), "float32")
        per_rank = x.numel() * x.element_size() // t._rows  # a row this process holds

        def mk(k):
            def chain(v):
                y = v
                for _ in range(k):
                    y = fn(y)
                return y
            return chain
        tr = marginal_trials(mk, (x,), k1=1, k2=3 if on_cpu else 9,
                             repeats=2 if on_cpu else 5,
                             trials=1 if on_cpu else 3, span=t.span)
        row = M.scored_algbw_row(tr, per_rank, t.n_ranks, "fused", on_cpu)
        out = os.path.join(args.outdir, "alltoall_algbw.json")
        if lead:
            with open(out, "w") as fp:
                json.dump(row, fp)
        return {"artifact": out, **row}
    rows.append(_step(args.outdir, "alltoall_scored", alltoall_scored, span))

    # -- 4. merge: measured rows win, provenance goes honest-mixed
    def merge():
        merged_path = os.path.join(args.outdir, "tuning_merged.json")
        if args.model_table is not None:
            base, model_path = TuningTable.load(args.model_table), args.model_table
        else:
            # the model's table for this card and layout (the key the
            # sweep's rows take), never a TPU table
            base = model_table(t.device_kind, [t.n_ranks], verbs, sizes,
                               platform=t.table_platform,
                               mesh_shapes=[tuple(mesh.shape)] if t.is_2d else None,
                               per_card=None if t.span is None else t.span.per_card)
            model_path = os.path.join(args.outdir, "tuning_model.json")
            if lead:
                base.save(model_path)
        merged = merge_tables(base, measured[0])
        if lead:
            merged.save(merged_path)
        return {"table": merged_path, "model_table": model_path,
                "provenance": merged.meta.get("provenance", "")[:120]}
    rows.append(_step(args.outdir, "table_merge", merge, span))

    # -- 5. one step-alignment capture (per-step predicted vs measured)
    def align():
        from rocnrdma_tpu_torch import trace as T
        out = os.path.join(args.outdir, f"align_{args.align_algo}.trace.json")
        argv2 = ["--collective", "allreduce", "--algo", args.align_algo,
                 "--ranks", str(t.n_ranks), "--size", args.align_size,
                 "--measured", "--align-steps", "--out", out,
                 "--platform", args.platform]
        if args.align_algo == "khd":
            # pin the digits algo="khd" dispatches AT THIS SIZE (the radix
            # ladder's pick), so the aligned schedule is the one that runs
            digs = t.khd_model_digits("allreduce", parse_size(args.align_size))
            argv2 += ["--digits", ",".join(str(d) for d in digs)]
        if args.mesh2d:
            argv2 += ["--mesh2d", args.mesh2d]
        if args.fake_devices:
            argv2 += ["--fake-devices", str(args.fake_devices)]
        T.main(argv2)
        if not lead:  # rank 0 wrote the trace
            return {}
        with open(out) as fp:
            diff = json.load(fp)["otherData"]["step_diff"]
        return {"trace": out, "steps": len(diff)}
    rows.append(_step(args.outdir, "align_steps", align, span))

    failed = sum(1 for r in rows if not r["ok"])
    if lead:
        print(f"[first_contact] {len(rows) - failed}/{len(rows)} steps ok; "
              f"report: {os.path.join(args.outdir, 'report.jsonl')}",
              file=sys.stderr)
    return failed


if __name__ == "__main__":
    from rocnrdma_tpu_torch.bench import cli_common as _cli

    sys.exit(_cli.main(main))
