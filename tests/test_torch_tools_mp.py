"""The tools across processes, one rank a process, on the CPU with gloo
(``runtime.multiprocess.run_cli``, and torchrun): the tuner's sweep and
``--measure-alpha``, ``trace --measured --align-steps``, ``first_contact``,
``bench_local``, ``fold_ladder`` and ``mfu_profile``.

Three fleets, started together, two of them running the tools' ``main``
in turn through a worker wrapper written here (``_WRAPPER``), which saves
each rank's results (the tuner's table, the traced collective's output,
each fold gate's chain), reports each calibration write and report row,
and can fail one rank's gate:

- 4 processes: the tuner sweep (``fused``, ``ring``, ``cuda_ring``: the
  kernels' plain versions across processes) and ``--measure-alpha``;
  ``trace --measured --align-steps`` with ``ring`` and ``dtree``; the
  ``--fake-devices`` refusals of the tuner and ``trace``;
- 3 processes: ``first_contact --skip-dryrun`` (allgather and alltoall:
  the sweep's ``tree`` arm needs a power of two, in the reference too),
  ``bench_local``, ``fold_ladder``, ``mfu_profile --profile``, then a
  ``bench_local`` whose gate fails on rank 1 only;
- 2 processes under torchrun (its agent hosts the store): the tuner.

Held: every rank keeps the same table with the same ``times_s`` (the
fleet's maximum) under the layout's key ``cpu/cpu-loopback``; a table never
answers a mesh of the other layout (one process against across
processes) at the same rank count, the committed
``tuning_h100_8x1.json`` resolves as before, and ``model_table`` under a
spanning key prices a GPU a process; the trace's model lane is the JAX
package's ``schedule_events`` for the same (collective, algo, n, size),
with one measured lane group a rank, each of the schedule's step count,
and each rank's output bitwise the one-process port's row; first_contact
exits 0 on every rank, rank 0 alone writes ``report.jsonl`` and the
calibration is written once; the local folds give one row a rank, each
rank's gate chains bitwise the one-process port's and the JAX package's
``make_combine_chain`` (``pallas_hbm_combine`` in interpret mode for the
kernels' rows); one rank's failed gate fails every rank, named.
"""

import importlib
import importlib.util
import json
import os
import pathlib
import subprocess
import sys
import textwrap
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _marks import needs_tpu_interpret
from rocnrdma_tpu import trace as RT
from rocnrdma_tpu.bench import bench_local as RB
from rocnrdma_tpu_torch.bench import bench_local, fold_ladder
from rocnrdma_tpu_torch.runtime import rank_mesh
from rocnrdma_tpu_torch.runtime.mesh import ProcessSpan, RankMesh
from rocnrdma_tpu_torch.runtime.multiprocess import reserve_port, run_cli
from rocnrdma_tpu_torch.transport import Transport, api
from rocnrdma_tpu_torch.transport import tuner as TU

ROOT = pathlib.Path(__file__).resolve().parents[1]
H100 = "NVIDIA H100 80GB HBM3"

_WRAPPER = textwrap.dedent('''
    """One rank of a test fleet of the tools: run RNR_STEPS' CLIs in turn
    (this process's arguments, the platform, after each one's), each
    one's results saved under RNR_DUMP and its outcome a line on stdout.
    The test runs a step in one process through ``hooked`` too."""
    import contextlib
    import importlib
    import json
    import os
    import sys

    import numpy as np
    import torch

    from rocnrdma_tpu_torch import first_contact, hw, trace
    from rocnrdma_tpu_torch.bench import bench_local, cli_common, fold_ladder
    from rocnrdma_tpu_torch.transport import tuner


    def rank():
        d = torch.distributed
        return d.get_rank() if d.is_available() and d.is_initialized() else "one"


    @contextlib.contextmanager
    def hooked(dump, tag, fail_rank=-1):
        """Within: the tuner's sweep table, the traced output and each
        fold gate's chain saved to ``dump/{tag}_{what}_r{rank}``; each
        calibration write and report row a line on stdout; on rank
        ``fail_rank`` the bench_local gate fails."""
        real = {(tuner.Autotuner, "sweep"): tuner.Autotuner.sweep,
                (trace, "_bitwise_equal"): trace._bitwise_equal,
                (bench_local, "make_combine_chain"): bench_local.make_combine_chain,
                (bench_local, "gate_error"): bench_local.gate_error,
                (fold_ladder, "fold_chain"): fold_ladder.fold_chain,
                (hw, "save_calibration"): hw.save_calibration,
                (first_contact, "_report"): first_contact._report}

        def path(what, ext):
            return os.path.join(dump, f"{tag}_{what}_r{rank()}.{ext}")

        def keep_first(what, out):
            # a gate's chain runs first; a timed chain of the same depth after
            if not os.path.exists(path(what, "npy")):
                np.save(path(what, "npy"), out.cpu().numpy())

        def sweep(self, *a, **k):
            table = real[(tuner.Autotuner, "sweep")](self, *a, **k)
            with open(path("table", "json"), "w") as fp:
                json.dump(table.to_dict(), fp)
            return table

        def bitwise_equal(got, want):
            np.save(path("output", "npy"), got.cpu().numpy())
            return real[(trace, "_bitwise_equal")](got, want)

        def combine_chain(kernel, k, plain=False):
            chain = real[(bench_local, "make_combine_chain")](kernel, k, plain)
            if k != 2 or plain:  # the gate's chain alone
                return chain
            def run(*xs):
                out = chain(*xs)
                keep_first(kernel, out)
                return out
            return run

        def gate_error(kname, *a):
            if rank() == fail_rank:
                return f"{kname}: injected on this rank only"
            return real[(bench_local, "gate_error")](kname, *a)

        def fold_chain(n_ops, k):
            chain = real[(fold_ladder, "fold_chain")](n_ops, k)
            if k != 2:
                return chain
            def run(*xs):
                out = chain(*xs)
                keep_first(f"fold{n_ops}", out)
                return out
            return run

        def save_calibration(*a, **k):
            print(f"SAVED-CALIBRATION {tag}", flush=True)
            return real[(hw, "save_calibration")](*a, **k)

        def report(outdir, row):
            print(f"REPORTED {tag} {row['step']}", flush=True)
            return real[(first_contact, "_report")](outdir, row)

        tuner.Autotuner.sweep = sweep
        trace._bitwise_equal = bitwise_equal
        bench_local.make_combine_chain = combine_chain
        bench_local.gate_error = gate_error
        fold_ladder.fold_chain = fold_chain
        hw.save_calibration = save_calibration
        first_contact._report = report
        try:
            yield
        finally:
            for (mod, name), fn in real.items():
                setattr(mod, name, fn)


    def steps():
        for i, step in enumerate(json.loads(os.environ["RNR_STEPS"])):
            try:
                with hooked(os.environ["RNR_DUMP"], step["tag"], step.get("fail_rank", -1)):
                    rc = importlib.import_module(step["module"]).main(
                        step["argv"] + sys.argv[1:])
                print(f"STEP {i} OK rc={rc}", flush=True)
            except (SystemExit, AssertionError, RuntimeError) as e:
                print(f"STEP {i} {type(e).__name__}: {e}", flush=True)
        return 0


    if __name__ == "__main__":
        sys.exit(cli_common.main(steps))
''')

P = "rocnrdma_tpu_torch."
TUNER = ["--verbs", "allreduce,alltoall", "--sizes", "4K,16K", "--algos",
         "fused,ring,cuda_ring"]
TRACE = ["--collective", "allreduce", "--size", "16K", "--measured", "--align-steps"]
FC = ["--skip-dryrun", "--sizes", "4K,16K", "--smoke-size", "16K", "--verbs",
      "allgather,alltoall", "--align-algo", "ring"]
LOCAL = ["--size", "16K", "--k2", "6", "--repeats", "2", "--trials", "1"]
LADDER = ["--widths", "2,3"]


def _steps(out) -> dict:
    """fleet -> [step]: each step's module, tag and argv (its --out under
    ``out``)."""
    return {
        "fleet4": [
            {"module": P + "transport.tuner", "tag": "tuner",
             "argv": TUNER + ["--out", f"{out}/tuner.json"]},
            {"module": P + "transport.tuner", "tag": "alpha", "argv": ["--measure-alpha"]},
            {"module": P + "trace", "tag": "trace_ring",
             "argv": TRACE + ["--algo", "ring", "--out", f"{out}/trace_ring.json"]},
            {"module": P + "trace", "tag": "trace_dtree",
             "argv": TRACE + ["--algo", "dtree", "--out", f"{out}/trace_dtree.json"]},
            {"module": P + "transport.tuner", "tag": "tuner_fake",
             "argv": TUNER + ["--fake-devices", "4", "--out", f"{out}/fake.json"]},
            {"module": P + "trace", "tag": "trace_fake",
             "argv": TRACE + ["--algo", "ring", "--fake-devices", "4"]},
        ],
        "fleet3": [
            {"module": P + "first_contact", "tag": "fc",
             "argv": FC + ["--outdir", f"{out}/fc"]},
            {"module": P + "bench.bench_local", "tag": "local",
             "argv": LOCAL + ["--out", f"{out}/local.jsonl"]},
            {"module": P + "bench.fold_ladder", "tag": "ladder",
             "argv": LADDER + ["--out", f"{out}/ladder.jsonl"]},
            {"module": P + "bench.mfu_profile", "tag": "mfu",
             "argv": ["--out", f"{out}/mfu.jsonl", "--profile", f"{out}/prof"]},
            {"module": P + "bench.bench_local", "tag": "local_fail", "fail_rank": 1,
             "argv": LOCAL + ["--kernels", "torch2,cuda2"]},
        ],
    }


def _env(root) -> dict:
    return {"PYTHONPATH": f"{root}{os.pathsep}{ROOT}{os.pathsep}"
                          f"{os.environ.get('PYTHONPATH', '')}",
            "RNR_DUMP": str(root / "dump"), "OMP_NUM_THREADS": "1"}


def _run_fleet(root, n: int, steps: list):
    rs = run_cli(n, "rnr_tools_fleet", [], platform="cpu", timeout_s=240.0,
                 env=dict(_env(root), RNR_STEPS=json.dumps(steps)))
    for r in rs:
        assert r.returncode == 0, (r.process_id, r.returncode, r.stdout[-3000:],
                                   r.stderr[-3000:])
    return rs


def _torchrun(root):
    """The tuner as 2 processes under torchrun (its agent's store)."""
    port, sock = reserve_port()
    sock.close()
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2",
         "--master-port", str(port), "-m", P + "transport.tuner", "--platform", "cpu",
         "--verbs", "allreduce", "--sizes", "4K", "--algos", "fused,ring",
         "--out", str(root / "out" / "torchrun.json")],
        capture_output=True, text=True, timeout=240, cwd=str(ROOT),
        env=dict(os.environ, **_env(root)))


@pytest.fixture(scope="module")
def fleets(tmp_path_factory):
    root = tmp_path_factory.mktemp("tools_mp")
    for d in ("dump", "one", "out"):
        (root / d).mkdir()
    (root / "rnr_tools_fleet.py").write_text(_WRAPPER)
    steps = _steps(root / "out")
    with ThreadPoolExecutor(3) as pool:
        runs = {f: pool.submit(_run_fleet, root, int(f[-1]), steps[f]) for f in steps}
        torchrun = pool.submit(_torchrun, root)
        runs = {f: r.result() for f, r in runs.items()}
        torchrun = torchrun.result()
    spec = importlib.util.spec_from_file_location("rnr_tools_fleet_here",
                                                  root / "rnr_tools_fleet.py")
    wrapper = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(wrapper)
    return {"root": root, "runs": runs, "steps": steps, "torchrun": torchrun,
            "wrapper": wrapper, "one": {}}


def _step_lines(fleets, fleet: str, tag: str) -> list:
    i = next(i for i, s in enumerate(fleets["steps"][fleet]) if s["tag"] == tag)
    return [next(line for line in r.stdout.splitlines() if line.startswith(f"STEP {i} "))
            for r in fleets["runs"][fleet]]


def _ok(fleets, fleet: str, tag: str) -> None:
    lines = _step_lines(fleets, fleet, tag)
    assert all(line.endswith("OK rc=0") for line in lines), lines


def _one_process(fleets, tag: str, module: str, argv: list) -> None:
    """``module`` with ``argv`` in this process at ``--platform cpu``, its
    results saved as rank "one" (once)."""
    if tag not in fleets["one"]:
        with fleets["wrapper"].hooked(str(fleets["root"] / "one"), tag):
            fleets["one"][tag] = importlib.import_module(P + module).main(
                argv + ["--platform", "cpu"])
    assert fleets["one"][tag] == 0


def _saved(fleets, tag: str, what: str, rank, ext: str = "npy"):
    where = "one" if rank == "one" else "dump"
    path = fleets["root"] / where / f"{tag}_{what}_r{rank}.{ext}"
    return json.loads(path.read_text()) if ext == "json" else np.load(path)


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view({2: np.uint16, 4: np.uint32, 8: np.uint64}[a.itemsize])


# -- the tuner -------------------------------------------------------------

def test_every_rank_keeps_the_same_table_under_the_spanning_key(fleets):
    _ok(fleets, "fleet4", "tuner")
    tables = [_saved(fleets, "tuner", "table", r, "json") for r in range(4)]
    assert all(t == tables[0] for t in tables[1:])  # times_s too: the fleet max
    keys = sorted(k for k in tables[0] if k != "_meta")
    assert keys == ["allreduce|4|1|cpu/cpu-loopback", "alltoall|4|1|cpu/cpu-loopback"]
    times = tables[0]["_meta"]["times_s"]
    for verb in ("allreduce", "alltoall"):
        for size, arms in times[verb].items():
            assert set(arms) == {"fused", "ring", "cuda_ring"} and min(arms.values()) > 0
            # each bucket names the arm the fleet's times make fastest
            won = min(arms, key=arms.get)
            assert TU.TuningTable.from_dict(tables[0]).lookup(
                verb, int(size), 4, 1, "cpu/cpu-loopback") == won
    written = json.loads((fleets["root"] / "out" / "tuner.json").read_text())
    meta = written["_meta"]
    assert {k: v for k, v in written.items() if k != "_meta"} == \
        {k: v for k, v in tables[0].items() if k != "_meta"}
    assert meta["processes"] == 4 and meta["link"] == "cpu-loopback"
    agreement = meta["policy_agreement"]
    assert agreement["points"] == 4 and 0 <= agreement["agree"] <= 4
    assert all(picked == "fused" or picked in ("ring", "cuda_ring")
               for by in agreement["picks"].values() for _, picked in by.values())
    # rank 0 alone prints the sweep
    rs = fleets["runs"]["fleet4"]
    assert "policy agreement on cpu/cpu-loopback" in rs[0].stdout
    assert all("policy agreement" not in r.stdout for r in rs[1:])


def test_the_measure_alpha_fleet_takes_the_median_of_the_ranks_medians(fleets):
    _ok(fleets, "fleet4", "alpha")
    rs = fleets["runs"]["fleet4"]
    lines = [ln for ln in rs[0].stdout.splitlines() if ln.startswith("dispatch alpha")]
    per_rank = [ln for ln in lines if "(rank " in ln]
    assert len(per_rank) == 4 and [f"(rank {r} of 4)" in ln
                                   for r, ln in enumerate(per_rank)] == [True] * 4
    meds = [float(ln.split("median ")[1].split(" ns")[0]) for ln in per_rank]
    fleet = float(lines[-1].split(": ")[1].split(" ns")[0])
    assert "the median of the 4 ranks' medians" in lines[-1]
    assert fleet == pytest.approx(float(np.median(meds)), abs=0.051)
    assert all("dispatch alpha" not in r.stdout for r in rs[1:])


def test_torchrun_runs_the_tuner_across_its_processes(fleets):
    r = fleets["torchrun"]
    assert r.returncode == 0, (r.stdout[-3000:], r.stderr[-3000:])
    table = json.loads((fleets["root"] / "out" / "torchrun.json").read_text())
    assert [k for k in table if k != "_meta"] == ["allreduce|2|1|cpu/cpu-loopback"]
    assert table["_meta"]["processes"] == 2
    assert r.stdout.count("policy agreement on cpu/cpu-loopback (2 ranks)") == 1


def _spanning(n: int, backend: str, staged: bool, per_card: int) -> Transport:
    """Rank 1 of an n-rank mesh that spans processes (no exchange runs)."""
    span = ProcessSpan(cross_group=None, backend=backend, staged=staged, index=1,
                       size=n, peers=tuple(range(n)), per_card=per_card)
    return Transport(RankMesh(devices=(torch.device("cpu"),), shape=(n,), span=span))


LAYOUTS = {"nvlink": ("nccl", False, 1), "host-loopback": ("gloo", True, 8)}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_a_table_never_answers_a_mesh_of_the_other_layout(layout):
    """The same rank count, one process against across processes, priced as
    on the card: each layout's table answers its own mesh alone."""
    spanning, one = _spanning(8, *LAYOUTS[layout]), Transport(rank_mesh(8, "cpu"))
    default = Transport(rank_mesh(8, "cpu"))  # no table
    for tr in (spanning, one):
        tr.platform, tr.device_kind = "gpu", H100
    assert (one.table_platform, spanning.table_platform) == ("gpu", f"gpu/{layout}")
    arms = {v: next(a for a in algos if a != "fused" and api.supports(v, a))
            for v, algos in api.SCHEDULES.items()
            if any(a != "fused" and api.supports(v, a) for a in algos)}
    for mine, other in ((one, spanning), (spanning, one)):
        table = TU.TuningTable()
        for verb, arm in arms.items():
            table.set_buckets(verb, 8, 1, mine.table_platform, [TU.Bucket(1 << 40, arm)])
        mine.tuning = other.tuning = table
        for verb, arm in arms.items():
            assert mine._resolve("auto", verb, 4096) == arm, verb
            assert other._resolve("auto", verb, 4096) == default._resolve(
                "auto", verb, 4096), verb


def test_the_fleet_table_answers_no_one_process_mesh(fleets):
    table = TU.TuningTable.load(str(fleets["root"] / "out" / "tuner.json"))
    one = Transport(rank_mesh(4, "cpu"), tuning=table)
    spanning = _spanning(4, "gloo", False, 1)
    spanning.tuning = table
    assert spanning.table_platform == "cpu/cpu-loopback"
    for verb in ("allreduce", "alltoall"):
        for size in (4096, 16384):
            assert one._resolve("auto", verb, size) == "fused"
            assert spanning._resolve("auto", verb, size) == table.lookup(
                verb, size, 4, 1, "cpu/cpu-loopback")


def test_the_committed_table_resolves_as_before():
    path = ROOT / "rocnrdma_tpu_torch" / "results" / "tuning_h100_8x1.json"
    raw = json.loads(path.read_text())
    table = TU.TuningTable.load(str(path))
    one = Transport(rank_mesh(8, "cpu"), tuning=table)
    spanning = _spanning(8, *LAYOUTS["host-loopback"])
    spanning.tuning = table
    for tr in (one, spanning):
        tr.platform, tr.device_kind = "gpu", H100
    checked = 0
    for key, buckets in raw.items():
        if key == "_meta":
            continue
        verb, n, ndim, plat = key.split("|")
        assert (n, ndim, plat) == ("8", "1", "gpu")
        for max_bytes, arm in buckets:
            assert one._resolve("auto", verb, max_bytes) == arm
            assert spanning._resolve("auto", verb, max_bytes) == "fused"
            checked += 1
    assert checked >= 4


def test_the_committed_4_gpu_table_answers_a_gpu_a_process_alone():
    """The sweep across 4 processes on 4 cards: every key is the NVLink
    layout's, each bucket resolves on a spanning NCCL mesh of 4, and none on
    a one-process mesh of 4 or a mesh of processes sharing a card."""
    path = ROOT / "rocnrdma_tpu_torch" / "results" / "tuning_h100_4gpu.json"
    raw = json.loads(path.read_text())
    meta = raw.pop("_meta")
    assert meta["processes"] == 4 and meta["link"] == "nvlink"
    assert meta["nvidia_smi"].splitlines() == ["NVIDIA H100 80GB HBM3, 700.00 W"] * 4
    table = TU.TuningTable.load(str(path))
    nvlink, one, shared = (_spanning(4, "nccl", False, 1), Transport(rank_mesh(4, "cpu")),
                           _spanning(4, "gloo", True, 4))
    for tr in (nvlink, one, shared):
        tr.platform, tr.device_kind, tr.tuning = "gpu", H100, table
    assert sorted({k.split("|", 1)[1] for k in raw}) == ["4|1|gpu/nvlink"]
    for key, buckets in raw.items():
        verb = key.split("|")[0]
        for max_bytes, arm in buckets:
            assert nvlink._resolve("auto", verb, max_bytes) == arm
            assert one._resolve("auto", verb, max_bytes) == "fused"
            assert shared._resolve("auto", verb, max_bytes) == "fused"
    # its agreement count is the model's pick beside each measured winner
    agreement = TU.policy_agreement(nvlink, table, list(meta["times_s"]),
                                    sorted({int(s) for by in meta["times_s"].values()
                                            for s in by}))
    assert agreement == meta["policy_agreement"]


def test_a_step_span_holds_its_device_work_on_every_stream(tmp_path):
    """On the card a step that crosses processes runs NCCL's kernel on
    NCCL's stream under NCCL's annotation: the steps lane takes each step
    span's extent over every stream, from the launches inside it. Without
    ``steps`` (a one-process capture) a step is its span's annotation on
    the caller's stream, as before."""
    host, dev = {"pid": 100, "tid": 5}, {"pid": 0}
    evs = [
        {"ph": "X", "cat": "user_annotation", "name": "ppermute khd rs r0 o1",
         "ts": 10.0, "dur": 20.0, **host},
        {"ph": "X", "cat": "user_annotation", "name": "ppermute khd ag r0 o1",
         "ts": 40.0, "dur": 5.0, **host},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 12.0,
         "dur": 1.0, "args": {"correlation": 1}, **host},
        {"ph": "X", "cat": "cuda_driver", "name": "cuLaunchKernelEx", "ts": 15.0,
         "dur": 1.0, "args": {"correlation": 2}, **host},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 41.0,
         "dur": 1.0, "args": {"correlation": 3}, **host},
        {"ph": "X", "cat": "kernel", "name": "add_kernel", "ts": 30.0, "dur": 2.0,
         "tid": 7, "args": {"correlation": 1}, **dev},
        {"ph": "X", "cat": "kernel", "name": "ncclDevKernel_SendRecv", "ts": 31.0,
         "dur": 100.0, "tid": 19, "args": {"correlation": 2}, **dev},
        {"ph": "X", "cat": "kernel", "name": "copy_kernel", "ts": 140.0, "dur": 3.0,
         "tid": 7, "args": {"correlation": 3}, **dev},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "ppermute khd rs r0 o1",
         "ts": 30.0, "dur": 2.0, "tid": 7, **dev},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "nccl:coalesced",
         "ts": 31.0, "dur": 100.0, "tid": 19, **dev},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": evs}))
    trace = importlib.import_module(P + "trace")
    one = dict(trace.measured_lanes(str(path)))
    assert "pid 0/steps" not in one
    assert ("ppermute khd rs r0 o1", 30000, 2000) in one["pid 0/tid 7"]
    lanes = dict(trace.measured_lanes(str(path), steps=True))
    assert lanes["pid 0/steps"] == [("ppermute khd rs r0 o1", 30000, 101000),
                                    ("ppermute khd ag r0 o1", 140000, 3000)]
    # the step span's own annotation on the caller's stream is left to it
    assert all("ppermute" not in name for label, lane in lanes.items()
               if label != "pid 0/steps" for name, _, _ in lane)


def test_model_table_under_a_spanning_key_prices_a_gpu_a_process():
    verbs, sizes = ["allreduce", "alltoall"], [4096, 1 << 20, 1 << 30]
    spanning = TU.model_table(H100, [4], verbs, sizes, platform="gpu/nvlink",
                              per_card=1, _audit=False)
    one = TU.model_table(H100, [4], verbs, sizes, _audit=False)
    assert sorted(k for k in spanning.to_dict() if k != "_meta") == [
        "allreduce|4|1|gpu/nvlink", "alltoall|4|1|gpu/nvlink"]
    for verb in verbs:
        assert spanning.meta[f"alpha_beta[{verb}]"] == list(TU.constants_for(H100, verb, 1))
        assert one.meta[f"alpha_beta[{verb}]"] == list(TU.constants_for(H100, verb, 4))
        t = _spanning(4, "nccl", False, 1)
        t.platform, t.device_kind = "gpu", H100
        for size in sizes:  # the model table's pick is the mesh's own model pick
            assert spanning.lookup(verb, size, 4, 1, "gpu/nvlink") == \
                t._resolve("model", verb, size)
    assert spanning.meta["per_card"] == 1 and "per_card" not in one.meta


# -- trace -----------------------------------------------------------------

TRACES = ["ring", "dtree"]


@pytest.mark.parametrize("algo", TRACES)
def test_the_trace_fleet_has_the_jax_model_lane_and_a_lane_group_a_rank(fleets, algo):
    _ok(fleets, "fleet4", f"trace_{algo}")
    doc = json.loads((fleets["root"] / "out" / f"trace_{algo}.json").read_text())
    ref = RT.to_chrome_trace(RT.schedule_events("allreduce", algo, 4, 16384),
                             TU.ALPHA_S, TU.BETA_S_PER_B)
    assert [e for e in doc["traceEvents"] if e["pid"] == 0] == ref["traceEvents"]
    n_steps = ref["otherData"]["n_steps"]
    od = doc["otherData"]
    assert od["n_steps"] == n_steps and od["measured_ranks"] == 4
    assert od["processes"] == 4 and od["link"] == "cpu-loopback"
    assert od["capture_bitwise_equal"]
    names = {e["pid"]: e["args"]["name"] for e in doc["traceEvents"]
             if e.get("name") == "process_name"}
    for r in range(4):
        assert names[1 + 2 * r] == f"rank {r} measured"
        assert names[2 + 2 * r] == f"rank {r} aligned"
        spans = [e for e in doc["traceEvents"] if e["pid"] == 1 + 2 * r
                 and e["ph"] == "X" and "ppermute" in e["name"]]
        assert len(spans) == n_steps, r
        aligned = [e for e in doc["traceEvents"] if e["pid"] == 2 + 2 * r and e["ph"] == "X"]
        assert len(aligned) == n_steps
    diff = od["step_diff"]
    assert [(row["rank"], row["step"]) for row in diff] == [
        (r, k) for r in range(4) for k in range(n_steps)]
    assert all(row["measured_max_us"] > 0 and row["lanes"] == 1 for row in diff)
    rs = fleets["runs"]["fleet4"]
    assert sum("aligned" in r.stderr and f"trace_{algo}.json" in r.stderr for r in rs) == 1


@pytest.mark.parametrize("algo", TRACES)
def test_each_rank_traced_output_is_the_one_process_row(fleets, algo):
    tag = f"trace_{algo}"
    _one_process(fleets, tag, "trace", TRACE + ["--algo", algo, "--ranks", "4",
                                                "--fake-devices", "4", "--out",
                                                str(fleets["root"] / "one" / f"{tag}.json")])
    whole = _saved(fleets, tag, "output", "one")
    for r in range(4):
        got = _saved(fleets, tag, "output", r)
        assert got.shape == (1,) + whole.shape[1:]
        np.testing.assert_array_equal(_bits(got[0]), _bits(whole[r]), err_msg=str(r))


def test_fake_devices_under_a_fleet_is_refused_by_name(fleets):
    for tag in ("tuner_fake", "trace_fake"):
        lines = _step_lines(fleets, "fleet4", tag)
        assert all("SystemExit" in line and "--fake-devices 4" in line
                   and "process group of 4" in line for line in lines), lines
    assert not (fleets["root"] / "out" / "fake.json").exists()


# -- first_contact ---------------------------------------------------------

STEPS = ["calibrate_chip", "cli_smoke", "measured_sweep", "alltoall_scored",
         "table_merge", "align_steps"]


def test_first_contact_runs_every_step_across_the_fleet(fleets):
    _ok(fleets, "fleet3", "fc")
    rs = fleets["runs"]["fleet3"]
    fc = fleets["root"] / "out" / "fc"
    report = [json.loads(ln) for ln in (fc / "report.jsonl").read_text().splitlines()]
    assert [r["step"] for r in report] == STEPS and all(r["ok"] for r in report)
    # rank 0 alone reports each step and writes the calibration, once
    assert [r.stdout.count("REPORTED fc ") for r in rs] == [len(STEPS), 0, 0]
    assert sum(r.stdout.count("SAVED-CALIBRATION fc") for r in rs) == 1
    cal = json.loads(pathlib.Path(report[0]["artifact"]).read_text())
    assert report[0]["artifact"].startswith(str(fc))
    assert "median of 3 processes" in cal["provenance"] and "2" in cal["fold_ladder"]
    measured = json.loads((fc / "tuning_measured.json").read_text())
    assert sorted(k for k in measured if k != "_meta") == [
        "allgather|3|1|cpu/cpu-loopback", "alltoall|3|1|cpu/cpu-loopback"]
    model = json.loads((fc / "tuning_model.json").read_text())
    assert sorted(k for k in model if k != "_meta") == [
        "allgather|3|1|cpu/cpu-loopback", "alltoall|3|1|cpu/cpu-loopback"]
    assert model["_meta"]["per_card"] == 1
    merged = json.loads((fc / "tuning_merged.json").read_text())
    assert merged["_meta"]["provenance"].startswith("mixed")
    assert all(merged[k] == measured[k] for k in measured if k != "_meta")
    smoke = [json.loads(ln) for ln in (fc / "cli_smoke.jsonl").read_text().splitlines()]
    assert {r["collective"] for r in smoke} == {"allreduce", "alltoall", "allgather"}
    assert all(r["extra"]["processes"] == 3 and r["extra"]["checked"] for r in smoke)
    align = json.loads((fc / "align_ring.trace.json").read_text())["otherData"]
    assert report[-1]["steps"] == len(align["step_diff"]) == 3 * 4  # 3 ranks x 4 steps
    a2a = json.loads((fc / "alltoall_algbw.json").read_text())
    assert a2a["value"] > 0 and report[2]["layout"] == "cpu/cpu-loopback"


# -- the local folds -------------------------------------------------------

def _rows(fleets, name: str) -> list:
    return [json.loads(ln) for ln in
            (fleets["root"] / "out" / name).read_text().splitlines()]


def test_the_local_folds_give_one_row_a_rank(fleets):
    for tag in ("local", "ladder", "mfu"):
        _ok(fleets, "fleet3", tag)
    local = _rows(fleets, "local.jsonl")
    assert [(r["rank"], r["kernel"]) for r in local] == [
        (rank, k) for rank in range(3) for k in bench_local.KERNELS]
    ladder = _rows(fleets, "ladder.jsonl")
    assert [(r["rank"], r["n_ops"]) for r in ladder] == [
        (rank, w) for rank in range(3) for w in (2, 3)]
    mfu = _rows(fleets, "mfu.jsonl")
    assert [r["rank"] for r in mfu] == [0, 1, 2]
    for r in local + ladder + mfu:
        assert r["processes"] == 3 and r["link"] == "cpu-loopback"
    assert all(r["s_per_op"] > 0 and r["device"] == "cpu" for r in local)
    assert all(r["GBps_median"] > 0 for r in ladder)
    assert all(r["full_us"] > 0 and r["top_ops"] for r in mfu)
    for rank in range(3):
        assert (fleets["root"] / "out" / "prof" / f"rank{rank}" / "trace.json").exists()
        assert mfu[rank]["profile_dir"].endswith(f"rank{rank}")
    rs = fleets["runs"]["fleet3"]
    assert "rank 2" in rs[0].stdout and all("GB/s" not in r.stdout for r in rs[1:])


def _local_operands() -> list:
    """bench_local's gate operands at 16 KiB fp32: its ``default_rng(0)``
    draws of 4096 elements, as many as the widest kernel's operands."""
    rng = np.random.default_rng(0)
    return [jnp.asarray(rng.standard_normal((4096,), dtype=np.float32))
            for _ in range(max(map(bench_local.kernel_n_ops, bench_local.KERNELS)))]


def _ref_kernel(kernel: str) -> str:
    return {"torch": "xla", "cuda": "pallas", "pipe": "pallas"}[kernel.rstrip("0123456789")] \
        + str(bench_local.kernel_n_ops(kernel))


@needs_tpu_interpret
@pytest.mark.parametrize("kernel", list(bench_local.KERNELS))
def test_each_rank_combine_gate_is_the_one_process_and_the_jax_chain(devices, fleets,
                                                                     kernel):
    _one_process(fleets, "local", "bench.bench_local", LOCAL)
    whole = _saved(fleets, "local", kernel, "one")
    want = np.asarray(RB.make_combine_chain(_ref_kernel(kernel), 8, True, 2,
                                            full_out=True)(*_local_operands()))
    np.testing.assert_array_equal(_bits(whole), _bits(want))
    for r in range(3):
        np.testing.assert_array_equal(_bits(_saved(fleets, "local", kernel, r)),
                                      _bits(whole), err_msg=str(r))


@pytest.mark.parametrize("width", [2, 3])
def test_each_rank_fold_gate_is_the_one_process_and_the_jax_chain(devices, fleets, width):
    _one_process(fleets, "ladder", "bench.fold_ladder", LADDER)
    whole = _saved(fleets, "ladder", f"fold{width}", "one")
    # the ladder's draws on the CPU: a generator seeded with the width,
    # 256 KiB operands, the gate on the first 32768 elements
    g = torch.Generator().manual_seed(width)
    xs = [torch.randn(65536, generator=g)[:32768].numpy() for _ in range(width)]
    want = np.asarray(RB.make_combine_chain(f"xla{width}", 8, True, 2, full_out=True)(
        *[jnp.asarray(x) for x in xs]))
    np.testing.assert_array_equal(_bits(whole), _bits(want))
    for r in range(3):
        np.testing.assert_array_equal(_bits(_saved(fleets, "ladder", f"fold{width}", r)),
                                      _bits(whole), err_msg=str(r))


def test_one_rank_failed_gate_fails_every_rank_named(fleets):
    lines = _step_lines(fleets, "fleet3", "local_fail")
    assert all("SystemExit" in line and "bench_local torch2 gate" in line
               and "failed on rank(s) [1] of 3" in line for line in lines), lines
    assert "injected" in lines[1] and all("injected" not in ln for ln in lines[:1] + lines[2:])
