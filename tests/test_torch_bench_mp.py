"""The bench CLIs and the headline across processes, one rank a process, on
the CPU with gloo (``runtime.multiprocess.run_cli``).

Three fleets, each running the CLIs' ``main`` in turn through a worker
wrapper written here (``_WRAPPER``), which saves each rank's checked rows
and can corrupt one rank's result before its check:

- 4 processes: ``bench_allreduce`` at 4 KiB a rank with every 1-D arm
  (``cuda_ring`` through its plain versions across processes, and
  ``--check-plain`` holding it to the one-process plain versions); the
  refusals of ``--fake-devices`` and of a ``--mesh2d`` whose S is not the
  world size; then a sweep whose check fails on rank 1 only;
- 3 processes (a ring that is not a power of two): ``bench_alltoall``
  with every 1-D arm, ``bench_reducescatter`` and ``bench_allgather``
  with theirs (``--check-plain``), the rooted ``bench_broadcast``,
  ``bench_reduce``, ``bench_gather`` and ``bench_scatter`` with
  ``--root`` on the last rank, and ``bench_sendrecv`` with ``--shift 2``;
- 2 processes: the headline (its MiB cut to 64 KiB, and its MFU leg,
  held elsewhere, stubbed);
- 2 processes: the headline again, one candidate failing on rank 1 only
  (after the candidate's collectives, so the fleet is not left inside
  one), which every rank drops.

Held: rank 0's ``--out`` records equal the one-process port's at
``--fake-devices N --platform cpu`` field for field, except the times and
``extra``'s ``link``, ``processes`` and ``peak_mem_bytes``; their keys are
the reference's ``metrics.record_key`` at the same arguments; each rank's
rows are bitwise the JAX package's ``Transport`` output on the runner's
input (``_build_input``: ``default_rng(0)``) for every explicit arm
(``cuda_ring`` against the reference's ``pallas_ring``), and within rtol
1e-5, atol 1e-6 for ``fused`` (torch's order of summation, not XLA's);
the failed check fails every rank, naming rank 1, inside the deadline; only
rank 0 prints results. Out of a fleet: a launcher's environment that
cannot be joined makes a CLI exit non-zero naming the coordinator (the
workload CLIs and the tools, ported across processes since, raise naming
it too; their fleets: ``tests/test_torch_workloads_mp.py`` and
``tests/test_torch_tools_mp.py``). The JAX package does not run across processes here
(``jax.distributed`` fails to initialize on this jax), so the fleet is
held to its one-process outputs.
"""

import importlib
import json
import os
import pathlib
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from rocnrdma_tpu import metrics as RM
from rocnrdma_tpu import runtime as rt
from rocnrdma_tpu.transport import Transport as RefTransport
from rocnrdma_tpu_torch import metrics
from rocnrdma_tpu_torch.bench import runner
from rocnrdma_tpu_torch.runtime.multiprocess import run_cli

ROOT = pathlib.Path(__file__).resolve().parents[1]

_WRAPPER = textwrap.dedent('''
    """One rank of a test fleet: run RNR_STEPS' CLIs in turn (this
    process's arguments, the platform, after each one's), each one's
    outcome a line on stdout."""
    import importlib
    import json
    import os
    import sys

    import numpy as np
    import torch

    from rocnrdma_tpu_torch import metrics as M
    from rocnrdma_tpu_torch.bench import cli_common, headline, runner

    DUMP = os.environ["RNR_DUMP"]
    STATE = {"fail_rank": -1, "fail_trial": None, "trials": 0}
    _check = runner._check
    _trials = headline.marginal_trials


    def check(got, want, rtol, atol, what, bound=None, ranks=None, first=0):
        rank = torch.distributed.get_rank()
        name = what.replace("/", "_").replace(" ", "_")
        np.save(os.path.join(DUMP, f"{name}_r{rank}.npy"), got.cpu().numpy())
        if rank == STATE["fail_rank"]:
            got = got.clone()
            got.reshape(-1)[0] += 1.0
        return _check(got, want, rtol, atol, what, bound, ranks, first)


    def trials(*a, **k):
        out = _trials(*a, **k)
        STATE["trials"] += 1
        if [torch.distributed.get_rank(), STATE["trials"]] == STATE["fail_trial"]:
            raise RuntimeError("injected: this candidate failed on this rank only")
        return out


    runner._check = check
    headline.marginal_trials = trials
    headline.mfu_leg = lambda *a: "# MFU leg (stubbed in this test)"


    def steps():
        for i, step in enumerate(json.loads(os.environ["RNR_STEPS"])):
            STATE["fail_rank"] = step.get("fail_rank", -1)
            STATE["fail_trial"], STATE["trials"] = step.get("fail_trial"), 0
            if step.get("small"):
                M.MiB = 64 * 1024
            try:
                importlib.import_module(step["module"]).main(step["argv"] + sys.argv[1:])
                print(f"STEP {i} OK", flush=True)
            except (SystemExit, AssertionError) as e:
                print(f"STEP {i} {type(e).__name__}: {e}", flush=True)
        return 0


    if __name__ == "__main__":
        sys.exit(cli_common.main(steps))
''')

B = "rocnrdma_tpu_torch.bench."
COMMON = ["--repeats", "1", "--iters", "1", "--warmup", "1"]
AR_ALGOS = ("fused", "ring", "ring_bidir", "tree", "khd", "dtree", "ptree", "ktree",
            "cuda_ring")
A2A_ALGOS = ("fused", "ring", "bruck", "cuda_ring")
RS_ALGOS = ("fused", "ring", "khd", "cuda_ring")  # reducescatter's and allgather's
BC_ALGOS = ("binomial", "fused")  # every rooted verb's
# the 3-process fleet's CLIs after bench_alltoall: (collective, algos, knobs'
# flags, --check-plain); 3K a rank is a whole multiple of the reduce-scatter
# kernel's n*128 elements
MORE = (("reducescatter", RS_ALGOS, [], True), ("allgather", RS_ALGOS, [], True),
        ("broadcast", BC_ALGOS, ["--root", "2"], False),
        ("reduce", BC_ALGOS, ["--root", "2"], False),
        ("gather", BC_ALGOS, ["--root", "2"], False),
        ("scatter", BC_ALGOS, ["--root", "2"], False),
        ("sendrecv", ("fused",), ["--shift", "2"], False))


def _argv(algos, flags, check_plain: bool, size: str) -> list:
    return (["--sizes", size, "--algos", ",".join(algos)] + flags
            + (["--check-plain"] if check_plain else []))


def _fleet(tmp, name: str, n: int, steps: list, timeout_s: float = 90.0) -> dict:
    root = tmp / name
    (root / "dump").mkdir(parents=True)
    (root / "rnr_test_fleet.py").write_text(_WRAPPER)
    rs = run_cli(n, "rnr_test_fleet", [], platform="cpu", timeout_s=timeout_s,
                 env={"PYTHONPATH": f"{root}{os.pathsep}{os.environ.get('PYTHONPATH', '')}",
                      "RNR_DUMP": str(root / "dump"), "RNR_STEPS": json.dumps(steps),
                      "OMP_NUM_THREADS": "1"})
    for r in rs:
        assert r.returncode == 0, (r.process_id, r.returncode, r.stdout[-3000:],
                                   r.stderr[-3000:])
    return {"root": root, "results": rs}


@pytest.fixture(scope="module")
def fleets(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("bench_mp")
    out = {}
    ar = ["--sizes", "4K", "--algos", ",".join(AR_ALGOS)] + COMMON
    out["ar"] = _fleet(tmp, "ar", 4, [
        {"module": B + "bench_allreduce",
         "argv": ar + ["--check-plain", "--out", str(tmp / "ar.jsonl")]},
        {"module": B + "bench_allreduce", "argv": ar + ["--fake-devices", "4"]},
        {"module": B + "bench_allreduce", "argv": ["--mesh2d", "2x2", "--sizes", "4K",
                                                    "--algos", "hierarchical"] + COMMON},
        {"module": B + "bench_allreduce", "fail_rank": 1,
         "argv": ["--sizes", "1K", "--algos", "ring"] + COMMON}])
    out["a2a"] = _fleet(tmp, "a2a", 3, [
        {"module": B + "bench_alltoall",
         "argv": ["--sizes", "3K", "--algos", ",".join(A2A_ALGOS), "--out",
                  str(tmp / "alltoall.jsonl")] + COMMON}] + [
        {"module": B + "bench_" + c,
         "argv": _argv(algos, flags, plain, "3K") + ["--out", str(tmp / f"{c}.jsonl")]
         + COMMON} for c, algos, flags, plain in MORE])
    out["head"] = _fleet(tmp, "head", 2, [
        {"module": B + "headline", "small": True,
         "argv": ["--out", str(tmp / "head_a2a.json")]}])
    # the third candidate (fused, ring_bidir, khd, cuda_ring) fails on rank 1
    out["head_fail"] = _fleet(tmp, "head_fail", 2, [
        {"module": B + "headline", "small": True, "fail_trial": [1, 3],
         "argv": ["--out", str(tmp / "head_fail_a2a.json")]}])
    out["tmp"] = tmp
    return out


def _records(path) -> list:
    return [json.loads(line) for line in open(path).read().splitlines()]


_TIMES = ("mean_s", "algbw_GBps", "busbw_GBps", "ts")
_EXTRA_TIMES = ("min_s", "max_s", "link", "processes", "peak_mem_bytes")


def _strip(rec: dict) -> dict:
    out = {k: v for k, v in rec.items() if k not in _TIMES}
    out["extra"] = {k: v for k, v in rec["extra"].items() if k not in _EXTRA_TIMES}
    return out


def _steps_out(fleet, i: int) -> list:
    return [next(line for line in r.stdout.splitlines() if line.startswith(f"STEP {i} "))
            for r in fleet["results"]]


# collective -> (fleet, ranks, size, algos, knobs' flags, --check-plain)
CASES = {"allreduce": ("ar", 4, "4K", AR_ALGOS, [], True),
         "alltoall": ("a2a", 3, "3K", A2A_ALGOS, [], False),
         **{c: ("a2a", 3, "3K", algos, flags, plain) for c, algos, flags, plain in MORE}}


@pytest.mark.parametrize("case", list(CASES))
def test_fleet_records_equal_the_one_process_port_and_reference_keys(fleets, tmp_path,
                                                                     case):
    fleet, n, size, algos, flags, check_plain = CASES[case]
    path = fleets["tmp"] / ("ar.jsonl" if case == "allreduce" else f"{case}.jsonl")
    got = _records(path)
    one = tmp_path / "one.jsonl"
    cli = importlib.import_module(B + "bench_" + case)
    assert cli.main(_argv(algos, flags, check_plain, size) + COMMON
                    + ["--fake-devices", str(n), "--platform", "cpu",
                       "--out", str(one)]) == 0
    want = _records(one)
    assert [_strip(r) for r in got] == [_strip(r) for r in want]
    assert len(got) == len(algos)
    assert all(r["extra"]["processes"] == n and r["extra"]["link"] == "cpu-loopback"
               and r["extra"]["checked"] for r in got)
    # --check-plain: each rank's cuda_ring rows bitwise its kernels' plain versions
    assert [r["extra"].get("plain_max_abs_err") for r in got if r["algo"] == "cuda_ring"] \
        == [0.0 if check_plain else None] * ("cuda_ring" in algos)
    # the keys are the reference's record_key at the same arguments
    keys = {RM.record_key("bench_" + case, r["collective"], r["algo"], n,
                          r["size_bytes"], r["dtype"], RM.knob_key(r["extra"]))
            for r in got}
    assert metrics.load_completed(path) == keys
    assert len(keys) == len(got)
    # only rank 0 printed the table
    results = fleets[fleet]["results"]
    assert "busbw GB/s" in results[0].stdout
    assert all("busbw GB/s" not in r.stdout for r in results[1:])


def _ref_out(collective: str, algo: str, x: np.ndarray, knobs: dict) -> np.ndarray:
    """The reference's ``jit_fn`` callable (what its runner times and
    checks) on ``x``."""
    t = RefTransport(rt.rank_mesh(x.shape[0]))
    fn = t.jit_fn(runner._OP[collective],
                  "pallas_ring" if algo == "cuda_ring" else algo, **knobs)
    return np.asarray(fn(t.shard(x)))


@pytest.mark.parametrize("case", list(CASES))
def test_each_rank_rows_equal_the_jax_transport(devices, fleets, case):
    fleet, n, size, algos, flags, _ = CASES[case]
    knobs = {flags[i].lstrip("-"): int(flags[i + 1]) for i in range(0, len(flags), 2)}
    shape, actual = runner._shape_and_bytes(case, n, runner.parse_size(size), "float32")
    x = np.random.default_rng(0).standard_normal(size=shape, dtype=np.float32)
    dump = fleets[fleet]["root"] / "dump"
    for algo in algos:
        ref = _ref_out(case, algo, x, knobs).reshape(n, -1)
        for r in range(n):
            got = np.load(dump / f"{case}_{algo}_float32_{actual}_B_r{r}.npy")
            got = got.reshape(-1)
            if algo == "fused":  # torch's order of summation, not XLA's
                np.testing.assert_allclose(got, ref[r], rtol=1e-5, atol=1e-6)
            else:
                np.testing.assert_array_equal(got.view(np.uint32), ref[r].view(np.uint32),
                                              err_msg=f"{case}/{algo} rank {r}")


def test_one_rank_failed_check_fails_every_rank_named(fleets):
    lines = _steps_out(fleets["ar"], 3)
    assert all("AssertionError" in line and "failed on rank(s) [1] of 4" in line
               for line in lines), lines
    assert "here: allreduce/ring" in lines[1] and "here:" not in lines[0]


def test_fake_devices_and_a_foreign_mesh2d_are_refused_by_name(fleets):
    fake = _steps_out(fleets["ar"], 1)
    assert all("SystemExit" in line and "--fake-devices 4" in line
               and "process group of 4" in line for line in fake), fake
    mesh = _steps_out(fleets["ar"], 2)
    assert all("SystemExit" in line and "--mesh2d 2x2" in line
               and "world size 4" in line and "S = 2" in line for line in mesh), mesh
    assert all(line == "STEP 0 OK" for line in _steps_out(fleets["ar"], 0))


def test_headline_across_processes_prints_one_line_from_rank_zero(fleets):
    r0, r1 = fleets["head"]["results"]
    rows = [json.loads(line) for line in r0.stdout.splitlines() if line.startswith("{")]
    assert len(rows) == 1 and not any(line.startswith("{")
                                      for line in r1.stdout.splitlines())
    row = rows[0]
    assert row["metric"] == "allreduce_busbw_GBps_per_chip" and row["processes"] == 2
    assert row["ranks_per_card"] == 1 and row["link"] == "cpu-loopback"
    assert row["algo"] in ("fused", "ring_bidir", "khd", "cuda_ring")
    assert row["value"] > 0 and row["vs_baseline"] > 0
    a2a = json.loads(open(fleets["tmp"] / "head_a2a.json").read())
    assert a2a["metric"] == "alltoall_algbw_GBps_per_chip" and a2a["processes"] == 2
    assert "winner" in r0.stderr and "MFU leg" in r0.stderr and "MFU" not in r1.stderr


def test_headline_drops_a_candidate_that_failed_on_one_rank_on_every_rank(fleets):
    r0, r1 = fleets["head_fail"]["results"]
    assert all("# algo khd failed on rank(s) [1]" in r.stderr for r in (r0, r1))
    assert "injected" in r1.stderr and "injected" not in r0.stderr
    rows = [json.loads(line) for line in r0.stdout.splitlines() if line.startswith("{")]
    assert len(rows) == 1 and rows[0]["algo"] in ("fused", "ring_bidir", "cuda_ring")
    winner = next(line for line in r0.stderr.splitlines() if "winner" in line)
    assert "khd=" not in winner and "cuda_ring=" in winner
    assert all(line == "STEP 0 OK" for line in _steps_out(fleets["head_fail"], 0))


@pytest.mark.parametrize("module", ["bench.bench_allreduce", "bench.headline"])
def test_an_unjoinable_coordinator_exits_non_zero_naming_it(tmp_path, module):
    """Rank 0 of a launcher's fleet whose coordinator address is taken:
    the CLI's process exits non-zero through ``cli_common.main``, the
    coordinator named, and runs nothing in one process."""
    with socket.socket() as taken:
        taken.bind(("127.0.0.1", 0))
        taken.listen(1)
        coordinator = "127.0.0.1:%d" % taken.getsockname()[1]
        env = dict(os.environ, COORDINATOR_ADDRESS=coordinator, WORLD_SIZE="2",
                   RANK="0", PYTHONPATH=str(ROOT))
        r = subprocess.run([sys.executable, "-m", "rocnrdma_tpu_torch." + module,
                            "--platform", "cpu", "--out", str(tmp_path / "out")],
                           env=env, capture_output=True, text=True, timeout=60)
    assert r.returncode != 0
    assert f"coordinator={coordinator!r}" in r.stderr, r.stderr[-2000:]
    assert r.stdout == "" and not (tmp_path / "out").exists()


# the arguments that make a tool run on the device (trace: --measured)
_DEVICE_ARGV = {"trace": ["--measured"]}


@pytest.mark.parametrize("module", ["bench.bench_allreduce", "workloads.moe",
                                    "workloads.ddp_replay", "workloads.fsdp_replay",
                                    "workloads.overlap", "trace", "first_contact",
                                    "transport.tuner", "bench.bench_local",
                                    "bench.fold_ladder", "bench.mfu_profile"])
def test_an_unjoinable_launcher_environment_is_refused_naming_the_coordinator(
        monkeypatch, tmp_path, module):
    """Every CLI joins a launcher's fleet (the tools too, since they run
    across processes): one whose environment cannot be joined raises, the
    coordinator named, before it writes anything."""
    monkeypatch.setenv("COORDINATOR_ADDRESS", "127.0.0.1:9")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.chdir(tmp_path)
    cli = importlib.import_module("rocnrdma_tpu_torch." + module)
    with pytest.raises(RuntimeError, match=r"coordinator='127.0.0.1:9'"):
        cli.main(["--platform", "cpu"] + _DEVICE_ARGV.get(module, []))
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("module,argv", [
    ("bench.bench_kernel_variants", []),
    ("bench.bench_pipe_sweep", []),
    ("bench.bench_ring_tiles", ["--platform", "cpu"])])
def test_a_one_process_micro_benchmark_refuses_a_fleet(monkeypatch, tmp_path,
                                                       module, argv):
    """The card's micro-benchmarks run in one process only: a launcher's
    fleet of more than one is refused, coordinator and world size named,
    before anything is built, timed or written."""
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "9")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.chdir(tmp_path)
    cli = importlib.import_module("rocnrdma_tpu_torch." + module)
    with pytest.raises(SystemExit, match=r"coordinator='127.0.0.1:9', world size 4\); "
                                         r"this CLI runs in one process only"):
        cli.main(argv + ["--out", str(tmp_path / "out.jsonl")])
    assert os.listdir(tmp_path) == []
