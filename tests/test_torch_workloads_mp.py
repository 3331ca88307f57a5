"""The workload CLIs across processes, one rank a process, on the CPU with
gloo (``runtime.multiprocess.run_cli``): ``moe``, ``ddp_replay``,
``fsdp_replay`` and ``overlap``.

Two fleets, started together, each running the CLIs' ``main`` in turn
through a worker wrapper written here (``_WRAPPER``), which saves each
rank's results (the layer's output, each replay mode's results, the
overlap's three callables' outputs) and can fail one rank's check:

- 4 processes: ``moe`` uniform and top-k with ``fused``, ``ring`` and
  ``cuda_ring`` (the alltoall kernel's plain version across processes,
  ``--check-plain`` holding it to the plain version on every rank's rows);
  ``ddp_replay`` and ``fsdp_replay`` in every mode with the same three
  arms (``cuda_ring``: the ring kernels' plain versions across processes,
  with ``--check-plain``); ``overlap`` with ``fused`` and ``ring``; the
  refusals of ``--ranks`` other than the world size and of
  ``--fake-devices``; then a ``moe`` whose identity check fails on rank 1
  only;
- 3 processes (not a power of two): ``moe`` uniform and top-k with
  ``fused`` and ``cuda_ring``.

Held: each rank's results are bitwise the one-process port's rows at
``--fake-devices N --platform cpu`` (run here through the same wrapper);
against the JAX package on the same seeded input, the tolerances of
``tests/test_torch_workloads.py``: the uniform layer and the replays'
``ring`` and ``cuda_ring`` (``pallas_ring`` in interpret mode, on the
first buckets and units: its interpreter takes ~0.6 s a call) bitwise,
``fused`` within 1e-5, the top-k layer and ``overlap`` within 1e-5;
rank 0's ``--out`` records equal the one-process port's field for field,
except the times and ``extra``'s ``link`` and ``processes``; only rank 0
prints; the failed check fails every rank naming rank 1, inside the
fleet's deadline. In one process: a rank's ``(1, T, E)`` logits route as
that row of the whole, and the replay timers' barrier and fleet maximum.
"""

import importlib
import importlib.util
import json
import os
import textwrap
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from rocnrdma_tpu import runtime as rt
from rocnrdma_tpu.transport import Transport as RefTransport
from rocnrdma_tpu.workloads import moe as ref_moe
from rocnrdma_tpu.workloads import overlap as ref_overlap
from rocnrdma_tpu.workloads import routing as RR
from rocnrdma_tpu_torch.runtime import rank_mesh
from rocnrdma_tpu_torch.runtime.multiprocess import run_cli
from rocnrdma_tpu_torch.transport import Transport
from rocnrdma_tpu_torch.workloads import _replay, ddp_replay, fsdp_replay, llama_trace
from rocnrdma_tpu_torch.workloads import routing as PR

_WRAPPER = textwrap.dedent('''
    """One rank of a test fleet of the workload CLIs: run RNR_STEPS' CLIs
    in turn (this process's arguments, the platform, after each one's),
    each one's results saved under RNR_DUMP and its outcome a line on
    stdout. The test runs a step in one process through ``hooked`` too."""
    import contextlib
    import importlib
    import json
    import os
    import sys

    import numpy as np
    import torch

    from rocnrdma_tpu_torch.bench import cli_common
    from rocnrdma_tpu_torch.workloads import ddp_replay, fsdp_replay, moe, overlap


    def rank():
        d = torch.distributed
        return d.get_rank() if d.is_available() and d.is_initialized() else "one"


    @contextlib.contextmanager
    def hooked(dump, tag, fail_rank=-1):
        """Within: the workload modules keep their results (the layer's
        last output, each replay mode's, the overlap callables' last), saved
        to ``dump/{tag}_{what}_r{rank}.npz`` when the CLI returns; on rank
        ``fail_rank`` the moe identity check sees a corrupted output."""
        real = {(moe, "moe_step"): moe.moe_step,
                (moe, "moe_topk_step"): moe.moe_topk_step,
                (moe, "identity_error"): moe.identity_error,
                (ddp_replay, "replay"): ddp_replay.replay,
                (fsdp_replay, "replay"): fsdp_replay.replay,
                (overlap, "build_fns"): overlap.build_fns}
        kept = {}

        def save(what, tensors):
            np.savez(os.path.join(dump, f"{tag}_{what}_r{rank()}.npz"),
                     *[t.detach().cpu().numpy() for t in tensors])

        def keeping(what, fn):
            def run(*a, **k):
                out = fn(*a, **k)
                kept[what] = out if isinstance(out, tuple) else (out,)
                return out
            return run

        def replay_of(mod):
            def replay(*a, **k):
                if k.get("out") is None:
                    k["out"] = []
                sec = real[(mod, "replay")](*a, **k)
                save(a[-1], k["out"])  # the mode
                return sec
            return replay

        def identity_error(got, want, rtol, atol):
            if rank() == fail_rank:
                got = got.clone()
                got.reshape(-1)[0] += 1.0
            return real[(moe, "identity_error")](got, want, rtol, atol)

        moe.moe_step = lambda *a, **k: keeping("moe", real[(moe, "moe_step")](*a, **k))
        moe.moe_topk_step = lambda *a, **k: keeping(
            "moe", real[(moe, "moe_topk_step")](*a, **k))
        moe.identity_error = identity_error
        ddp_replay.replay = replay_of(ddp_replay)
        fsdp_replay.replay = replay_of(fsdp_replay)
        overlap.build_fns = lambda *a, **k: tuple(
            keeping(w, f) for w, f in zip(("compute", "comm", "both"),
                                          real[(overlap, "build_fns")](*a, **k)))
        try:
            yield
            for what, tensors in kept.items():
                save(what, tensors)
        finally:
            for (mod, name), fn in real.items():
                setattr(mod, name, fn)


    def steps():
        for i, step in enumerate(json.loads(os.environ["RNR_STEPS"])):
            try:
                with hooked(os.environ["RNR_DUMP"], step["tag"], step.get("fail_rank", -1)):
                    importlib.import_module(step["module"]).main(step["argv"] + sys.argv[1:])
                print(f"STEP {i} OK", flush=True)
            except (SystemExit, AssertionError) as e:
                print(f"STEP {i} {type(e).__name__}: {e}", flush=True)
        return 0


    if __name__ == "__main__":
        sys.exit(cli_common.main(steps))
''')

W = "rocnrdma_tpu_torch.workloads."
ALGOS = ("fused", "ring", "cuda_ring")
MOE = {"uniform": ["--tokens", "32", "--d-model", "8"],
       "topk": ["--routing", "topk", "--tokens", "16", "--d-model", "8"]}
REPLAY = {"ddp_replay": ["--scale", "1048576", "--bucket-mb", "4096"],
          "fsdp_replay": ["--scale", "1048576"]}
OVERLAP = ["--layers", "2", "--dim", "32", "--batch", "8", "--grad-kb", "1"]
ONCE = ["--repeats", "1"]


def _plain(algo: str) -> list:
    return ["--check-plain"] if algo == "cuda_ring" else []


def _cases() -> dict:
    """tag -> (fleet, processes, module, argv): every step whose results
    and records the tests hold."""
    cases = {}
    for n, algos in ((4, ALGOS), (3, ("fused", "cuda_ring"))):
        for routing, argv in MOE.items():
            for algo in algos:
                cases[f"moe_{routing}_{algo}_{n}"] = (
                    f"fleet{n}", n, "moe", argv + ["--algo", algo, "--iters", "1"]
                    + ONCE + _plain(algo))
    for wl, argv in REPLAY.items():
        for algo in ALGOS:
            cases[f"{wl}_{algo}_4"] = ("fleet4", 4, wl,
                                       argv + ["--algo", algo] + ONCE + _plain(algo))
    for algo in ("fused", "ring"):
        cases[f"overlap_{algo}_4"] = ("fleet4", 4, "overlap",
                                      OVERLAP + ["--algo", algo, "--iters", "1"] + ONCE)
    return cases


CASES = _cases()
# steps that check a refusal or a failure, after the cases (fleet4 only)
REFUSALS = [("ddp_ranks", "ddp_replay", REPLAY["ddp_replay"] + ["--ranks", "2"] + ONCE),
            ("moe_fake", "moe", MOE["uniform"] + ["--fake-devices", "4"] + ONCE)]
FAIL = ("moe_fail", "moe", MOE["uniform"] + ["--algo", "fused", "--iters", "1"] + ONCE)


def _load_wrapper(root):
    spec = importlib.util.spec_from_file_location("rnr_wl_fleet_here",
                                                  root / "rnr_wl_fleet.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_fleet(root, n: int, steps: list):
    rs = run_cli(n, "rnr_wl_fleet", [], platform="cpu", timeout_s=120.0,
                 env={"PYTHONPATH": f"{root}{os.pathsep}{os.environ.get('PYTHONPATH', '')}",
                      "RNR_DUMP": str(root / "dump"), "RNR_STEPS": json.dumps(steps),
                      "OMP_NUM_THREADS": "1"})
    for r in rs:
        assert r.returncode == 0, (r.process_id, r.returncode, r.stdout[-3000:],
                                   r.stderr[-3000:])
    return rs


@pytest.fixture(scope="module")
def fleets(tmp_path_factory):
    root = tmp_path_factory.mktemp("workloads_mp")
    for d in ("dump", "one", "out"):
        (root / d).mkdir()
    (root / "rnr_wl_fleet.py").write_text(_WRAPPER)
    steps = {"fleet4": [], "fleet3": []}
    for tag, (fleet, _, module, argv) in CASES.items():
        steps[fleet].append({"module": W + module, "tag": tag,
                             "argv": argv + ["--out", str(root / "out" / f"{tag}.jsonl")]})
    for tag, module, argv in REFUSALS:
        steps["fleet4"].append({"module": W + module, "tag": tag, "argv": argv})
    tag, module, argv = FAIL
    steps["fleet4"].append({"module": W + module, "tag": tag, "argv": argv, "fail_rank": 1})
    with ThreadPoolExecutor(2) as pool:
        runs = dict(zip(steps, pool.map(lambda f: _run_fleet(root, int(f[-1]), steps[f]),
                                        steps)))
    return {"root": root, "runs": runs, "steps": steps,
            "wrapper": _load_wrapper(root), "one": {}}


def _step_lines(fleets, fleet: str, tag: str) -> list:
    i = next(i for i, s in enumerate(fleets["steps"][fleet]) if s["tag"] == tag)
    return [next(line for line in r.stdout.splitlines() if line.startswith(f"STEP {i} "))
            for r in fleets["runs"][fleet]]


def _one_process(fleets, tag: str) -> list:
    """The one-process port's run of ``tag``'s step at ``--fake-devices N
    --platform cpu`` (its results saved as rank "one"): its records."""
    if tag not in fleets["one"]:
        _, n, module, argv = CASES[tag]
        root = fleets["root"]
        out = root / "one" / f"{tag}.jsonl"
        with fleets["wrapper"].hooked(str(root / "one"), tag):
            assert importlib.import_module(W + module).main(
                argv + ["--fake-devices", str(n), "--platform", "cpu",
                        "--out", str(out)]) == 0
        fleets["one"][tag] = [json.loads(line) for line in out.read_text().splitlines()]
    return fleets["one"][tag]


def _saved(fleets, tag: str, what: str, rank) -> list:
    where = "one" if rank == "one" else "dump"
    with np.load(fleets["root"] / where / f"{tag}_{what}_r{rank}.npz") as z:
        return [z[f"arr_{i}"] for i in range(len(z.files))]


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}[a.itemsize])


def _whats(tag: str) -> tuple:
    module = CASES[tag][2]
    if module == "moe":
        return ("moe",)
    if module == "overlap":
        return ("compute", "comm", "both")
    return ddp_replay.MODES


def _summed_by_the_library(tag: str, what: str, i: int) -> bool:
    """Is result ``i`` of ``what`` a ``fused`` sum, which gloo adds across
    processes in its own order?"""
    if "_fused_" not in tag:
        return False
    module = CASES[tag][2]
    if module == "ddp_replay":
        return True
    if module == "fsdp_replay":
        return fsdp_replay.step_plan(34)[i][0] == "rs"
    return module == "overlap" and (what == "comm" or (what == "both" and i == 1))


@pytest.mark.parametrize("tag", list(CASES))
def test_each_rank_results_are_the_one_process_rows(fleets, tag):
    """Bitwise, but a ``fused`` sum within rtol 1e-5, atol 1e-6 (gloo's
    order of summation, not torch's over the rank axis), as
    ``tests/test_torch_rank_mp.py`` holds it."""
    _one_process(fleets, tag)
    n = CASES[tag][1]
    for what in _whats(tag):
        whole = _saved(fleets, tag, what, "one")
        assert whole, what
        for r in range(n):
            mine = _saved(fleets, tag, what, r)
            assert len(mine) == len(whole), (what, r)
            for i, (got, want) in enumerate(zip(mine, whole)):
                # overlap's compute and both[0] are every rank's own
                # matmul chain: rank r's rows of the whole batch
                assert got.shape == (1,) + want.shape[1:], (what, r, i)
                msg = f"{tag} {what} rank {r} result {i}"
                if _summed_by_the_library(tag, what, i):
                    np.testing.assert_allclose(got[0], want[r], rtol=1e-5, atol=1e-6,
                                               err_msg=msg)
                else:
                    np.testing.assert_array_equal(_bits(got[0]), _bits(want[r]),
                                                  err_msg=msg)


_STRIP = ("mean_s", "algbw_GBps", "busbw_GBps", "ts")
_STRIP_EXTRA = ("link", "processes", "step_ms", "speedup_vs_sequential", "compute_s",
                "comm_s", "overlap_frac")


def _strip(rec: dict) -> dict:
    out = {k: v for k, v in rec.items() if k not in _STRIP}
    out["extra"] = {k: v for k, v in rec["extra"].items() if k not in _STRIP_EXTRA}
    return out


@pytest.mark.parametrize("tag", list(CASES))
def test_rank_zero_records_equal_the_one_process_port(fleets, tag):
    fleet, n, module, _ = CASES[tag]
    got = [json.loads(line) for line in
           (fleets["root"] / "out" / f"{tag}.jsonl").read_text().splitlines()]
    want = _one_process(fleets, tag)
    assert [_strip(r) for r in got] == [_strip(r) for r in want]
    assert len(got) == (3 if "replay" in module else 1)
    assert all(r["extra"]["processes"] == n and r["extra"]["link"] == "cpu-loopback"
               and "processes" not in w["extra"] and w["extra"]["link"] == "cpu-loopback"
               for r, w in zip(got, want))
    if tag.split("_")[-2] == "cuda_ring":  # --check-plain: bitwise the plain versions
        assert [r["extra"]["plain_max_abs_err"] for r in got] == [0.0] * len(got)
    # rank 0 alone printed the table
    i = next(i for i, s in enumerate(fleets["steps"][fleet]) if s["tag"] == tag)
    runs = fleets["runs"][fleet]
    assert all(line == f"STEP {i} OK" for line in _step_lines(fleets, fleet, tag))
    table = f"{got[0]['collective']:>13}"
    assert table in runs[0].stdout
    assert all(table not in r.stdout for r in runs[1:])


def _ref_t(n: int) -> RefTransport:
    return RefTransport(rt.rank_mesh(n))


_MOE_CASES = [t for t in CASES if CASES[t][2] == "moe"]


@pytest.mark.parametrize("tag", _MOE_CASES)
def test_moe_rows_are_held_to_the_jax_layer(devices, fleets, tag):
    """The reference's layer on the same seeded input: the uniform layer
    bitwise (data only moves), the top-k layer within 1e-5 in fp32."""
    n = CASES[tag][1]
    routing = tag.split("_")[1]
    rng = np.random.default_rng(0)
    t = _ref_t(n)
    if routing == "uniform":
        x = rng.standard_normal((n, n, 32 // n, 8), dtype=np.float32)
        want = np.asarray(ref_moe.moe_step(t, "fused", False)(t.shard(x)))
    else:
        cap = RR.expert_capacity(16, n, 2, 1.25)
        tok = rng.standard_normal((n, 16, 8), dtype=np.float32)
        logits = rng.standard_normal((n, 16, n), dtype=np.float32)
        want = np.asarray(ref_moe.moe_topk_step(t, "fused", False, n, cap, 2)(
            t.shard(tok), t.shard(logits))[0])
    for r in range(n):
        got = _saved(fleets, tag, "moe", r)[0][0]
        if routing == "uniform":
            np.testing.assert_array_equal(_bits(got), _bits(want[r]))
        else:
            np.testing.assert_allclose(got, want[r], rtol=1e-5, atol=1e-5)


_REPLAY_CASES = [t for t in CASES if "replay" in CASES[t][2]]
PALLAS_FIRST = 3  # buffers held to the interpreted Pallas kernels


@pytest.mark.parametrize("tag", _REPLAY_CASES)
def test_replay_rows_are_held_to_the_jax_transport(devices, fleets, tag):
    """Each mode's results on every rank against the reference's
    ``Transport`` on the whole buffers: ``ring`` and ``cuda_ring``
    (``pallas_ring``) bitwise, ``fused`` within 1e-5."""
    wl, algo = tag.split("_")[0] + "_replay", tag.split("_replay_")[1][:-2]
    n = CASES[tag][1]
    one = Transport(rank_mesh(n, "cpu"))
    if wl == "ddp_replay":
        trace = llama_trace.generate_trace(llama_trace.LLAMA3_8B, bucket_mb=4096.0)
        bufs = ddp_replay._bucket_arrays(one, trace, 1048576, "float32")
        calls = [("allreduce", b) for b in bufs]
    else:
        units = fsdp_replay.flat_units(llama_trace.LLAMA3_8B)
        grain = fsdp_replay.CUDA_RING_GRAIN if algo == "cuda_ring" else 1
        shards, fulls = fsdp_replay._unit_arrays(one, units, 1048576, "float32", grain)
        calls = [("allgather", shards[i]) if k == "ag" else ("reduce_scatter", fulls[i])
                 for k, i in fsdp_replay.step_plan(len(units))]
    t = _ref_t(n)
    ref_algo = "pallas_ring" if algo == "cuda_ring" else algo
    picked = range(PALLAS_FIRST) if algo == "cuda_ring" else range(len(calls))
    want = {i: np.asarray(t.jit_fn(calls[i][0], ref_algo)(t.shard(calls[i][1].numpy())))
            .reshape(n, -1) for i in picked}
    for mode in ddp_replay.MODES:
        for r in range(n):
            mine = _saved(fleets, tag, mode, r)
            assert len(mine) == len(calls)
            for i in picked:
                got = mine[i].reshape(-1)
                if algo == "fused":
                    np.testing.assert_allclose(got, want[i][r], rtol=1e-5, atol=1e-5)
                else:
                    np.testing.assert_array_equal(_bits(got), _bits(want[i][r]),
                                                  err_msg=f"{tag} {mode} rank {r} call {i}")


@pytest.mark.parametrize("algo", ["fused", "ring"])
def test_overlap_rows_are_held_to_the_jax_callables(devices, fleets, algo):
    tag = f"overlap_{algo}_4"
    t = _ref_t(4)
    y, Ws, grads = ref_overlap.example_inputs(t, layers=2, dim=32, batch=8,
                                              grad_elems=1024 // 4)
    compute, comm, both = ref_overlap.build_fns(t, algo)
    want = {"compute": [compute(y, Ws)], "comm": [comm(grads)], "both": list(both(y, Ws, grads))}
    for what, arrays in want.items():
        for r in range(4):
            for got, w in zip(_saved(fleets, tag, what, r), arrays):
                np.testing.assert_allclose(got[0], np.asarray(w)[r], rtol=1e-5, atol=1e-5)


def test_one_rank_failed_moe_check_fails_every_rank_named(fleets):
    lines = _step_lines(fleets, "fleet4", FAIL[0])
    assert all("AssertionError" in line and "moe uniform identity" in line
               and "failed on rank(s) [1] of 4" in line for line in lines), lines
    assert "here:" in lines[1] and all("here:" not in line for line in lines[:1] + lines[2:])


def test_a_foreign_rank_count_and_fake_devices_are_refused_by_name(fleets):
    ranks = _step_lines(fleets, "fleet4", "ddp_ranks")
    assert all("SystemExit" in line and "2 ranks" in line and "world's 4 processes" in line
               for line in ranks), ranks
    fake = _step_lines(fleets, "fleet4", "moe_fake")
    assert all("SystemExit" in line and "--fake-devices 4" in line
               and "process group of 4" in line for line in fake), fake


@pytest.mark.parametrize("cf", [0.5, 1.25])
@pytest.mark.parametrize("k", [1, 2])
def test_a_rank_row_routes_as_that_row_of_the_whole(cf, k):
    """The top-k layer's routing on one rank's ``(1, T, E)`` logits (what
    a process holds across processes) equals that row of the routing of
    the whole ``(n, T, E)``, bitwise: gates, experts, positions, keep, the
    dispatch and the combine."""
    n, T, E, d = 4, 64, 4, 8
    rng = np.random.default_rng(17)
    logits = torch.from_numpy(rng.standard_normal((n, T, E), dtype=np.float32))
    x = torch.from_numpy(rng.standard_normal((n, T, d), dtype=np.float32))
    cap = PR.expert_capacity(T, E, k, cf)

    def route(lg, xx):
        gates, experts = PR.topk_route(lg, k)
        pos, keep = PR.dispatch_mask(experts, E, cap)
        disp = PR.build_dispatch(xx, experts, pos, keep, E, cap)
        return (gates, experts, pos, keep, disp,
                PR.combine(disp * 3.0 + 1.0, gates, experts, pos, keep))

    whole = route(logits, x)
    for r in range(n):
        for got, want in zip(route(logits[r:r + 1], x[r:r + 1]), whole):
            assert torch.equal(got, want[r:r + 1]), r


class _Span:
    size, index, peers = 2, 0, (0, 1)


@pytest.mark.parametrize("timer", ["sequential", "overlap", "fused"])
def test_replay_timers_barrier_each_repeat_and_take_the_fleet_max(monkeypatch, timer):
    """With a span each repeat starts after ``fleet_barrier`` (outside the
    timed window) and the times are ``fleet_max``'s; without one neither
    is called."""
    calls = []
    monkeypatch.setattr(_replay, "fleet_barrier", lambda span: calls.append("barrier"))
    monkeypatch.setattr(_replay, "fleet_max",
                        lambda v, span: calls.append(("max", len(v))) or [1.0, 2.0, 9.0])
    cpu = torch.device("cpu")
    thunks = [lambda: calls.append("call") or 0]
    run = {"sequential": lambda **k: _replay.timed_sequential(thunks, 3, cpu, **k),
           "overlap": lambda **k: _replay.timed_overlap(thunks, 3, 0, cpu, **k),
           "fused": lambda **k: _replay.timed_fused(lambda: [thunks[0]()], (), 3, cpu,
                                                     **k)}[timer]
    assert run(span=_Span()) == 2.0  # the trimmed mean of the fleet's maxima
    body = [c for c in calls if c != "call"]
    assert body == ["barrier"] * 3 + [("max", 3)]
    # each barrier is outside a repeat: a call follows it before the next
    assert calls[-2:] == ["call", ("max", 3)] and calls.count("call") == 3 + (timer == "fused")
    calls.clear()
    assert run() > 0 and set(calls) == {"call"}
