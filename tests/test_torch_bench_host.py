"""The port's bench_host CLI, end to end on the CPU (no perf gate).

Rank 0 re-executes ``python -m rocnrdma_tpu_torch.bench.bench_host
--worker`` once per rank (real OS processes); the JSONL rows carry the
reference's keys, the wire's zero-copy counter is 0 on the steady path,
and the workers import neither torch nor jax.
"""

import json
import os
import subprocess
import sys

import pytest

from rocnrdma_tpu_torch import native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native library not buildable")

ARGS = ["--ranks", "2", "--plane", "shm", "--sizes", "64K", "--repeats", "1",
        "--iters", "1"]


def _cli(module, args, tmp_path, env_extra=None):
    env = dict(os.environ, **(env_extra or {}))
    return subprocess.run([sys.executable, "-m", module, *args], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=240)


def _rows(path):
    return [json.loads(line) for line in open(path) if line.strip()]


def _shape(row) -> dict:
    """The keys of a record, its extra and its extra's dicts."""
    return {"keys": sorted(row), "extra": sorted(row["extra"]),
            **{f"extra.{k}": sorted(v) for k, v in row["extra"].items()
               if isinstance(v, dict) and k not in ("fleet", "trace")}}


def test_cli_writes_the_references_jsonl_keys(tmp_path):
    # the workers must not import torch or jax: a stub that raises on
    # import sits first on their path
    stubs = tmp_path / "stubs"
    stubs.mkdir()
    for mod in ("torch", "jax"):
        (stubs / f"{mod}.py").write_text(f"raise ImportError('{mod} imported')\n")
    out = tmp_path / "port.jsonl"
    r = _cli("rocnrdma_tpu_torch.bench.bench_host", ARGS + ["--out", str(out)],
             tmp_path, {"PYTHONPATH": f"{stubs}{os.pathsep}{REPO}"})
    assert r.returncode == 0, r.stdout + r.stderr
    assert "payload_bytes_copied" not in r.stderr
    ref_out = tmp_path / "ref.jsonl"
    r2 = _cli("rocnrdma_tpu.bench.bench_host", ARGS + ["--out", str(ref_out)],
              tmp_path)
    assert r2.returncode == 0, r2.stdout + r2.stderr
    port, ref = _rows(out), _rows(ref_out)
    assert [p["collective"] for p in port] == [q["collective"] for q in ref]
    for p, q in zip(port, ref):
        assert _shape(p) == _shape(q), p["collective"]
        assert p["platform"] == "host-shm" and p["n_ranks"] == 2
        assert p["extra"]["wire"]["payload_bytes_copied"] == 0
        assert p["size_bytes"] == q["size_bytes"] == 65536
    # the printed table is the reference's (host columns included)
    head = [l for l in r.stdout.splitlines() if "collective" in l][0]
    ref_head = [l for l in r2.stdout.splitlines() if "collective" in l][0]
    assert head == ref_head and "wp99(us)" in head


def test_cli_rdma_and_tcp_paths(tmp_path):
    out = tmp_path / "p.jsonl"
    for plane, transport in (("tcp", "msg"), ("shm", "rdma")):
        r = _cli("rocnrdma_tpu_torch.bench.bench_host",
                 ["--ranks", "2", "--plane", plane, "--transport", transport,
                  "--sizes", "64K", "--collectives", "allreduce",
                  "--repeats", "1", "--iters", "1", "--out", str(out)],
                 tmp_path)
        assert r.returncode == 0, r.stdout + r.stderr
    rows = _rows(out)
    assert [row["platform"] for row in rows] == ["host-tcp", "host-shm"]
    assert all(row["extra"]["wire"]["payload_bytes_copied"] == 0 for row in rows)


def test_cli_refusals(tmp_path):
    r = _cli("rocnrdma_tpu_torch.bench.bench_host", ["--smoke", "--plane", "tcp"],
             tmp_path)
    assert r.returncode != 0 and "--smoke runs the fixed" in r.stderr
    r = _cli("rocnrdma_tpu_torch.bench.bench_host", ["--collectives", "hier"],
             tmp_path)
    assert r.returncode != 0 and "--node-map" in r.stderr


def test_sweep_writes_a_corpus_the_tuner_fits(tmp_path):
    corpus, summary = tmp_path / "corpus.jsonl", tmp_path / "tune.json"
    r = _cli("rocnrdma_tpu_torch.bench.bench_host",
             ["--sweep", "--ranks", "2", "--plane", "shm", "--sizes", "256K",
              "--sweep-frames", "131072,524276", "--repeats", "1",
              "--iters", "1", "--out", str(corpus), "--tune-out", str(summary)],
             tmp_path)
    assert r.returncode == 0, r.stdout + r.stderr
    doc = json.loads(summary.read_text())
    assert doc["schema"] == "tune_sweep_r1" and doc["plane"] == "shm"
    assert len(_rows(corpus)) == 2
    model = tmp_path / "model.json"
    r = _cli("rocnrdma_tpu_torch.transport.tuner",
             ["--fit-host", str(corpus), "--out", str(model)], tmp_path)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "shm" in json.loads(model.read_text())["planes"]


def test_16MiB_puts_do_not_starve_the_ring(tmp_path):
    """4 rank processes, tcp, 1 MiB then 16 MiB a rank: a rank's put can
    wait on arena credit its right neighbour returns only when it tests
    its receive, while that neighbour waits in its own put. The ring
    exchange (alltoall) and the p2p sends (sendrecv's batch) now test
    their posted receives while they wait; the reference stalls here in
    some runs (alltoall) or most (sendrecv; ROADMAP Queue 3)."""
    r = _cli("rocnrdma_tpu_torch.bench.bench_host",
             ["--ranks", "4", "--plane", "tcp", "--sizes", "1M,16M",
              "--collectives", "alltoall,sendrecv", "--repeats", "3",
              "--iters", "3"], tmp_path)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    assert "credit starved" not in r.stderr


# -- bench/host_tune.py: the floors, the fit and the comparison ------------

def _rec(algo, plane, ranks, gbps, **extra):
    return {"algo": algo, "platform": f"host-{plane}", "n_ranks": ranks,
            "algbw_GBps": gbps, "extra": extra}


def _smoke_records(scale=1.0):
    """One ``--smoke`` run's rows, in the order the smoke writes them."""
    s = scale
    return [
        _rec("ring", "shm", 2, 0.9 * s), _rec("ring", "tcp", 2, 0.5 * s),
        _rec("ring_rdma", "shm", 2, 0.8 * s),
        _rec("lanes", "shm", 2, 0.1, p99_us=1500.0 / s, bulk_GBps=0.4 * s),
        _rec("unbatched", "shm", 2, 0.2),
        _rec("coalesced", "shm", 2, 0.7, coalesce={"speedup": 3.6 * s}),
        _rec("ring", "tcp", 2, 0.46),  # the codec scenario's baseline
        _rec("codec-int8", "tcp", 2, 0.4 * s, spread=[0.3, 0.42 * s]),
        _rec("codec-fp8", "tcp", 2, 0.18),
        _rec("ring", "tcp", 4, 0.25),
        _rec("hier", "tcp", 4, 0.35 * s, hier={"speedup_best": 1.2 * s}),
        _rec("hier-codec", "tcp", 4, 0.31),
    ]


def test_smoke_values_reads_each_gate_by_its_row():
    from rocnrdma_tpu_torch.bench import host_tune
    v = host_tune.smoke_values(_smoke_records())
    assert v == {"shm_GBps": 0.9, "tcp_GBps": 0.5, "rdma_GBps": 0.8,
                 "lanes_p99_us": 1500.0, "lanes_bulk_GBps": 0.4,
                 "coalesce_speedup": 3.6, "codec_int8_GBps": 0.4,
                 "codec_int8_best_GBps": 0.42, "hier_GBps": 0.35,
                 "hier_speedup_best": 1.2}
    with pytest.raises(ValueError, match="no hier row on tcp at 4 ranks"):
        host_tune.smoke_values([r for r in _smoke_records()
                                if r["algo"] != "hier"])


def test_derive_floors_takes_half_the_worst_run_and_keeps_the_hier_guard():
    from rocnrdma_tpu_torch.bench import bench_host, host_tune
    runs = [host_tune.smoke_values(_smoke_records(s)) for s in (1.0, 0.8)]
    f = host_tune.derive_floors(runs)
    worst = host_tune.smoke_values(_smoke_records(0.8))
    assert f["worst"] == worst
    assert f["SMOKE_FLOORS"] == {"shm": round(0.625 * 0.72, 3),
                                 "tcp": round(0.625 * 0.4, 3),
                                 "rdma": round(0.625 * 0.64, 3)}
    assert f["SMOKE_FLOORS_HIER"] == round(0.625 * 0.28, 3)
    assert f["SMOKE_LANES_P99_US"] == round(2 * 1500.0 / 0.8, -2)
    assert f["SMOKE_LANES_BULK_GBPS"] == round(0.5 * 0.32, 3)
    assert f["SMOKE_COALESCE_SPEEDUP"] == round(0.5 * 3.6 * 0.8, 2)
    assert f["SMOKE_CODEC_X"] == round(0.5 * 0.42 * 0.8 / round(0.25, 3), 2)
    # the schedule-collapse guard is the reference's bar, not a floor
    assert "SMOKE_HIER_MIN_X" not in f and bench_host.SMOKE_HIER_MIN_X == 0.9


def _fake_bench_host(calls, smoke_scale=(1.0,)):
    """Stands for ``host_tune._bench_host``: writes canned records where
    the real CLI would and records each call's arguments and env."""
    runs = iter(range(10 ** 6))  # the smoke runs, numbered

    def run(args, log, env=None):
        calls.append((list(args), dict(env or {})))
        out = args[args.index("--out") + 1]
        if "--sweep" in args:
            plane = args[args.index("--plane") + 1]
            with open(out, "a") as fp:
                for size in (1 << 18, 1 << 20, 1 << 22):
                    for frame in (131072, 524276, 1 << 20, 1 << 22):
                        mean = 2e-4 + size * (1e-9 + 3e-10 * (frame > 524276))
                        fp.write(json.dumps({
                            "platform": f"host-{plane}", "size_bytes": size,
                            "n_ranks": 2, "mean_s": mean,
                            "algbw_GBps": size / mean / 1e9,
                            "extra": {"spread": [0.9 * size / mean / 1e9,
                                                 size / mean / 1e9],
                                      "wire": {"frame_bytes": frame}}}) + "\n")
                fp.write('{"platform": "host-')  # a torn tail line
                fp.write("\n")
            tune = args[args.index("--tune-out") + 1]
            with open(tune, "w") as fp:
                json.dump({"rows": [{"size_bytes": 1 << 20, "ratio": 1.0}]}, fp)
            return 0
        if "--smoke" in args:
            k = next(runs)
            with open(out, "w") as fp:
                for r in _smoke_records(smoke_scale[k % len(smoke_scale)]):
                    fp.write(json.dumps(r) + "\n")
            return 0
        static = env.get("ROCNRDMA_WIRE_TUNER") == "0"
        with open(out, "w") as fp:
            fp.write(json.dumps({"algbw_GBps": 1.0 if static else 2.0,
                                 "extra": {"wire": {"frame_bytes": 4 << 20,
                                                    "pipeline_depth": 2,
                                                    "tuner_version": 0}}})
                     + "\n")
        return 0
    return run


@pytest.fixture
def quiet_codec(monkeypatch):
    from rocnrdma_tpu_torch.bench import host_tune
    monkeypatch.setattr(host_tune, "codec_rates", lambda: {
        "int8": {"encode_GBps": 4.0, "decode_fold_GBps": 5.0},
        "fp8": {"encode_GBps": 2.0, "decode_fold_GBps": 1.0},
        "fp8_over_int8_cost": 3.3})
    return host_tune


def test_host_tune_without_planes_runs_only_the_smoke(tmp_path, monkeypatch,
                                                      quiet_codec):
    host_tune, calls = quiet_codec, []
    monkeypatch.setattr(host_tune, "_bench_host",
                        _fake_bench_host(calls, (1.0, 0.8)))
    out = tmp_path / "ht.json"
    assert host_tune.main(["--out", str(out), "--planes", "",
                           "--smoke-runs", "2"]) == 0
    doc = json.loads(out.read_text())
    assert doc["planes"] == {} and doc["tables"] == {}
    assert doc["compare"] is None and doc["meta"]["commands"] == []
    assert [c[0][0] for c in calls] == ["--smoke", "--smoke"]
    assert [r["exit"] for r in doc["smoke"]["runs"]] == [0, 0]
    assert doc["smoke"]["floors"]["SMOKE_FLOORS"]["tcp"] == round(0.625 * 0.4, 3)


def test_host_tune_fits_the_sweep_through_tuner_fit_host(tmp_path, monkeypatch,
                                                         quiet_codec):
    from rocnrdma_tpu_torch.transport import tuner
    host_tune, calls = quiet_codec, []
    monkeypatch.setattr(host_tune, "_bench_host", _fake_bench_host(calls))
    out = tmp_path / "ht.json"
    assert host_tune.main(["--out", str(out), "--planes", "shm,tcp",
                           "--smoke-runs", "0"]) == 0
    doc = json.loads(out.read_text())
    # the same corpus through the tuner's own --fit-host CLI
    ref = tmp_path / "ref.json"
    r = _cli("rocnrdma_tpu_torch.transport.tuner",
             ["--fit-host", f"{out}.corpus.jsonl", "--out", str(ref)], tmp_path)
    assert r.returncode == 0, r.stdout + r.stderr
    want = tuner.load_host_model(str(ref))
    codec_s = 1e-9 / 4.0 + 1e-9 / 5.0
    assert set(doc["planes"]) == set(want) == {"shm", "tcp"}
    for plane, params in want.items():
        assert doc["planes"][plane] == {**params.to_dict(),
                                        "codec_s_per_b": codec_s}
    assert doc["tables"] == {k: [list(e) for e in v] for k, v in
                             tuner.load_host_tables(str(ref)).items()}
    assert doc["meta"]["fit"] == {"shm": "least-squares (12 rows)",
                                  "tcp": "least-squares (12 rows)"}
    assert set(doc["meta"]["sweeps"]) == {"shm", "tcp"}


def test_host_tune_compares_the_committed_model_with_the_static_wire(
        tmp_path, monkeypatch, quiet_codec):
    host_tune, calls = quiet_codec, []
    monkeypatch.setattr(host_tune, "_bench_host", _fake_bench_host(calls))
    monkeypatch.setenv("ROCNRDMA_HOST_TUNING", "elsewhere.json")
    out = tmp_path / "ht.json"
    assert host_tune.main(["--out", str(out), "--planes", "", "--smoke-runs",
                           "0", "--compare-planes", "tcp", "--compare-ranks",
                           "2,4", "--sizes", "1M", "--compare-rounds",
                           "2"]) == 0
    rows = json.loads(out.read_text())["compare"]
    assert [(r["plane"], r["ranks"], r["size"]) for r in rows] == [
        ("tcp", 2, "1M"), ("tcp", 4, "1M")]
    assert all(r["verdict"] == "win" and r["median_ratio"] == 2.0
               for r in rows)
    arms = ["static" if env.get("ROCNRDMA_WIRE_TUNER") == "0" else "committed"
            for _, env in calls]
    assert arms == ["static", "committed", "committed", "static"] * 4
    for _, env in calls:  # every wire knob unset but the static arm's
        assert env.pop("ROCNRDMA_WIRE_TUNER", None) in (None, "0")
        assert set(env.values()) == {None}
        assert set(env) == set(host_tune.WIRE_KNOBS) - {"ROCNRDMA_WIRE_TUNER"}
    assert host_tune.verdict([1.0, 1.1], [1.2, 1.3]) == "loss"
    assert host_tune.verdict([1.0, 1.25], [1.2, 1.3]) == "unresolved"
    assert host_tune.verdict([1.4, 1.5], [1.2, 1.3]) == "win"


def test_the_committed_floors_are_the_recorded_runs_rule():
    """bench_host's floors are derive_floors over the three runs that
    results/host_smoke_h100.json records."""
    from rocnrdma_tpu_torch.bench import bench_host, host_tune
    doc = json.load(open(os.path.join(
        REPO, "rocnrdma_tpu_torch", "results", "host_smoke_h100.json")))
    runs = [{k: v for k, v in r.items() if k != "exit"}
            for r in doc["smoke"]["runs"]]
    floors = host_tune.derive_floors(runs)
    assert len(runs) == 3 and floors == doc["smoke"]["floors"]
    for name, value in floors.items():
        if name != "worst":
            assert getattr(bench_host, name) == value, name
