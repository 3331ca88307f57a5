"""The port's collectives, Transport and bench CLIs against the JAX
reference, on the CPU.

- ``ring`` / ``ring_bidir`` arms: bitwise equal to the reference's
  ``ring_allreduce`` for every op (same chunking, step indices and fold
  order; ``avg`` multiplies by the reciprocal of n as XLA's compiled
  reference does).
- ``fused``: rtol = atol = 1e-5, because ``torch.sum``'s order of
  summation differs from ``psum``'s.
- The port imports nothing of JAX or of the JAX package, and nothing of
  Triton at import time (checked in a subprocess over every module: this
  process already imported jax in conftest.py).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from rocnrdma_tpu import metrics as RM
from rocnrdma_tpu import runtime as rt
from rocnrdma_tpu.bench import bench_allreduce as ref_bench_allreduce
from rocnrdma_tpu.collectives import schedule as RS
from rocnrdma_tpu.transport import Transport as RefTransport
from rocnrdma_tpu_torch import hw, metrics
from rocnrdma_tpu_torch import ops as T
from rocnrdma_tpu_torch.bench import (bench_allreduce, bench_local, bench_ring_tiles,
                                      runner, timing)
from rocnrdma_tpu_torch.collectives import schedule as PS
from rocnrdma_tpu_torch.runtime import detect_topology, rank_mesh
from rocnrdma_tpu_torch.transport import Transport, api

from _marks import needs_tpu_interpret

OPS = ("sum", "prod", "max", "min", "avg")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a).view(np.uint32)


def _cpu_transport(n: int) -> Transport:
    return Transport(rank_mesh(n, "cpu"))


@pytest.mark.parametrize("n", [2, 3, 8])
@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("algo", ["ring", "ring_bidir"])
def test_ring_arms_bitwise_equal_reference(devices, n, op, algo):
    x = np.random.default_rng(n).standard_normal((n, 1001)).astype(np.float32)
    rt_ = RefTransport(rt.rank_mesh(n))
    ref = np.asarray(rt_.allreduce(rt_.shard(x), algo, op=op))
    t = _cpu_transport(n)
    got = t.allreduce(t.shard(x), algo, op=op).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(ref))


@pytest.mark.parametrize("op", OPS)
def test_fused_matches_reference(devices, op):
    n = 8
    x = np.random.default_rng(1).standard_normal((n, 777)).astype(np.float32)
    rt_ = RefTransport(rt.rank_mesh(n))
    ref = np.asarray(rt_.allreduce(rt_.shard(x), "fused", op=op))
    t = _cpu_transport(n)
    got = t.allreduce(t.shard(x), "fused", op=op).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@needs_tpu_interpret
def test_cuda_ring_arm_bitwise_equals_pallas_ring_arm(devices):
    n = 4
    x = np.random.default_rng(0).standard_normal((n, 300)).astype(np.float32)
    rt_ = RefTransport(rt.rank_mesh(n))
    ref = np.asarray(rt_.allreduce(rt_.shard(x), "pallas_ring"))
    t = _cpu_transport(n)
    got = t.allreduce(t.shard(x), "cuda_ring").numpy()
    np.testing.assert_array_equal(_bits(got), _bits(ref))
    assert t.stats()["allreduce/cuda_ring"]["calls"] == 1


def test_cuda_ring_tiled_tier_leaves_input_unchanged(monkeypatch):
    # above the one-tile limit the arm runs the tiled tier out of place
    monkeypatch.setattr(api, "CUDA_RING_TILE_BYTES", 4096)
    t = _cpu_transport(3)
    x = t.shard(np.random.default_rng(2).standard_normal((3, 5000)).astype(np.float32))
    assert api.cuda_ring_tile_rows(x) == 7  # a 14-row chunk in two tiles
    before = x.clone()
    got = t.allreduce(x, "cuda_ring")
    assert torch.equal(x, before)
    want = T.hbm_ring_allreduce_plain(x.clone(), tile_rows=7)
    assert torch.equal(got, want)


def test_cuda_ring_is_sum_only():
    t = _cpu_transport(4)
    x = t.shard(np.ones((4, 16), np.float32))
    with pytest.raises(ValueError, match="sum-only"):
        t.allreduce(x, "cuda_ring", op="max")
    with pytest.raises(ValueError, match="unknown reduce op"):
        t.allreduce(x, "ring", op="median")
    with pytest.raises(ValueError, match="unknown algo"):
        t.allreduce(x, "pallas_ring")


def test_rnr_algo_reroutes_auto(monkeypatch):
    t = _cpu_transport(2)
    x = t.shard(np.arange(8, dtype=np.float32).reshape(2, 4))
    assert t._resolve("auto", "allreduce") == "fused"
    monkeypatch.setenv("RNR_ALGO", "ring")
    assert t._resolve("auto", "allreduce") == "ring"
    t.allreduce(x)
    assert t.stats() == {"allreduce/ring": {"calls": 1, "bytes": 32}}
    assert "allreduce/ring" in t.format_stats()
    assert t._resolve("fused", "allreduce") == "fused"  # explicit algos win
    monkeypatch.setenv("RNR_ALGO", "bogus")
    with pytest.raises(ValueError, match="not an algorithm"):
        t._resolve("auto", "allreduce")


def test_shard_places_rank_major_tensor_and_validates():
    t = _cpu_transport(3)
    x = np.random.default_rng(0).standard_normal((3, 10)).astype(np.float32)
    s = t.shard(x, torch.bfloat16)
    assert s.dtype == torch.bfloat16 and s.shape == (3, 10) and s.device.type == "cpu"
    assert torch.equal(s, torch.from_numpy(x).to(torch.bfloat16))
    with pytest.raises(ValueError, match="leading dim"):
        t.shard(np.zeros((2, 10), np.float32))
    with pytest.raises(ValueError, match="rank-major"):
        t.jit_fn("allreduce", "fused")(torch.zeros(2, 10))


def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rank_mesh(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Transport()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_allreduce.main(["--preset", "loopback2", "--fake-devices", "2"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_local.main(["--kernels", "cuda2"])


def test_bench_allreduce_loopback2_matches_reference_record_keys(devices, tmp_path):
    ref_out, out = tmp_path / "ref.jsonl", tmp_path / "port.jsonl"
    common = ["--preset", "loopback2", "--repeats", "2", "--iters", "2"]
    assert ref_bench_allreduce.main(common + ["--out", str(ref_out)]) == 0
    argv = common + ["--fake-devices", "2", "--platform", "cpu", "--out", str(out)]
    assert bench_allreduce.main(argv) == 0
    keys = metrics.load_completed(out)
    assert keys == RM.load_completed(ref_out)
    assert keys == {("bench_allreduce", "allreduce", a, 2, 4096, "float32")
                    for a in ("ring", "fused")}
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert {r["tier"] for r in rows} == {"correctness-oracle"}
    assert all(r["extra"]["checked"] and r["extra"]["link"] == "cpu-loopback"
               for r in rows)
    # --resume adds nothing; --paranoid reruns bitwise
    assert bench_allreduce.main(argv + ["--resume"]) == 0
    assert len(out.read_text().splitlines()) == 2
    assert bench_allreduce.main(
        ["--ranks", "3", "--sizes", "4K", "--algos", "ring,ring_bidir,cuda_ring,fused",
         "--dtypes", "float32,bfloat16", "--fake-devices", "3", "--platform", "cpu",
         "--repeats", "2", "--iters", "1", "--paranoid", "--redop", "sum"]) == 0


def test_bench_allreduce_rejects_bad_flags():
    base = ["--fake-devices", "2", "--platform", "cpu", "--sizes", "4K"]
    with pytest.raises(ValueError, match="unknown algo"):
        bench_allreduce.main(base + ["--algos", "bogus"])
    with pytest.raises(ValueError, match="unknown dtype"):
        bench_allreduce.main(base + ["--dtypes", "int7"])
    with pytest.raises(ValueError):
        bench_allreduce.main(base + ["--sizes", "banana"])
    with pytest.raises(SystemExit, match="preset needs 8 ranks"):
        bench_allreduce.main(base + ["--preset", "ring8", "--strict-preset"])


def test_bench_allreduce_profile_writes_a_trace(tmp_path):
    prof = tmp_path / "prof"
    assert bench_allreduce.main(
        ["--fake-devices", "2", "--platform", "cpu", "--sizes", "4K", "--repeats",
         "1", "--iters", "1", "--algos", "fused", "--profile", str(prof)]) == 0
    assert (prof / "trace.json").stat().st_size > 0


def test_runner_self_check_accepts_ring_rounding_rejects_a_lost_rank():
    # 8 bf16 ranks whose values cancel: a per-hop-rounded ring may land
    # 0.09 off an expected 0.01, inside the (n-1)-add rounding bound but
    # outside atol = rtol = 5e-2; losing a rank's 1.0 is outside both
    x = np.array([[1.0], [-1.0], [1.0], [-1.0], [1.0], [-1.0], [1.0], [-0.99]],
                 np.float32)
    bound = torch.from_numpy(runner._rounding_bound(x, "sum", "bfloat16"))
    want = torch.from_numpy(x.sum(axis=0))
    runner._check(torch.full((8, 1), 0.1), want, 5e-2, 5e-2, "ring", bound)
    with pytest.raises(AssertionError, match="8 element"):
        runner._check(torch.full((8, 1), 0.1), want, 5e-2, 5e-2, "ring")
    with pytest.raises(AssertionError, match="off"):
        runner._check((want - 1.0).expand(8, 1), want, 5e-2, 5e-2, "ring", bound)


def test_bench_local_rows_on_cpu(capsys):
    args = bench_local.make_parser().parse_args(
        ["--platform", "cpu", "--size", "64K", "--k2", "6", "--repeats", "2",
         "--trials", "1"])
    rows = bench_local.run(args)
    assert [r["kernel"] for r in rows] == list(bench_local.KERNELS)
    assert all(r["platform"] == "cpu" and r["s_per_op"] > 0 for r in rows)
    assert bench_local.kernel_n_ops("cuda3") == 3


def test_bench_ring_tiles_rows_on_cpu(tmp_path):
    # 3 ranks x 64 KiB fp32: a 5462-element chunk takes 8- and 32-row tiles,
    # not 64 rows (8192 elements would pad it); each point is checked first
    out = tmp_path / "tiles.jsonl"
    rows = bench_ring_tiles.run(bench_ring_tiles.make_parser().parse_args(
        ["--platform", "cpu", "--ranks", "3", "--sizes", "64K", "--tile-rows",
         "8,32,64", "--repeats", "1", "--iters", "1", "--out", str(out)]))
    assert [(r["tier"], r["tile_rows"], r["tiles_per_chunk"], r["chunk_elems"])
            for r in rows] == [("one_tile", None, 1, 5504), ("tiled", 8, 6, 6144),
                               ("tiled", 32, 2, 8192)]
    assert all(r["ms"] > 0 and r["link"] == "hbm-loopback" for r in rows)
    assert [json.loads(line)["tile_rows"] for line in out.read_text().splitlines()] \
        == [None, 8, 32]


def test_sass_loads_counts_loads_in_flight_before_an_add():
    from rocnrdma_tpu_torch.bench import sass_loads
    sass = """
        Function : _Z1kv
        /*0000*/                   LDC R1, c[0x0][0x28] ;   /* 0x00000a00ff017b82 */
                                                            /* 0x000fe20000000800 */
        /*0010*/                   LDG.E.128 R4, desc[UR4][R2.64] ;
        /*0020*/              @!P0 LDG.E.128 R8, desc[UR4][R2.64+0x10] ;
        /*0030*/                   FADD R4, R4, R8 ;
        /*0040*/                   LDG.E.128 R8, desc[UR4][R6.64] ;
        /*0050*/                   FADD R4, R4, R8 ;
        Function : _Z1jv
        /*0000*/                   LDS.128 R8, [R2] ;
        /*0010*/                   LD.E.128 R4, desc[UR4][R2.64] ;
        /*0020*/                   STG.E [R2.64], R4 ;
    """
    assert sass_loads._loads(sass) == {"_Z1kv": {"ldg": 3, "loads_before_add": 2},
                                       "_Z1jv": {"ldg": 1, "loads_before_add": 1}}
    log = ("ptxas info    : Compiling entry function '_Z1kv' for 'sm_90a'\n"
           "ptxas info    : Function properties for _Z1kv\n"
           "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads\n"
           "ptxas info    : Used 40 registers, used 0 barriers\n")
    assert sass_loads._ptxas(log) == {"_Z1kv": {"spill_bytes": 12, "registers": 40}}


def test_kernel_variants_apply_to_the_committed_sources():
    # every variant's substitution finds its target in today's sources
    from rocnrdma_tpu_torch.bench import bench_kernel_variants as V
    from rocnrdma_tpu_torch.ops import _build
    for lib, apply in V.VARIANTS.values():
        with open(os.path.join(_build.CSRC, f"{lib}.cu")) as fp:
            src = fp.read()
        out = apply(src)
        assert out != src and out.count("__global__") == src.count("__global__")
    with open(os.path.join(_build.CSRC, "ring.cu")) as fp:
        assert "cp.async.bulk" in V.VARIANTS["ring_ag_bulk"][1](fp.read())


def test_timing_helpers_on_cpu():
    x = torch.ones(1000)
    tm = timing.time_fn(torch.add, x, x, warmup=1, repeats=3, calls_per_repeat=2)
    assert tm.min_s <= tm.mean_s <= tm.max_s and tm.repeats == 3
    trials = timing.marginal_trials(
        lambda k: (lambda v: [v + 1 for _ in range(k)]), (x,), 1, 4, repeats=2,
        trials=2)
    assert len(trials) == 2 and all(v > 0 for v in trials)
    assert timing.trimmed_mean([1.0, 2.0, 30.0]) == 2.0


@pytest.mark.parametrize("n", range(1, 10))
def test_schedule_indices_equal_reference(n):
    assert PS.ring_permutation(n) == RS.ring_permutation(n)
    assert PS.ring_permutation(n, -1) == RS.ring_permutation(n, -1)
    for r in range(n):
        assert PS.ring_owned_chunk(n, r) == RS.ring_owned_chunk(n, r)
        for s in range(n):
            for f in ("ring_rs_send_chunk", "ring_rs_recv_chunk",
                      "ring_ag_send_chunk", "ring_ag_recv_chunk"):
                assert getattr(PS, f)(n, s, r) == getattr(RS, f)(n, s, r)
    x = np.random.default_rng(n).standard_normal((n, n * 5)).astype(np.float32)
    np.testing.assert_array_equal(PS.sim_ring_allreduce(x), RS.sim_ring_allreduce(x))


def test_metrics_equal_reference():
    for coll in ("allreduce", "allgather", "reducescatter", "broadcast", "sendrecv"):
        for n in (1, 2, 8):
            assert metrics.busbw_GBps(coll, n, 1 << 20, 1e-3) == \
                RM.busbw_GBps(coll, n, 1 << 20, 1e-3)
    rec = metrics.BenchRecord.measure("b", "allreduce", "ring", 8, 4096, "float32",
                                      1e-5, platform="gpu", op="max")
    again = metrics.BenchRecord.from_json(rec.to_json())
    assert again.key() == rec.key() == ("b", "allreduce", "ring", 8, 4096,
                                        "float32", ("op", "max"))
    assert rec.tier == "performance"
    assert "busbw GB/s" in metrics.format_table([rec])
    for trials in ([1e-3], [1e-3, 2e-3, 1.5e-3], [4e-3, 1e-3, 2e-3, 3e-3]):
        for on_cpu in (True, False):
            assert metrics.scored_algbw_row(trials, 1 << 20, 8, "fused", on_cpu) == \
                RM.scored_algbw_row(trials, 1 << 20, 8, "fused", on_cpu)


def test_hw_and_topology():
    h100 = hw.chip_for("NVIDIA H100 80GB HBM3")
    assert h100.hbm_GBps == 3350.0 and "datasheet" in h100.source
    assert hw.chip_for("cpu") is None
    assert hw.bytes_bound_ms(3.35e9, "NVIDIA H100 80GB HBM3") == pytest.approx(1.0)
    assert hw.fp32_ops_bound_ms(67e9, "NVIDIA H100 80GB HBM3") == pytest.approx(1.0)
    with pytest.raises(ValueError, match="no datasheet row"):
        hw.bytes_bound_ms(1.0, "cpu")
    topo = detect_topology("cpu", fake_devices=4)
    assert (topo.platform, topo.n_devices, topo.is_oracle) == ("cpu", 4, True)
    mesh = rank_mesh(4, "cpu")
    assert mesh.n_ranks == 4 and mesh.device == torch.device("cpu")
    with pytest.raises(ValueError, match="unknown platform"):
        detect_topology("tpu")


def test_port_imports_no_jax_and_no_reference_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import rocnrdma_tpu_torch\n"
        "for m in pkgutil.walk_packages(rocnrdma_tpu_torch.__path__, "
        "'rocnrdma_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'rocnrdma_tpu', 'triton', 'ml_dtypes'))\n"
        "need = ('rocnrdma_tpu_torch.' + m for m in ('workloads', 'workloads.routing', "
        "'workloads.moe', 'workloads.llama_trace', 'workloads._replay', "
        "'workloads.ddp_replay', 'workloads.fsdp_replay', 'workloads.overlap', "
        "'bench.headline', 'bench.mfu_profile', 'graft_entry', 'trace', "
        "'first_contact', 'runtime.topology', 'runtime.topo_cli', 'runtime.init', "
        "'runtime.multiprocess', 'runtime.mp_worker', 'collectives._steps', "
        "'collectives._exchange', 'collectives.hierarchical', 'runtime.mesh', "
        "'distributed', 'lockwitness', 'native', 'obs', 'obs.recorder', "
        "'obs.trace', 'obs.chrome', 'obs.conformance', 'obs.fleet', "
        "'transport.bootstrap', 'transport.plugin', 'transport.codec', "
        "'transport.lanes', 'transport.coalesce', 'transport.faults', "
        "'transport.evasion', 'transport.backoff', 'transport.keyspace', "
        "'bench.bench_host'))\n"
        "missing = [m for m in need if m not in sys.modules]\n"
        "print(bad, missing)\n"
        "sys.exit(1 if bad or missing else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_chip_smoke_fails_without_a_card(tmp_path):
    # alone in a directory and with no CUDA device: non-zero, no result line
    lone = tmp_path / "chip_smoke.py"
    lone.write_text(open(os.path.join(REPO, "chip_smoke.py")).read())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, str(lone)], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
