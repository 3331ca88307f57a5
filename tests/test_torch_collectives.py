"""The port's reduce-scatter, allgather and alltoall against the JAX
reference, on the CPU.

- ``ring`` reduce-scatter: bitwise equal to the reference's for every op
  (the same -1-shifted reduce phase, chunking and fold order; ``avg``
  multiplies by the reciprocal of n as XLA's compiled reference does).
- ``ring`` allgather, the rotation (``ring``) and ``bruck`` alltoall:
  bitwise, since they only move data.
- ``fused``: reduce-scatter to rtol = atol = 1e-5 (torch's order of
  summation is not ``psum_scatter``'s); allgather and alltoall bitwise.
- The copied schedule functions equal the reference's; the three CLIs
  write the reference CLIs' record keys.
"""

import numpy as np
import pytest
import torch

from rocnrdma_tpu import metrics as RM
from rocnrdma_tpu import runtime as rt
from rocnrdma_tpu.bench import bench_allgather as ref_bench_allgather
from rocnrdma_tpu.bench import bench_alltoall as ref_bench_alltoall
from rocnrdma_tpu.bench import bench_reducescatter as ref_bench_reducescatter
from rocnrdma_tpu.collectives import schedule as RS
from rocnrdma_tpu.transport import Transport as RefTransport
from rocnrdma_tpu_torch import metrics
from rocnrdma_tpu_torch.bench import (bench_allgather, bench_alltoall,
                                      bench_reducescatter, runner)
from rocnrdma_tpu_torch.collectives import schedule as PS
from rocnrdma_tpu_torch.runtime import rank_mesh
from rocnrdma_tpu_torch.transport import Transport

OPS = ("sum", "prod", "max", "min", "avg")


def _bits(a) -> np.ndarray:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return np.ascontiguousarray(a).view(np.uint32)


def _pair(n: int):
    return RefTransport(rt.rank_mesh(n)), Transport(rank_mesh(n, "cpu"))


def _both(n: int, verb: str, algo: str, x: np.ndarray, **kw):
    ref_t, t = _pair(n)
    ref = np.asarray(getattr(ref_t, verb)(ref_t.shard(x), algo, **kw))
    got = getattr(t, verb)(t.shard(x), algo, **kw)
    return ref, got


@pytest.mark.parametrize("n", [2, 3, 8])
@pytest.mark.parametrize("op", OPS)
def test_ring_reduce_scatter_bitwise_equals_reference(devices, n, op):
    x = np.random.default_rng(n).standard_normal((n, n * 125)).astype(np.float32)
    ref, got = _both(n, "reduce_scatter", "ring", x, op=op)
    assert got.shape == (n, 125)
    np.testing.assert_array_equal(_bits(got), _bits(ref))


@pytest.mark.parametrize("op", OPS)
def test_fused_reduce_scatter_matches_reference(devices, op):
    n = 8
    x = np.random.default_rng(1).standard_normal((n, n * 97)).astype(np.float32)
    ref, got = _both(n, "reduce_scatter", "fused", x, op=op)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n", [2, 3, 8])
@pytest.mark.parametrize("algo", ["ring", "fused"])
def test_allgather_bitwise_equals_reference(devices, n, algo):
    x = np.random.default_rng(n).standard_normal((n, 333)).astype(np.float32)
    ref, got = _both(n, "allgather", algo, x)
    assert got.shape == (n, n * 333)
    np.testing.assert_array_equal(_bits(got), _bits(ref))


@pytest.mark.parametrize("n", [2, 3, 5, 8])
@pytest.mark.parametrize("algo", ["ring", "bruck", "fused"])
def test_alltoall_bitwise_equals_reference(devices, n, algo):
    x = np.random.default_rng(n).standard_normal((n, n, 77)).astype(np.float32)
    ref, got = _both(n, "alltoall", algo, x)
    np.testing.assert_array_equal(_bits(got), _bits(ref))
    np.testing.assert_array_equal(got.numpy(), x.transpose(1, 0, 2))


def test_verbs_validate_their_inputs():
    t = Transport(rank_mesh(4, "cpu"))
    x = t.shard(np.ones((4, 16), np.float32))
    with pytest.raises(ValueError, match="sum-only"):
        t.reduce_scatter(x, "cuda_ring", op="max")
    with pytest.raises(ValueError, match="must divide"):
        t.reduce_scatter(t.shard(np.ones((4, 10), np.float32)), "ring")
    with pytest.raises(ValueError, match="leading dim"):
        t.alltoall(x, "bruck")
    with pytest.raises(ValueError, match="no 'bruck' schedule"):
        t.allgather(x, "bruck")
    with pytest.raises(ValueError, match="alltoallv knows"):
        t.alltoallv(t.shard(np.ones((4, 4, 2), np.float32)), np.ones((4, 4)), "ring")


def test_rnr_algo_bruck_reroutes_alltoall_auto(monkeypatch):
    t = Transport(rank_mesh(4, "cpu"))
    x = t.shard(np.arange(64, dtype=np.float32).reshape(4, 4, 4))
    monkeypatch.setenv("RNR_ALGO", "bruck")
    assert t._resolve("auto", "alltoall") == "bruck"
    assert t._resolve("auto", "allgather") == "fused"  # no bruck allgather
    assert torch.equal(t.alltoall(x), x.transpose(0, 1))
    assert t.stats() == {"alltoall/bruck": {"calls": 1, "bytes": 256}}
    # alltoallv honours only its own algorithms; others fall back to fused
    t.alltoallv(x, np.full((4, 4), 4))
    assert t.stats()["alltoallv/fused"]["calls"] == 1
    monkeypatch.setenv("RNR_ALGO", "cuda_ring")
    t.alltoallv(x, np.full((4, 4), 4))
    assert t.stats()["alltoallv/cuda_ring"]["calls"] == 1
    monkeypatch.setenv("RNR_ALGO", "bogus")
    with pytest.raises(ValueError, match="not an algorithm"):
        t.alltoallv(x, np.full((4, 4), 4))


def test_cuda_ring_arms_follow_the_tile_policy(monkeypatch):
    from rocnrdma_tpu_torch.transport import api
    monkeypatch.setattr(api, "CUDA_RING_TILE_BYTES", 4096)
    t = Transport(rank_mesh(4, "cpu"))
    x = t.shard(np.random.default_rng(3).standard_normal((4, 4 * 1536)).astype(np.float32))
    # reduce-scatter: a 1536-element chunk (12 rows) in two 6-row tiles;
    # allgather: the rank's 6144 elements (48 rows) in six 8-row tiles
    assert api.cuda_ring_tile_rows(x, "reduce_scatter") == 6
    assert api.cuda_ring_tile_rows(x, "allgather") == 8
    assert torch.equal(t.reduce_scatter(x, "cuda_ring"), t.reduce_scatter(x, "ring"))
    assert torch.equal(t.allgather(x, "cuda_ring"), t.allgather(x, "fused"))


@pytest.mark.parametrize("n", range(1, 10))
def test_alltoall_schedules_equal_reference(n):
    for r in range(n):
        for s in range(1, max(n, 2)):
            assert PS.a2a_send_chunk(n, s, r) == RS.a2a_send_chunk(n, s, r)
            assert PS.a2a_recv_slot(n, s, r) == RS.a2a_recv_slot(n, s, r)
    assert PS.bruck_phases(n) == RS.bruck_phases(n)
    for k in PS.bruck_phases(n):
        assert PS.bruck_mask(n, k) == RS.bruck_mask(n, k)
    x = np.random.default_rng(n).standard_normal((n, n * 3)).astype(np.float32)
    np.testing.assert_array_equal(PS.sim_alltoall(x), RS.sim_alltoall(x))
    np.testing.assert_array_equal(PS.sim_bruck_alltoall(x), RS.sim_bruck_alltoall(x))


@pytest.mark.parametrize("bench,ref_bench,collective", [
    (bench_reducescatter, ref_bench_reducescatter, "reducescatter"),
    (bench_allgather, ref_bench_allgather, "allgather"),
    (bench_alltoall, ref_bench_alltoall, "alltoall"),
])
def test_bench_clis_match_reference_record_keys(devices, tmp_path, bench, ref_bench,
                                                collective):
    ref_out, out = tmp_path / "ref.jsonl", tmp_path / "port.jsonl"
    common = ["--ranks", "4", "--sizes", "16K", "--repeats", "2", "--iters", "2"]
    assert ref_bench.main(common + ["--fake-devices", "4", "--out", str(ref_out)]) == 0
    assert bench.main(common + ["--platform", "cpu", "--fake-devices", "4",
                                "--out", str(out)]) == 0
    keys = metrics.load_completed(out)
    assert keys == RM.load_completed(ref_out)
    assert {k[2] for k in keys} == {"ring", "fused"} and {k[1] for k in keys} == {collective}


def test_runner_checks_data_movement_exactly():
    x = np.arange(2 * 2 * 3, dtype=np.float32).reshape(2, 2, 3)
    want = torch.from_numpy(runner._expected("alltoall", x, "sum"))
    got = torch.from_numpy(x.transpose(1, 0, 2).copy())
    runner._check(got, want, 0.0, 0.0, "alltoall")
    got[1, 0, 2] += 1e-6
    with pytest.raises(AssertionError, match="1 element"):
        runner._check(got, want, 0.0, 0.0, "alltoall")
    # reduce-scatter: row r is shard r, with the rounding bound laid out alike
    y = np.random.default_rng(0).standard_normal((4, 8)).astype(np.float32)
    assert runner._expected("reducescatter", y, "sum").shape == (4, 2)
    assert runner._rounding_bound(y, "sum", "bfloat16", "reducescatter").shape == (4, 2)
    assert runner._rounding_bound(y, "sum", "bfloat16", "allgather") is None
    assert runner._shape_and_bytes("allgather", 4, 16384, "float32") == ((4, 1024), 16384)
    assert runner._shape_and_bytes("alltoall", 3, 4096, "float32") == ((3, 3, 341), 4092)
