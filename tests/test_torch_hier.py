"""The port's 2-D ``('slice', 'intra')`` mesh, its hierarchical allreduce
and alltoall and the khd2d verbs against the JAX reference, on the CPU,
and the Transport's algorithm table against the reference's.

- The mesh is 2 x 4 on the 8 fake CPU devices; the port's input is
  ``(slices, per_slice, ...)`` rank-major, flat rank ``s * 4 + i``.
- hierarchical allreduce (intra ring and khd) and khd2d: bitwise in fp32
  for sum, max, min and prod; ``avg`` to rtol = atol = 1e-6 (the port
  multiplies by 1/n where the reference divides). ``cross_dtype=bfloat16``
  rounds the cross-slice partials: rtol = atol = 1e-6 against the
  reference, whose rounding it shares (bf16 round-to-nearest-even both).
- bfloat16 buffers (hierarchical, khd2d): bitwise, each fold rounding to
  bf16 in both packages.
- The data-moving verbs (hierarchical alltoall, khd2d allgather, the fused
  2-D verbs that only copy) are bitwise; fused reductions rtol = atol =
  1e-5.
"""

import json

import numpy as np
import pytest
import torch

from rocnrdma_tpu import metrics as RM
from rocnrdma_tpu import runtime as rt
from rocnrdma_tpu.bench import bench_allreduce as ref_bench_allreduce
from rocnrdma_tpu.bench import presets as ref_presets
from rocnrdma_tpu.transport import Transport as RefTransport
from rocnrdma_tpu.transport import api as ref_api
from rocnrdma_tpu_torch import metrics
from rocnrdma_tpu_torch.bench import bench_allreduce, bench_sendrecv, presets
from rocnrdma_tpu_torch.runtime import INTRA_AXIS, SLICE_AXIS, slice_mesh
from rocnrdma_tpu_torch.transport import Transport, api

OPS = ("sum", "max", "min", "prod", "avg")


def _bits(a) -> np.ndarray:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return np.ascontiguousarray(a).view(np.uint32)


def _hold(got: torch.Tensor, ref, exact: bool = True, tol: float = 1e-6) -> None:
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    if exact:
        np.testing.assert_array_equal(_bits(got), _bits(ref))
    else:
        np.testing.assert_allclose(got.numpy(), ref, rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def pair():
    return RefTransport(rt.slice_mesh(2, 4)), Transport(slice_mesh(2, 4, "cpu"))


def _x(*shape, seed=0) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_slice_mesh_layout(monkeypatch):
    mesh = slice_mesh(2, 4, "cpu")
    assert (mesh.axis_names, mesh.shape, mesh.n_ranks) == \
        ((SLICE_AXIS, INTRA_AXIS), (2, 4), 8)
    assert mesh.device == torch.device("cpu")
    t = Transport(mesh)
    assert t.is_2d and t.n_ranks == 8
    with pytest.raises(ValueError, match="mesh shape"):
        t.shard(np.zeros((8, 3), np.float32))
    with pytest.raises(ValueError, match="rank-major"):
        t.allreduce(torch.zeros(8, 3))
    with pytest.raises(ValueError, match="1-D rank mesh"):
        t.alltoallv(torch.zeros(2, 4, 8, 1), np.zeros((8, 8), int))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        slice_mesh(2, 4)


def test_schedule_table_and_supports_equal_reference():
    # every (verb, algo) pair of the reference, pallas_ring named cuda_ring
    rename = {"pallas_ring": "cuda_ring"}
    assert {v: sorted(rename.get(a, a) for a in arms)
            for v, arms in ref_api.SCHEDULES.items()} == \
        {v: sorted(arms) for v, arms in api.SCHEDULES.items()}
    assert api.ALGOS == tuple(rename.get(a, a) for a in ref_api.ALGOS)
    for verb in ref_api.SCHEDULES:
        for algo in ref_api.ALGOS:
            for is_2d in (False, True):
                assert api.supports(verb, rename.get(algo, algo), is_2d) == \
                    ref_api.supports(verb, algo, is_2d), (verb, algo, is_2d)


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("intra_algo", ["ring", "khd"])
def test_hierarchical_allreduce_equals_reference(devices, pair, intra_algo, op):
    r, t = pair
    x = _x(2, 4, 1001, seed=1)
    ref = r.allreduce(r.shard(x), "hierarchical", op=op, intra_algo=intra_algo)
    got = t.allreduce(t.shard(x), "hierarchical", op=op, intra_algo=intra_algo)
    _hold(got, ref, op != "avg")


@pytest.mark.parametrize("op", ["sum", "avg"])
def test_hierarchical_cross_dtype_equals_reference(devices, pair, op):
    r, t = pair
    x = _x(2, 4, 1001, seed=2)
    ref = r.allreduce(r.shard(x), "hierarchical", op=op, cross_dtype="bfloat16")
    got = t.allreduce(t.shard(x), "hierarchical", op=op, cross_dtype="bfloat16")
    _hold(got, ref, exact=False)
    # the bf16 cross phase rounds: it is not the fp32 result
    fp32 = t.allreduce(t.shard(x), "hierarchical", op=op)
    assert not torch.equal(got, fp32)
    np.testing.assert_allclose(got.numpy(), fp32.numpy(), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("algo,kw", [("hierarchical", {}), ("khd2d", {}),
                                     ("hierarchical", {"intra_algo": "khd"})])
def test_2d_allreduce_bf16_bitwise_equals_reference(devices, pair, algo, kw):
    # bf16 buffers: every fold rounds to bf16 in both packages, so the
    # stated tolerance is zero
    import jax.numpy as jnp
    r, t = pair
    x = _x(2, 4, 1001, seed=8)
    ref = r.allreduce(r.shard(jnp.asarray(x, jnp.bfloat16)), algo, **kw)
    got = t.allreduce(t.shard(x, torch.bfloat16), algo, **kw)
    assert got.dtype == torch.bfloat16
    _hold(got.float(), np.asarray(ref, np.float32))


@pytest.mark.parametrize("op", OPS)
def test_khd2d_allreduce_equals_reference(devices, pair, op):
    r, t = pair
    x = _x(2, 4, 1001, seed=3)
    _hold(t.allreduce(t.shard(x), "khd2d", op=op),
          r.allreduce(r.shard(x), "khd2d", op=op), op != "avg")


@pytest.mark.parametrize("verb,algo,op", [
    ("reduce_scatter", "khd2d", "sum"), ("reduce_scatter", "khd2d", "max"),
    ("allgather", "khd2d", None), ("allgather", "fused", None),
    ("reduce_scatter", "fused", "sum")])
def test_2d_reduce_scatter_and_allgather_equal_reference(devices, pair, verb, algo, op):
    r, t = pair
    x = _x(2, 4, 8 * 37, seed=4)
    kw = {} if op is None else {"op": op}
    ref = getattr(r, verb)(r.shard(x), algo, **kw)
    got = getattr(t, verb)(t.shard(x), algo, **kw)
    _hold(got, ref, exact=not (algo == "fused" and op == "sum"), tol=1e-5)


@pytest.mark.parametrize("algo", ["hierarchical", "fused", "auto"])
def test_2d_alltoall_bitwise_equals_reference(devices, pair, algo):
    r, t = pair
    x = _x(2, 4, 8, 13, seed=5)
    _hold(t.alltoall(t.shard(x), algo), r.alltoall(r.shard(x), algo))


@pytest.mark.parametrize("verb", ["broadcast", "gather", "scatter", "reduce"])
def test_2d_fused_rooted_verbs_equal_reference(devices, pair, verb):
    r, t = pair
    x = _x(2, 4, 8 * 9, seed=6)
    ref = getattr(r, verb)(r.shard(x), root=5)
    got = getattr(t, verb)(t.shard(x), root=5)
    _hold(got, ref, exact=verb != "reduce", tol=1e-5)


def test_2d_auto_policy_and_refusals(pair):
    _, t = pair
    x = t.shard(_x(2, 4, 64, seed=7))
    assert t._resolve("auto", "allreduce") == "hierarchical"
    assert t._resolve("auto", "alltoall") == "hierarchical"
    assert t._resolve("auto", "reduce_scatter") == "fused"
    for algo in ("ring", "khd", "tree", "binomial"):
        with pytest.raises(ValueError, match="on a 2-D mesh"):
            t.allreduce(x, algo)
    with pytest.raises(ValueError, match="has no 'fused' schedule on a 2-D mesh"):
        t.sendrecv(x)
    with pytest.raises(ValueError, match="custom programs run on a 1-D"):
        t.program_fn(None)
    # cross_dtype forces hierarchical under auto; it refuses other arms
    assert torch.equal(t.allreduce(x, cross_dtype="bfloat16"),
                       t.allreduce(x, "hierarchical", cross_dtype="bfloat16"))


def test_cross_dtype_refusals_match_reference(devices, pair):
    r, t = pair
    x = np.ones((2, 4, 16), np.float32)
    for kw in ({"algo": "fused", "cross_dtype": "bfloat16"},
               {"algo": "hierarchical", "cross_dtype": "int32"},
               {"algo": "hierarchical", "cross_dtype": "bfloat16", "op": "max"},
               {"algo": "khd2d", "intra_algo": "khd"},
               {"algo": "hierarchical", "intra_algo": "tree"}):
        with pytest.raises(ValueError) as ref_err:
            r.allreduce(r.shard(x), **kw)
        with pytest.raises(ValueError) as got_err:
            t.allreduce(t.shard(x), **kw)
        assert str(got_err.value) == str(ref_err.value)


def test_presets_scale_as_the_reference():
    for name in ("tree64", "multislice"):
        ref, pre = ref_presets.get_preset(name), presets.get_preset(name)
        assert (pre.n_ranks, pre.mesh2d, pre.sizes, pre.dtypes, pre.algos) == \
            (ref.n_ranks, ref.mesh2d, ref.sizes, ref.dtypes, ref.algos)
        for n_dev, cap in ((8, 4 << 30), (8, 64 << 20), (6, 1 << 20), (1, 1 << 30)):
            a, b = pre.scaled_to(n_dev, cap), ref.scaled_to(n_dev, cap)
            assert (a.n_ranks, a.mesh2d, a.sizes) == (b.n_ranks, b.mesh2d, b.sizes)
    assert presets.get_preset("tree64").scaled_to(8, 4 << 30).n_ranks == 8
    assert presets.get_preset("multislice").scaled_to(8, 4 << 30).mesh2d == (2, 4)


def test_multislice_cli_matches_reference_record_keys(devices, tmp_path):
    ref_out, out = tmp_path / "ref.jsonl", tmp_path / "port.jsonl"
    common = ["--preset", "multislice", "--sizes", "64K", "--algos",
              "hierarchical,khd2d,fused", "--repeats", "2", "--iters", "1"]
    assert ref_bench_allreduce.main(common + ["--out", str(ref_out)]) == 0
    argv = common + ["--platform", "cpu", "--fake-devices", "8", "--out", str(out)]
    assert bench_allreduce.main(argv) == 0
    keys = metrics.load_completed(out)
    assert keys == RM.load_completed(ref_out) and len(keys) == 3
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert all(r["extra"]["mesh2d"] == [2, 4] and r["extra"]["checked"] for r in rows)
    # the hierarchical allreduce's knobs, checked against numpy
    assert bench_allreduce.main(
        ["--mesh2d", "2x4", "--sizes", "64K", "--algos", "hierarchical",
         "--cross-dtype", "bfloat16", "--intra-algo", "khd", "--platform", "cpu",
         "--fake-devices", "8", "--repeats", "1", "--iters", "1", "--out", str(out)]) == 0
    last = json.loads(out.read_text().splitlines()[-1])
    assert (last["extra"]["cross_dtype"], last["extra"]["intra_algo"]) == ("bfloat16", "khd")
    with pytest.raises(ValueError, match="2-D mesh"):
        bench_sendrecv.main(["--mesh2d", "2x4", "--platform", "cpu",
                             "--fake-devices", "8", "--sizes", "4K"])
