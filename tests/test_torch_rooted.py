"""The port's rooted verbs (broadcast, reduce, gather, scatter: ``binomial``
and ``fused``), sendrecv and their CLIs against the JAX reference, on the
CPU.

- The binomial schedule helpers and simulators are copies: pinned equal to
  the reference's.
- n in {8, 6} (6 pads the gather/scatter slots to 8) and root in {0, 3}.
- Broadcast, gather, scatter and sendrecv only move data: bitwise.
- Binomial reduce keeps the reference's tree and fold order: bitwise in
  fp32 for sum, max, min and prod; ``avg`` to rtol = atol = 1e-6 (the port
  multiplies by 1/n where the reference divides). Fused reduce sums in
  torch's order: rtol = atol = 1e-5 for sum and avg, bitwise for max.
- bfloat16 binomial reduce: bitwise (each fold rounds to bf16 in both).
"""

import json

import numpy as np
import pytest
import torch

from rocnrdma_tpu import metrics as RM
from rocnrdma_tpu import runtime as rt
from rocnrdma_tpu.bench import runner as ref_runner
from rocnrdma_tpu.collectives import schedule as RS
from rocnrdma_tpu.transport import Transport as RefTransport
from rocnrdma_tpu_torch import metrics
from rocnrdma_tpu_torch.bench import runner
from rocnrdma_tpu_torch.collectives import schedule as PS
from rocnrdma_tpu_torch.runtime import rank_mesh
from rocnrdma_tpu_torch.transport import Transport


def _bits(a) -> np.ndarray:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return np.ascontiguousarray(a).view(np.uint32)


def _pair(n: int):
    return RefTransport(rt.rank_mesh(n)), Transport(rank_mesh(n, "cpu"))


def _x(n: int, cols: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed + n).standard_normal((n, cols)).astype(np.float32)


@pytest.mark.parametrize("n", range(1, 10))
def test_binomial_helpers_equal_reference(n):
    assert PS.binomial_masks(n) == RS.binomial_masks(n)
    assert PS.pow2_pad(n) == RS.pow2_pad(n)
    x = _x(n, 6 * n)
    for root in range(n):
        for m in PS.binomial_masks(n):
            assert PS.bcast_pairs(n, m, root) == RS.bcast_pairs(n, m, root)
            assert PS.gather_pairs(n, m, root) == RS.gather_pairs(n, m, root)
        for sim in ("sim_binomial_broadcast", "sim_binomial_reduce",
                    "sim_binomial_scatter"):
            np.testing.assert_array_equal(getattr(PS, sim)(x, root),
                                          getattr(RS, sim)(x, root))
        np.testing.assert_array_equal(PS.sim_binomial_gather(x[:, :5], root),
                                      RS.sim_binomial_gather(x[:, :5], root))


@pytest.mark.parametrize("root", [0, 3])
@pytest.mark.parametrize("n", [8, 6])
@pytest.mark.parametrize("algo", ["binomial", "fused"])
@pytest.mark.parametrize("verb", ["broadcast", "gather", "scatter"])
def test_data_moving_rooted_verbs_bitwise_equal_reference(devices, verb, algo, n, root):
    x = _x(n, 7 * n)
    r, t = _pair(n)
    ref = getattr(r, verb)(r.shard(x), algo, root=root)
    got = getattr(t, verb)(t.shard(x), algo, root=root)
    assert got.shape == np.asarray(ref).shape
    np.testing.assert_array_equal(_bits(got), _bits(ref))


@pytest.mark.parametrize("op", ["sum", "max", "min", "prod", "avg"])
@pytest.mark.parametrize("root", [0, 3])
@pytest.mark.parametrize("n", [8, 6])
def test_binomial_reduce_equals_reference(devices, n, root, op):
    x = _x(n, 1001, seed=5)
    r, t = _pair(n)
    ref = np.asarray(r.reduce(r.shard(x), "binomial", root=root, op=op))
    got = t.reduce(t.shard(x), "binomial", root=root, op=op)
    if op == "avg":
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(_bits(got), _bits(ref))
    assert not got[[q for q in range(n) if q != root]].any()


@pytest.mark.parametrize("n", [8, 6])
def test_binomial_reduce_bf16_bitwise_equals_reference(devices, n):
    # each fold rounds to bf16 in both packages: the stated tolerance is zero
    import jax.numpy as jnp
    x = _x(n, 1001, seed=7)
    r, t = _pair(n)
    ref = r.reduce(r.shard(jnp.asarray(x, jnp.bfloat16)), "binomial", root=3)
    got = t.reduce(t.shard(x, torch.bfloat16), "binomial", root=3)
    np.testing.assert_array_equal(_bits(got.float()), _bits(np.asarray(ref, np.float32)))


@pytest.mark.parametrize("op", ["sum", "max", "avg"])
@pytest.mark.parametrize("n", [8, 6])
def test_fused_reduce_matches_reference(devices, n, op):
    x = _x(n, 1001, seed=6)
    r, t = _pair(n)
    ref = np.asarray(r.reduce(r.shard(x), "fused", root=3, op=op))
    got = t.reduce(t.shard(x), "fused", root=3, op=op).numpy()
    if op == "max":
        np.testing.assert_array_equal(_bits(got), _bits(ref))
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shift", [1, 3, -2, 9])
@pytest.mark.parametrize("n", [8, 6])
def test_sendrecv_bitwise_equals_reference(devices, n, shift):
    x = _x(n, 333)
    r, t = _pair(n)
    ref = r.sendrecv(r.shard(x), shift=shift)
    got = t.sendrecv(t.shard(x), shift=shift)
    np.testing.assert_array_equal(_bits(got), _bits(ref))
    np.testing.assert_array_equal(got.numpy(), PS.sim_sendrecv(x, shift))


def test_rooted_refusals_match_reference(devices):
    r, t = _pair(4)
    x = np.ones((4, 8), np.float32)
    for call in (lambda tr: tr.broadcast(tr.shard(x), root=4),
                 lambda tr: tr.reduce(tr.shard(x), "binomial", root=-1),
                 lambda tr: tr.sendrecv(tr.shard(x), "binomial"),
                 lambda tr: tr.scatter(tr.shard(x[:, :7]), "binomial")):
        with pytest.raises(ValueError) as ref_err:
            call(r)
        with pytest.raises(ValueError) as got_err:
            call(t)
        assert str(got_err.value).split(";")[0] == str(ref_err.value).split(";")[0]


def test_auto_resolves_to_fused_and_counts():
    t = Transport(rank_mesh(6, "cpu"))
    x = t.shard(_x(6, 12))
    for verb in ("broadcast", "reduce", "gather", "scatter", "sendrecv"):
        getattr(t, verb)(x)
    assert set(t.stats()) == {f"{v}/fused" for v in
                              ("broadcast", "reduce", "gather", "scatter", "sendrecv")}


@pytest.mark.parametrize("collective", ["broadcast", "reduce", "gather",
                                        "scatter", "sendrecv"])
def test_rooted_clis_match_reference_record_keys(devices, tmp_path, collective):
    from importlib import import_module
    ref_cli = import_module(f"rocnrdma_tpu.bench.bench_{collective}")
    cli = import_module(f"rocnrdma_tpu_torch.bench.bench_{collective}")
    ref_out, out = tmp_path / "ref.jsonl", tmp_path / "port.jsonl"
    knob = ["--shift", "3"] if collective == "sendrecv" else ["--root", "3"]
    common = ["--ranks", "6", "--sizes", "4K", "--repeats", "2", "--iters", "1"] + knob
    if collective == "reduce":
        common += ["--redop", "avg"]
    assert ref_cli.main(common + ["--out", str(ref_out)]) == 0
    assert cli.main(common + ["--platform", "cpu", "--fake-devices", "6",
                              "--out", str(out)]) == 0
    keys = metrics.load_completed(out)
    assert keys == RM.load_completed(ref_out) and len(keys) == (
        1 if collective == "sendrecv" else 2)
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert all(r["extra"]["checked"] for r in rows)


@pytest.mark.parametrize("collective", ["broadcast", "reduce", "gather",
                                        "scatter", "sendrecv"])
def test_runner_expected_equals_reference(collective):
    x = _x(6, 24, seed=9)
    kw = {"shift": 3} if collective == "sendrecv" else {"root": 3}
    op = "avg" if collective == "reduce" else "sum"
    want = ref_runner._expected(collective, x, None, op=op, **kw)
    got = runner._expected(collective, x, op, kw.get("root", 0), kw.get("shift", 1))
    np.testing.assert_array_equal(np.broadcast_to(got, want.shape), want)


def test_new_clis_raise_without_a_card(monkeypatch):
    # no GPU and no --platform cpu: every CLI of this slice raises
    from importlib import import_module
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for collective in ("broadcast", "reduce", "gather", "scatter", "sendrecv"):
        cli = import_module(f"rocnrdma_tpu_torch.bench.bench_{collective}")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["--fake-devices", "4", "--sizes", "4K"])
    from rocnrdma_tpu_torch.bench import bench_allreduce, bench_small_calls
    for preset in ("tree64", "multislice"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bench_allreduce.main(["--preset", preset, "--fake-devices", "8"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_small_calls.main(["--label", "x"])


def test_tree64_cli_self_checks_on_cpu(tmp_path):
    from rocnrdma_tpu_torch.bench import bench_allreduce
    out = tmp_path / "tree64.jsonl"
    assert bench_allreduce.main(
        ["--preset", "tree64", "--platform", "cpu", "--fake-devices", "8",
         "--max-bytes", "64K", "--algos", "tree,khd,dtree,ptree,ktree,fused",
         "--repeats", "1", "--iters", "1", "--out", str(out)]) == 0
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert {(r["algo"], r["n_ranks"], r["size_bytes"]) for r in rows} == {
        (a, 8, 64 << 10) for a in ("tree", "khd", "dtree", "ptree", "ktree", "fused")}
    assert all(r["extra"]["checked"] and r["extra"]["preset"] == "tree64" for r in rows)
