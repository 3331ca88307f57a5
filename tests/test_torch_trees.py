"""The port's tree-family allreduce schedules (``tree``, ``khd``,
``dtree``, ``ptree``, ``ktree``) and khd's reduce-scatter and allgather
against the JAX reference, on the CPU.

- The schedule tables and numpy simulators are copies: pinned equal to the
  reference's for n = 1..9.
- Every arm keeps the reference's chunk indices and fold order (including
  the identity folds of ranks that receive nothing), so fp32 results for
  sum, max, min and prod are bitwise equal to the reference's Transport on
  the 8 fake CPU devices. ``avg`` is held to rtol = atol = 1e-6: the port
  multiplies by 1/n where the reference divides (the ring arms' rule).
- bfloat16: the stated tolerance is zero. Each fold rounds to bf16 in
  both packages (XLA's CPU backend rounds every add here), so the sums
  are bitwise equal too.
- khd runs with explicit digits, since the reference's default radix comes
  from its cost model; the port's default is ``khd_digits(n)``.
"""

import numpy as np
import pytest
import torch

from rocnrdma_tpu import runtime as rt
from rocnrdma_tpu.collectives import ktree as RK
from rocnrdma_tpu.collectives import ptree as RP
from rocnrdma_tpu.collectives import schedule as RS
from rocnrdma_tpu.transport import Transport as RefTransport
from rocnrdma_tpu_torch.collectives import ktree as PK
from rocnrdma_tpu_torch.collectives import ptree as PP
from rocnrdma_tpu_torch.collectives import schedule as PS
from rocnrdma_tpu_torch.runtime import rank_mesh
from rocnrdma_tpu_torch.transport import Transport

OPS = ("sum", "max", "min", "prod", "avg")


def _bits(a) -> np.ndarray:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return np.ascontiguousarray(a).view(np.uint32)


def _hold(got: torch.Tensor, ref, op: str = "sum") -> None:
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    if op == "avg":
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(_bits(got), _bits(ref))


@pytest.mark.parametrize("n", range(1, 10))
def test_schedule_tables_equal_reference(n):
    x = np.random.default_rng(n).standard_normal((n, n * 6)).astype(np.float32)
    if n & (n - 1) == 0:
        assert PS.hd_masks(n) == RS.hd_masks(n)
        for r in range(n):
            for s in range(len(PS.hd_masks(n)) + 1):
                assert PS.hd_segment(n, r, s) == RS.hd_segment(n, r, s)
        np.testing.assert_array_equal(PS.sim_hd_allreduce(x), RS.sim_hd_allreduce(x))
    else:
        with pytest.raises(ValueError, match="power-of-two"):
            PS.hd_masks(n)
    for radix in (2, 3, 4, 8):
        digits = PS.khd_digits(n, radix)
        assert digits == RS.khd_digits(n, radix)
        assert PS.khd_strides(digits) == RS.khd_strides(digits)
        for t in range(len(digits)):
            for o in range(digits[t]):
                assert PS.khd_perm(n, digits, t, o) == RS.khd_perm(n, digits, t, o)
        np.testing.assert_array_equal(PS.sim_khd_allreduce(x, digits),
                                      RS.sim_khd_allreduce(x, digits))
    assert PS.dbtree_parents(n) == RS.dbtree_parents(n)
    for parents in PS.dbtree_parents(n):
        assert PS.dbtree_depths(parents) == RS.dbtree_depths(parents)
        assert PS.dbtree_steps(parents) == RS.dbtree_steps(parents)
        assert PS.dbtree_up_levels(parents) == RS.dbtree_up_levels(parents)
        for chunks in (1, 2, 5):
            assert PS.ptree_ticks(parents, chunks) == RS.ptree_ticks(parents, chunks)
    np.testing.assert_array_equal(PS.sim_dbtree_allreduce(x), RS.sim_dbtree_allreduce(x))
    np.testing.assert_array_equal(PS.sim_ptree_allreduce(x, 3),
                                  RS.sim_ptree_allreduce(x, 3))
    for arity in (2, 3, 8):
        assert PK.kary_levels(n, arity) == RK.kary_levels(n, arity)
        for a, b in zip(PK.sim_kary_allreduce(list(x), arity),
                        RK.sim_kary_allreduce(list(x), arity)):
            np.testing.assert_array_equal(a, b)
    assert PS.hierarchical_phases() == RS.hierarchical_phases()
    np.testing.assert_array_equal(PS.sim_sendrecv(x, 3), RS.sim_sendrecv(x, 3))


def test_constants_equal_reference():
    assert PK.KTREE_ARITY == RK.KTREE_ARITY
    assert (PP.PTREE_CHUNKS, PP.PTREE_MIN_CHUNK_ELEMS, PP.PTREE_MAX_CHUNKS) == \
        (RP.PTREE_CHUNKS, RP.PTREE_MIN_CHUNK_ELEMS, RP.PTREE_MAX_CHUNKS)
    for elems in (1, 4096, 8191, 8192, 1 << 20, 1 << 28):
        assert PP.ptree_auto_chunks(elems) == RP.ptree_auto_chunks(elems)


CASES = [("tree", 8, {}), ("khd", 8, {"digits": (4, 2)}),
         ("khd", 6, {"digits": (3, 2)}), ("dtree", 8, {}), ("dtree", 6, {}),
         ("ptree", 8, {"chunks": 3}), ("ptree", 6, {}), ("ktree", 8, {}),
         ("ktree", 6, {})]


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("algo,n,kw", CASES,
                         ids=[f"{a}-{n}-{kw.get('digits', kw.get('chunks', ''))}"
                              for a, n, kw in CASES])
def test_tree_arms_equal_reference(devices, algo, n, kw, op):
    x = np.random.default_rng(n).standard_normal((n, 1001)).astype(np.float32)
    r = RefTransport(rt.rank_mesh(n))
    t = Transport(rank_mesh(n, "cpu"))
    ref = r.allreduce(r.shard(x), algo, op=op, **kw)
    _hold(t.allreduce(t.shard(x), algo, op=op, **kw), ref, op)


@pytest.mark.parametrize("verb,algo,kw", [
    ("allreduce", "tree", {}), ("allreduce", "khd", {"digits": (4, 2)}),
    ("allreduce", "dtree", {}), ("allreduce", "ptree", {"chunks": 3}),
    ("allreduce", "ktree", {}), ("reduce_scatter", "khd", {"digits": (2, 4)})])
def test_tree_arms_bf16_bitwise_equal_reference(devices, verb, algo, kw):
    import jax.numpy as jnp
    x = np.random.default_rng(11).standard_normal((8, 8 * 125)).astype(np.float32)
    r = RefTransport(rt.rank_mesh(8))
    t = Transport(rank_mesh(8, "cpu"))
    ref = getattr(r, verb)(r.shard(jnp.asarray(x, jnp.bfloat16)), algo, **kw)
    got = getattr(t, verb)(t.shard(x, torch.bfloat16), algo, **kw)
    assert got.dtype == torch.bfloat16
    _hold(got.float(), np.asarray(ref, np.float32))


@pytest.mark.parametrize("n,digits", [(8, (4, 2)), (6, (3, 2))])
@pytest.mark.parametrize("op", ["sum", "max", "avg"])
def test_khd_reduce_scatter_equals_reference(devices, n, digits, op):
    x = np.random.default_rng(1).standard_normal((n, n * 37)).astype(np.float32)
    r = RefTransport(rt.rank_mesh(n))
    t = Transport(rank_mesh(n, "cpu"))
    ref = r.reduce_scatter(r.shard(x), "khd", op=op, digits=digits)
    _hold(t.reduce_scatter(t.shard(x), "khd", op=op, digits=digits), ref, op)


@pytest.mark.parametrize("n,digits", [(8, (4, 2)), (6, (3, 2)), (8, (8,))])
def test_khd_allgather_equals_reference(devices, n, digits):
    x = np.random.default_rng(2).standard_normal((n, 41)).astype(np.float32)
    r = RefTransport(rt.rank_mesh(n))
    t = Transport(rank_mesh(n, "cpu"))
    ref = r.allgather(r.shard(x), "khd", digits=digits)
    _hold(t.allgather(t.shard(x), "khd", digits=digits), ref)


def test_khd_default_digits_and_max_radix():
    # without digits the port runs khd_digits(n); max_radix caps it
    t = Transport(rank_mesh(8, "cpu"))
    x = t.shard(np.random.default_rng(3).standard_normal((8, 300)).astype(np.float32))
    want = t.allreduce(x, "khd", digits=PS.khd_digits(8))
    assert PS.khd_digits(8) == (8,)
    assert torch.equal(t.allreduce(x, "khd"), want)
    assert torch.equal(t.allreduce(x, max_radix=2),
                       t.allreduce(x, "khd", digits=(2, 2, 2)))
    assert t.stats()["allreduce/khd"]["calls"] == 4  # max_radix forced khd


def test_tree_needs_a_power_of_two():
    t = Transport(rank_mesh(6, "cpu"))
    with pytest.raises(ValueError, match="power-of-two"):
        t.allreduce(t.shard(np.ones((6, 8), np.float32)), "tree")


@pytest.mark.parametrize("algo", ["dtree", "ptree", "ktree"])
def test_arms_fold_the_identity_where_the_reference_does(devices, algo):
    # a rank that receives nothing in a substep folds the op's identity,
    # which turns a sum's -0.0 into +0.0: the signs of zeros match too
    n = 6
    x = np.where(np.random.default_rng(4).random((n, 1001)) < 0.5, -0.0, 0.0)
    x = x.astype(np.float32)
    r = RefTransport(rt.rank_mesh(n))
    t = Transport(rank_mesh(n, "cpu"))
    ref = r.allreduce(r.shard(x), algo)
    _hold(t.allreduce(t.shard(x), algo), ref)
