"""The port's schedule IR (``collectives/program.py``), grouped launch
(``transport/group.py``) and Transport knobs (``acc``, ``premul``,
``donate``, ``chunks``, ``digits``/``max_radix``, ``root_hint``) against
the JAX reference, on the CPU.

- Programs: validation errors and the numpy oracle equal the reference's;
  ``Transport.program_fn`` is bitwise equal to the reference's for the
  stock builders and for a program whose ranks send and receive the same
  chunk in one step.
- Groups: results equal the direct verbs' bit for bit, run at exit in
  queue order, one cached callable per signature; ``.result()`` before
  exit raises.
- Knobs: every refusal carries the reference's message (for a bad dtype
  the part before the underlying library's own text). ``premul`` and
  ``acc`` results on the ``ring`` arm are bitwise equal to the
  reference's; ``donate=True`` returns the input, holding the same bits as
  the call without it.
"""

import numpy as np
import pytest
import torch

from rocnrdma_tpu import runtime as rt
from rocnrdma_tpu.collectives import program as RP
from rocnrdma_tpu.transport import Transport as RefTransport
from rocnrdma_tpu_torch.collectives import program as PP
from rocnrdma_tpu_torch.runtime import rank_mesh, slice_mesh
from rocnrdma_tpu_torch.transport import Transport
from rocnrdma_tpu_torch.transport.group import GroupError


def _bits(a) -> np.ndarray:
    a = a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)
    return np.ascontiguousarray(a).view(np.uint32)


def _x(n: int, cols: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((n, cols)).astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    return RefTransport(rt.rank_mesh(8)), Transport(rank_mesh(8, "cpu"))


def _swap_program(mod, n: int):
    """Ranks r and r^1 swap chunk 0 into chunk 0 (send and receive the same
    chunk in one step), then fold chunk 1 around a ring."""
    zeros = tuple(0 for _ in range(n))
    ones = tuple(1 for _ in range(n))
    return mod.Program("swap", n, 2, (
        mod.Step(tuple((r, r ^ 1) for r in range(n)), zeros, zeros, mod.WRITE),
        mod.Step(tuple((r, (r + 1) % n) for r in range(n)), ones, ones, mod.REDUCE)),
        op="max")


def _bad_programs(mod):
    return [
        mod.Program("b", 2, 2, (mod.Step(((0, 1),), (0, 5), (0, 0)),)),
        mod.Program("d", 3, 1, (mod.Step(((0, 1), (0, 2)), (0, 0, 0), (0, 0, 0)),)),
        mod.Program("d", 3, 1, (mod.Step(((0, 2), (1, 2)), (0, 0, 0), (0, 0, 0)),)),
        mod.Program("c", 2, 1, (mod.Step(((0, 1),), (0, 0), (0, 0), "xor"),)),
        mod.Program("s", 3, 1, (mod.Step(((0, 1),), (0, 0), (0, 0, 0)),)),
        mod.Program("r", 2, 1, (mod.Step(((0, 2),), (0, 0), (0, 0)),)),
        mod.prog_ring_allreduce(4, op="avg"),
        mod.Program("z", 0, 1, ()),
    ]


def test_program_validation_equals_reference():
    for ref_p, p in zip(_bad_programs(RP), _bad_programs(PP)):
        with pytest.raises(RP.ProgramError) as ref_err:
            RP.validate(ref_p)
        with pytest.raises(PP.ProgramError) as err:
            PP.validate(p)
        assert str(err.value) == str(ref_err.value)


@pytest.mark.parametrize("n", [2, 3, 6, 8])
def test_program_builders_and_sim_equal_reference(n):
    x = _x(n, 5 * n + 3, seed=n)
    pairs = [(PP.prog_ring_allreduce(n), RP.prog_ring_allreduce(n)),
             (PP.prog_ring_allreduce(n, "max"), RP.prog_ring_allreduce(n, "max")),
             (PP.prog_ring_allgather(n), RP.prog_ring_allgather(n)),
             (PP.prog_binomial_broadcast(n, n - 1), RP.prog_binomial_broadcast(n, n - 1)),
             (_swap_program(PP, n & ~1 or 2), _swap_program(RP, n & ~1 or 2))]
    for p, ref_p in pairs:
        assert (p.name, p.n_ranks, p.n_chunks, p.op) == \
            (ref_p.name, ref_p.n_ranks, ref_p.n_chunks, ref_p.op)
        assert [(s.perm, s.send_chunk, s.recv_chunk, s.combine) for s in p.steps] == \
            [(s.perm, s.send_chunk, s.recv_chunk, s.combine) for s in ref_p.steps]
        if p.n_ranks == n:
            np.testing.assert_array_equal(PP.sim_program(p, x), RP.sim_program(ref_p, x))


@pytest.mark.parametrize("build", ["ring_allreduce", "ring_allreduce_max",
                                   "ring_allgather", "binomial_broadcast", "swap"])
def test_program_fn_bitwise_equals_reference(devices, pair, build):
    r, t = pair
    make = {"ring_allreduce": lambda m: m.prog_ring_allreduce(8),
            "ring_allreduce_max": lambda m: m.prog_ring_allreduce(8, "max"),
            "ring_allgather": lambda m: m.prog_ring_allgather(8),
            "binomial_broadcast": lambda m: m.prog_binomial_broadcast(8, 3),
            "swap": lambda m: _swap_program(m, 8)}[build]
    x = _x(8, 203, seed=1)
    ref = r.program_fn(make(RP))(r.shard(x))
    got = t.program_fn(make(PP))(t.shard(x))
    np.testing.assert_array_equal(_bits(got), _bits(ref))
    np.testing.assert_array_equal(got.numpy(), PP.sim_program(make(PP), x))


def test_program_fn_refusals(pair):
    _, t = pair
    with pytest.raises(ValueError, match="program is for 4 ranks, mesh has 8"):
        t.program_fn(PP.prog_ring_allreduce(4))
    with pytest.raises(PP.ProgramError, match="not usable"):
        t.program_fn(PP.prog_ring_allreduce(8, op="avg"))


def test_group_results_equal_direct_calls_in_order(pair):
    _, t = pair
    x1 = t.shard(_x(8, 64, seed=2))
    x2 = t.shard(_x(8, 8 * 5, seed=3))
    with t.group() as g:
        h1 = g.allreduce(x1, "ring", op="max")
        h2 = g.reduce_scatter(x2, "ring")
        h3 = g.sendrecv(x1, shift=3)
        h4 = g.broadcast(x1, "binomial", root=5)
        h5 = g.allreduce(x1, chunks=2)  # forces ptree, as a direct call
        with pytest.raises(GroupError, match="not executed yet"):
            h1.result()
    assert torch.equal(h1.result(), t.allreduce(x1, "ring", op="max"))
    assert torch.equal(h2.result(), t.reduce_scatter(x2, "ring"))
    assert torch.equal(h3.result(), t.sendrecv(x1, shift=3))
    assert torch.equal(h4.result(), t.broadcast(x1, "binomial", root=5))
    assert torch.equal(h5.result(), t.allreduce(x1, "ptree", chunks=2))
    with pytest.raises(GroupError, match="already executed"):
        g.allgather(x1)
    with pytest.raises(GroupError, match="single-use"):
        g.__enter__()


def test_group_caches_one_callable_per_signature_and_counts():
    t = Transport(rank_mesh(4, "cpu"))
    x = t.shard(_x(4, 16, seed=4))
    for _ in range(2):
        with t.group() as g:
            g.allreduce(x, "ring")
            g.allgather(x)
    assert sum(1 for k in t._cache if k[0] == "__group__") == 1
    assert t.stats()["allreduce/ring"]["calls"] == 2
    assert t.stats()["allgather/fused"]["calls"] == 2
    with t.group() as g:  # empty: a no-op
        pass
    with pytest.raises(ValueError, match="root 4 out of range"):
        with t.group() as g:
            g.gather(x, root=4)  # refused when queued, not at exit
    with pytest.raises(RuntimeError, match="boom"):
        with t.group() as g:
            h = g.allreduce(x)
            raise RuntimeError("boom")
    with pytest.raises(GroupError):
        h.result()  # an exception in the block skips the launch


def test_root_hint_steers_grouped_rooted_verbs():
    t = Transport(rank_mesh(4, "cpu"))
    x = t.shard(_x(4, 8, seed=5))
    t.root_hint = lambda: 2
    with t.group() as g:
        h = g.broadcast(x)
        h0 = g.broadcast(x, root=0)
    assert torch.equal(h.result(), t.broadcast(x, root=2))
    assert torch.equal(h0.result(), t.broadcast(x))  # explicit root pins
    t.root_hint = 3
    assert t._default_root() == 3


def test_group_on_2d_mesh():
    t = Transport(slice_mesh(2, 2, "cpu"))
    x = t.shard(np.random.default_rng(6).standard_normal((2, 2, 12)).astype(np.float32))
    with t.group() as g:
        h1 = g.allreduce(x)  # auto -> hierarchical on a 2-D mesh
        h2 = g.allreduce(x, "khd2d")
    assert torch.equal(h1.result(), t.allreduce(x, "hierarchical"))
    assert torch.equal(h2.result(), t.allreduce(x, "khd2d"))
    assert "allreduce/hierarchical" in t.stats()


def test_premul_and_acc_bitwise_equal_reference(devices, pair):
    r, t = pair
    x = _x(8, 1001, seed=7)
    ref = r.allreduce(r.shard(x), "ring", premul=0.37)
    got = t.allreduce(t.shard(x), "ring", premul=0.37)
    np.testing.assert_array_equal(_bits(got), _bits(ref))
    ref = r.reduce(r.shard(x), "binomial", root=2, premul=0.125)
    got = t.reduce(t.shard(x), "binomial", root=2, premul=0.125)
    np.testing.assert_array_equal(_bits(got), _bits(ref))
    import jax.numpy as jnp
    xb = r.shard(jnp.asarray(x, jnp.bfloat16))
    ref = r.allreduce(xb, "ring", acc="float32")
    got = t.allreduce(t.shard(x, torch.bfloat16), "ring", acc=torch.float32)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(got), _bits(np.asarray(ref, np.float32)))


@pytest.mark.parametrize("verb,algo,kw", [
    ("allreduce", "ring", {}), ("allreduce", "ptree", {"chunks": 3}),
    ("allreduce", "khd", {"digits": (2, 4)}), ("alltoall", "ring", {}),
    ("broadcast", "binomial", {"root": 3}), ("reduce", "binomial", {"root": 3}),
    ("sendrecv", "fused", {"shift": 2})])
def test_donate_writes_the_same_result_into_the_input(verb, algo, kw):
    t = Transport(rank_mesh(8, "cpu"))
    x = _x(8, 8 * 25, seed=8)
    if verb == "alltoall":
        x = x.reshape(8, 8, 25)
    want = getattr(t, verb)(t.shard(x), algo, **kw)
    y = t.shard(x).clone()
    got = getattr(t, verb)(y, algo, donate=True, **kw)
    assert got.data_ptr() == y.data_ptr()
    assert torch.equal(got, want)
    assert torch.equal(t.jit_fn(verb, algo, donate=True, **kw)(t.shard(x).clone()), want)


def test_knob_refusals_equal_reference(devices, pair):
    r, t = pair
    x = np.ones((8, 16), np.float32)
    xi = np.ones((8, 16), np.int32)
    calls = [
        ("allreduce", x, {"op": "max", "premul": 2.0}),
        ("allreduce", xi, {"algo": "ring", "premul": 2.0}),
        ("reduce_scatter", x, {"donate": True}),
        ("allgather", x, {"algo": "ring", "donate": True}),
        ("gather", x, {"donate": True}),
        ("scatter", x, {"donate": True}),
        ("allreduce", x, {"algo": "ring", "chunks": 2}),
        ("allreduce", x, {"algo": "ptree", "chunks": 0}),
        ("allreduce", x, {"algo": "ring", "digits": (2, 4)}),
        ("allreduce", x, {"algo": "khd", "digits": (3, 3)}),
        ("allreduce", x, {"algo": "khd", "digits": (8, 1)}),
        ("allreduce", x, {"digits": (2, 4), "max_radix": 4}),
        ("allreduce", x, {"max_radix": 1}),
        ("allreduce", x, {"algo": "ring", "intra_algo": "ring"}),
        ("allreduce", x, {"algo": "khd2d"}),
        ("allreduce", x, {"algo": "hierarchical"}),
        ("reduce", x, {"root": 8}),
        ("broadcast", x, {"algo": "tree"}),
        ("allreduce", x, {"algo": "bogus"}),
        ("bogus_verb", x, {}),
    ]
    for verb, arr, kw in calls:
        kw = dict(kw)
        algo = kw.pop("algo", "auto")

        def call(tr):
            if verb == "bogus_verb":
                return tr.jit_fn(verb, algo)
            return tr.jit_fn(verb, algo, **kw)(tr.shard(arr))
        with pytest.raises(ValueError) as ref_err:
            call(r)
        with pytest.raises(ValueError) as err:
            call(t)
        # the port names the reference's pallas_ring arm cuda_ring
        want = str(ref_err.value).replace("pallas_ring", "cuda_ring")
        assert str(err.value).split("; know")[0] == want.split("; know")[0], (verb, kw)
    for tr in (r, t):
        with pytest.raises(ValueError, match="^bad acc dtype 'float7'"):
            tr.allreduce(tr.shard(x), acc="float7")


def test_slice_modules_import_no_jax_reference_or_triton():
    # the subprocess test in test_torch_transport.py walks every module of
    # the port; this one names the modules of the rooted verbs, the tree
    # family, the 2-D mesh, programs and groups, so none can drop out
    import os
    import subprocess
    import sys
    mods = ["rocnrdma_tpu_torch.collectives." + m for m in
            ("rooted", "tree", "khd", "dtree", "ptree", "ktree", "hierarchical",
             "program", "schedule")]
    mods += ["rocnrdma_tpu_torch.transport.group", "rocnrdma_tpu_torch.runtime.mesh"]
    mods += [f"rocnrdma_tpu_torch.bench.bench_{v}" for v in
             ("broadcast", "reduce", "gather", "scatter", "sendrecv")]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'rocnrdma_tpu', 'triton'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
