"""The port's workloads (``rocnrdma_tpu_torch.workloads``) against the JAX
reference (``rocnrdma_tpu.workloads``), on the CPU, the same seeded numpy
inputs through both.

Tolerances:
- routing's integer outputs (experts, positions, keep) and
  ``build_dispatch``'s forward: bitwise;
- the gates (a softmax), ``combine`` and ``build_dispatch``'s backward:
  1e-6 in float32;
- ``moe_topk_step`` (x2 and FFN experts) and ``overlap``: 1e-5 in float32,
  5e-2 in bfloat16;
- the replays: ``ring`` and ``cuda_ring`` bitwise (the reference's
  ``pallas_ring`` runs in TPU interpret mode), ``fused`` within 1e-5.
"""

import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from rocnrdma_tpu import runtime as rt
from rocnrdma_tpu.transport import Transport as RefTransport
from rocnrdma_tpu.workloads import ddp_replay as ref_ddp
from rocnrdma_tpu.workloads import fsdp_replay as ref_fsdp
from rocnrdma_tpu.workloads import llama_trace as ref_trace
from rocnrdma_tpu.workloads import moe as ref_moe
from rocnrdma_tpu.workloads import overlap as ref_overlap
from rocnrdma_tpu.workloads import routing as RR
from rocnrdma_tpu_torch.runtime import rank_mesh, slice_mesh
from rocnrdma_tpu_torch.transport import Transport
from rocnrdma_tpu_torch.workloads import (_replay, ddp_replay, fsdp_replay, from_numpy,
                                          llama_trace, moe, overlap)
from rocnrdma_tpu_torch.workloads import routing as PR

from _marks import needs_tpu_interpret

CPU = torch.device("cpu")


def _np(x) -> np.ndarray:
    return x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x, np.float32)


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().contiguous()
        a = a.view(torch.int16 if a.element_size() == 2 else torch.int32).numpy()
    a = np.asarray(a)
    return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint32)


def _route_both(logits: np.ndarray, k: int, E: int, cap: int):
    """The reference's routing tables (vmapped over the lead dim) and the
    port's (batched), from the same logits."""
    gr, er = jax.vmap(lambda l: RR.topk_route(l, k))(jnp.asarray(logits))
    pr, kr = jax.vmap(lambda e: RR.dispatch_mask(e, E, cap))(er)
    gp, ep = PR.topk_route(torch.from_numpy(logits), k)
    pp, kp = PR.dispatch_mask(ep, E, cap)
    return (gr, er, pr, kr), (gp, ep, pp, kp)


# -- routing ----------------------------------------------------------------

def test_expert_capacity_equals_reference():
    for T in (1, 7, 64, 128, 4096):
        for E in (1, 3, 8):
            for k in (1, 2):
                for cf in (0.5, 1.0, 1.25, 4.0):
                    assert PR.expert_capacity(T, E, k, cf) == RR.expert_capacity(T, E, k, cf)


@pytest.mark.parametrize("cf", [0.5, 1.0, 1.25])
@pytest.mark.parametrize("k", [1, 2])
def test_routing_tables_equal_reference(cf, k):
    n, T, E = 4, 64, 4
    logits = np.random.default_rng(7).standard_normal((n, T, E)).astype(np.float32)
    cap = RR.expert_capacity(T, E, k, cf)
    (gr, er, pr, kr), (gp, ep, pp, kp) = _route_both(logits, k, E, cap)
    assert ep.dtype == pp.dtype == torch.int32 and kp.dtype == torch.bool
    np.testing.assert_array_equal(ep.numpy(), np.asarray(er))
    np.testing.assert_array_equal(pp.numpy(), np.asarray(pr))
    np.testing.assert_array_equal(kp.numpy(), np.asarray(kr))
    np.testing.assert_allclose(gp.numpy(), np.asarray(gr), rtol=1e-6, atol=1e-6)
    assert PR.route_stats(kp) == RR.route_stats(kr)
    if cf < 1.0:
        assert PR.route_stats(kp)["dropped"] > 0


def test_topk_breaks_ties_toward_the_lower_id_as_the_reference():
    # a hand-built tie row: experts 1, 2 and 4 share the top logit, 0 and 3
    # the next; the reference's lax.top_k takes them in id order
    logits = np.array([[0.5, 2.0, 2.0, 0.5, 2.0],
                       [1.0, 1.0, 1.0, 1.0, 1.0],
                       [-0.0, 0.0, -1.0, 0.0, -0.0]], np.float32)
    for k in (1, 2, 3, 4):
        gr, er = RR.topk_route(jnp.asarray(logits), k)
        gp, ep = PR.topk_route(torch.from_numpy(logits), k)
        np.testing.assert_array_equal(ep.numpy(), np.asarray(er))
        np.testing.assert_allclose(gp.numpy(), np.asarray(gr), rtol=1e-6, atol=1e-6)
    assert PR.topk_route(torch.from_numpy(logits), 3)[1][0].tolist() == [1, 2, 4]


@pytest.mark.parametrize("cf", [1.0, 1.25, 0.5])
def test_build_dispatch_and_combine_equal_reference(cf):
    n, T, E, k, d = 4, 64, 4, 2, 16
    rng = np.random.default_rng(11)
    logits = rng.standard_normal((n, T, E)).astype(np.float32)
    x = rng.standard_normal((n, T, d)).astype(np.float32)
    cap = RR.expert_capacity(T, E, k, cf)
    (gr, er, pr, kr), (gp, ep, pp, kp) = _route_both(logits, k, E, cap)
    disp_r = jax.vmap(lambda x_, e, p, m: RR.build_dispatch(x_, e, p, m, E, cap))(
        jnp.asarray(x), er, pr, kr)
    disp_p = PR.build_dispatch(torch.from_numpy(x), ep, pp, kp, E, cap)
    assert disp_p.shape == (n, E, cap, d)
    np.testing.assert_array_equal(_bits(disp_p), _bits(disp_r))
    # combine over a transformed dispatch (every slot distinct)
    out_r = jax.vmap(RR.combine)(disp_r * 3.0 + 1.0, gr, er, pr, kr)
    out_p = PR.combine(disp_p * 3.0 + 1.0, gp, ep, pp, kp)
    np.testing.assert_allclose(out_p.numpy(), np.asarray(out_r), rtol=1e-6, atol=1e-6)


def test_build_dispatch_heavy_drops_never_corrupt_slots():
    # the reference's case: every token's top-1 is expert 0, capacity 2
    rng = np.random.default_rng(3)
    T, E, k, d, cap = 12, 2, 2, 4, 2
    x = rng.standard_normal((T, d)).astype(np.float32)
    logits = np.stack([np.full(T, 5.0), rng.standard_normal(T)], -1).astype(np.float32)
    _, experts = PR.topk_route(torch.from_numpy(logits), k)
    pos, keep = PR.dispatch_mask(experts, E, cap)
    assert int(keep.sum()) < T * k
    disp = PR.build_dispatch(torch.from_numpy(x), experts, pos, keep, E, cap).numpy()
    xe, xp, xk = (experts.numpy().reshape(-1), pos.numpy().reshape(-1),
                  keep.numpy().reshape(-1))
    want = np.zeros_like(disp)
    for i in range(T * k):
        if xk[i]:
            want[xe[i], xp[i]] = x[i // k]
    np.testing.assert_array_equal(disp, want)
    _, er = RR.topk_route(jnp.asarray(logits), k)
    pr, kr = RR.dispatch_mask(er, E, cap)
    np.testing.assert_array_equal(
        _bits(disp), _bits(RR.build_dispatch(jnp.asarray(x), er, pr, kr, E, cap)))


@pytest.mark.parametrize("cf", [0.5, 1.25])
def test_build_dispatch_backward_equals_reference_custom_vjp(cf):
    rng = np.random.default_rng(5)
    n, T, E, k, d = 2, 12, 3, 2, 5
    x = rng.standard_normal((n, T, d)).astype(np.float32)
    logits = rng.standard_normal((n, T, E)).astype(np.float32)
    cap = RR.expert_capacity(T, E, k, cf)
    co = rng.standard_normal((n, E, cap, d)).astype(np.float32)
    (_, er, pr, kr), (_, ep, pp, kp) = _route_both(logits, k, E, cap)
    if cf < 1.0:
        assert int((~kp).sum()) > 0
    ref = jax.grad(lambda v: (jax.vmap(
        lambda x_, e, p, m: RR.build_dispatch(x_, e, p, m, E, cap))(v, er, pr, kr)
        * co).sum())(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    (PR.build_dispatch(xt, ep, pp, kp, E, cap) * torch.from_numpy(co)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    # the routing tables get no gradient
    g = torch.autograd.grad(PR.build_dispatch(xt, ep, pp, kp, E, cap).sum(), xt)[0]
    assert g.shape == xt.shape


# -- moe --------------------------------------------------------------------

def _moe_pair(n, T, d, E, k, cf, dtype, expert, algo="fused", ref_algo="fused"):
    """The reference's and the port's moe_topk_step outputs on the same
    seeded inputs; ``expert``: None (x2) or "ffn" (weights carried over by
    from_numpy)."""
    rng = np.random.default_rng(2)
    cap = RR.expert_capacity(T, E, k, cf)
    tok = rng.standard_normal((n, T, d)).astype(np.float32)
    logits = rng.standard_normal((n, T, E)).astype(np.float32)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    rt_ = RefTransport(rt.rank_mesh(n))
    t = Transport(rank_mesh(n, "cpu"))
    ref_exp = port_exp = None
    if expert == "ffn":
        ffn = 48
        w_in = jnp.asarray(rng.standard_normal((E, d, ffn)) / np.sqrt(d), jdt)
        w_out = jnp.asarray(rng.standard_normal((E, ffn, d)) / np.sqrt(ffn), jdt)
        ref_exp = ref_moe.ffn_expert(w_in, w_out)
        port_exp = moe.ffn_expert(*from_numpy((np.asarray(w_in), np.asarray(w_out)), CPU))
    ref_step = ref_moe.moe_topk_step(rt_, ref_algo, True, E, cap, k, expert=ref_exp)
    out_r, keep_r = ref_step(rt_.shard(jnp.asarray(tok, jdt)), rt_.shard(logits))
    port_step = moe.moe_topk_step(t, algo, True, E, cap, k, expert=port_exp)
    out_p, keep_p = port_step(t.shard(tok, getattr(torch, dtype)), t.shard(logits))
    return (out_r, keep_r), (out_p, keep_p), t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("expert", [None, "ffn"])
@pytest.mark.parametrize("cf", [1.0, 1.25])
def test_moe_topk_step_equals_reference(cf, expert, dtype):
    (out_r, keep_r), (out_p, keep_p), _ = _moe_pair(4, 64, 32, 4, 2, cf, dtype, expert)
    tol = 1e-5 if dtype == "float32" else 5e-2
    assert out_p.dtype == getattr(torch, dtype) and out_p.shape == (4, 64, 32)
    np.testing.assert_array_equal(keep_p.numpy(), np.asarray(keep_r))
    np.testing.assert_allclose(_np(out_p), _np(out_r), rtol=tol, atol=tol)


def test_moe_topk_step_cuda_ring_arm_equals_fused_and_reference():
    # the alltoall kernel's plain version on the CPU: the data only moves,
    # so the arm equals the library arm bit for bit
    (out_r, keep_r), (out_p, keep_p), t = _moe_pair(4, 64, 32, 4, 2, 1.25, "float32",
                                                    "ffn", algo="cuda_ring")
    (_, _), (out_f, _), _ = _moe_pair(4, 64, 32, 4, 2, 1.25, "float32", "ffn")
    np.testing.assert_array_equal(_bits(out_p), _bits(out_f))
    np.testing.assert_allclose(_np(out_p), _np(out_r), rtol=1e-5, atol=1e-5)


def test_moe_dispatch_enters_the_alltoall_as_a_view():
    t = Transport(rank_mesh(4, "cpu"))
    seen = []
    inner = t.jit_fn("alltoall", "fused")
    x = torch.randn(4, 4, 5, 6)

    def spy(v):
        seen.append(v)
        return inner(v)
    out = moe._a2a_slots(spy, x)
    assert seen[0].shape == (4, 4, 30) and seen[0].data_ptr() == x.data_ptr()
    assert torch.equal(out, x.transpose(0, 1))


@pytest.mark.parametrize("expert_compute", [False, True])
def test_moe_step_uniform_equals_reference(expert_compute):
    n, cap, d = 4, 3, 8
    x = np.random.default_rng(4).standard_normal((n, n, cap, d)).astype(np.float32)
    rt_ = RefTransport(rt.rank_mesh(n))
    ref = ref_moe.moe_step(rt_, "fused", expert_compute)(rt_.shard(x))
    t = Transport(rank_mesh(n, "cpu"))
    for algo in ("fused", "ring", "bruck", "cuda_ring"):
        got = moe.moe_step(t, algo, expert_compute)(t.shard(x))
        np.testing.assert_array_equal(_bits(got), _bits(ref))
    if not expert_compute:
        np.testing.assert_array_equal(got.numpy(), x)


def test_moe_models_equal_reference():
    assert moe.MOE_MODELS == ref_moe.MOE_MODELS


def test_moe_cli_on_cpu(tmp_path, capsys):
    out = tmp_path / "moe.jsonl"
    base = ["--platform", "cpu", "--repeats", "2", "--iters", "1", "--out", str(out)]
    assert moe.main(base + ["--fake-devices", "4", "--tokens", "64", "--d-model", "16"]) == 0
    assert moe.main(base + ["--model", "mixtral-8x7b", "--routing", "topk", "--tokens",
                            "32", "--fake-devices", "8", "--algo", "cuda_ring",
                            "--expert-compute"]) == 0
    assert moe.main(base + ["--mesh2d", "2x2", "--fake-devices", "4", "--tokens", "32",
                            "--d-model", "8", "--routing", "topk", "--capacity-factor",
                            "8"]) == 0
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["collective"] for r in rows] == ["alltoall", "moe_layer", "moe_layer"]
    assert rows[1]["extra"]["d_model"] == 4096 and rows[1]["n_ranks"] == 8
    assert "dropped" in capsys.readouterr().err


# -- the trace and the replays -------------------------------------------------

def test_llama_trace_buckets_equal_reference():
    for cap in (25.0, 100.0):
        for dtype in ("float32", "bfloat16"):
            got = llama_trace.generate_trace(llama_trace.LLAMA3_8B, cap, dtype)
            want = ref_trace.generate_trace(ref_trace.LLAMA3_8B, cap, dtype)
            assert got.to_json() == want.to_json()
    assert llama_trace.LLAMA3_8B.param_shapes() == ref_trace.LLAMA3_8B.param_shapes()
    assert fsdp_replay.flat_units(llama_trace.LLAMA3_8B) == \
        ref_fsdp.flat_units(ref_trace.LLAMA3_8B)
    assert fsdp_replay.step_plan(5) == ref_fsdp.step_plan(5)
    tr = llama_trace.Trace.from_json(got.to_json())
    assert tr == got


def _small_trace():
    return llama_trace.generate_trace(llama_trace.LLAMA3_8B, bucket_mb=4096.0)


def test_replay_buffers_equal_reference(devices):
    n, scale = 4, 1 << 20
    rt_ = RefTransport(rt.rank_mesh(n))
    t = Transport(rank_mesh(n, "cpu"))
    ref = ref_ddp._bucket_arrays(rt_, ref_trace.generate_trace(
        ref_trace.LLAMA3_8B, bucket_mb=4096.0), scale, "float32")
    got = ddp_replay._bucket_arrays(t, _small_trace(), scale, "float32")
    assert len(got) == len(ref) > 2
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(_bits(g), _bits(r))
    units = fsdp_replay.flat_units(llama_trace.LLAMA3_8B)
    rs, rf = ref_fsdp._unit_arrays(rt_, units, scale, "float32")
    ps, pf = fsdp_replay._unit_arrays(t, units, scale, "float32")
    for g, r in zip(ps + pf, rs + rf):
        np.testing.assert_array_equal(_bits(g), _bits(r))


_REF_OUTPUTS: dict = {}


def _ref_outputs(n, key, verb_bufs):
    """The reference Transport's result of each (verb, algo, buffer), once
    per ``key`` (the outputs do not depend on the replay mode)."""
    if key not in _REF_OUTPUTS:
        rt_ = RefTransport(rt.rank_mesh(n))
        _REF_OUTPUTS[key] = [np.asarray(rt_.jit_fn(verb, algo)(rt_.shard(np.asarray(b))))
                             for verb, algo, b in verb_bufs]
    return _REF_OUTPUTS[key]


@pytest.mark.parametrize("mode", ["sequential", "overlap", "jit_fused"])
@pytest.mark.parametrize("algo", ["ring", "fused", pytest.param("cuda_ring",
                                                                 marks=needs_tpu_interpret)])
def test_ddp_replay_outputs_equal_reference(devices, mode, algo):
    n, scale = 4, 1 << 20
    t = Transport(rank_mesh(n, "cpu"))
    bufs = ddp_replay._bucket_arrays(t, _small_trace(), scale, "float32")[:5]
    out = []
    sec = ddp_replay.replay(t, bufs, algo, mode, repeats=2, window=2, out=out)
    assert sec > 0 and len(out) == len(bufs)
    ref_algo = "pallas_ring" if algo == "cuda_ring" else algo
    ref = _ref_outputs(n, ("ddp", algo), [("allreduce", ref_algo, b.numpy()) for b in bufs])
    for g, r in zip(out, ref):
        if algo == "fused":
            np.testing.assert_allclose(g.numpy(), r, rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_array_equal(_bits(g), _bits(r))


@pytest.mark.parametrize("mode", ["sequential", "overlap", "jit_fused"])
@pytest.mark.parametrize("algo", ["ring", "fused", pytest.param("cuda_ring",
                                                                 marks=needs_tpu_interpret)])
def test_fsdp_replay_outputs_equal_reference(devices, mode, algo):
    n, scale = 4, 1 << 20
    t = Transport(rank_mesh(n, "cpu"))
    units = fsdp_replay.flat_units(llama_trace.LLAMA3_8B)[:3]
    grain = fsdp_replay.CUDA_RING_GRAIN if algo == "cuda_ring" else 1
    shards, fulls = fsdp_replay._unit_arrays(t, units, scale, "float32", grain=grain)
    if algo == "cuda_ring":
        assert all(s.shape[1] % 128 == 0 for s in shards)
    out = []
    fsdp_replay.replay(t, shards, fulls, algo, mode, repeats=2, window=2, out=out)
    plan = fsdp_replay.step_plan(len(units))
    assert len(out) == len(plan)
    ref_algo = "pallas_ring" if algo == "cuda_ring" else algo
    ref = _ref_outputs(n, ("fsdp", algo), [
        ("allgather" if k == "ag" else "reduce_scatter", ref_algo,
         (shards if k == "ag" else fulls)[i].numpy()) for k, i in plan])
    for g, r in zip(out, ref):
        if algo == "fused":
            np.testing.assert_allclose(g.numpy(), r.reshape(g.shape), rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_array_equal(_bits(g), _bits(r.reshape(g.shape)))


def test_replay_rejects_an_unknown_mode():
    t = Transport(rank_mesh(2, "cpu"))
    with pytest.raises(ValueError, match="unknown mode"):
        ddp_replay.replay(t, [t.shard(np.ones((2, 4), np.float32))], "fused", "bogus")
    assert _replay.default_window(type("T", (), {"is_oracle": True})()) == 4


@pytest.mark.parametrize("verb", ["allreduce", "reduce_scatter"])
def test_replay_sums_within_the_smoke_bound(verb):
    # chip_smoke holds the fused replay sums to the plain ring within
    # sum_bound; the fused and ring arms on the CPU lie within it, and an
    # error beyond it is caught
    import chip_smoke
    from rocnrdma_tpu_torch import ops
    n = 8
    t = Transport(rank_mesh(n, "cpu"))
    x = t.shard(np.random.default_rng(3).standard_normal((n, n * 256), np.float32))
    want = (ops.ring_allreduce_plain(x) if verb == "allreduce"
            else ops.ring_reduce_scatter_plain(x))
    got = getattr(t, verb)(x, "fused")
    bound = chip_smoke.sum_bound(x, n, verb)
    assert chip_smoke.within("fused vs ring", got, want, bound) <= float(bound.max())
    off = got.clone()
    off[-1, -1] += 2 * float(bound.max())
    with pytest.raises(AssertionError, match="rounding bound"):
        chip_smoke.within("fused vs ring", off, want, bound)


def test_replay_out_holds_one_repeat():
    t = Transport(rank_mesh(2, "cpu"))
    bufs = [t.shard(np.ones((2, 4), np.float32)), t.shard(np.ones((2, 3), np.float32))]
    for mode in ddp_replay.MODES:
        out = ["stale"]
        ddp_replay.replay(t, bufs, "fused", mode, repeats=3, out=out)
        assert len(out) == len(bufs) and all(bool((o == 2).all()) for o in out)


def test_ddp_replay_cli_on_cpu(tmp_path, capsys):
    out = tmp_path / "ddp.jsonl"
    common = ["--platform", "cpu", "--scale", "1048576", "--bucket-mb", "500",
              "--repeats", "2", "--out", str(out)]
    assert ddp_replay.main(common + ["--fake-devices", "4"]) == 0
    assert ddp_replay.main(common + ["--fake-devices", "8", "--mesh2d", "2x4",
                                     "--cross-dtype", "bfloat16", "--algo",
                                     "hierarchical", "--modes", "jit_fused,overlap"]) == 0
    assert ddp_replay.main(common + ["--fake-devices", "4", "--algo", "cuda_ring",
                                     "--modes", "sequential"]) == 0
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["extra"]["mode"] for r in rows] == ["sequential", "overlap", "jit_fused",
                                                  "jit_fused", "overlap", "sequential"]
    assert "speedup_vs_sequential" in rows[1]["extra"]
    assert "speedup_vs_sequential" not in rows[3]["extra"]
    assert rows[3]["extra"]["cross_dtype"] == "bfloat16"
    trace = tmp_path / "trace.json"
    assert ddp_replay.main(["--trace-out", str(trace)]) == 0
    assert llama_trace.Trace.from_json(trace.read_text()) == llama_trace.generate_trace()
    with pytest.raises(SystemExit, match="unknown mode"):
        ddp_replay.main(common + ["--modes", "bogus"])


def test_fsdp_replay_cli_on_cpu(tmp_path):
    out = tmp_path / "fsdp.jsonl"
    common = ["--platform", "cpu", "--scale", "1048576", "--repeats", "2", "--out", str(out)]
    assert fsdp_replay.main(common + ["--fake-devices", "4"]) == 0
    assert fsdp_replay.main(common + ["--fake-devices", "4", "--algo", "cuda_ring",
                                      "--modes", "overlap"]) == 0
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["algo"] for r in rows] == ["auto"] * 3 + ["cuda_ring"]
    assert all(r["collective"] == "fsdp" and r["extra"]["n_units"] == 34 for r in rows)


# -- overlap ----------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mesh", ["1d", "2d"])
@pytest.mark.parametrize("algo", ["fused", "ring"])
def test_overlap_equals_reference(mesh, algo, dtype):
    if mesh == "2d" and algo == "ring":
        for mod, tr in ((overlap, Transport(slice_mesh(2, 2, "cpu"))),
                        (ref_overlap, RefTransport(rt.slice_mesh(2, 2)))):
            with pytest.raises(ValueError, match="1-D"):
                mod.build_fns(tr, "ring")
        return
    rt_ = RefTransport(rt.rank_mesh(4) if mesh == "1d" else rt.slice_mesh(2, 2))
    t = Transport(rank_mesh(4, "cpu") if mesh == "1d" else slice_mesh(2, 2, "cpu"))
    kw = dict(layers=3, dim=32, batch=8, grad_elems=20, dtype=dtype)
    ref_in = ref_overlap.example_inputs(rt_, **kw)
    got_in = overlap.example_inputs(t, **kw)
    tol = 1e-5 if dtype == "float32" else 5e-2
    for g, r in zip(got_in, ref_in):
        np.testing.assert_allclose(_np(g), _np(r), rtol=tol, atol=tol)
    if dtype == "float32":  # the same draws and arithmetic: bitwise
        for g, r in zip(got_in, ref_in):
            np.testing.assert_array_equal(_bits(g), _bits(r))
    rc, rm, rb = ref_overlap.build_fns(rt_, algo)
    pc, pm, pb = overlap.build_fns(t, algo)
    ref = (rc(ref_in[0], ref_in[1]), rm(ref_in[2])) + tuple(rb(*ref_in))
    got = (pc(got_in[0], got_in[1]), pm(got_in[2])) + tuple(pb(*got_in))
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_allclose(_np(g), _np(r), rtol=tol, atol=tol)
    # the reference's own arrays, weights included, carried over
    y, Ws, grads = from_numpy(tuple(ref_in), CPU)
    yb, gb = pb(y, Ws, grads)
    np.testing.assert_allclose(_np(yb), _np(ref[2]), rtol=tol, atol=tol)
    np.testing.assert_allclose(_np(gb), _np(ref[3]), rtol=tol, atol=tol)


def test_overlap_measure_and_cli(tmp_path, capsys):
    t = Transport(rank_mesh(4, "cpu"))
    res = overlap.measure(t, layers=2, dim=32, batch=8, grad_elems=16, repeats=2, iters=1)
    assert res["compute_s"] > 0 and res["comm_s"] > 0 and res["both_s"] > 0
    assert np.isfinite(res["overlap_frac"])
    out = tmp_path / "o.jsonl"
    assert overlap.main(["--fake-devices", "4", "--platform", "cpu", "--layers", "2",
                         "--dim", "32", "--batch", "8", "--grad-kb", "1", "--repeats",
                         "2", "--iters", "1", "--algo", "ring", "--out", str(out)]) == 0
    row = json.loads(out.read_text())
    assert row["extra"]["layers"] == 2 and row["algo"] == "ring"
    assert "overlap" in capsys.readouterr().out
    with pytest.raises(ValueError, match="fused\\|ring"):
        overlap.build_fns(t, "khd")


# -- weights ---------------------------------------------------------------

def test_from_numpy_carries_bf16_bit_for_bit_and_keeps_the_tree():
    w = (np.random.default_rng(0).standard_normal((3, 5)) * 7).astype(ml_dtypes.bfloat16)
    tree = {"w": w, "b": [np.arange(4, dtype=np.float32), jnp.ones(2, jnp.bfloat16)],
            "lr": np.float32(0.5), "name": "x", "n": 3}
    got = from_numpy(tree, CPU)
    assert got["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["w"].view(torch.int16).numpy(), w.view(np.int16))
    assert got["b"][0].dtype == torch.float32 and torch.equal(got["b"][0], torch.arange(4.0))
    assert got["b"][1].dtype == torch.bfloat16 and isinstance(got["b"], list)
    assert got["lr"].shape == () and float(got["lr"]) == 0.5
    assert got["name"] == "x" and got["n"] == 3
    cast = from_numpy((w,), CPU, torch.float32)
    assert isinstance(cast, tuple) and cast[0].dtype == torch.float32
    np.testing.assert_array_equal(cast[0].numpy(), w.astype(np.float32))
