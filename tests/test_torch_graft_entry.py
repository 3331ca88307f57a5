"""The port's graft entry (``rocnrdma_tpu_torch/graft_entry.py``) against
the repository's ``__graft_entry__.py``, on the CPU.

- ``entry()``: the same example inputs (bitwise) and outputs within 1e-5
  (the MoE layer's FFN) and 1e-6 (the DDP step) of the reference's.
- ``_ddp_step_fn``: the 1-D (fused) and 2-D (hierarchical) steps within
  1e-6 of the reference's.
- ``dryrun_multichip``: every surface checked against numpy inside, at
  4 and 8 ranks and the reference's other rank counts, light included;
  the ``cuda_ring`` tier is never skipped.
"""

import numpy as np
import pytest
import torch

import __graft_entry__ as ref
from rocnrdma_tpu import runtime as rt
from rocnrdma_tpu_torch import graft_entry as G
from rocnrdma_tpu_torch import ops
from rocnrdma_tpu_torch.runtime import rank_mesh, slice_mesh
from rocnrdma_tpu_torch.transport import Transport


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_entry_equals_reference(devices):
    fn, args = G.entry("cpu")
    rfn, rargs = ref.entry()
    flat = [args[0], args[1], *args[2], *args[3], args[4]]
    rflat = [rargs[0], rargs[1], *rargs[2], *rargs[3], rargs[4]]
    for a, r in zip(flat, rflat):
        assert isinstance(a, torch.Tensor) and a.device.type == "cpu"
        np.testing.assert_array_equal(_np(a), np.asarray(r))
    out, new = fn(*args)
    rout, rnew = rfn(*rargs)
    assert out.shape == (1, 32, 64)
    np.testing.assert_allclose(_np(out), np.asarray(rout), rtol=1e-5, atol=1e-5)
    for p, r in zip(new, rnew):
        np.testing.assert_allclose(_np(p), np.asarray(r), rtol=1e-6, atol=1e-6)
    # the DDP leg on one rank: params - lr * grads[0]
    tokens, _, params, grads, lr = args
    for p, g, pn in zip(params, grads, new):
        np.testing.assert_allclose(_np(pn), _np(p - lr * g[0]), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mesh2d", [None, (2, 4)])
def test_ddp_step_equals_reference(devices, mesh2d):
    rng = np.random.default_rng(9)
    if mesh2d:
        rmesh, t, lead = rt.slice_mesh(*mesh2d), Transport(slice_mesh(*mesh2d, "cpu")), mesh2d
    else:
        rmesh, t, lead = rt.rank_mesh(8), Transport(rank_mesh(8, "cpu")), (8,)
    params = [rng.standard_normal((6, 5)).astype(np.float32),
              rng.standard_normal((7,)).astype(np.float32)]
    grads = [rng.standard_normal(lead + (6, 5)).astype(np.float32),
             rng.standard_normal(lead + (7,)).astype(np.float32)]
    lr = np.float32(0.25)
    want = ref._ddp_step_fn(rmesh, hierarchical=bool(mesh2d))(params, grads, lr)
    got = G._ddp_step_fn(t, hierarchical=bool(mesh2d))(
        [torch.from_numpy(p) for p in params], [t.shard(g) for g in grads], float(lr))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-6, atol=1e-6)


def test_mesh_factor_equals_reference():
    for n in range(1, 300):
        assert G._mesh_factor(n) == ref._mesh_factor(n)


@pytest.mark.parametrize("n", [4, 8])
def test_dryrun_multichip_runs_the_cuda_ring_tier(n, capsys):
    before = ops.launch_counts()
    G.dryrun_multichip(n, device="cpu")
    out = capsys.readouterr().out
    assert f"dryrun_multichip({n})" in out and "cuda_ring(ar+alltoallv)" in out
    assert "hierarchical=True" in out and "khd2d(ar/rs/ag)" in out and out.strip().endswith("OK")
    # on the CPU the tier runs the plain versions: no kernel launches
    assert ops.launch_counts() == before


@pytest.mark.parametrize("n,light", [(1, None), (2, None), (3, None), (15, None),
                                     (16, True), (192, None)])
def test_dryrun_multichip_other_rank_counts(n, light, capsys):
    G.dryrun_multichip(n, light=light, device="cpu")
    out = capsys.readouterr().out
    assert out.strip().endswith("OK")
    assert ("LIGHT" in out) == (n >= 16)


def test_graft_entry_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        G.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        G.dryrun_multichip(4)
