"""The flagship step and the multi-rank dry run, counterpart of the
repository's ``__graft_entry__.py``.

- ``entry(device)`` -> ``(fn, example_args)``: the MoE layer forward
  (router -> static-capacity dispatch -> FFN expert -> gated combine; one
  expert on one rank, the expert-parallel program's shape) chained with
  the DDP training step (gradient allreduce + SGD);
  ``fn(tokens, logits, params, grads, lr)``.
- ``dryrun_multichip(n, light, device)``: the multi-rank training step's
  collectives over n ranks on one device, a 2-D ``('slice', 'intra')``
  mesh where n factors: dp gradient allreduce + SGD (hierarchical on the
  2-D mesh), ep alltoall, the top-k MoE layer, grouped launch, the tree
  family, the ``cuda_ring`` tier (the reference's ``pallas_ring`` tier: on
  the CPU it runs the kernels' plain versions, and it is never skipped),
  one FSDP unit and the ragged alltoall, each checked against numpy on
  tiny shapes.

Both run on the GPU unless ``device="cpu"`` is given.
"""

from __future__ import annotations

import numpy as np
import torch

from rocnrdma_tpu_torch.runtime import rank_mesh, resolve_device, slice_mesh
from rocnrdma_tpu_torch.transport import Transport


def _device(device) -> torch.device:
    return resolve_device() if device is None else torch.device(device)


def _ddp_step_fn(t: Transport, hierarchical: bool):
    """The DDP train step over ``t``'s mesh: every rank's gradient row is
    allreduced (the hierarchical schedule on a 2-D mesh, ``fused``
    otherwise), then applied to the replicated params as an SGD update.
    ``step(params, grads, lr)``: params replicated tensors, grads
    rank-major; returns the new params."""
    n = t.n_ranks
    algo = "hierarchical" if hierarchical else "fused"

    def step(params, grads, lr):
        new = []
        for p, g in zip(params, grads):
            # every rank row holds the sum; the params are replicated
            g = t.allreduce(g, algo).reshape((n,) + p.shape)[0]
            new.append(p - lr * g / n)
        return new
    return step


def entry(device=None):
    """(fn, example_args): the one-rank flagship step, the MoE layer forward
    chained with the DDP gradient allreduce + SGD update."""
    from rocnrdma_tpu_torch.workloads import from_numpy
    from rocnrdma_tpu_torch.workloads import routing as R
    from rocnrdma_tpu_torch.workloads.moe import ffn_expert, moe_topk_step

    dev = _device(device)
    t = Transport(rank_mesh(1, dev))
    ddp = _ddp_step_fn(t, hierarchical=False)
    T, d = 32, 64
    cap = max(R.expert_capacity(T, 1, 1, 4.0), T)
    wrng = np.random.default_rng(3)
    w_in, w_out = from_numpy(
        (wrng.standard_normal((1, d, 4 * d)) / d ** 0.5,
         wrng.standard_normal((1, 4 * d, d)) / (4 * d) ** 0.5), dev, torch.float32)
    moe = moe_topk_step(t, "auto", True, 1, cap, 1, expert=ffn_expert(w_in, w_out))

    def flagship(tokens, logits, params, grads, lr):
        out, _keep = moe(tokens, logits)
        return out, ddp(params, grads, lr)

    rng = np.random.default_rng(0)
    args = from_numpy(
        (rng.standard_normal((1, T, d), dtype=np.float32),
         rng.standard_normal((1, T, 1), dtype=np.float32),
         [rng.standard_normal((64, 64), dtype=np.float32),
          rng.standard_normal((64,), dtype=np.float32)],
         [rng.standard_normal((1, 64, 64), dtype=np.float32),
          rng.standard_normal((1, 64), dtype=np.float32)],
         np.float32(0.1)), dev)
    return flagship, args


def _mesh_factor(n: int) -> tuple | None:
    """(slices, per_slice) for composite n >= 4: the smallest prime factor
    as the slice count (2 x n/2 for even n, 3 x 5 for 15); None = flat ring."""
    if n >= 4:
        for p in range(2, int(n ** 0.5) + 1):
            if n % p == 0:
                return p, n // p
    return None


def _close(got: torch.Tensor, want, rtol: float, atol: float, what: str = "") -> None:
    np.testing.assert_allclose(got.float().cpu().numpy(), want, rtol=rtol, atol=atol,
                               err_msg=what)


def _sum_rows(x: np.ndarray, n: int, shape) -> np.ndarray:
    """Every rank's row the sum of the n rank rows of ``x``."""
    return np.broadcast_to(x.reshape(n, -1).sum(0), (n, x.size // n)).reshape(shape)


def dryrun_multichip(n_devices: int, light: bool | None = None, device=None) -> None:
    """Run the multi-rank training step's collectives once over
    ``n_devices`` ranks on one device and check each against numpy.

    ``light``: only the contract-critical 2-D surfaces (hierarchical dp
    step, khd2d allreduce, ep alltoall, top-k MoE) on shrunk payloads;
    default: light at n >= 192, as the reference."""
    from rocnrdma_tpu_torch.workloads import routing as R
    from rocnrdma_tpu_torch.workloads.moe import moe_topk_step

    dev = _device(device)
    if light is None:
        light = n_devices >= 192
    n = n_devices
    fac = _mesh_factor(n)
    mesh = slice_mesh(*fac, dev) if fac is not None else rank_mesh(n, dev)
    hierarchical = fac is not None
    lead = tuple(mesh.shape)
    t = Transport(mesh)
    rng = np.random.default_rng(1)

    # --- dp: gradient allreduce + SGD update -------------------------------
    step = _ddp_step_fn(t, hierarchical=hierarchical)
    params = [rng.standard_normal((16, 16), dtype=np.float32),
              rng.standard_normal((16,), dtype=np.float32)]
    grads = [rng.standard_normal(lead + (16, 16), dtype=np.float32),
             rng.standard_normal(lead + (16,), dtype=np.float32)]
    lr = np.float32(0.5)
    new_params = step([torch.from_numpy(p).to(dev) for p in params],
                      [t.shard(g) for g in grads], float(lr))
    for p, g, pn in zip(params, grads, new_params):
        want = p - lr * g.reshape((n,) + p.shape).sum(0) / n
        _close(pn, want, 1e-4, 1e-5, "dp step")

    # --- ep: alltoall dispatch/combine over the same mesh ------------------
    x = rng.standard_normal(lead + ((n, 2, 2) if light else (n, 4, 8)), dtype=np.float32)
    xs = t.shard(x)
    _close(t.alltoall(t.alltoall(xs, "auto"), "auto"), x, 1e-5, 1e-6, "ep alltoall")

    # --- 2-D only: hierarchical alltoall, the bf16 cross-slice allreduce,
    # khd2d's three verbs --------------------------------------------------
    if fac is not None:
        gx = rng.standard_normal(lead + (24,), dtype=np.float32)
        if not light:
            ha = t.alltoall(xs, "hierarchical")
            if not torch.equal(ha, t.alltoall(xs, "fused")):
                raise AssertionError("hierarchical alltoall differs from fused")
            hx = t.allreduce(t.shard(gx), "hierarchical", cross_dtype="bfloat16")
            _close(hx, _sum_rows(gx, n, hx.shape), 5e-2, 5e-2, "bf16 cross-slice")
        k2 = t.allreduce(t.shard(gx), "khd2d")
        _close(k2, _sum_rows(gx, n, k2.shape), 1e-4, 1e-5, "khd2d allreduce")
        if not light:
            g2 = rng.standard_normal(lead + (n * 2,), dtype=np.float32)
            rs2 = t.reduce_scatter(t.shard(g2), "khd2d")
            _close(rs2.reshape(n, 2), g2.reshape(n, n, 2).sum(0), 1e-4, 1e-5,
                   "khd2d reduce_scatter")
            sh2 = rng.standard_normal(lead + (3,), dtype=np.float32)
            ag2 = t.allgather(t.shard(sh2), "khd2d")
            _close(ag2.reshape(n, n * 3), np.broadcast_to(sh2.reshape(-1), (n, n * 3)),
                   1e-6, 1e-6, "khd2d allgather")

    # --- ep with top-k routing: the MoE layer; capacity >= every routed
    # entry, so nothing drops and the layer is the identity -----------------
    T, d = (8, 4) if light else (16, 8)
    k = min(2, n)
    cap = max(R.expert_capacity(T, n, k, 4.0), T * k)
    tok = rng.standard_normal(lead + (T, d), dtype=np.float32)
    logits = rng.standard_normal(lead + (T, n), dtype=np.float32)
    out, keep = moe_topk_step(t, "auto", False, n, cap, k)(t.shard(tok), t.shard(logits))
    if not bool(keep.all()):
        raise AssertionError("generous capacity still dropped")
    _close(out, tok, 1e-4, 1e-4, "moe top-k")

    if light:
        print(f"dryrun_multichip({n}): mesh={mesh.axis_names} {lead} "
              f"hierarchical={hierarchical} LIGHT (dp-hier+khd2d-ar+ep-a2a+moe-topk "
              f"on shrunk payloads) OK")
        return

    # --- grouped launch and the tree families on a flat rank ring ---------
    t1 = Transport(rank_mesh(n, dev))
    g1 = rng.standard_normal((n, 33), dtype=np.float32)
    g2 = rng.standard_normal((n, n * 4), dtype=np.float32)
    with t1.group() as g:
        h1 = g.allreduce(t1.shard(g1), algo="dtree")
        h2 = g.reduce_scatter(t1.shard(g2), algo="ring")
    _close(h1.result(), np.broadcast_to(g1.sum(0), g1.shape), 1e-4, 1e-5, "group dtree")
    _close(h2.result(), g2.sum(0).reshape(n, -1), 1e-4, 1e-5, "group ring rs")
    for algo in ("ktree", "khd", "ptree"):
        _close(t1.allreduce(t1.shard(g1), algo), np.broadcast_to(g1.sum(0), g1.shape),
               1e-4, 1e-5, algo)
    _close(t1.allreduce(t1.shard(g1), "khd", max_radix=max(2, n // 2)),
           np.broadcast_to(g1.sum(0), g1.shape), 1e-4, 1e-5, "khd max_radix")

    # --- the cuda_ring tier: the hand-written ring and alltoall kernels (on
    # the CPU their plain versions) ------------------------------------------
    _close(t1.allreduce(t1.shard(g2), "cuda_ring"), np.broadcast_to(g2.sum(0), g2.shape),
           1e-4, 1e-5, "cuda_ring allreduce")

    # --- one FSDP/ZeRO-3 unit: allgather(param shard), reduce_scatter(grads)
    per = 6
    fshard = rng.standard_normal((n, per), dtype=np.float32)
    fgrad = rng.standard_normal((n, n * per), dtype=np.float32)
    full = t1.allgather(t1.shard(fshard), "ring")
    _close(full, np.broadcast_to(fshard.reshape(-1), (n, n * per)), 1e-5, 1e-6, "fsdp ag")
    gshard = t1.reduce_scatter(t1.shard(fgrad), "ring")
    _close(gshard, fgrad.sum(0).reshape(n, per), 1e-4, 1e-5, "fsdp rs")
    _close(t1.reduce_scatter(t1.shard(fgrad), "khd"), gshard.cpu().numpy(), 1e-4, 1e-5,
           "khd rs")
    _close(t1.allgather(t1.shard(fshard), "khd"), full.cpu().numpy(), 1e-5, 1e-6, "khd ag")

    # --- ragged alltoall, on the library path and the kernel ---------------
    vcap = 3
    counts = rng.integers(0, vcap + 1, size=(n, n))
    va = rng.standard_normal((n, n, vcap, 2), dtype=np.float32)
    for algo in ("auto", "cuda_ring"):
        vout, vrc = t1.alltoallv(t1.shard(va), counts, algo)
        vout, vrc = vout.cpu().numpy(), vrc.cpu().numpy()
        for me in range(n):
            np.testing.assert_array_equal(vrc[me], counts[:, me])
            for src in range(n):
                kc = counts[src, me]
                np.testing.assert_allclose(vout[me, src, :kc], va[src, me, :kc],
                                           rtol=1e-5, atol=1e-6)

    print(f"dryrun_multichip({n}): mesh={mesh.axis_names} {lead} "
          f"hierarchical={hierarchical} "
          f"moe-topk+group+dtree+ktree+khd(ar/rs/ag+radix-knob)+ptree"
          f"+cuda_ring(ar+alltoallv)+fsdp-unit+alltoallv"
          f"{'+hier-a2a+cross-dtype+khd2d(ar/rs/ag)' if fac is not None else ''} OK")
