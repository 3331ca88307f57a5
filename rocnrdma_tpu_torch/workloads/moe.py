"""MoE expert-parallel dispatch/combine workload (component C7;
``BASELINE.json:11`` "MoE alltoall").

Counterpart of ``rocnrdma_tpu/workloads/moe.py``. Every rank hosts one
expert; tokens are routed, alltoall'd to their experts (dispatch),
transformed, and alltoall'd back (combine). The bench times the two
alltoalls, optionally with the expert transform between them, and checks
``combine(dispatch(x)) == x`` (an alltoall twice is the identity).

Where the reference ``jax.vmap``s the routing over the mesh's lead dims,
the port routes all ranks at once with batched tensor ops over the rank
axis (``workloads/routing.py``); only the alltoalls cross ranks, through
``Transport.alltoall``. The dispatch ``(ranks..., E, cap, d)`` enters the
alltoall as the view ``(ranks..., E, cap*d)``.

Usage::

    python -m rocnrdma_tpu_torch.workloads.moe --fake-devices 8 --tokens 512 --d-model 256
    python -m rocnrdma_tpu_torch.workloads.moe --model mixtral-8x7b --routing topk \\
        --tokens 4096 --fake-devices 8 --algo cuda_ring
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from rocnrdma_tpu_torch import metrics as M
from rocnrdma_tpu_torch.bench import cli_common
from rocnrdma_tpu_torch.bench.runner import DTYPES
from rocnrdma_tpu_torch.bench.timing import trimmed_mean
from rocnrdma_tpu_torch.transport import Transport
from rocnrdma_tpu_torch.workloads import _replay
from rocnrdma_tpu_torch.workloads import routing as R


def _a2a_slots(a2a, v: torch.Tensor) -> torch.Tensor:
    """Alltoall of ``(ranks..., E, cap, d)`` slots as the view
    ``(ranks..., E, cap*d)``, back to the slot shape."""
    return a2a(v.reshape(v.shape[:-2] + (-1,))).reshape(v.shape)


def moe_step(t: Transport, algo: str, expert_compute: bool):
    """The dispatch -> (expert) -> combine step over uniform routing.

    Layout: x is ``(ranks..., n_experts, cap, d)``: chunk e holds the
    tokens this rank routes to expert e (capacity cap)."""
    a2a = t.jit_fn("alltoall", algo)

    def step(x):
        routed = _a2a_slots(a2a, x)      # dispatch: tokens to their expert
        if expert_compute:
            # a transform that is its own inverse up to scale: keeps the
            # round trip exact
            routed = routed * 2.0
        return _a2a_slots(a2a, routed)   # combine: results back to sources
    return step


def ffn_expert(w_in: torch.Tensor, w_out: torch.Tensor):
    """A per-expert FFN for ``moe_topk_step``'s expert slot: two matmuls and
    gelu over the dispatched ``(..., E, cap, d)`` slots, weights
    ``(E, d, ffn)`` / ``(E, ffn, d)``; 4 * tokens * d * ffn flops a step.
    The gelu is the tanh form, ``jax.nn.gelu``'s default."""
    def expert(v):
        h = torch.einsum("...ecd,edf->...ecf", v, w_in)
        h = torch.nn.functional.gelu(h, approximate="tanh")
        return torch.einsum("...ecf,efd->...ecd", h, w_out)
    return expert


def moe_topk_step(t: Transport, algo: str, expert_compute: bool,
                  n_experts: int, cap: int, top_k: int, expert=None):
    """The MoE layer: router logits -> top-k gating with a static capacity
    (tokens past capacity dropped, GShard-style) -> alltoall dispatch ->
    expert -> alltoall combine -> gate-weighted gather. Inputs: tokens
    ``(ranks..., T, d)`` and router logits ``(ranks..., T, E)``; returns the
    output ``(ranks..., T, d)`` and the keep mask ``(ranks..., T, k)``.
    ``expert``: the transform of the dispatched ``(ranks..., E, cap, d)``
    slots (default: x2, for identity-style checks; ``ffn_expert(...)`` for
    matmul work)."""
    a2a = t.jit_fn("alltoall", algo)
    if expert is None:
        def expert(v):
            return v * 2.0

    def step(tokens, logits):
        gates, experts = R.topk_route(logits, top_k)
        pos, keep = R.dispatch_mask(experts, n_experts, cap)
        dispatch = R.build_dispatch(tokens, experts, pos, keep, n_experts, cap)
        routed = _a2a_slots(a2a, dispatch)
        if expert_compute:
            routed = expert(routed)
        back = _a2a_slots(a2a, routed)
        return R.combine(back, gates, experts, pos, keep), keep
    return step


# Public MoE architectures as dispatch-shape presets: the alltoall traffic
# depends only on (d_model, n_experts) and the token count.
MOE_MODELS = {
    # Mixtral-8x7B: d_model 4096, 8 experts, top-2 routing -> 2 dispatches
    # per token; with one expert per rank the natural EP world is 8.
    "mixtral-8x7b": {"d_model": 4096, "n_experts": 8, "top_k": 2},
}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="moe", description="MoE alltoall dispatch/combine bench")
    p.add_argument("--tokens", type=int, default=1024, help="tokens per rank")
    p.add_argument("--d-model", type=int, default=512)
    p.add_argument("--model", choices=sorted(MOE_MODELS), default=None,
                   help="public MoE architecture preset: sets --d-model and "
                        "scales --tokens by its top_k (each token is "
                        "dispatched top_k times)")
    p.add_argument("--dtype", choices=tuple(DTYPES), default="float32")
    p.add_argument("--ranks", type=int, default=None)
    p.add_argument("--mesh2d", type=str, default=None, metavar="SLICESxPER")
    p.add_argument("--algo", default="auto")
    p.add_argument("--expert-compute", action="store_true",
                   help="run the expert transform between dispatch and combine")
    p.add_argument("--routing", choices=("uniform", "topk"), default="uniform",
                   help="uniform: fixed-shape chunks (pure transport "
                        "traffic); topk: router -> top-k gating with static "
                        "capacity and GShard-style token dropping")
    p.add_argument("--top-k", type=int, default=2)
    p.add_argument("--capacity-factor", type=float, default=1.25)
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--fake-devices", type=int, default=None)
    p.add_argument("--platform", choices=("auto", "cpu"), default="auto")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    spec = MOE_MODELS[args.model] if args.model else None
    if spec:
        args.d_model = spec["d_model"]
        if args.routing == "topk":
            # real routing accounts for top_k via the expert capacity;
            # scaling tokens too would double-count the dispatch traffic
            args.top_k = spec["top_k"]
        else:
            args.tokens *= spec["top_k"]  # uniform emulation of k dispatches
        if args.ranks is None and args.mesh2d is None:
            args.ranks = spec["n_experts"]  # the model's EP world

    topo = cli_common.setup_backend(args.fake_devices, args.platform, args.ranks)
    t = Transport(cli_common.build_mesh(args.mesh2d, args.ranks, topo))
    n = t.n_ranks
    if spec:
        print(f"# {args.model}: d_model={args.d_model}, top_k={spec['top_k']}, "
              f"running {n} experts (one per rank)", file=sys.stderr)
        if n != spec["n_experts"]:
            print(f"# WARNING: {args.model} has {spec['n_experts']} experts "
                  f"but this mesh has {n} ranks: traffic shape is "
                  f"{n}-expert, not the named model's", file=sys.stderr)

    dtype = DTYPES[args.dtype]
    lead = tuple(t.mesh.shape)
    rng0 = np.random.default_rng(0)

    if args.routing == "topk":
        cap = R.expert_capacity(args.tokens, n, args.top_k, args.capacity_factor)
        tok_np = rng0.standard_normal(size=lead + (args.tokens, args.d_model),
                                      dtype=np.float32)
        log_np = rng0.standard_normal(size=lead + (args.tokens, n), dtype=np.float32)
        x = (t.shard(tok_np, dtype), t.shard(log_np))
        topk_step = moe_topk_step(t, args.algo, args.expert_compute, n, cap, args.top_k)

        def step(tokens, logits):
            return topk_step(tokens, logits)[0]

        out0, keep = topk_step(*x)
        stats = R.route_stats(keep)
        print(f"# topk routing: top_k={args.top_k} capacity={cap} "
              f"({args.capacity_factor}x): {stats['dropped']}/"
              f"{stats['routed']} dropped ({100 * stats['drop_rate']:.1f}%)",
              file=sys.stderr)
        if not args.expert_compute and stats["dropped"] == 0:
            # no drops + identity experts: the gates sum to 1 per token, so
            # the layer output is the input, to the token dtype's precision
            tol = 1e-4 if dtype.itemsize >= 4 else 5e-2
            np.testing.assert_allclose(out0.float().cpu().numpy(),
                                       x[0].float().cpu().numpy(), rtol=tol, atol=tol)
        del out0, keep
    else:
        cap = max(1, args.tokens // n)  # uniform: tokens/rank/expert
        x_np = rng0.standard_normal(size=lead + (n, cap, args.d_model), dtype=np.float32)
        x = (t.shard(x_np, dtype),)
        step = moe_step(t, args.algo, args.expert_compute)
        # without compute, combine(dispatch(x)) is the identity
        if not args.expert_compute:
            np.testing.assert_allclose(step(*x).float().cpu().numpy(),
                                       x[0].float().cpu().numpy(), rtol=1e-5, atol=1e-6)

    out = step(*x)
    _replay._sync(t.device)
    spans = []
    for _ in range(args.repeats):
        t0 = time.perf_counter()
        for _ in range(args.iters):
            out = step(*x)
        _replay._sync(t.device)
        spans.append((time.perf_counter() - t0) / args.iters)
    mean_s = trimmed_mean(spans)

    per_rank_bytes = n * cap * args.d_model * dtype.itemsize
    # uniform: the step is 2 bare alltoalls, so step/2 is alltoall time.
    # topk: the step also routes, so the record keeps the full layer time
    # under its own op name
    collective, sec = (("alltoall", mean_s / 2.0) if args.routing == "uniform"
                       else ("moe_layer", mean_s))
    rec = M.BenchRecord.measure(
        "moe", collective, args.algo, n, per_rank_bytes, args.dtype, sec,
        platform=topo.platform, tokens=args.tokens, d_model=args.d_model,
        capacity=cap, routing=args.routing, expert_compute=args.expert_compute,
        step_ms=mean_s * 1e3, device=topo.device_name)
    if args.out:
        with open(args.out, "a") as fp:
            rec.write(fp)
    print(M.format_table([rec]))
    print(f"#   full dispatch+combine step: {mean_s * 1e3:.3f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
