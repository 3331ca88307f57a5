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

Across processes (a launcher's environment, ``cli_common``), each
process is one rank and one expert of ``rank_mesh(N, group=WORLD)``: the
inputs are drawn whole from ``default_rng(0)`` as one process draws them
and each rank keeps its row, which routes as that row of the whole. The
checks are agreed (one rank's failure fails every rank, naming it), each
repeat starts after a barrier and the step time is the maximum over the
ranks; rank 0 alone prints and writes ``--out``. ``--check-plain`` holds
a ``cuda_ring`` layer's output to the same layer over every rank's rows
with the alltoall kernel's plain version, bitwise.

Usage::

    python -m rocnrdma_tpu_torch.workloads.moe --fake-devices 8 --tokens 512 --d-model 256
    python -m rocnrdma_tpu_torch.workloads.moe --model mixtral-8x7b --routing topk \\
        --tokens 4096 --fake-devices 8 --algo cuda_ring
    torchrun --nproc-per-node 4 -m rocnrdma_tpu_torch.workloads.moe \\
        --model mixtral-8x7b --routing topk --tokens 4096 --algo cuda_ring --check-plain
"""

from __future__ import annotations

import argparse
import math
import sys

import numpy as np
import torch

from rocnrdma_tpu_torch import metrics as M
from rocnrdma_tpu_torch.bench import cli_common
from rocnrdma_tpu_torch.bench.runner import DTYPES
from rocnrdma_tpu_torch.bench.timing import agree, fleet_sum
from rocnrdma_tpu_torch.ops import alltoall_cuda
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
    return uniform_layer(t.jit_fn("alltoall", algo), expert_compute)


def uniform_layer(a2a, expert_compute: bool):
    """``moe_step``'s step over the alltoall ``a2a`` (rank-major in, out)."""
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
    return topk_layer(t.jit_fn("alltoall", algo), expert_compute, n_experts, cap,
                      top_k, expert)


def topk_layer(a2a, expert_compute: bool, n_experts: int, cap: int, top_k: int,
               expert=None):
    """``moe_topk_step``'s layer over the alltoall ``a2a``."""
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
    p.add_argument("--check-plain", action="store_true",
                   help="--algo cuda_ring: hold the layer's output to the same "
                        "layer with the alltoall kernel's plain version, bitwise")
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

    # under a launcher's fleet the mesh is the world's, one expert a rank;
    # the model's expert count sets the ranks of one process's mesh only
    model_ranks = spec["n_experts"] if spec and args.mesh2d is None else None
    topo = cli_common.setup_backend(args.fake_devices, args.platform,
                                    args.ranks or model_ranks, across=True)
    t = Transport(cli_common.build_mesh(
        args.mesh2d, args.ranks or (None if cli_common.joined() else model_ranks), topo))
    n, span, lead = t.n_ranks, t.span, cli_common.is_lead()
    rows = math.prod(t.mesh.local_shape)  # the ranks this process holds
    first = 0 if span is None else span.index * rows
    if spec and lead:
        print(f"# {args.model}: d_model={args.d_model}, top_k={spec['top_k']}, "
              f"running {n} experts (one per rank)", file=sys.stderr)
        if n != spec["n_experts"]:
            print(f"# WARNING: {args.model} has {spec['n_experts']} experts "
                  f"but this mesh has {n} ranks: traffic shape is "
                  f"{n}-expert, not the named model's", file=sys.stderr)

    dtype = DTYPES[args.dtype]
    whole = tuple(t.mesh.shape)
    rng0 = np.random.default_rng(0)

    if args.routing == "topk":
        cap = R.expert_capacity(args.tokens, n, args.top_k, args.capacity_factor)
        tok_np = rng0.standard_normal(size=whole + (args.tokens, args.d_model),
                                      dtype=np.float32)
        log_np = rng0.standard_normal(size=whole + (args.tokens, n), dtype=np.float32)
        x = (t.shard(tok_np, dtype), t.shard(log_np))
        topk_step = moe_topk_step(t, args.algo, args.expert_compute, n, cap, args.top_k)

        def step(tokens, logits):
            return topk_step(tokens, logits)[0]

        out0, keep = topk_step(*x)
        stats = fleet_route_stats(keep, span)
        if lead:
            print(f"# topk routing: top_k={args.top_k} capacity={cap} "
                  f"({args.capacity_factor}x): {stats['dropped']}/"
                  f"{stats['routed']} dropped ({100 * stats['drop_rate']:.1f}%)",
                  file=sys.stderr)
        if not args.expert_compute and stats["dropped"] == 0:
            # no drops + identity experts: the gates sum to 1 per token, so
            # the layer output is the input, to the token dtype's precision
            tol = 1e-4 if dtype.itemsize >= 4 else 5e-2
            agree(span, identity_error(out0, x[0], tol, tol), "moe topk identity")
        del out0, keep
        whole_np = (tok_np, log_np)

        def plain_layer(tokens, logits):
            return topk_layer(alltoall_cuda.alltoall_plain, args.expert_compute, n, cap,
                              args.top_k)(tokens, logits)[0]
    else:
        cap = max(1, args.tokens // n)  # uniform: tokens/rank/expert
        x_np = rng0.standard_normal(size=whole + (n, cap, args.d_model), dtype=np.float32)
        x = (t.shard(x_np, dtype),)
        step = moe_step(t, args.algo, args.expert_compute)
        # without compute, combine(dispatch(x)) is the identity
        if not args.expert_compute:
            agree(span, identity_error(step(*x), x[0], 1e-5, 1e-6),
                  "moe uniform identity")
        whole_np = (x_np,)
        plain_layer = uniform_layer(alltoall_cuda.alltoall_plain, args.expert_compute)

    before = _replay.launch_counts(t.device)
    step(*x)  # warm
    _replay._sync(t.device)

    def run():
        for _ in range(args.iters):
            y = step(*x)
        _replay._sync(t.device)
        return [y]
    last = []
    mean_s = _replay.timed(run, args.repeats, last, span) / args.iters
    extra = _replay.launched(t.device, before)
    if args.check_plain and args.algo == "cuda_ring":
        # the same layer over every rank's rows, its alltoall the kernel's
        # plain version, on this device: this process's rows bitwise (the
        # tokens in the sweep dtype, the logits float32, as ``x``)
        want = plain_layer(*(torch.from_numpy(a).to(t.device).to(
            dtype if i == 0 else torch.float32) for i, a in enumerate(whole_np)))
        extra["plain_max_abs_err"] = _replay.check_plain(
            t, last, [want.reshape(n, -1)[first:first + rows].cpu()],
            f"moe {args.routing}/{args.algo}")
        del want
    del last, whole_np

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
        step_ms=mean_s * 1e3, device=topo.device_name,
        **cli_common.link_extra(topo, span, n), **extra)
    if not lead:
        return 0
    if args.out:
        with open(args.out, "a") as fp:
            rec.write(fp)
    print(M.format_table([rec]))
    print(f"#   full dispatch+combine step: {mean_s * 1e3:.3f} ms")
    return 0


def identity_error(got: torch.Tensor, want: torch.Tensor, rtol: float,
                   atol: float) -> str | None:
    """Why ``got`` is not ``want`` within ``rtol``/``atol``, or None: the
    layer's identity check, agreed across the fleet by its caller."""
    try:
        np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                                   rtol=rtol, atol=atol)
    except AssertionError as e:
        return str(e)
    return None


def fleet_route_stats(keep: torch.Tensor, span) -> dict:
    """``routing.route_stats`` over every rank's ``keep``: this process's
    alone, or across processes the sums over the ranks of ``span``."""
    stats = R.route_stats(keep)
    if span is None:
        return stats
    routed, kept = (int(v) for v in fleet_sum([stats["routed"], stats["kept"]], span))
    return {"routed": routed, "kept": kept, "dropped": routed - kept,
            "drop_rate": (routed - kept) / routed if routed else 0.0}


if __name__ == "__main__":
    sys.exit(cli_common.main(main))
