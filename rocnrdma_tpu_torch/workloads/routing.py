"""Top-k MoE routing with a static capacity: the dense dispatch.

Counterpart of ``rocnrdma_tpu/workloads/routing.py``. Each expert has a
fixed capacity ``C = ceil(T * top_k / E * capacity_factor)``; tokens routed
past an expert's capacity are dropped (their combine weight is zero), the
Switch-Transformer/GShard discipline.

Layout: one expert per EP rank, so the dispatch tensor ``(E, C, d)`` is
the alltoall input (chunk e -> rank e). Every function also takes leading
batch dims (the rank axis of a rank-major tensor): where the reference
``jax.vmap``s the routing over the mesh, the port runs it as batched tensor
ops over those dims, each batch row routed on its own.

Integer outputs (experts, positions, keep) and the dispatch tensor equal
the reference's bit for bit; the gates are a softmax, within float
rounding of it.
"""

from __future__ import annotations

import math

import torch


def expert_capacity(tokens: int, n_experts: int, top_k: int,
                    capacity_factor: float) -> int:
    """The static per-expert slot count."""
    return max(1, int(-(-tokens * top_k * capacity_factor // n_experts)))


def topk_route(logits: torch.Tensor, top_k: int):
    """Route each token to its top-k experts.

    ``logits``: ``(..., T, E)``. Returns ``(gates, experts)``, both
    ``(..., T, k)``: softmax-renormalized combine weights over the chosen
    experts, and the expert ids (int32), highest logit first, in
    ``jax.lax.top_k``'s order: the float32 values totally ordered (-0.0
    below +0.0), ties to the lower expert id. ``torch.topk`` promises no
    order among equal values and ranks -0.0 with +0.0, so the ids come from
    a stable descending sort of the logits' bits mapped to order-keeping
    ints."""
    bits = logits.float().contiguous().view(torch.int32)
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    experts = torch.sort(key, dim=-1, descending=True, stable=True)[1][..., :top_k]
    gates = torch.softmax(torch.gather(logits, -1, experts), dim=-1)
    return gates, experts.to(torch.int32)


def dispatch_mask(experts: torch.Tensor, n_experts: int, capacity: int):
    """Position bookkeeping for the static dispatch.

    ``experts``: ``(..., T, k)`` expert ids in routing priority order
    (row-major: token order breaks ties, GShard's position-in-expert rule).
    Returns ``(pos, keep)``, both ``(..., T, k)``: each entry's slot within
    its expert (int32), and whether it fits under ``capacity``."""
    lead, (T, k) = experts.shape[:-2], experts.shape[-2:]
    flat = experts.reshape(lead + (T * k,)).long()
    onehot = torch.nn.functional.one_hot(flat, n_experts).to(torch.int32)  # (..., T*k, E)
    # slot = how many earlier entries chose the same expert
    pos_flat = (torch.cumsum(onehot, dim=-2, dtype=torch.int32) - 1) * onehot
    pos = pos_flat.sum(dim=-1, dtype=torch.int32).reshape(experts.shape)
    return pos, pos < capacity


def _tables(experts, pos, keep):
    """The routing tables flattened to ``(B, T*k)``: experts, positions
    with dropped entries at slot 0, keep; and the batch index."""
    T, k = experts.shape[-2:]
    B = math.prod(experts.shape[:-2])
    e = experts.reshape(B, T * k).long()
    m = keep.reshape(B, T * k)
    p = torch.where(m, pos.reshape(B, T * k), 0).long()
    b = torch.arange(B, device=experts.device)[:, None]
    return e, p, m, b


def _build_dispatch_impl(x, experts, pos, keep, n_experts, capacity):
    """Forward of ``build_dispatch``: a small scatter builds the inverse
    permutation (slot (e, p) <- flat entry index), then the payload moves
    in one gather. The reference sends dropped entries to distinct
    out-of-bounds slots that its scatter drops; torch's scatter raises on
    those, so here they land in one spare slot past the capacity, cut off
    before the gather (every kept entry owns a distinct slot)."""
    lead, (T, k) = experts.shape[:-2], experts.shape[-2:]
    d = x.shape[-1]
    e, _, m, b = _tables(experts, pos, keep)
    B = e.shape[0]
    slot = torch.where(m, pos.reshape(B, T * k).long(), capacity)
    src = torch.full((B, n_experts, capacity + 1), -1, dtype=torch.long, device=x.device)
    entry = torch.arange(T * k, device=x.device).expand(B, T * k)
    src[b, e, slot] = entry
    src = src[:, :, :capacity]
    # flat entry i carries token i // k (row-major routing priority)
    tok = (src // k if k > 1 else src).clamp(min=0)
    rows = x.reshape(B, T, d)[b[:, :, None], tok]              # (B, E, C, d)
    out = torch.where((src >= 0)[..., None], rows, torch.zeros((), dtype=x.dtype,
                                                               device=x.device))
    return out.reshape(lead + (n_experts, capacity, d))


def _build_dispatch_bwd(experts, pos, keep, g):
    """Cotangent of ``build_dispatch`` for ``x``: token t sums its kept
    slots' upstream rows, a gather by the same (expert, pos) tables the
    forward used (never a scatter-add)."""
    lead, (T, k) = experts.shape[:-2], experts.shape[-2:]
    E, C, d = g.shape[-3:]
    e, p, m, b = _tables(experts, pos, keep)
    picked = g.reshape(-1, E, C, d)[b, e, p]                   # (B, T*k, d)
    picked = torch.where(m[..., None], picked, torch.zeros((), dtype=g.dtype,
                                                           device=g.device))
    return picked.reshape(lead + (T, k, d)).sum(dim=-2).to(g.dtype)


class _BuildDispatch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, experts, pos, keep, n_experts, capacity):
        ctx.save_for_backward(experts, pos, keep)
        return _build_dispatch_impl(x, experts, pos, keep, n_experts, capacity)

    @staticmethod
    def backward(ctx, g):
        experts, pos, keep = ctx.saved_tensors
        return _build_dispatch_bwd(experts, pos, keep, g), None, None, None, None, None


def build_dispatch(x: torch.Tensor, experts: torch.Tensor, pos: torch.Tensor,
                   keep: torch.Tensor, n_experts: int, capacity: int) -> torch.Tensor:
    """Scatter tokens ``x`` ``(..., T, d)`` into the ``(..., E, C, d)``
    dispatch tensor (dropped entries contribute nothing; unused slots stay
    zero). Differentiable in ``x``: its backward is a gather over the same
    routing tables (the reference's custom VJP), so neither direction
    moves the payload through a scatter."""
    return _BuildDispatch.apply(x, experts, pos, keep, n_experts, capacity)


def combine(expert_out: torch.Tensor, gates: torch.Tensor, experts: torch.Tensor,
            pos: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """Gather each token's surviving expert outputs back, gate-weighted:
    ``(..., E, C, d) -> (..., T, d)``. Dropped entries contribute zero."""
    lead, (T, k) = experts.shape[:-2], experts.shape[-2:]
    E, C, d = expert_out.shape[-3:]
    e, p, m, b = _tables(experts, pos, keep)
    picked = expert_out.reshape(-1, E, C, d)[b, e, p]          # (B, T*k, d)
    w = (gates * keep.to(gates.dtype)).reshape(-1, T * k, 1)
    return (picked * w.to(picked.dtype)).reshape(lead + (T, k, d)).sum(dim=-2)


def route_stats(keep: torch.Tensor) -> dict:
    """Drop-rate accounting (reads ``keep`` back to the host)."""
    total = keep.numel()
    kept = int(keep.sum())
    return {"routed": total, "kept": kept, "dropped": total - kept,
            "drop_rate": (total - kept) / total if total else 0.0}
