"""Mixed-radix halving-doubling ("khd"): the ring family's wire bytes with
a radix-wide fold per round, for any rank count.

Counterpart of ``rocnrdma_tpu/collectives/khd.py``. Digits
``(d_0, ..., d_L-1)`` multiply to n; rank r's t-th digit is
``(r // s_t) % d_t`` (``schedule.khd_strides``). Reduce-scatter round t
splits each rank's segment into ``d_t`` parts: the rank keeps the part of
its own digit and folds in, for offsets o = 1 .. d_t - 1 in turn, the copy
of that part held by the group member whose digit is its own minus o (the
one that sends to it along rotation +o, ``schedule.khd_perm``). Allgather
reverses the rounds. Where the reference moves parts with
``lax.ppermute``, a rank here reads its group members' rows of the same
range directly; a round writes each rank's kept part (or, in allgather,
its members' parts) and reads only ranges no rank writes in that round, so
rows update in place.

``bidir`` (the registered form): in substep o the reference ships each
part's first half along +o and its second half along -o, except where
``_split_offset`` says the split is void. The second half then comes from
the member whose digit is its own plus o, which changes the fold order;
the port folds each half from the rank the reference's routing names, so
fp32 results equal the reference's bit for bit. The allgather rounds only
copy, and every part comes from its owner whichever rotation carries it,
so they copy each part in one piece.

``khd2d_*``: digits are the 2-D mesh shape ``(slices, per_slice)`` and
round t rotates within mesh axis t only. With ranks flattened as
``s * per_slice + i`` that is exactly the flat schedule with those digits.

The Transport's ``khd`` arm without ``digits`` runs ``khd_digits(n)``
(largest radix first, at most 8): the reference's cost-model radix waits
for the tuner's port.
"""

from __future__ import annotations

import math

import torch

from rocnrdma_tpu_torch.collectives.reduce_op import finalize, fold_
from rocnrdma_tpu_torch.collectives.schedule import khd_digits, khd_strides


def _split_offset(bidir: bool, d: int, part: int, o: int) -> bool:
    """Does substep ``o`` of a radix-``d`` round split across the two
    rotations? Not when unidirectional, for d = 2 (the pair exchange is
    symmetric already), for a 1-element part, or at ``o = d/2``, where the
    +o and -o rotations are the same permutation."""
    return bidir and d > 2 and part >= 2 and 2 * o != d


def _resolve_digits(n: int, digits, max_radix: int) -> tuple[int, ...]:
    digits = khd_digits(n, max_radix) if digits is None else tuple(int(d) for d in digits)
    prod = math.prod(digits)
    if prod != n:
        raise ValueError(f"digits {digits} multiply to {prod}, axis has {n}")
    return digits


class _Digits:
    """Rank r's digits and the rank of its round-t group member of digit j."""

    def __init__(self, n: int, digits: tuple):
        self.strides = khd_strides(digits)
        self.digits = digits
        self.of = [[(r // s) % d for s, d in zip(self.strides, digits)]
                   for r in range(n)]

    def member(self, r: int, t: int, j: int) -> int:
        return r + (j % self.digits[t] - self.of[r][t]) * self.strides[t]


def _rs_phase(x: torch.Tensor, op: str, digits: tuple, bidir: bool):
    """The reduce-scatter rounds on a fresh zero-padded (n, n*chunk) copy of
    ``x``. Returns (buf, seg, chunk): rank r's fully reduced chunk starts at
    element ``seg[r]`` of its row (which is r*chunk)."""
    n = x.shape[0]
    flat = x.reshape(n, -1)
    size = flat.shape[1]
    chunk = -(-size // n)
    buf = flat.new_zeros((n, n * chunk))
    buf[:, :size] = flat
    dg = _Digits(n, digits)
    seg = [0] * n
    P = 1
    for t, d in enumerate(digits):
        P *= d
        part = (n // P) * chunk
        h1 = part // 2
        seg = [seg[r] + dg.of[r][t] * part for r in range(n)]  # kept part
        for r in range(n):
            k, j = seg[r], dg.of[r][t]
            kept = buf[r, k:k + part]
            for o in range(1, d):
                fwd = dg.member(r, t, j - o)  # sends to r along +o
                if not _split_offset(bidir, d, part, o):
                    fold_(kept, buf[fwd, k:k + part], op)
                else:
                    bwd = dg.member(r, t, j + o)  # second halves ride -o
                    fold_(kept[:h1], buf[fwd, k:k + h1], op)
                    fold_(kept[h1:], buf[bwd, k + h1:k + part], op)
    return buf, seg, chunk


def _ag_phase(buf: torch.Tensor, seg: list, chunk: int, digits: tuple) -> torch.Tensor:
    """The allgather rounds, reversed: each rank copies in its group
    members' parts from their rows."""
    n = buf.shape[0]
    dg = _Digits(n, digits)
    P = n
    for t in range(len(digits) - 1, -1, -1):
        d = digits[t]
        part = (n // P) * chunk
        base = [seg[r] - dg.of[r][t] * part for r in range(n)]
        for r in range(n):
            for j in range(d):
                if j != dg.of[r][t]:
                    q = dg.member(r, t, j)
                    st = base[r] + j * part  # q's own part
                    buf[r, st:st + part] = buf[q, st:st + part]
        seg = base
        P //= d
    return buf


def khd_allreduce(x: torch.Tensor, op: str = "sum", digits=None,
                  max_radix: int = 8, bidir: bool = False) -> torch.Tensor:
    """Allreduce of rank-major ``x`` by mixed-radix halving-doubling
    (``op``: sum/prod/max/min/avg). ``digits``: explicit round radices
    (they must multiply to n); default ``khd_digits(n, max_radix)``."""
    n = x.shape[0]
    if n == 1:
        return finalize(x.clone(), op, 1)
    digits = _resolve_digits(n, digits, max_radix)
    size = x[0].numel()
    buf, seg, chunk = _rs_phase(x, op, digits, bidir)
    buf = _ag_phase(buf, seg, chunk, digits)
    return finalize(buf[:, :size].reshape(x.shape), op, n)


def khd_reduce_scatter(x: torch.Tensor, op: str = "sum", digits=None,
                       max_radix: int = 8, bidir: bool = True) -> torch.Tensor:
    """The reduce-scatter rounds standalone: (n, S) -> (n, S/n), row r the
    fully reduced chunk r (the mixed-radix segment start of rank r is r)."""
    n = x.shape[0]
    flat = x.reshape(n, -1)
    if flat.shape[1] % n:
        raise ValueError(f"reduce_scatter needs size divisible by {n} ranks, "
                         f"got {flat.shape[1]}")
    if n == 1:
        return finalize(flat.clone(), op, 1)
    digits = _resolve_digits(n, digits, max_radix)
    buf, seg, chunk = _rs_phase(x, op, digits, bidir)
    out = torch.stack([buf[r, seg[r]:seg[r] + chunk] for r in range(n)])
    return finalize(out, op, n)


def khd_allgather(x: torch.Tensor, digits=None, max_radix: int = 8,
                  bidir: bool = True) -> torch.Tensor:
    """The allgather rounds standalone (recursive multiplying): (n, c) ->
    (n, n, c), every row the rank-ordered concatenation. ``bidir`` changes
    only which rotation carries a part, not what lands."""
    n = x.shape[0]
    flat = x.reshape(n, -1)
    if n == 1:
        return flat.unsqueeze(1).clone()
    digits = _resolve_digits(n, digits, max_radix)
    chunk = flat.shape[1]
    # seed: my chunk at my mixed-radix position, my flat rank x chunk
    buf = flat.new_zeros((n, n, chunk))
    r = torch.arange(n, device=x.device)
    buf[r, r] = flat
    buf = _ag_phase(buf.reshape(n, n * chunk), [q * chunk for q in range(n)],
                    chunk, digits)
    return buf.reshape(n, n, chunk)


def khd2d_allreduce(x: torch.Tensor, mesh_shape, op: str = "sum",
                    bidir: bool = True) -> torch.Tensor:
    """khd over a 2-D mesh: digits = the mesh shape, round t within mesh
    axis t. ``x``: rank-major over the flattened mesh (s * per_slice + i)."""
    return khd_allreduce(x, op=op, digits=tuple(mesh_shape), bidir=bidir)


def khd2d_reduce_scatter(x: torch.Tensor, mesh_shape, op: str = "sum",
                         bidir: bool = True) -> torch.Tensor:
    """The khd2d reduce-scatter rounds standalone: (n, S) -> (n, S/n)."""
    return khd_reduce_scatter(x, op=op, digits=tuple(mesh_shape), bidir=bidir)


def khd2d_allgather(x: torch.Tensor, mesh_shape, bidir: bool = True) -> torch.Tensor:
    """The khd2d allgather rounds standalone: (n, c) -> (n, n, c)."""
    return khd_allgather(x, digits=tuple(mesh_shape), bidir=bidir)
