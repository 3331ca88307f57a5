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
range directly; a round writes each rank's kept part (or, in allgather, its
members' parts) and reads only ranges no rank writes in that round, so rows
update in place.

``bidir`` (the registered form): in substep o the reference ships each
part's first half along +o and its second half along -o, except where
``_split_offset`` says the split is void. The second half then comes from
the member whose digit is its own plus o, which changes the fold order;
the port folds each half from the rank the reference's routing names, so
fp32 results equal the reference's bit for bit. The allgather rounds only
copy, and every part comes from its owner whichever rotation carries it;
they copy each half along the rotation the reference names, so that each
of the reference's permutes is one step span here too.

``khd2d_*``: digits are the 2-D mesh shape ``(slices, per_slice)`` and
round t rotates within mesh axis t only. With ranks flattened as
``s * per_slice + i`` that is exactly the flat schedule with those digits.

Across processes (``span``, the ``ProcessSpan`` of a mesh whose leading
axis is the process boundary), ``x`` is this process's rows: on a 1-D
mesh (one rank a process) its one row, and every round's groups cross
processes; on khd2d's 2-D mesh slice ``span.index``'s per_slice rows, and
round 0 (the slice axis, stride per_slice) is the only round that
crosses. The crossing rounds lead, so in each of their permutes every
rank of a process reads the same range of its member's row (a
reduce-scatter reads at the reader's kept part, an allgather the member's
own part), which every rank can compute: the sender ships that range of
all its rows to the process that reads it, one
``_exchange.permute_rows`` a permute, and the receiver folds or copies it
exactly where the one-process schedule reads the member's row. The other
rounds stay in the process. The folds are the one-process schedule's, in
its substep order, so results are its bits.

A call without ``digits`` runs ``khd_digits(n)`` (largest radix first, at
most 8); the Transport's verbs pass the radix ladder's pick
(``Transport.khd_model_digits``), as the reference's do.
"""

from __future__ import annotations

import math

import torch

from rocnrdma_tpu_torch.collectives._exchange import permute_rows
from rocnrdma_tpu_torch.collectives._steps import step_span
from rocnrdma_tpu_torch.collectives.reduce_op import finalize, fold_
from rocnrdma_tpu_torch.collectives.schedule import khd_digits, khd_strides


def _split_offset(bidir: bool, d: int, part: int, o: int) -> bool:
    """Does substep ``o`` of a radix-``d`` round split across the two
    rotations? Not when unidirectional, for d = 2 (the pair exchange is
    symmetric already), for a 1-element part, or at ``o = d/2``, where the
    +o and -o rotations are the same permutation."""
    return bidir and d > 2 and part >= 2 and 2 * o != d


def _substeps(bidir: bool, d: int, part: int, t: int, o: int) -> list:
    """The reference's permutes of substep ``o`` of round ``t``, as
    ``(lo, hi, rotation, name)``: the range of a part each moves and the
    digit offset of the member it comes from. One permute, the whole part
    from the member o below (+o); or, where the split is real, two: the
    first half from the member o below, the second from the member o above
    (-o)."""
    if not _split_offset(bidir, d, part, o):
        return [(0, part, -o, f"r{t} o{o}")]
    h1 = part // 2
    return [(0, h1, -o, f"r{t} o{o}+"), (h1, part, o, f"r{t} o{d - o}-")]


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


def _layout(rows: int, digits: tuple, span) -> tuple[range, int]:
    """``(held, cross)``: the flat ranks whose rows this process holds and
    how many leading rounds cross processes. In one process every rank
    and none. Across processes with one rank a process, rank
    ``span.index`` and every round; else slice ``span.index``'s rows and
    round 0 (``digits[0]`` must be the span's slices, the other digits
    its rows)."""
    if span is None:
        return range(rows), 0
    if rows == 1 and math.prod(digits) == span.size:
        return range(span.index, span.index + 1), len(digits)
    if digits[0] != span.size or math.prod(digits[1:]) != rows:
        raise ValueError(f"across processes round 0 is the {span.size} slices "
                         f"and the other rounds the {rows} rows held here; "
                         f"got digits {digits}")
    return range(span.index * rows, (span.index + 1) * rows), 1


def _proc_pairs(dg: _Digits, t: int, rot: int, rows: int, procs: int) -> list:
    """The (src, dst) processes of a crossing round's permute: process s's
    rows read from their members ``rot`` digits above, all in one
    process."""
    return [(dg.member(s * rows, t, dg.of[s * rows][t] + rot) // rows, s)
            for s in range(procs)]


def _crossing(buf: torch.Tensor, lo: int, hi: int, pairs, span) -> torch.Tensor:
    """A crossing permute: every held row's range ``lo .. hi`` goes to this
    process's destination in ``pairs``, and the range its source sent
    comes back, (rows, hi - lo)."""
    return permute_rows(buf[None, :, lo:hi], pairs, span)[0]


def _rs_phase(x: torch.Tensor, op: str, digits: tuple, bidir: bool, span=None):
    """The reduce-scatter rounds on a fresh zero-padded (rows, n*chunk)
    copy of ``x``. Returns (buf, seg, chunk): rank r's fully reduced chunk
    starts at element ``seg[r]`` of its row (which is r*chunk). Loops run
    step-outer, rank-inner, one step span per permute of the reference (a
    split offset is two: +o, then -o); each rank still folds its offsets
    in the reference's order, and a round reads only ranges no rank writes
    in it, so the result does not depend on the loop order. With ``span``
    the rows are this process's (module docstring)."""
    rows = x.shape[0]
    held, cross = _layout(rows, digits, span)
    n = math.prod(digits)
    flat = x.reshape(rows, -1)
    size = flat.shape[1]
    chunk = -(-size // n)
    buf = flat.new_zeros((rows, n * chunk))
    buf[:, :size] = flat
    dg = _Digits(n, digits)
    row = buf.unbind(0)  # one view per rank, sliced per step
    r0 = held[0]  # the first held rank: row r - r0 is rank r's
    seg = [0] * n
    P = 1
    for t, d in enumerate(digits):
        P *= d
        part = (n // P) * chunk
        seg = [seg[r] + dg.of[r][t] * part for r in range(n)]  # kept part
        for o in range(1, d):
            for lo, hi, rot, name in _substeps(bidir, d, part, t, o):
                with step_span(f"khd rs {name}"):
                    if t < cross:
                        # the reader reads at its own kept part
                        pairs = _proc_pairs(dg, t, rot, rows, span.size)
                        at = seg[rows * next(q for p, q in pairs if p == span.index)]
                        k = seg[r0]
                        fold_(buf[:, k + lo:k + hi],
                              _crossing(buf, at + lo, at + hi, pairs, span), op)
                        continue
                    for r in held:
                        k = seg[r]
                        src = dg.member(r, t, dg.of[r][t] + rot)
                        fold_(row[r - r0][k + lo:k + hi],
                              row[src - r0][k + lo:k + hi], op)
    return buf, seg, chunk


def _ag_phase(buf: torch.Tensor, seg: list, chunk: int, digits: tuple,
              bidir: bool, span=None) -> torch.Tensor:
    """The allgather rounds, reversed: each rank copies in its group
    members' parts from their rows, one step span per permute of the
    reference. In substep o a part's first half comes from the member o
    below along +o and, where the split is real, its second half from the
    member o above along -o; over the substeps every member's part lands
    whole. The rounds only copy, and a rank's own part is never written in
    its round, so the loop order changes no bit. A substep's n copies are
    one ``_foreach_copy_``: copied by halves one at a time, a radix-8 round
    would launch 13 n copies where a whole-part round launches 7 n. With
    ``span`` the rows are this process's (module docstring)."""
    rows = buf.shape[0]
    held, cross = _layout(rows, digits, span)
    n = math.prod(digits)
    dg = _Digits(n, digits)
    row = buf.unbind(0)
    r0 = held[0]
    P = n
    for t in range(len(digits) - 1, -1, -1):
        d = digits[t]
        part = (n // P) * chunk
        base = [seg[r] - dg.of[r][t] * part for r in range(n)]
        for o in range(1, d):
            for lo, hi, rot, name in _substeps(bidir, d, part, t, o):
                if t < cross:
                    # every held rank ships its own part; the member rot
                    # above's own part lands
                    own = base[r0] + dg.of[r0][t] * part
                    st = base[r0] + ((dg.of[r0][t] + rot) % d) * part
                    pairs = _proc_pairs(dg, t, rot, rows, span.size)
                    with step_span(f"khd ag {name}"):
                        buf[:, st + lo:st + hi] = _crossing(buf, own + lo, own + hi,
                                                            pairs, span)
                    continue
                dst, src = [], []
                for r in held:
                    j = dg.of[r][t] + rot
                    q = dg.member(r, t, j)
                    st = base[r] + (j % d) * part  # q's own part
                    dst.append(row[r - r0][st + lo:st + hi])
                    src.append(row[q - r0][st + lo:st + hi])
                with step_span(f"khd ag {name}"):
                    torch._foreach_copy_(dst, src)
        seg = base
        P //= d
    return buf


def _axis_ranks(x: torch.Tensor, span) -> int:
    """The ranks of the axis: the rows of ``x``, or, across processes,
    every process's (module docstring)."""
    return x.shape[0] * (1 if span is None else span.size)


def khd_allreduce(x: torch.Tensor, op: str = "sum", digits=None,
                  max_radix: int = 8, bidir: bool = False, *,
                  span=None) -> torch.Tensor:
    """Allreduce of rank-major ``x`` by mixed-radix halving-doubling
    (``op``: sum/prod/max/min/avg). ``digits``: explicit round radices
    (they must multiply to n); default ``khd_digits(n, max_radix)``.
    ``span``: the mesh's leading axis across processes (module
    docstring)."""
    n = _axis_ranks(x, span)
    if n == 1:
        return finalize(x.clone(), op, 1)
    digits = _resolve_digits(n, digits, max_radix)
    size = x[0].numel()
    buf, seg, chunk = _rs_phase(x, op, digits, bidir, span)
    buf = _ag_phase(buf, seg, chunk, digits, bidir, span)
    return finalize(buf[:, :size].reshape(x.shape), op, n)


def khd_reduce_scatter(x: torch.Tensor, op: str = "sum", digits=None,
                       max_radix: int = 8, bidir: bool = True, *,
                       span=None) -> torch.Tensor:
    """The reduce-scatter rounds standalone: (n, S) -> (n, S/n), row r the
    fully reduced chunk r (the mixed-radix segment start of rank r is r).
    ``span``: as in ``khd_allreduce``; the result is the held rows'."""
    n = _axis_ranks(x, span)
    flat = x.reshape(x.shape[0], -1)
    if flat.shape[1] % n:
        raise ValueError(f"reduce_scatter needs size divisible by {n} ranks, "
                         f"got {flat.shape[1]}")
    if n == 1:
        return finalize(flat.clone(), op, 1)
    digits = _resolve_digits(n, digits, max_radix)
    buf, seg, chunk = _rs_phase(x, op, digits, bidir, span)
    held, _ = _layout(x.shape[0], digits, span)
    out = torch.stack([buf[r - held[0], seg[r]:seg[r] + chunk] for r in held])
    return finalize(out, op, n)


def khd_allgather(x: torch.Tensor, digits=None, max_radix: int = 8,
                  bidir: bool = True, *, span=None) -> torch.Tensor:
    """The allgather rounds standalone (recursive multiplying): (n, c) ->
    (n, n, c), every row the rank-ordered concatenation. ``bidir`` changes
    only which rotation carries a part, not what lands. ``span``: as in
    ``khd_allreduce``; the result is the held rows'."""
    rows = x.shape[0]
    n = _axis_ranks(x, span)
    flat = x.reshape(rows, -1)
    if n == 1:
        return flat.unsqueeze(1).clone()
    digits = _resolve_digits(n, digits, max_radix)
    chunk = flat.shape[1]
    # seed: my chunk at my mixed-radix position, my flat rank x chunk
    buf = flat.new_zeros((rows, n, chunk))
    held = torch.tensor(_layout(rows, digits, span)[0], device=x.device)
    buf[torch.arange(rows, device=x.device), held] = flat
    buf = _ag_phase(buf.reshape(rows, n * chunk), [q * chunk for q in range(n)],
                    chunk, digits, bidir, span)
    return buf.reshape(rows, n, chunk)


def khd2d_allreduce(x: torch.Tensor, mesh_shape, op: str = "sum",
                    bidir: bool = True, span=None) -> torch.Tensor:
    """khd over a 2-D mesh: digits = the mesh shape, round t within mesh
    axis t. ``x``: rank-major over the flattened mesh (s * per_slice + i);
    with ``span``, this process's per_slice rows."""
    return khd_allreduce(x, op=op, digits=tuple(mesh_shape), bidir=bidir,
                         span=span)


def khd2d_reduce_scatter(x: torch.Tensor, mesh_shape, op: str = "sum",
                         bidir: bool = True, span=None) -> torch.Tensor:
    """The khd2d reduce-scatter rounds standalone: (n, S) -> (n, S/n)."""
    return khd_reduce_scatter(x, op=op, digits=tuple(mesh_shape), bidir=bidir,
                              span=span)


def khd2d_allgather(x: torch.Tensor, mesh_shape, bidir: bool = True,
                    span=None) -> torch.Tensor:
    """The khd2d allgather rounds standalone: (n, c) -> (n, n, c)."""
    return khd_allgather(x, digits=tuple(mesh_shape), bidir=bidir, span=span)
