"""Schedule indices and their numpy simulators: ring, alltoall, sendrecv,
halving-doubling, binomial rooted trees, mixed-radix halving-doubling (khd),
the double binary tree and its chunk-pipelined form, and the hierarchical
phase list.

Copied from ``rocnrdma_tpu/collectives/schedule.py`` (the port imports
nothing of the JAX package); the tests pin these equal to the reference's.
The torch schedules in this package index with exactly these functions.

**Ring allreduce.** Each rank's buffer is split into n chunks. Phase 1,
reduce-scatter, n-1 steps: at step s rank r sends chunk ``(r - s) mod n``
to rank ``(r+1) mod n`` and adds the chunk it receives. After n-1 steps
rank r holds the fully reduced chunk ``(r + 1) mod n``. Phase 2, allgather,
n-1 steps: at step s rank r sends chunk ``(r + 1 - s) mod n``. Traffic per
rank: ``2 (n-1)/n * S``, the busbw factor in metrics.py.

**Halving-doubling allreduce** (the ``tree`` arm): log2(n) x 2 steps for a
power-of-two n. Recursive halving pairs rank r with ``r XOR mask`` for
mask = n/2, ..., 1; each pair exchanges the half of its segment the
partner keeps and folds it. Recursive doubling reverses the masks.

**Hierarchical allreduce**: on a ``('slice', 'intra')`` mesh,
reduce-scatter over intra, allreduce the shard across slices, allgather
over intra.
"""

from __future__ import annotations

import numpy as np

def ring_permutation(n: int, shift: int = 1) -> list[tuple[int, int]]:
    """The (src, dst) pairs of a rotate-by-``shift`` step."""
    return [(r, (r + shift) % n) for r in range(n)]


def ring_rs_send_chunk(n: int, step: int, rank: int) -> int:
    """Chunk index ``rank`` transmits at reduce-scatter step ``step``."""
    return (rank - step) % n


def ring_rs_recv_chunk(n: int, step: int, rank: int) -> int:
    """Chunk index ``rank`` receives (and accumulates) at RS step ``step``."""
    return (rank - step - 1) % n


def ring_owned_chunk(n: int, rank: int) -> int:
    """Chunk fully reduced on ``rank`` after the n-1 reduce-scatter steps."""
    return (rank + 1) % n


def ring_ag_send_chunk(n: int, step: int, rank: int) -> int:
    """Chunk index ``rank`` transmits at allgather step ``step``."""
    return (rank + 1 - step) % n


def ring_ag_recv_chunk(n: int, step: int, rank: int) -> int:
    return (rank - step) % n


def sim_ring_allreduce(bufs: np.ndarray) -> np.ndarray:
    """Simulate the ring schedule on a (n, n*chunk) array, one row per rank."""
    n = bufs.shape[0]
    bufs = bufs.reshape(n, n, -1).copy()  # (rank, chunk, elems)
    for step in range(n - 1):
        sent = {r: bufs[r, ring_rs_send_chunk(n, step, r)].copy() for r in range(n)}
        for src, dst in ring_permutation(n):
            bufs[dst, ring_rs_recv_chunk(n, step, dst)] += sent[src]
    for step in range(n - 1):
        sent = {r: bufs[r, ring_ag_send_chunk(n, step, r)].copy() for r in range(n)}
        for src, dst in ring_permutation(n):
            bufs[dst, ring_ag_recv_chunk(n, step, dst)] = sent[src]
    return bufs.reshape(n, -1)


def sim_sendrecv(bufs: np.ndarray, shift: int = 1) -> np.ndarray:
    """Simulate the pairwise shift exchange: out[r] = in[(r - shift) mod n]
    (every rank sends to r+shift along ``ring_permutation(n, shift)``)."""
    return np.roll(bufs, shift, axis=0)



# ---------------------------------------------------------------------------
# Halving-doubling ("tree")


def hd_masks(n: int) -> list[int]:
    """Partner XOR masks for recursive halving: [n/2, n/4, ..., 1]."""
    if n & (n - 1) or n < 1:
        raise ValueError(f"halving-doubling needs a power-of-two rank count, got {n}")
    masks = []
    m = n >> 1
    while m:
        masks.append(m)
        m >>= 1
    return masks


def hd_segment(n: int, rank: int, upto_step: int) -> tuple[int, int]:
    """(start_chunk, n_chunks) of the buffer segment ``rank`` still owns after
    ``upto_step`` halving steps, in units of 1/n-th chunks."""
    start, length = 0, n
    for mask in hd_masks(n)[:upto_step]:
        length //= 2
        if rank & mask:  # upper partner keeps the upper half
            start += length
    return start, length


# ---------------------------------------------------------------------------
# Alltoall rotation: n-1 steps; at step s every rank ships the chunk destined
# s ranks ahead along a shift-by-s ring permutation.


def a2a_send_chunk(n: int, step: int, rank: int) -> int:
    """Chunk index ``rank`` transmits at rotation step ``step`` (1-based)."""
    return (rank + step) % n


def a2a_recv_slot(n: int, step: int, rank: int) -> int:
    """Slot where ``rank`` stores the chunk received at rotation step ``step``."""
    return (rank - step) % n


def sim_alltoall(bufs: np.ndarray) -> np.ndarray:
    """Simulate the rotation alltoall on a (n, n*chunk) array: out[j, i] = in[i, j]."""
    n = bufs.shape[0]
    bufs = bufs.reshape(n, n, -1)
    out = bufs.copy()
    for step in range(1, n):
        sent = {r: bufs[r, a2a_send_chunk(n, step, r)].copy() for r in range(n)}
        for src, dst in ring_permutation(n, shift=step):
            out[dst, a2a_recv_slot(n, step, dst)] = sent[src]
    return out.reshape(n, -1)


# ---------------------------------------------------------------------------
# Hierarchical


def hierarchical_phases() -> list[tuple[str, str]]:
    """(collective, mesh_axis) phases of the 2-level allreduce."""
    return [("reducescatter", "intra"), ("allreduce", "slice"), ("allgather", "intra")]



# ---------------------------------------------------------------------------
# Simulator of halving-doubling (numpy, the unit-test oracle)


def sim_hd_allreduce(bufs: np.ndarray) -> np.ndarray:
    """Simulate halving-doubling on a (n, n*chunk) buffer array."""
    n = bufs.shape[0]
    bufs = bufs.reshape(n, n, -1).copy()
    masks = hd_masks(n)
    # recursive halving (reduce-scatter)
    for s, mask in enumerate(masks):
        sent = {}
        for r in range(n):
            start, length = hd_segment(n, r, s)
            half = length // 2
            # send the half the partner keeps
            if r & mask:  # I keep upper; send lower
                sent[r] = (start, half, bufs[r, start:start + half].copy())
            else:
                sent[r] = (start + half, half, bufs[r, start + half:start + length].copy())
        for r in range(n):
            p = r ^ mask
            st, ln, data = sent[p]
            bufs[r, st:st + ln] += data
    # recursive doubling (allgather)
    for s, mask in enumerate(reversed(masks)):
        step = len(masks) - 1 - s
        sent = {}
        for r in range(n):
            start, length = hd_segment(n, r, step + 1)
            sent[r] = (start, length, bufs[r, start:start + length].copy())
        for r in range(n):
            p = r ^ mask
            st, ln, data = sent[p]
            bufs[r, st:st + ln] = data
    return bufs.reshape(n, -1)


# ---------------------------------------------------------------------------
# Binomial rooted collectives (broadcast / reduce / gather / scatter)
#
# All four run in ceil(log2 n) steps over "virtual ranks"
# v = (rank - root) mod n, so any root reuses the root-0 schedule.
#
# **Broadcast** (recursive doubling): at step mask m = 1, 2, 4, ... the
# vranks [0, m) that already hold the data send to vrank+m; receivers are
# vranks [m, 2m). **Reduce** mirrors it with descending masks: vranks
# [m, 2m) send to vrank-m, which combines.
#
# **Gather**: buffers live in vrank slot order so every subtree is
# contiguous. At step m (ascending), vranks ≡ m (mod 2m) send their m-slot
# subtree [v, v+m) to vrank-m, which stores it at [v, v+m) — message size
# is static per step (m slots), start indices dynamic. **Scatter** reverses:
# at step m (descending), vranks ≡ 0 (mod 2m) send the upper half
# [v+m, v+2m) of their block to vrank+m. Slot buffers are padded to the next
# power of two so wrap-around subtrees stay in range (pad slots carry zeros).


def binomial_masks(n: int) -> list[int]:
    """Step masks 1, 2, 4, ... < n (any n, not just powers of two)."""
    out, m = [], 1
    while m < n:
        out.append(m)
        m <<= 1
    return out


def pow2_pad(n: int) -> int:
    """Slot-buffer length for the gather/scatter trees: n rounded up to the
    next power of two, so wrap-around subtrees stay in range. The torch
    schedules (rooted.py) and the sims below must pad identically."""
    return 1 << max(0, (n - 1).bit_length())


def bcast_pairs(n: int, mask: int, root: int = 0) -> list[tuple[int, int]]:
    """(src, dst) true-rank pairs at broadcast step ``mask`` (reduce reverses)."""
    return [((v + root) % n, (v + mask + root) % n)
            for v in range(mask) if v + mask < n]


def gather_pairs(n: int, mask: int, root: int = 0) -> list[tuple[int, int]]:
    """(src, dst) true-rank pairs at gather step ``mask`` (scatter reverses)."""
    return [((v + root) % n, (v - mask + root) % n)
            for v in range(mask, n, 2 * mask)]


def sim_binomial_broadcast(bufs: np.ndarray, root: int = 0) -> np.ndarray:
    """Simulate the recursive-doubling broadcast: every row becomes row root."""
    n = bufs.shape[0]
    bufs = bufs.copy()
    for m in binomial_masks(n):
        sent = {src: bufs[src].copy() for src, _ in bcast_pairs(n, m, root)}
        for src, dst in bcast_pairs(n, m, root):
            bufs[dst] = sent[src]
    return bufs


def sim_binomial_reduce(bufs: np.ndarray, root: int = 0) -> np.ndarray:
    """Simulate the mirrored reduce: row root = sum of all rows, others zero."""
    n = bufs.shape[0]
    bufs = bufs.astype(np.float64).copy()
    for m in reversed(binomial_masks(n)):
        pairs = [(d, s) for s, d in bcast_pairs(n, m, root)]  # reversed flow
        sent = {src: bufs[src].copy() for src, _ in pairs}
        for src, dst in pairs:
            bufs[dst] += sent[src]
    out = np.zeros_like(bufs)
    out[root] = bufs[root]
    return out


def sim_binomial_gather(bufs: np.ndarray, root: int = 0) -> np.ndarray:
    """Simulate the subtree gather on (n, chunk) rows. Returns (n, n*chunk):
    row root = all rows concatenated in true-rank order, others zero."""
    n, chunk = bufs.shape
    npad = pow2_pad(n)
    slot = np.zeros((n, npad, chunk), bufs.dtype)  # [holder, vrank slot, elems]
    for r in range(n):
        slot[r, (r - root) % n] = bufs[r]
    for m in binomial_masks(n):
        sent = {src: slot[src, (((src - root) % n)):((src - root) % n) + m].copy()
                for src, _ in gather_pairs(n, m, root)}
        for src, dst in gather_pairs(n, m, root):
            v = (src - root) % n
            slot[dst, v:v + m] = sent[src]
    out = np.zeros((n, n * chunk), bufs.dtype)
    # vrank slot v holds true rank (v + root) mod n; reorder to true-rank order
    order = [(t - root) % n for t in range(n)]
    out[root] = slot[root, order].reshape(-1)
    return out


def sim_binomial_scatter(bufs: np.ndarray, root: int = 0) -> np.ndarray:
    """Simulate the halving scatter on (n, n*chunk) rows (only row root read).
    Returns (n, chunk): row r = root's chunk r."""
    n = bufs.shape[0]
    chunk = bufs.shape[1] // n
    npad = pow2_pad(n)
    slot = np.zeros((n, npad, chunk), bufs.dtype)
    # root's buffer, rotated into vrank slot order
    full = bufs[root].reshape(n, chunk)
    for v in range(n):
        slot[root, v] = full[(v + root) % n]
    for m in reversed(binomial_masks(n)):
        pairs = [(d, s) for s, d in gather_pairs(n, m, root)]  # reversed flow
        sent = {}
        for src, dst in pairs:
            v = (src - root) % n
            up = (v // (2 * m)) * (2 * m) + m
            sent[src] = slot[src, up:up + m].copy()
        for src, dst in pairs:
            v = (dst - root) % n
            slot[dst, v:v + m] = sent[src]
    return np.stack([slot[r, (r - root) % n] for r in range(n)])


# ---------------------------------------------------------------------------
# Radix-k (mixed-radix) halving-doubling allreduce ("khd")
#
# The wide-fold generalization of halving-doubling: digits (d_0, ..., d_L-1)
# with n = prod(d_t). Reduce-scatter round t splits each rank's current
# segment into d_t parts; the rank keeps the part indexed by its own t-th
# mixed-radix digit and sends part j to the group member whose digit is j —
# d_t - 1 substeps, each a FULL permutation (every rank sends and
# receives; no partial-permute gating), after which the rank folds its kept
# part with the d_t - 1 arrivals in ONE fused (d_t)-operand pass. Allgather
# reverses the rounds. Total serialized wire per rank:
#   sum_t (d_t - 1) * (S / prod(d_0..d_t))  =  S * (1 - 1/n)
# per phase — EXACTLY the ring's bytes, with sum(d_t - 1) steps per phase
# instead of n - 1. No pipelining or overlap assumption is needed for that
# account: the substeps are full permutations whose serialized sizes simply
# sum to the optimum. At radix 8 the round-0 fold is an 8-operand combine
# and the schedule still moves ring-equal bytes.
# Digits all equal to 2 recover tree.py's classic halving-doubling.


def khd_digits(n: int, max_radix: int = 8) -> tuple[int, ...]:
    """Factor ``n`` into schedule digits, greedily largest-first, each
    <= ``max_radix`` where a divisor exists. A prime factor above the radix
    cap becomes its own digit (that round degenerates to the direct
    exchange: d-1 substeps, still bandwidth-optimal, just alpha-heavy)."""
    if n < 1:
        raise ValueError(f"need n >= 1 ranks, got {n}")
    digits = []
    while n > 1:
        for d in range(min(max_radix, n), 1, -1):
            if n % d == 0:
                digits.append(d)
                n //= d
                break
        else:  # prime > max_radix
            digits.append(n)
            n = 1
    return tuple(digits)


def khd_strides(digits) -> list[int]:
    """Stride of each digit position: s_t = prod(digits[t+1:]); rank r's
    t-th digit is (r // s_t) % digits[t]."""
    out, s = [], 1
    for d in reversed(digits):
        out.append(s)
        s *= d
    return out[::-1]


def khd_perm(n: int, digits, t: int, offset: int) -> list[tuple[int, int]]:
    """The (src, dst) full permutation for substep ``offset`` of round ``t``:
    every rank sends to the group member whose t-th digit is its own plus
    ``offset`` (mod digits[t])."""
    s = khd_strides(digits)[t]
    d = digits[t]
    return [(r, r + ((((r // s) % d) + offset) % d - (r // s) % d) * s)
            for r in range(n)]


def sim_khd_allreduce(bufs: np.ndarray, digits=None) -> np.ndarray:
    """Simulate radix-k halving-doubling on (n, n*chunk) rows (sum op)."""
    n = bufs.shape[0]
    if digits is None:
        digits = khd_digits(n)
    if int(np.prod(digits)) != n:
        raise ValueError(f"digits {digits} do not factor n={n}")
    bufs = bufs.reshape(n, n, -1).astype(np.float64).copy()  # chunk units
    strides = khd_strides(digits)
    dig = [[(r // strides[t]) % digits[t] for t in range(len(digits))]
           for r in range(n)]
    P = 1
    seg_start = [0] * n
    # reduce-scatter rounds
    for t, d in enumerate(digits):
        P *= d
        part = n // P
        arrivals = [[] for _ in range(n)]
        for o in range(1, d):
            sent = {}
            for src, dst in khd_perm(n, digits, t, o):
                st = seg_start[src] + ((dig[src][t] + o) % d) * part
                sent[dst] = bufs[src, st:st + part].copy()
            for r in range(n):
                arrivals[r].append(sent[r])
        for r in range(n):
            keep = seg_start[r] + dig[r][t] * part
            for a in arrivals[r]:
                bufs[r, keep:keep + part] += a
            seg_start[r] = keep
    # allgather rounds, reversed
    for t in range(len(digits) - 1, -1, -1):
        d = digits[t]
        part = n // P
        base = [seg_start[r] - dig[r][t] * part for r in range(n)]
        sent = {}
        for o in range(1, d):
            for src, dst in khd_perm(n, digits, t, o):
                sent[(dst, o)] = bufs[src, seg_start[src]:
                                      seg_start[src] + part].copy()
        for o in range(1, d):
            for r in range(n):
                idx = (dig[r][t] - o) % d
                st = base[r] + idx * part
                bufs[r, st:st + part] = sent[(r, o)]
        for r in range(n):
            seg_start[r] = base[r]
        P //= d
    return bufs.reshape(n, -1)


# ---------------------------------------------------------------------------
# Double binary tree allreduce
#
# The flagship tree algorithm of the reference's stack (NCCL/RCCL ship it as
# their default large-scale allreduce): TWO complementary binary trees, each
# reducing-then-broadcasting HALF of the buffer, so the per-rank send load of
# tree edges is spread across both halves instead of idling the leaves.
#
# **Tree 1** is the in-order "Fenwick" tree on 1-based ranks: the root of a
# range is the multiple of the largest power of two inside it, so every
# odd 1-based rank (even 0-based rank) is a leaf — for ANY n, not just
# powers of two (which is this schedule's advantage over halving-doubling).
# **Tree 2** is tree 1 with all labels shifted by +1 mod n: leaves of tree 2
# are exactly the internal ranks of tree 1 for even n (perfect complement),
# and all-but-one for odd n. (RCCL mirrors instead of shifting for odd n; a
# shift keeps complementarity strictly better here — the mirror of our tree
# shape maps even leaves back onto even ranks when n is odd.)
#
# An allreduce over one tree = reduce up the edges + broadcast back down.
# Each level contributes up to two substeps (left children, then
# right children — in an in-order tree, left child < parent < right child,
# so the split guarantees unique destinations per substep).


def dbtree_parents(n: int) -> tuple[list[int], list[int]]:
    """Parent arrays (parent[root] == -1) of the two complementary trees."""
    if n < 1:
        raise ValueError(f"need n >= 1 ranks, got {n}")
    p1 = [-1] * n

    def build(lo: int, hi: int, par: int) -> None:
        # in-order tree on 1-based [lo, hi]; ranges always have the form
        # [k*2^m + 1, k*2^m + rem], whose root is lo - 1 + 2^floor(log2 size)
        if lo > hi:
            return
        size = hi - lo + 1
        root = lo - 1 + (1 << (size.bit_length() - 1))
        p1[root - 1] = par - 1  # store 0-based
        build(lo, root - 1, root)
        build(root + 1, hi, root)

    build(1, n, 0)  # sentinel parent 0 -> stored as -1
    p2 = [-1 if p1[(r - 1) % n] == -1 else (p1[(r - 1) % n] + 1) % n
          for r in range(n)]
    return p1, p2


def dbtree_depths(parents: list[int]) -> list[int]:
    """Node depths (root = 0)."""
    def depth(r: int) -> int:
        d = 0
        while parents[r] != -1:
            r = parents[r]
            d += 1
        return d
    return [depth(r) for r in range(len(parents))]


def dbtree_steps(parents: list[int]) -> tuple[
        list[list[tuple[int, int]]], list[list[tuple[int, int]]]]:
    """(up, down) substeps for one tree.

    ``up``: reduce phase, deepest level first; each substep is a list of
    (child, parent) pairs with unique parents (a level's first children,
    then its second children — NOT a label comparison, because tree 2's
    +1 mod n shift wraps labels, so a "right" child can carry a smaller
    label than its parent). A node's children always fire before the node's
    own up-send, so partial sums are complete when forwarded. ``down``:
    broadcast phase, the exact reverse with (parent, child) pairs.
    """
    n = len(parents)
    depths = dbtree_depths(parents)
    children: dict[int, list[int]] = {p: [] for p in range(n)}
    for c in range(n):
        if parents[c] != -1:
            children[parents[c]].append(c)
    up: list[list[tuple[int, int]]] = []
    for d in range(max(depths), 0, -1):
        for side in (0, 1):
            pairs = [(c, parents[c]) for c in range(n)
                     if depths[c] == d
                     and children[parents[c]].index(c) == side]
            if pairs:
                up.append(pairs)
    down = [[(p, c) for c, p in pairs] for pairs in reversed(up)]
    return up, down


def dbtree_up_levels(parents: list[int]) -> tuple[
        list[list[list[tuple[int, int]]]], list[list[tuple[int, int]]]]:
    """(up_levels, down): the up-phase substeps of ``dbtree_steps`` grouped
    by tree level (deepest first) — each level holds 1-2 partial-permute
    substeps whose receives a parent may DEFER and combine in one fused
    pass — plus the unchanged down phase, so callers derive the schedule
    once."""
    depths = dbtree_depths(parents)
    up, down = dbtree_steps(parents)
    levels: dict[int, list] = {}
    for pairs in up:
        d = depths[pairs[0][0]]  # all of a substep's children share a depth
        levels.setdefault(d, []).append(pairs)
    return [levels[d] for d in sorted(levels, reverse=True)], down


def sim_dbtree_allreduce(bufs: np.ndarray) -> np.ndarray:
    """Simulate the double-tree allreduce on (n, elems) rows (sum op)."""
    n = bufs.shape[0]
    half = -(-bufs.shape[1] // 2)
    padded = np.zeros((n, 2 * half), bufs.dtype)
    padded[:, :bufs.shape[1]] = bufs
    halves = padded.reshape(n, 2, half).transpose(1, 0, 2).copy()
    for t, parents in enumerate(dbtree_parents(n)):
        h = halves[t]
        up, down = dbtree_steps(parents)
        for pairs in up:
            sent = {c: h[c].copy() for c, _ in pairs}
            for c, p in pairs:
                h[p] += sent[c]
        for pairs in down:
            sent = {p: h[p].copy() for p, _ in pairs}
            for p, c in pairs:
                h[c] = sent[p]
    out = halves.transpose(1, 0, 2).reshape(n, 2 * half)
    return out[:, :bufs.shape[1]]


# ---------------------------------------------------------------------------
# Chunk-pipelined double binary tree ("ptree")
#
# The streaming variant of the double binary tree: each half-buffer is cut into C chunks that STREAM
# through the tree — at up-tick T, a child at depth d sends chunk
# (T - depth_max + d) to its parent, so level t of chunk i overlaps level
# t-1 of chunk i+1 and the critical link carries ~S/2 per phase per tree
# instead of depth x S/2. A parent's two children share a depth, so both of
# a tick's arrivals target the SAME chunk index and fold with the parent's
# own chunk in ONE fused 3-operand pass — the per-chunk arrival fold is a
# genuine wide combine, one per pipeline beat.
#
# Tick count per phase: C + depth_max - 1. Serialized-bytes accounting (the
# honest cost-model account, no overlap assumed): each tick runs up to 2
# partial-permute substeps per tree x 2 trees, each moving S/(2C) —
# 4 substeps x (C+D-1) ticks x S/(2C) = 2S(C+D-1)/C per phase, 4S(C+D-1)/C
# for up+down. The substeps within a tick are data-independent (all sends
# sliced before any fold), so a backend that overlaps independent
# collectives approaches the NCCL pipelined-tree figure of 2S.


def ptree_ticks(parents: list[int], chunks: int) -> tuple[
        list[list[list[tuple[int, int, int]]]],
        list[list[list[tuple[int, int, int]]]]]:
    """(up, down) tick tables for one tree of the pipelined schedule.

    ``up``: list over ticks; each tick holds up to 2 substeps (one per
    child slot); each substep is a list of (child, parent, chunk_idx)
    triples — chunk_idx is what the child sends, = tick - depth_max +
    depth(child), kept when 0 <= idx < chunks. ``down`` mirrors with
    (parent, child, chunk_idx) triples, chunk_idx = tick - depth(parent).
    """
    n = len(parents)
    depths = dbtree_depths(parents)
    dmax = max(depths)
    if dmax == 0:
        return [], []
    children: dict[int, list[int]] = {p: [] for p in range(n)}
    for c in range(n):
        if parents[c] != -1:
            children[parents[c]].append(c)
    up = []
    for t in range(chunks + dmax - 1):
        tick = []
        for side in (0, 1):
            sub = [(c, parents[c], t - dmax + depths[c]) for c in range(n)
                   if parents[c] != -1
                   and children[parents[c]].index(c) == side
                   and 0 <= t - dmax + depths[c] < chunks]
            if sub:
                tick.append(sub)
        up.append(tick)
    down = []
    for t in range(chunks + dmax - 1):
        tick = []
        for side in (0, 1):
            sub = [(p, c, t - depths[p]) for p in children for c in children[p]
                   if children[p].index(c) == side
                   and 0 <= t - depths[p] < chunks]
            if sub:
                tick.append(sub)
        down.append(tick)
    return up, down


def sim_ptree_allreduce(bufs: np.ndarray, chunks: int = 4) -> np.ndarray:
    """Simulate the chunk-pipelined double tree on (n, elems) rows (sum)."""
    n = bufs.shape[0]
    if n == 1:
        return bufs.copy()
    half = -(-bufs.shape[1] // 2)
    csize = -(-half // chunks)
    padded = np.zeros((n, 2 * chunks * csize), bufs.dtype)
    padded[:, :half] = bufs[:, :half]
    padded[:, chunks * csize:chunks * csize + bufs.shape[1] - half] = \
        bufs[:, half:]
    halves = padded.reshape(n, 2, chunks, csize).transpose(1, 0, 2, 3).copy()
    for ti, parents in enumerate(dbtree_parents(n)):
        h = halves[ti]
        up, down = ptree_ticks(parents, chunks)
        for tick in up:
            sent = {(c, p): h[c, i].copy() for sub in tick for c, p, i in sub}
            for sub in tick:
                for c, p, i in sub:
                    h[p, i] += sent[(c, p)]
        for tick in down:
            sent = {(p, c): h[p, i].copy() for sub in tick for p, c, i in sub}
            for sub in tick:
                for p, c, i in sub:
                    h[c, i] = sent[(p, c)]
    out = halves.transpose(1, 0, 2, 3).reshape(n, 2 * chunks * csize)
    res = np.empty_like(bufs)
    res[:, :half] = out[:, :half]
    res[:, half:] = out[:, chunks * csize:chunks * csize + bufs.shape[1] - half]
    return res


# ---------------------------------------------------------------------------
# Bruck alltoall (log-step; latency-optimal for small messages)


def bruck_phases(n: int) -> list[int]:
    """Shift distances 1, 2, 4, ... < n. Works for any n (not just 2^k)."""
    out, k = [], 1
    while k < n:
        out.append(k)
        k <<= 1
    return out


def bruck_mask(n: int, k: int) -> list[int]:
    """Chunk positions exchanged at phase k: indices with bit k set."""
    return [i for i in range(n) if i & k]


def sim_bruck_alltoall(bufs: np.ndarray) -> np.ndarray:
    """Simulate Bruck on a (n, n*chunk) array: same transpose semantics as
    the rotation algorithm in (n-1) -> ceil(log2 n) steps, at the cost of
    moving each chunk up to log2(n) times ((n/2)*log2(n) total traffic)."""
    n = bufs.shape[0]
    x = bufs.reshape(n, n, -1)
    # phase 0: local upward rotation so each rank's self-chunk sits at 0
    buf = np.stack([np.roll(x[r], -r, axis=0) for r in range(n)])
    for k in bruck_phases(n):
        idx = bruck_mask(n, k)
        sent = {r: buf[r, idx].copy() for r in range(n)}
        for src, dst in ring_permutation(n, shift=k):
            buf[dst, idx] = sent[src]
    # final: chunk i on rank r came from rank (r - i) mod n
    out = np.empty_like(buf)
    for r in range(n):
        for i in range(n):
            out[r, (r - i) % n] = buf[r, i]
    return out.reshape(n, -1)
