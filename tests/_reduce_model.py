"""A model of the reduce kernel's flag protocol across processes
(``ops/csrc/reduce_across.cu``), shared by ``tests/test_torch_reduce.py``
and ``tests/test_torch_ring.py``.

Each (rank, lane) block runs the kernel's action list for a sequence of
launches on one flag region, which is never reset: the entry barrier; in
pass k the pushes of sub-step k, the fold of sub-step k-1 after its reduce
arrivals, (allreduce) the drain of sub-step k-2 after its allgather
arrivals, and one arrival on the words of the pass; then it leaves. A
scheduler picks a random runnable actor each tick, and a wait is runnable
only once its word has reached this launch's count e*(n-1). Each rank's
stream releases launch e to its blocks only after every lane of launch e-1
has left. One element stands for a vector. The model asserts that a push
into rank d's rows lands while rank d's lane is inside the same launch,
after rank d folded (input row) or drained (output row) what the last push
there left; that a fold reads only what this launch pushed, and a drain
likewise; that in place no range of the row is overwritten before it was
pushed; that no lane leaves before it folded and drained all its
sub-steps; that every range is pushed, folded and drained exactly once a
launch; that every flag word ends at launches*(n-1); and the results,
against the plain versions, are the caller's.
"""

import numpy as np
import torch

from rocnrdma_tpu_torch.ops import ipc, push_cuda
from rocnrdma_tpu_torch.ops import ring_cuda as R

MAX_STEPS = ipc.MAX_STEPS
WORDS = ipc.FLAG_WORDS["reduce"]


def ranges(geo: push_cuda.Geometry, pv: int, b: int) -> list:
    """Lane b's sub-step ranges [s0, s1), as the kernel clamps them."""
    lo = b * geo.lane
    hi = min(lo + geo.lane, pv)
    return [(min(lo + k * geo.step, hi), min(lo + (k + 1) * geo.step, hi))
            for k in range(geo.steps)]


def geo(pv: int, lanes: int, steps: int) -> push_cuda.Geometry:
    """``lanes`` lanes in ``steps`` sub-steps over ``pv`` elements, ragged at
    the ends where pv does not divide."""
    lane = -(-pv // lanes)
    step = -(-lane // steps)
    return push_cuda.Geometry(lanes=-(-pv // lane), lane=lane, steps=steps, step=step,
                              vecs=4)


def arrivals(ar: bool, k: int, steps: int) -> list:
    """The words pass k raises: reduce word k (the last through
    MAX_STEPS-1), allgather word k-1 likewise (RS: all with its last
    reduce word)."""
    words = []
    if k < steps:
        words += [("R", w) for w in range(k, k + 1 if k + 1 < steps else MAX_STEPS)]
        if not ar and k + 1 == steps:
            words += [("AG", w) for w in range(MAX_STEPS)]
    if ar and 1 <= k <= steps:
        words += [("AG", w) for w in range(k - 1, k if k < steps else MAX_STEPS)]
    return words


def program(mode, n, r, e, steps, barrier_lag=0, fold_waits=True, drain_waits=True,
            push_early=False, drain_first=False):
    """reduce_across.cu's actions for block (r, b) in launch e (from 1), mode
    "ar" or "rs". The unsafe variants: ``barrier_lag`` 1, an entry barrier
    one launch behind; ``fold_waits`` / ``drain_waits`` False, folds or
    drains without their arrivals; ``push_early``, the first pushes before
    the entry barrier; ``drain_first``, each pass drains its own sub-step
    at once, before it pushes it."""
    ar = mode == "ar"
    prog = [("enter",), ("signal", [("bar", 0)])]
    wait_bar = ("wait", ("bar", 0), (e - barrier_lag) * (n - 1))
    prog += [("push", 0), wait_bar] if push_early else [wait_bar]
    for k in range(steps + (2 if ar else 1)):
        if drain_first and ar and k < steps:
            prog.append(("drain", k))
        if k < steps and not (push_early and k == 0):
            prog.append(("push", k))
        if 1 <= k <= steps:
            if fold_waits:
                prog.append(("wait", ("R", k - 1), e * (n - 1)))
            prog.append(("fold", k - 1))
        if ar and k >= 2 and not drain_first:
            if drain_waits:
                prog.append(("wait", ("AG", k - 2), e * (n - 1)))
            prog.append(("drain", k - 2))
        words = arrivals(ar, k, steps)
        if words:
            prog.append(("signal", words))
    return prog + [("leave",)]


def run(launches, g, seed, variant=None, missing=None):
    """Run ``launches``, a list of (mode, x, in_place): x the ranks' rows,
    (n, n, pv), mode "ar" or "rs", with geometry ``g`` on one flag region;
    ``variant`` (a dict of ``program``'s keywords) for every block. Returns
    each launch's results: (n, n, pv) for "ar", (n, pv) for "rs", rank r's
    row its result. ``missing=(rank, e)``: that rank never launches e;
    returns the expiries (rank, lane, flag word) the other ranks' stuck
    lanes end in."""
    n, pv = launches[0][1].shape[0], launches[0][1].shape[2]
    L = g.lanes
    rows, outs = [], []
    for mode, x, in_place in launches:
        rows.append(x.copy())
        outs.append(rows[-1] if in_place else np.full(
            (n, n, pv) if mode == "ar" else (n, pv), np.nan, np.float32))
    inbox = np.full((n, n, pv), np.nan, np.float32)   # rank q's input row, slot j
    outbox = np.full((n, n, pv), np.nan, np.float32)  # rank q's output row, slot j
    # the launch of the last push into / fold or drain of (rank q, slot j, v)
    pushed_in, folded = np.zeros((n, n, pv), int), np.zeros((n, n, pv), int)
    pushed_out, drained = np.zeros((n, n, pv), int), np.zeros((n, n, pv), int)
    read = np.zeros((n, n, pv), int)  # the launch that last pushed (r, chunk, v)
    released = np.zeros(n, int)
    left = np.zeros((n, L), int)
    inside = np.zeros((n, L), int)
    flags = {}
    progs = {}
    for r in range(n):
        last = len(launches) if missing is None or missing[0] != r else missing[1] - 1
        prog = [(e, a) for e in range(1, last + 1)
                for a in [("gate",)] + program(launches[e - 1][0], n, r, e, g.steps,
                                               **(variant or {}))]
        for b in range(L):
            progs[(r, b)] = prog
        progs[("stream", r)] = [(e, ("release",)) for e in range(1, last + 1)]
    pcs = {k: 0 for k in progs}
    rng = np.random.default_rng(seed)

    def runnable(key):
        if pcs[key] == len(progs[key]):
            return False
        e, act = progs[key][pcs[key]]
        if key[0] == "stream":  # launch e follows the whole of launch e-1
            return (left[key[1]] >= e - 1).all()
        if act[0] == "gate":
            return released[key[0]] >= e
        return act[0] != "wait" or flags.get((act[1], key[0], key[1]), 0) >= act[2]

    while True:
        ready = [k for k in progs if runnable(k)]
        if not ready:
            break
        key = ready[rng.integers(len(ready))]
        e, act = progs[key][pcs[key]]
        pcs[key] += 1
        if key[0] == "stream":
            released[key[1]] = e
            continue
        r, b = key
        mode, _, in_place = launches[e - 1]
        row, out = rows[e - 1][r], outs[e - 1][r]
        others = [(r + s) % n for s in range(1, n)]
        if act[0] == "enter":
            inside[r, b] = e
        elif act[0] == "signal":
            for q in others:
                for w in act[1]:
                    flags[(w, q, b)] = flags.get((w, q, b), 0) + 1
        elif act[0] == "push":
            s0, s1 = ranges(g, pv, b)[act[1]]
            for d in others:
                assert inside[d, b] == e, \
                    f"rank {r} pushed into rank {d} outside its part of launch {e}"
                assert (folded[d, r, s0:s1] == pushed_in[d, r, s0:s1]).all(), \
                    f"rank {r} pushed launch {e} into rank {d}'s slot before it was folded"
                inbox[d, r, s0:s1] = row[d, s0:s1]
                pushed_in[d, r, s0:s1] = e
                read[r, d, s0:s1] = e
        elif act[0] == "fold":
            s0, s1 = ranges(g, pv, b)[act[1]]
            for q in others:
                assert (pushed_in[r, q, s0:s1] == e).all(), \
                    f"rank {r} folded launch {e} before rank {q}'s push landed"
                assert (folded[r, q, s0:s1] == e - 1).all(), "a range folded twice"
            first = r if mode == "ar" else (r + 1) % n
            ops = [row[r, s0:s1] if q == r else inbox[r, q, s0:s1]
                   for q in ((first + k) % n for k in range(n))]
            acc = ops[0].copy()
            for v in ops[1:]:
                acc = v + acc
            folded[r, others, s0:s1] = e
            if mode == "rs":
                out[s0:s1] = acc
                continue
            out[r, s0:s1] = acc
            for d in others:
                assert inside[d, b] == e, \
                    f"rank {r} pushed its sum into rank {d} outside launch {e}"
                assert (drained[d, r, s0:s1] == pushed_out[d, r, s0:s1]).all(), \
                    f"rank {r} pushed launch {e}'s sum into rank {d}'s slot before it " \
                    f"was drained"
                outbox[d, r, s0:s1] = acc
                pushed_out[d, r, s0:s1] = e
        elif act[0] == "drain":
            s0, s1 = ranges(g, pv, b)[act[1]]
            for j in others:
                if in_place:
                    assert (read[r, j, s0:s1] == e).all(), \
                        f"rank {r} wrote its row in place before it pushed the range " \
                        f"(launch {e})"
                assert (pushed_out[r, j, s0:s1] == e).all(), \
                    f"rank {r} drained launch {e} before rank {j}'s sum landed"
                assert (drained[r, j, s0:s1] < e).all(), "a range drained twice"
                out[j, s0:s1] = outbox[r, j, s0:s1]
                drained[r, j, s0:s1] = e
        elif act[0] == "leave":
            lo, hi = b * g.lane, min((b + 1) * g.lane, pv)
            assert (folded[r, others, lo:hi] == e).all(), \
                f"rank {r} lane {b} left launch {e} before it folded"
            if mode == "ar":
                assert (drained[r, others, lo:hi] == e).all(), \
                    f"rank {r} lane {b} left launch {e} before it drained"
            inside[r, b] = 0
            left[r, b] = e

    stuck = [k for k in progs if pcs[k] != len(progs[k])]
    if missing is not None:
        expired = []
        for k in stuck:
            act = progs[k][pcs[k]][1]
            if k[0] != "stream" and act[0] == "wait":
                kind, w = act[1]
                word = {"bar": 0, "R": 1 + w, "AG": 1 + MAX_STEPS + w}[kind]
                expired.append((k[0], k[1], k[1] * WORDS + word))
        return sorted(expired)
    assert not stuck, f"deadlock: {stuck} blocked"
    off = ~np.eye(n, dtype=bool)
    assert (pushed_in[off] == len(launches)).all() and (folded[off] == len(launches)).all()
    words = [("bar", 0)] + [(kind, w) for kind in ("R", "AG") for w in range(MAX_STEPS)]
    for r in range(n):
        for b in range(L):
            for w in words:
                assert flags[(w, r, b)] == len(launches) * (n - 1), (w, r, b)
    return outs


def want(mode, x) -> np.ndarray:
    """The plain versions' result of one launch, shaped as ``run``'s: the
    one-process allreduce with chunks of pv, or the reduce-scatter's fold."""
    n, pv = x.shape[0], x.shape[2]
    t = torch.from_numpy(x.copy())
    if mode == "ar":
        return R._allreduce_plain(t.reshape(n, -1), 1).numpy().reshape(n, n, pv)
    return R._fold_chunks(t, 1).numpy()


def inputs(n, pv, launches, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((n, n, pv)).astype(np.float32) for _ in range(launches)]


def bits(a) -> np.ndarray:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return np.ascontiguousarray(a).view(np.uint32)
