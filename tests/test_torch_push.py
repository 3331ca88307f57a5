"""The push kernel across processes (``rocnrdma_tpu_torch.ops.push_cuda``,
``ops/csrc/push_across.cu``): the allgather and the alltoall of a 1-D mesh
that spans processes, one rank a process.

- A model of the kernel's protocol (entry barrier; per sub-step, pushes
  into the peers' workspace rows, the drain of the sub-step before it,
  arrivals; the last drain), per (rank, lane), with the source strides of
  both verbs, every lane and sub-step range cut as the kernel cuts them,
  stepped through seeded random interleavings over back-to-back launches
  on one flag region; also with rows staged on each rank's stream, a rank
  that never launches, and three unsafe orders the model must reject. The
  kernel itself runs only on the card (``tests/test_torch_card.py``,
  ``chip_smoke.py`` phase 14).
- The model's results against the JAX package's ``pallas_alltoall`` and
  ``pallas_ring_allgather`` in TPU interpret mode, bitwise.
- The geometry: a pure function of its arguments, lanes from the card's
  blocks with a card to itself and the shared cap otherwise.
- The wrappers' host path with a stand-in for the built library and the
  workspace's device memory: an aligned row's own pointer reaches the
  launch with nothing staged, a padded or strided row is staged and
  counted, and the epoch advances only when a launch went in.
"""

import ctypes

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from rocnrdma_tpu import runtime as rt
from rocnrdma_tpu.ops import pallas_alltoall, pallas_ring_allgather
from rocnrdma_tpu_torch import ops as T
from rocnrdma_tpu_torch.ops import alltoall_cuda as A
from rocnrdma_tpu_torch.ops import ipc, push_cuda
from rocnrdma_tpu_torch.ops import ring_cuda as R

from _marks import needs_tpu_interpret

RANK = rt.mesh.RANK_AXIS
MAX_STEPS = push_cuda.MAX_STEPS
WORDS = ipc.FLAG_WORDS["push"]


def _bits(a) -> np.ndarray:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return np.ascontiguousarray(a).view(np.uint32)


# ---------------------------------------------------------------------------
# The protocol model. Each (rank, lane) block runs the kernel's action list
# for a sequence of launches on one flag region, which is never reset; a
# scheduler picks a random runnable actor each tick, and a wait is runnable
# only once its word has reached this launch's count e*(n-1). Each rank's
# stream releases launch e to its blocks after its copy in (a staged row),
# and joins it once every lane has left, then copies out (a padded
# result). The model asserts that a push into rank d's row lands while rank
# d's lane is inside the same launch and after rank d drained that range of
# the launch before; that a drain reads only what this launch pushed; that
# a staged row is read only after its copy in; that no lane leaves before
# it drained all its sub-steps; that every range is pushed and drained
# exactly once a launch; that every flag word ends at launches*(n-1); and
# that the results equal the plain versions.


def _ranges(geo: push_cuda.Geometry, pv: int, b: int) -> list:
    """Lane b's sub-step ranges [s0, s1), as the kernel clamps them."""
    lo = b * geo.lane
    hi = min(lo + geo.lane, pv)
    out = []
    for k in range(geo.steps):
        s0 = min(lo + k * geo.step, hi)
        out.append((s0, min(s0 + geo.step, hi)))
    return out


def _push_program(n, r, e, steps, barrier_lag=0, drain_waits=True):
    """push_across.cu's actions for block (r, b) in launch e (from 1).
    ``barrier_lag`` 1: an entry barrier one launch behind; ``drain_waits``
    False: drains without waiting for their sub-step's arrivals."""
    prog = [("enter",), ("signal", "bar", None),
            ("wait", "bar", (e - barrier_lag) * (n - 1))]
    for k in range(steps):
        prog.append(("push", k))
        if k > 0:
            if drain_waits:
                prog.append(("wait", k - 1, e * (n - 1)))
            prog.append(("drain", k - 1))
        prog.append(("signal", k, MAX_STEPS - 1 if k == steps - 1 else k))
    if drain_waits:
        prog.append(("wait", steps - 1, e * (n - 1)))
    return prog + [("drain", steps - 1), ("leave",)]


def _push_before_barrier(n, r, e, steps):
    prog = _push_program(n, r, e, steps)
    i = prog.index(("push", 0))
    return prog[:2] + [prog[i]] + prog[2:i] + prog[i + 1:]


def _barrier_one_launch_behind(n, r, e, steps):
    return _push_program(n, r, e, steps, barrier_lag=1)


def _drain_before_arrivals(n, r, e, steps):
    return _push_program(n, r, e, steps, drain_waits=False)


def _pieces(x, gather: bool):
    """Rank r's piece for rank d: x[r] (allgather) or x[r, d]."""
    return (lambda r, d: x[r]) if gather else (lambda r, d: x[r, d])


def _run_push_protocol(xs, geo, seed, gather=False, program=_push_program,
                       staged=False, missing=None):
    """Run one launch per input in ``xs`` (each (n, n, pv) for the alltoall,
    (n, pv) for the allgather: one element a vector) with geometry ``geo``
    on one flag region; returns each launch's results, (n, n, pv): rank r's
    slot j what rank j sent it. ``staged``: every rank copies its row into
    its workspace input row on its stream before each launch, and copies
    its result out after it. ``missing=(rank, e)``: that rank never
    launches e; returns the expiries (rank, lane, flag word) the other
    ranks' stuck lanes end in."""
    n, pv = xs[0].shape[0], xs[0].shape[-1]
    L = geo.lanes
    outs = [np.full((n, n, pv), np.nan, np.float32) for _ in xs]
    ws_in = np.full(xs[0].shape, np.nan, np.float32)
    ws_out = np.full((n, n, pv), np.nan, np.float32)
    pushed = np.zeros((n, n, pv), int)   # launch of the last push into (rank, slot, v)
    drained = np.zeros((n, n, pv), int)  # launch of the last drain of it
    copied_in, released = np.zeros(n, int), np.zeros(n, int)
    left = np.zeros((n, L), int)
    inside = np.zeros((n, L), int)
    flags = {}
    progs = {}
    for r in range(n):
        last = len(xs) if missing is None or missing[0] != r else missing[1] - 1
        prog = [(e, a) for e in range(1, last + 1)
                for a in [("gate",)] + program(n, r, e, geo.steps)]
        for b in range(L):
            progs[(r, b)] = prog
        progs[("stream", r)] = [(e, (a,)) for e in range(1, last + 1)
                                for a in ("copy_in", "release", "join", "copy_out")]
    pcs = {k: 0 for k in progs}
    rng = np.random.default_rng(seed)

    def runnable(key):
        if pcs[key] == len(progs[key]):
            return False
        e, act = progs[key][pcs[key]]
        if key[0] == "stream":
            return act[0] != "join" or (left[key[1]] >= e).all()
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
        x = xs[e - 1]
        if key[0] == "stream":
            r = key[1]
            if act[0] == "copy_in" and staged:
                ws_in[r] = x[r]
                copied_in[r] = e
            elif act[0] == "release":
                released[r] = e
            elif act[0] == "copy_out" and staged:
                assert (drained[r][np.arange(n) != r] == e).all(), \
                    f"rank {r} copied out launch {e} before every slot was drained"
            continue
        r, b = key
        if act[0] == "enter":
            inside[r, b] = e
        elif act[0] == "signal":
            _, word, upto = act
            words = ["bar"] if word == "bar" else range(word, upto + 1)
            for s in range(1, n):
                for w in words:
                    f = (w, (r + s) % n, b)
                    flags[f] = flags.get(f, 0) + 1
        elif act[0] == "push":
            s0, s1 = _ranges(geo, pv, b)[act[1]]
            if staged:
                assert copied_in[r] == e, f"rank {r} read its input row before copy_in({e})"
            piece = _pieces(ws_in if staged else x, gather)
            for s in range(1, n + 1):
                d = (r + s) % n
                if d == r:  # its own piece: straight into its result
                    outs[e - 1][r, r, s0:s1] = piece(r, r)[s0:s1]
                    continue
                assert inside[d, b] == e, \
                    f"rank {r} pushed into rank {d} outside its part of launch {e}"
                assert (drained[d, r, s0:s1] == e - 1).all(), \
                    f"rank {r} pushed launch {e} into rank {d}'s row before it was drained"
                ws_out[d, r, s0:s1] = piece(r, d)[s0:s1]
                pushed[d, r, s0:s1] = e
        elif act[0] == "drain":
            s0, s1 = _ranges(geo, pv, b)[act[1]]
            for j in range(n):
                if j == r:
                    continue
                assert (pushed[r, j, s0:s1] == e).all(), \
                    f"rank {r} drained launch {e} before rank {j}'s push landed"
                assert (drained[r, j, s0:s1] == e - 1).all(), "a range drained twice"
                outs[e - 1][r, j, s0:s1] = ws_out[r, j, s0:s1]
                drained[r, j, s0:s1] = e
        elif act[0] == "leave":
            lo, hi = b * geo.lane, min((b + 1) * geo.lane, pv)
            assert (drained[r][np.arange(n) != r][:, lo:hi] == e).all(), \
                f"rank {r} lane {b} left launch {e} before it drained"
            inside[r, b] = 0
            left[r, b] = e

    stuck = [k for k in progs if pcs[k] != len(progs[k])]
    if missing is not None:
        expired = []
        for k in stuck:
            act = progs[k][pcs[k]][1]
            if k[0] != "stream" and act[0] == "wait":
                word = 0 if act[1] == "bar" else 1 + act[1]
                expired.append((k[0], k[1], k[1] * WORDS + word))
        return sorted(expired)
    assert not stuck, f"deadlock: {stuck} blocked"
    off = ~np.eye(n, dtype=bool)
    assert (pushed[off] == len(xs)).all() and (drained[off] == len(xs)).all()
    for r in range(n):
        for b in range(L):
            for w in ["bar"] + list(range(MAX_STEPS)):
                assert flags[(w, r, b)] == len(xs) * (n - 1), (w, r, b)
    return outs


def _want(x, gather: bool) -> np.ndarray:
    """The plain version's result of one launch, as the model shapes it."""
    n, pv = x.shape[0], x.shape[-1]
    if gather:
        return R.ring_allgather_plain(torch.from_numpy(x)).numpy().reshape(n, n, pv)
    return A.alltoall_plain(torch.from_numpy(x)).numpy()


def _geo(n, pv, lanes, steps):
    """A geometry of ``lanes`` lanes in ``steps`` sub-steps, ragged at the
    ends where pv does not divide."""
    lane = -(-pv // lanes)
    step = -(-lane // steps)
    return push_cuda.Geometry(lanes=-(-pv // lane), lane=lane, steps=steps, step=step, vecs=4)


def _inputs(n, pv, launches, seed, gather):
    rng = np.random.default_rng(seed)
    shape = (n, pv) if gather else (n, n, pv)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(launches)]


@pytest.mark.parametrize("gather", [False, True], ids=["alltoall", "allgather"])
@pytest.mark.parametrize("n", [2, 3, 8])
def test_push_protocol_model_random_interleavings(n, gather):
    # 3 lanes of 3 sub-steps over 20 vectors: the last lane and its last
    # sub-steps ragged
    geo = _geo(n, 20, 3, 3)
    xs = _inputs(n, 20, 1, n, gather)
    want = _want(xs[0], gather)
    for seed in range(60):
        got, = _run_push_protocol(xs, geo, seed, gather)
        np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("steps", [1, 2, MAX_STEPS])
@pytest.mark.parametrize("gather", [False, True], ids=["alltoall", "allgather"])
@pytest.mark.parametrize("n", [2, 3, 4])
def test_push_protocol_model_back_to_back_epochs(n, gather, steps):
    # three launches on one flag region, never reset, each waiting for its
    # own epoch's counts; every arrival word advances once a launch whatever
    # the sub-steps, so the launches may also cut their lanes differently
    xs = _inputs(n, 16, 3, 20 + n, gather)
    wants = [_want(x, gather) for x in xs]
    for seed in range(30):
        for got, want in zip(_run_push_protocol(xs, _geo(n, 16, 2, steps), seed, gather),
                             wants):
            np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("gather", [False, True], ids=["alltoall", "allgather"])
@pytest.mark.parametrize("n", [2, 3, 8])
def test_push_protocol_model_staged_rows(n, gather):
    # a padded or strided row: copied into the workspace input row on the
    # rank's stream before each launch, its result copied out after
    xs = _inputs(n, 12, 3, 40 + n, gather)
    wants = [_want(x, gather) for x in xs]
    for seed in range(15):
        gots = _run_push_protocol(xs, _geo(n, 12, 2, 2), seed, gather, staged=True)
        for got, want in zip(gots, wants):
            np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("gather", [False, True], ids=["alltoall", "allgather"])
@pytest.mark.parametrize("n", [2, 4])
def test_push_protocol_model_with_the_kernels_own_geometry(n, gather):
    # the lanes and sub-steps geometry() gives a small card: 3 SMs, every
    # lane a whole 32-vector run, the last lane ragged
    pv = 7 * push_cuda.MIN_LANE_VECS + 40
    geo = push_cuda.geometry(n, pv, 1, sms=3, resident=24, blocks_per_sm=2,
                             step_bytes=push_cuda.ALIGN_VECS * push_cuda.VEC)
    assert geo.lanes == 6 and geo.steps > 1 and geo.lanes * geo.lane >= pv > (
        geo.lanes - 1) * geo.lane
    xs = _inputs(n, pv, 2, 60 + n, gather)
    wants = [_want(x, gather) for x in xs]
    for seed in range(3):
        for got, want in zip(_run_push_protocol(xs, geo, seed, gather), wants):
            np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("program", [_push_before_barrier, _barrier_one_launch_behind,
                                     _drain_before_arrivals])
@pytest.mark.parametrize("gather", [False, True], ids=["alltoall", "allgather"])
@pytest.mark.parametrize("n", [2, 3, 8])
def test_push_protocol_model_rejects_unsafe_orders(n, gather, program):
    # the model is strict enough to catch a kernel that pushes before its
    # entry barrier, whose barrier lets a launch push into a row its owner
    # has not drained of the launch before, or that drains a sub-step
    # before its arrivals
    xs = _inputs(n, 16, 3, 80 + n, gather)
    caught = 0
    for seed in range(30):
        try:
            _run_push_protocol(xs, _geo(n, 16, 2, 2), seed, gather, program)
        except AssertionError:
            caught += 1
    assert caught > 0


@pytest.mark.parametrize("gather", [False, True], ids=["alltoall", "allgather"])
@pytest.mark.parametrize("n", [2, 3, 8])
def test_push_protocol_model_a_rank_that_never_launches_expires_the_others(n, gather):
    # rank 0 dies before launch 2: every other rank's every lane ends in
    # the bounded wait of launch 2's entry barrier, on its lane's word
    xs = _inputs(n, 16, 2, 100 + n, gather)
    geo = _geo(n, 16, 2, 3)
    want = [(r, b, b * WORDS) for r in range(1, n) for b in range(geo.lanes)]
    for seed in range(10):
        assert _run_push_protocol(xs, geo, seed, gather, missing=(0, 2)) == want


@needs_tpu_interpret
@pytest.mark.parametrize("n", [2, 4])
def test_push_protocol_model_bitwise_equals_pallas(devices, n):
    # one element a vector: the model's results against the JAX package's
    # kernels on the same rows (pallas_alltoall per chunk of 128)
    rng = np.random.default_rng(120 + n)
    x = rng.standard_normal((n, n, 128)).astype(np.float32)
    f = jax.jit(jax.shard_map(lambda s: pallas_alltoall(s[0], RANK)[None],
                              mesh=rt.rank_mesh(n), in_specs=(P(RANK),),
                              out_specs=P(RANK), check_vma=False))
    got, = _run_push_protocol([x], _geo(n, 128, 3, 4), 0)
    np.testing.assert_array_equal(_bits(got), _bits(f(x)))
    g = rng.standard_normal((n, 200)).astype(np.float32)
    f = jax.jit(jax.shard_map(lambda s: pallas_ring_allgather(s[0], RANK).reshape(1, -1),
                              mesh=rt.rank_mesh(n), in_specs=(P(RANK),),
                              out_specs=P(RANK), check_vma=False))
    got, = _run_push_protocol([g], _geo(n, 200, 3, 4), 0, gather=True)
    np.testing.assert_array_equal(_bits(got.reshape(n, -1)), _bits(f(g)))


# ---------------------------------------------------------------------------
# The geometry.


def test_push_geometry_lanes_follow_the_layout():
    sms, resident = 132, 8 * 132
    big = 64 << 20  # vectors a piece: 1 GiB
    own = push_cuda.geometry(4, big, 1, sms, resident)
    assert own.lanes == push_cuda.KNOBS["push"][0] * sms
    # a card shared by the span's processes keeps the one-process ring kernel's cap
    shared = push_cuda.geometry(4, big, 2, sms, resident)
    assert shared.lanes == ipc.max_lanes(4, sms, 2)["push"] == -(-4 * sms // 4)
    assert (shared.steps, shared.step) == (1, shared.lane) and own.steps > 1
    assert push_cuda.geometry(8, big, 8, sms, resident).lanes == -(-4 * sms // 8)
    # never more than the card holds, nor than the workspace's flag region
    assert push_cuda.geometry(4, big, 1, sms, 100).lanes == 100
    assert push_cuda.geometry(4, big, 1, sms, resident, blocks_per_sm=16).lanes == \
        ipc.max_lanes(4, sms, 1)["push"]
    assert push_cuda.geometry(4, big, 2, sms, 40).lanes == 10  # resident / n
    for geo in (own, shared):
        assert geo.lanes * geo.lane >= big > (geo.lanes - 1) * geo.lane
        assert geo.steps * geo.step >= geo.lane and 1 <= geo.steps <= push_cuda.MAX_STEPS
        assert geo.lane % push_cuda.ALIGN_VECS == 0 == geo.step % push_cuda.ALIGN_VECS


def test_push_geometry_is_a_pure_function_and_small_rows_take_few_lanes():
    args = [(n, pv, pc) for n in (2, 4, 8) for pv in (1, 33, 4096, 1 << 22) for pc in (1, 4)]
    first = [push_cuda.geometry(*a, 132, 1056) for a in args]
    assert first == [push_cuda.geometry(*a, 132, 1056) for a in reversed(args)][::-1]
    tiny = push_cuda.geometry(4, 8, 1, 132, 1056)
    assert (tiny.lanes, tiny.steps) == (1, 1) and tiny.lane >= 8
    # sub-steps of about STEP_BYTES a piece, at most MAX_STEPS
    g = push_cuda.geometry(4, 1 << 22, 1, 132, 1056, step_bytes=1 << 12)
    assert g.steps == push_cuda.MAX_STEPS
    assert push_cuda.geometry(4, 1 << 22, 1, 132, 1056, step_bytes=1 << 40).steps == 1
    with pytest.raises(ValueError, match="vecs"):
        push_cuda.geometry(4, 64, 1, 132, 1056, vecs=3)
    with pytest.raises(ValueError, match="no push geometry"):
        push_cuda.geometry(1, 64, 1, 132, 1056)


def test_workspace_flag_regions_hold_every_lane_count_of_both_kernels():
    for n, pc in ((2, 1), (4, 1), (4, 4), (8, 8)):
        caps = ipc.max_lanes(n, 132, pc)
        shared = -(-4 * 132 // n)  # the one-process ring kernel's cap
        for kernel in ("push", "reduce"):
            assert caps[kernel] == (ipc.BLOCKS_PER_SM_CAP * 132 if pc == 1 else shared)
            # the regions of lanes 1..cap tile without overlap
            words = ipc.FLAG_WORDS[kernel]
            ends = [ipc._triangle(kernel, L) for L in range(caps[kernel] + 1)]
            assert all(ends[L] - ends[L - 1] == L * words * 4 for L in range(1, len(ends)))


# ---------------------------------------------------------------------------
# The wrappers' host path, with a stand-in for the built library and the
# workspace's device memory.


class _FakeLib:
    def __init__(self, sms=4, resident=32, rc=0):
        self.sms, self.resident, self.rc = sms, resident, rc
        self.launches, self.queries = [], []

    def rnr_push_resident(self, vecs, device):
        self.queries.append((vecs, device))
        return self.resident

    def rnr_push_rank(self, *args):
        self.launches.append(args)
        return self.rc

    def rnr_push_error(self, code):
        return b"fake error"


class _Span:
    def __init__(self, ws, n, per_card):
        self.ws, self.size, self.per_card, self.index = ws, n, per_card, 1

    def workspace(self, device):
        return self.ws


@pytest.fixture
def fake(monkeypatch):
    """(fake library, a function making a span of n processes, per_card of
    them on a card, whose workspace's rows are host memory)."""
    from rocnrdma_tpu_torch.ops import _build
    lib = _FakeLib()
    monkeypatch.setattr(_build, "load", lambda name: lib)
    monkeypatch.setattr(_build, "build", lambda names=(): {})
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda d: 77, raising=False)
    monkeypatch.setattr(ipc, "diag", lambda: (None, 0xD1A6))
    monkeypatch.setattr(ipc.Workspace, "finish", lambda self: None)
    props = type("P", (), {"multi_processor_count": lib.sms})
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda d: props)
    monkeypatch.setattr(ipc, "_LIVE", [])
    push_cuda._card.cache_clear()
    push_cuda.geometry_for.cache_clear()
    T.reset_launch_counts()

    def span(n, per_card=1):
        s = type("S", (), {"size": n, "index": 1, "per_card": per_card})()
        ws = ipc.Workspace(s, torch.device("cuda", 0))
        ws.capacity = 1 << 18
        mem = torch.zeros(2 * ws.capacity, dtype=torch.uint8)
        ws._rows = (mem[:ws.capacity], mem[ws.capacity:])
        ws.bases = tuple(0x10000 * (q + 1) for q in range(n))
        return _Span(ws, n, per_card)

    yield lib, span
    push_cuda._card.cache_clear()
    push_cuda.geometry_for.cache_clear()
    T.reset_launch_counts()


def _aligned(shape, dtype=torch.float32, seed=0):
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32))
    return x.to(dtype)


def _launched(lib):
    """The last launch's (dst table, flags table, src, stride, out, n, pv,
    lanes, lane, step, steps, vecs, epoch, rank, timeout, diag, device,
    stream)."""
    return lib.launches[-1]


def test_alltoall_across_aligned_row_is_read_in_place_with_nothing_staged(fake):
    lib, span = fake
    s = span(4)
    x = _aligned((1, 4, 256))
    out = A._alltoall_across_kernel(x, s, 4, 256, 256)
    args = _launched(lib)
    pv = 256 * 4 // 16
    assert args[2] == x.data_ptr() and args[3] == pv and args[5:7] == (4, pv)
    assert args[4] == out.data_ptr() and out.shape == x.shape
    geo = push_cuda.geometry(4, pv, 1, lib.sms, lib.resident)
    assert args[7:12] == (geo.lanes, geo.lane, geo.step, geo.steps, geo.vecs)
    assert args[12:14] == (1, s.index) and args[15] == 0xD1A6 and args[17] == 77
    # the tables: every rank's output row, then its flag region at these lanes
    dst, flags = args[0], args[1]
    ws = s.ws
    assert list(dst) == [b + ws.flag_bytes + ws.capacity for b in ws.bases]
    assert list(flags) == [b + ws._flags_off("push", geo.lanes) for b in ws.bases]
    assert T.staged_bytes() == dict.fromkeys(T.staged_bytes(), 0)
    assert T.launch_counts()["alltoall_across"] == 1


def test_ring_allgather_across_aligned_row_is_read_in_place_with_nothing_staged(fake):
    lib, span = fake
    s = span(3)
    x = _aligned((1, 704), torch.bfloat16)  # 704 bf16: 88 whole 16-byte vectors
    out = R._allgather_across_kernel(x, s, 3, 704)
    args = _launched(lib)
    assert args[2] == x.data_ptr() and args[3] == 0  # one piece for every rank
    assert args[4] == out.data_ptr() and out.shape == (1, 3 * 704)
    assert args[5:7] == (3, 88)
    assert T.staged_bytes() == dict.fromkeys(T.staged_bytes(), 0)
    assert T.launch_counts()["ring_allgather_across"] == 1


def test_a_padded_or_strided_row_is_staged_and_counted(fake):
    lib, span = fake
    s = span(4)
    x = _aligned((1, 4, 77))  # chunks padded to 128
    out = A._alltoall_across_kernel(x, s, 4, 77, 128)
    args = _launched(lib)
    inp = s.ws._rows[0]
    assert args[2] == inp.data_ptr() != x.data_ptr() and out.shape == x.shape
    assert args[3] == args[6] == 128 * 4 // 16
    staged = inp[:4 * 128 * 4].view(torch.float32).view(4, 128)[:, :77]
    assert torch.equal(staged, x.reshape(4, 77))
    assert T.staged_bytes()["alltoall_across_in"] == 4 * 77 * 4
    assert T.staged_bytes()["alltoall_across_out"] == 4 * 77 * 4
    # whole chunks but strided: staged in, nothing sliced out
    y = _aligned((1, 4, 256 * 2))[:, :, ::2]
    A._alltoall_across_kernel(y, s, 4, 256, 256)
    assert T.staged_bytes()["alltoall_across_in"] == 4 * 77 * 4 + 4 * 256 * 4
    assert T.staged_bytes()["alltoall_across_out"] == 4 * 77 * 4
    # an allgather row of a part vector: padded to 4 fp32
    g = _aligned((1, 30))
    R._allgather_across_kernel(g, s, 4, 30)
    assert _launched(lib)[2] == inp.data_ptr()
    assert T.staged_bytes()["ring_allgather_across_in"] == 30 * 4
    assert T.staged_bytes()["ring_allgather_across_out"] == 4 * 30 * 4
    assert T.launch_counts()["alltoall_across"] == 2
    assert T.launch_counts()["ring_allgather_across"] == 1


def test_push_lanes_follow_per_card(fake):
    lib, span = fake
    lib.resident = 6  # a card of its own may launch 6 blocks, a shared one 6 / n
    per = 4096  # 1024 vectors a piece: lanes at their cap
    x = _aligned((1, 2, per))
    lanes = {}
    for pc in (1, 2):
        A._alltoall_across_kernel(x, span(2, pc), 2, per, per)
        lanes[pc] = _launched(lib)[7]
    assert lanes[1] == min(push_cuda.KNOBS["push"][0] * lib.sms, lib.resident)
    assert lanes[2] == min(-(-4 * lib.sms // 2), lib.resident // 2) == 3
    assert lanes[1] != lanes[2]


def test_push_epoch_advances_only_when_the_launch_went_in(fake):
    lib, span = fake
    s = span(2)
    x = _aligned((1, 2, 128))
    A._alltoall_across_kernel(x, s, 2, 128, 128)
    A._alltoall_across_kernel(x, s, 2, 128, 128)
    lanes = _launched(lib)[7]
    assert [a[12] for a in lib.launches] == [1, 2]
    assert s.ws.epochs[("push", lanes)] == 2 and s.ws.launches == 2
    lib.rc = 1
    with pytest.raises(RuntimeError, match="push kernel launch across processes"):
        A._alltoall_across_kernel(x, s, 2, 128, 128)
    assert s.ws.epochs[("push", lanes)] == 2 and s.ws.launches == 2
    assert T.launch_counts()["alltoall_across"] == 2  # a refused launch is no launch
    lib.rc = 0
    R._allgather_across_kernel(x.reshape(1, -1), s, 2, 256)  # the same region
    assert _launched(lib)[12] == 3
    assert isinstance(_launched(lib)[0], ctypes.Array)


def test_expired_names_the_push_kernels_words(monkeypatch):
    words = (ctypes.c_uint * ipc.DIAG_WORDS)(2, 1, 3, 3 * WORDS + 4, 5, 6, 7, 4)
    monkeypatch.setattr(ipc, "_DIAG", [words, 0])
    msg = str(ipc.expired(2.0))
    assert "push (allgather, alltoall) kernel" in msg
    assert f"rank 1, lane 3, flag word {3 * WORDS + 4} (arrivals of sub-step 3)" in msg
    words[3] = 2 * WORDS
    assert "(entry barrier)" in str(ipc.expired(2.0))
    words[7], words[3] = 5, 2 * ipc.FLAG_WORDS["reduce"] + 2  # the reduce kernel's
    assert "reduce (allreduce) kernel" in str(ipc.expired(2.0))
    assert "(reduce arrivals of sub-step 1)" in str(ipc.expired(2.0))
