"""The port's alltoall kernel (``rocnrdma_tpu_torch.ops.alltoall_cuda``).

- The plain version against ``pallas_alltoall`` run in TPU interpret mode
  under ``shard_map`` on the fake CPU devices, as
  ``tests/test_pallas_ring.py`` runs it: bitwise (both only copy), and the
  ragged ``alltoallv`` through the port's ``cuda_ring`` arm against
  ``pallas_alltoallv``, with equal ``recv_counts``.
- A model of the CUDA kernel's protocol (copy home, global barrier, direct
  writes, arrivals and their drain per (rank, lane)), stepped through
  seeded random interleavings, since the kernel itself runs only on the
  card (``tests/test_torch_card.py``); also one rank a process, each
  rank's workspace rows copied in and out on its own stream, and a rank
  that never launches.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from rocnrdma_tpu import runtime as rt
from rocnrdma_tpu.ops import pallas_alltoall, pallas_alltoallv
from rocnrdma_tpu_torch import ops as T
from rocnrdma_tpu_torch.runtime import rank_mesh
from rocnrdma_tpu_torch.transport import Transport

from _marks import needs_tpu_interpret

RANK = rt.mesh.RANK_AXIS


def _bits(a) -> np.ndarray:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return np.ascontiguousarray(a).view(np.uint32)


@needs_tpu_interpret
@pytest.mark.parametrize("n", [2, 3, 8])
def test_alltoall_plain_bitwise_equals_pallas_alltoall(devices, n):
    # 77 trailing elements: lane-unaligned per chunk (the row-wise padding)
    x = np.random.default_rng(n).standard_normal((n, n, 77)).astype(np.float32)
    f = jax.jit(jax.shard_map(lambda s: pallas_alltoall(s[0], RANK)[None],
                              mesh=rt.rank_mesh(n), in_specs=(P(RANK),),
                              out_specs=P(RANK), check_vma=False))
    ref = f(x)
    xt = torch.from_numpy(x)
    np.testing.assert_array_equal(_bits(T.alltoall_plain(xt)), _bits(ref))
    # the wrapper takes the plain version for a CPU tensor
    np.testing.assert_array_equal(_bits(T.alltoall(xt)), _bits(ref))


def test_alltoall_plain_involution_and_validation():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (4, 4, 128)).astype(np.float32))
    assert torch.equal(T.alltoall_plain(T.alltoall_plain(x)), x)
    assert torch.equal(T.alltoall(x), x.transpose(0, 1))
    with pytest.raises(ValueError, match="leading dim"):
        T.alltoall(torch.zeros((4, 3, 8)))
    with pytest.raises(ValueError, match="counts must be"):
        T.alltoallv(x, np.zeros((3, 3), np.int64))


@needs_tpu_interpret
@pytest.mark.parametrize("n", [2, 4, 8])
def test_alltoallv_cuda_ring_arm_bitwise_equals_pallas_alltoallv(devices, n):
    rng = np.random.default_rng(n)
    cap, d = 5, 4
    counts = rng.integers(0, cap + 1, size=(n, n))
    x = rng.standard_normal((n, n, cap, d)).astype(np.float32)
    cj = jnp.asarray(counts)

    def fn(s):
        out, rc = pallas_alltoallv(s[0], cj, RANK)
        return out[None], rc[None]

    f = jax.jit(jax.shard_map(fn, mesh=rt.rank_mesh(n), in_specs=(P(RANK),),
                              out_specs=(P(RANK), P(RANK)), check_vma=False))
    ref, ref_rc = f(x)
    t = Transport(rank_mesh(n, "cpu"))
    out, rc = t.alltoallv(t.shard(x), counts, "cuda_ring")
    np.testing.assert_array_equal(_bits(out), _bits(ref))
    np.testing.assert_array_equal(rc.numpy(), np.asarray(ref_rc))
    fused, fused_rc = t.alltoallv(t.shard(x), counts, "fused")
    assert torch.equal(fused, out) and torch.equal(fused_rc, rc)
    assert t.stats()["alltoallv/cuda_ring"]["calls"] == 1


# ---------------------------------------------------------------------------
# A model of alltoall.cu's protocol. Each (rank, lane) block runs the
# kernel's action list for a sequence of launches on one flag buffer, which
# is never reset; a scheduler picks a random runnable block each tick, and a
# wait is runnable only once its flag has reached this launch's count
# e*(n-1). Ranks keep no step with each other, as on separate cards: a
# rank's lane hands its output to launch e when it enters, and takes it back
# when it leaves. The model asserts that no block writes into a rank's
# output outside that rank's part of the same launch (before the rank has
# entered this launch's barrier, or after it left), that no block leaves
# before every chunk of its output lane has landed, that every output lane
# is written exactly once a launch, that no lane deadlocks, that every flag
# ends at launches*(n-1), and that the values equal the plain version.


def _a2a_program(n, r, e):
    """alltoall.cu's actions for block (r, b) in launch e (from 1): entry
    barrier, the writes of all n chunks (its own included), arrivals."""
    return ([("enter",), ("signal", "bar"), ("wait", "bar", e * (n - 1))]
            + [("write", d) for d in range(n)]
            + [("signal", "arr"), ("wait", "arr", e * (n - 1)), ("leave",)])


def _run_a2a_protocol(xs, lanes: int, seed: int, program=_a2a_program, across=False,
                      missing=None):
    """Run one launch per input in ``xs`` (each (n, n, per) float32, per
    divisible by lanes) on one flag buffer; returns each launch's output.

    ``across``: one rank a process, each with one input and one output row
    (its IPC workspace) reused by every launch, and a stream that runs
    ``copy_in(e)``, launch e's blocks and ``copy_out(e)`` in order; the
    model asserts that a rank's blocks read its input row only after its
    copy in of the same launch, that no peer writes a rank's output row
    outside that rank's launch e (before it, or after its copy out), and
    that ``copy_out(e)`` reads only landed chunks. ``missing=(rank, e)``:
    that rank never launches e; returns the expiries (rank, lane, flag
    word) every other rank's stuck lanes end in."""
    n, _, per = xs[0].shape
    w = per // lanes
    outs = [np.full_like(x, np.nan) for x in xs]
    writes = np.zeros((len(xs), n, n, lanes), int)  # (launch, dst, src, lane)
    ws_in = np.full((n, n, per), np.nan, np.float32)
    ws_out = np.full((n, n, per), np.nan, np.float32)
    staged, released, copied = np.zeros(n, int), np.zeros(n, int), np.zeros(n, int)
    left = np.zeros((n, lanes), int)
    flags = {}
    inside = np.zeros((n, lanes), int)  # the launch a (rank, lane) is in, 0 between
    progs = {}
    for r in range(n):
        prog = [(e, a) for e in range(1, len(xs) + 1)
                for a in ([("gate",)] if across else []) + program(n, r, e)]
        for b in range(lanes):
            progs[(r, b)] = prog
        if across:
            last = len(xs) if missing is None or missing[0] != r else missing[1] - 1
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
        if key[0] == "stream":
            r = key[1]
            if act[0] == "copy_in":
                ws_in[r] = xs[e - 1][r]
                staged[r] = e
            elif act[0] == "release":
                released[r] = e
            elif act[0] == "copy_out":
                assert (writes[e - 1, r] == 1).all(), \
                    f"rank {r} copied out launch {e} before every chunk landed"
                outs[e - 1][r] = ws_out[r]
                copied[r] = e
            continue
        r, b = key
        lo, hi = b * w, (b + 1) * w
        if act[0] == "enter":
            inside[r, b] = e
        elif act[0] == "signal":
            for s in range(1, n):
                f = (act[1], (r + s) % n, b)
                flags[f] = flags.get(f, 0) + 1
        elif act[0] == "write":
            d = act[1]
            assert inside[d, b] == e, \
                f"wrote into rank {d} outside its part of launch {e}"
            if across:
                assert staged[r] == e, f"rank {r} read its input row before copy_in({e})"
                assert released[d] == e and copied[d] < e, \
                    f"wrote into rank {d}'s output row outside its launch {e}"
                ws_out[d, r, lo:hi] = ws_in[r, d, lo:hi]
            else:
                outs[e - 1][d, r, lo:hi] = xs[e - 1][r, d, lo:hi]
            writes[e - 1, d, r, b] += 1
        elif act[0] == "leave":
            if not across:
                assert (writes[e - 1, r, :, b] == 1).all(), \
                    f"rank {r} left launch {e} before every chunk landed"
            inside[r, b] = 0
            left[r, b] = e

    stuck = [k for k in progs if pcs[k] != len(progs[k])]
    if missing is not None:
        expired = []
        for k in stuck:
            act = progs[k][pcs[k]][1]
            if k[0] != "stream" and act[0] == "wait":
                expired.append((k[0], k[1], k[1] * 2 + ("bar", "arr").index(act[1])))
        return sorted(expired)
    assert not stuck, f"deadlock: lanes {stuck} blocked"
    assert (writes == 1).all(), "an output lane written other than once"
    for r in range(n):
        for b in range(lanes):
            assert flags[("bar", r, b)] == len(xs) * (n - 1)
            assert flags[("arr", r, b)] == len(xs) * (n - 1)
    return outs


@pytest.mark.parametrize("n", [2, 3, 8])
def test_alltoall_kernel_protocol_model_random_interleavings(n):
    lanes, per = 3, 3 * 128
    x = np.random.default_rng(n).standard_normal((n, n, per)).astype(np.float32)
    want = T.alltoall_plain(torch.from_numpy(x)).numpy()
    for seed in range(200):
        got, = _run_a2a_protocol([x], lanes, seed)
        np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("n", [2, 3, 8])
def test_alltoall_kernel_protocol_model_back_to_back_epochs(n):
    # three launches on one flag buffer with no reset in between (the
    # wrapper's cached flags), each waiting for its own epoch's counts
    lanes, per = 2, 2 * 128
    rng = np.random.default_rng(20 + n)
    xs = [rng.standard_normal((n, n, per)).astype(np.float32) for _ in range(3)]
    wants = [T.alltoall_plain(torch.from_numpy(x)).numpy() for x in xs]
    for seed in range(200):
        gots = _run_a2a_protocol(xs, lanes, seed)
        for got, want in zip(gots, wants):
            np.testing.assert_array_equal(_bits(got), _bits(want))


def _a2a_write_before_barrier(n, r, e):
    prog = _a2a_program(n, r, e)
    writes = [a for a in prog if a[0] == "write"]
    rest = [a for a in prog if a[0] != "write"]
    return rest[:2] + writes + rest[2:]  # enter, signal, writes, wait, ...


def _a2a_exit_before_arrivals(n, r, e):
    return [a for a in _a2a_program(n, r, e) if a[:2] != ("wait", "arr")]


@pytest.mark.parametrize("n", [2, 3, 8])
@pytest.mark.parametrize("program", [_a2a_write_before_barrier,
                                     _a2a_exit_before_arrivals])
def test_alltoall_kernel_protocol_model_rejects_unsafe_orders(n, program):
    # the model is strict enough to catch a kernel that writes into a rank
    # before that rank entered this epoch's barrier, or drains (leaves)
    # before every chunk of its lane has landed
    lanes, per = 2, 2 * 128
    rng = np.random.default_rng(40 + n)
    xs = [rng.standard_normal((n, n, per)).astype(np.float32) for _ in range(3)]
    caught = 0
    for seed in range(50):
        try:
            _run_a2a_protocol(xs, lanes, seed, program)
        except AssertionError:
            caught += 1
    assert caught > 0


@pytest.mark.parametrize("n", [2, 3, 8])
def test_alltoall_kernel_protocol_model_across_processes(n):
    # one rank a process: its workspace rows reused by three launches,
    # copied in before and out after each on its own stream
    lanes, per = 2, 2 * 128
    rng = np.random.default_rng(60 + n)
    xs = [rng.standard_normal((n, n, per)).astype(np.float32) for _ in range(3)]
    wants = [T.alltoall_plain(torch.from_numpy(x)).numpy() for x in xs]
    for seed in range(10):
        gots = _run_a2a_protocol(xs, lanes, seed, across=True)
        for got, want in zip(gots, wants):
            np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("n", [2, 3, 8])
@pytest.mark.parametrize("program", [_a2a_write_before_barrier,
                                     _a2a_exit_before_arrivals])
def test_alltoall_kernel_protocol_model_across_processes_rejects_unsafe_orders(n, program):
    lanes, per = 2, 2 * 128
    rng = np.random.default_rng(80 + n)
    xs = [rng.standard_normal((n, n, per)).astype(np.float32) for _ in range(3)]
    caught = 0
    for seed in range(10):
        try:
            _run_a2a_protocol(xs, lanes, seed, program, across=True)
        except AssertionError:
            caught += 1
    assert caught > 0


@pytest.mark.parametrize("n", [2, 3, 8])
def test_alltoall_kernel_protocol_model_a_rank_that_never_launches_expires_the_others(n):
    # rank 0 dies before launch 2: every other rank's every lane ends in the
    # bounded wait of launch 2's entry barrier, on its lane's word
    lanes, per = 2, 2 * 128
    rng = np.random.default_rng(100 + n)
    xs = [rng.standard_normal((n, n, per)).astype(np.float32) for _ in range(2)]
    want = [(r, b, 2 * b) for r in range(1, n) for b in range(lanes)]
    for seed in range(10):
        assert _run_a2a_protocol(xs, lanes, seed, across=True, missing=(0, 2)) == want


# ---------------------------------------------------------------------------
# The wrapper's host path, with a stand-in for the built library: its lane
# and flag caches are pure functions of their keys, and the epoch advances
# by one for each launch that went in, and only then.


class _FakeLib:
    def __init__(self, rc=0):
        self.queries, self.launches, self.rc = [], [], rc

    def rnr_a2a_lanes(self, n, per, code, device):
        self.queries.append((n, per, code, device))
        return 1 + (per // 128 + n + code) % 7

    def rnr_alltoall_rows(self, *args):
        self.launches.append(args)
        return self.rc

    def rnr_a2a_error(self, code):
        return b"fake error"


@pytest.fixture
def fake_lib(monkeypatch):
    from rocnrdma_tpu_torch.ops import _build, alltoall_cuda
    lib = _FakeLib()
    monkeypatch.setattr(_build, "load", lambda name: lib)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda d: 77,
                        raising=False)
    alltoall_cuda._lanes.cache_clear()
    monkeypatch.setattr(alltoall_cuda, "_FLAGS", {})
    yield lib
    alltoall_cuda._lanes.cache_clear()


def test_alltoall_lane_and_flag_caches_are_pure_functions_of_their_keys(fake_lib):
    from rocnrdma_tpu_torch.ops import alltoall_cuda as A
    keys = [(0, 8, 128, 0), (0, 8, 128, 1), (0, 3, 4096, 0), (1, 8, 128, 0)]
    first = [A._lanes(*k) for k in keys]
    again = [A._lanes(*k) for k in reversed(keys)][::-1]
    assert first == again
    assert fake_lib.queries == [(n, per, code, dev) for dev, n, per, code in keys]
    cpu = torch.device("cpu")
    f = A._flags(cpu, 5, 8, 3)
    assert A._flags(cpu, 5, 8, 3) is f
    assert f[0].shape == (8, 3 * A.FLAG_WORDS) and f[0].dtype == torch.int32
    assert not bool(f[0].any()) and f[1] == 0
    others = [A._flags(cpu, 6, 8, 3), A._flags(cpu, 5, 3, 3), A._flags(cpu, 5, 8, 4)]
    assert all(o is not f for o in others) and len(A._FLAGS) == 4


def test_alltoall_launch_advances_the_epoch_only_when_it_went_in(fake_lib):
    from rocnrdma_tpu_torch.ops import alltoall_cuda as A
    n, per = 4, 256
    src = torch.zeros((n, n * per))
    out = torch.empty_like(src)
    A._launch(src, out, n, per)
    A._launch(src, out, n, per)
    A._launch(src, out, n, per, sync=False)  # the data pass alone: no epoch
    (entry,) = A._FLAGS.values()
    assert entry[1] == 2
    epochs = [args[10] for args in fake_lib.launches]
    syncs = [args[11] for args in fake_lib.launches]
    assert epochs == [1, 2, 2] and syncs == [1, 1, 0]
    # the tables are built in C from each tensor's base and row stride
    args = fake_lib.launches[0]
    assert args[:4] == (src.data_ptr(), n * per * 4, out.data_ptr(), n * per * 4)
    assert args[5] == entry[0].stride(0) * 4 and args[13] == 77
    fake_lib.rc = 1
    with pytest.raises(RuntimeError, match="alltoall kernel launch"):
        A._launch(src, out, n, per)
    assert entry[1] == 2  # a refused launch leaves the epoch where it was
    fake_lib.rc = 0
    A._launch(src, out, n, per)
    assert entry[1] == 3 and fake_lib.launches[-1][10] == 3
