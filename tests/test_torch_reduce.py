"""The reduce kernel across processes (``ops/csrc/reduce_across.cu``,
``rocnrdma_tpu_torch.ops.push_cuda.launch_reduce``): the allreduce and the
reduce-scatter of a 1-D mesh that spans processes, one rank a process
(``ring_cuda``'s ``ring_allreduce_across``, ``hbm_ring_allreduce_across``,
``_tiled_allreduce_across`` and ``ring_reduce_scatter_across``).

- The model of the kernel's protocol (``tests/_reduce_model.py``) in both
  modes, with K sub-steps, out of place and in place, stepped through
  seeded random interleavings over back-to-back launches on one flag
  region; a rank that never launches; and the unsafe orders the model must
  reject: a push before the entry barrier, a fold before its reduce
  arrivals, a drain before its allgather arrivals, an in-place write of a
  range not yet pushed, and a next launch's push into a slot not yet folded
  or drained. The kernel itself runs only on the card
  (``tests/test_torch_card.py``, ``chip_smoke.py`` phase 14).
- The model's results against the JAX package's ``pallas_ring_allreduce``
  and ``pallas_ring_reduce_scatter`` in TPU interpret mode, bitwise.
- The geometry: lanes from the card's blocks with a card to itself, the
  shared cap otherwise, the same answer for every process.
- The wrappers' host path with a stand-in for the built library and the
  workspace's device memory: an aligned row's own pointer reaches the
  launch with nothing staged, a padded or strided row is staged and
  counted, in place passes the row as the result, and the epoch advances
  only when a launch went in.
"""

import ctypes

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import _reduce_model as M
from rocnrdma_tpu import runtime as rt
from rocnrdma_tpu.ops import pallas_ring_allreduce, pallas_ring_reduce_scatter
from rocnrdma_tpu_torch import ops as T
from rocnrdma_tpu_torch.ops import ipc, push_cuda
from rocnrdma_tpu_torch.ops import ring_cuda as R

from _marks import needs_tpu_interpret

RANK = rt.mesh.RANK_AXIS
MODES = pytest.mark.parametrize("mode", ["ar", "rs"], ids=["allreduce", "reduce_scatter"])


def _check(launches, g, seed, **kw):
    for (mode, x, _), got in zip(launches, M.run(launches, g, seed, **kw)):
        np.testing.assert_array_equal(M.bits(got), M.bits(M.want(mode, x)))


# ---------------------------------------------------------------------------
# The protocol model.


@MODES
@pytest.mark.parametrize("n", [2, 3, 8])
def test_reduce_protocol_model_random_interleavings(n, mode):
    # 3 lanes of 3 sub-steps over 20 elements a chunk: the last lane and its
    # last sub-steps ragged
    x, = M.inputs(n, 20, 1, n)
    for seed in range(60):
        _check([(mode, x, False)], M.geo(20, 3, 3), seed)


@pytest.mark.parametrize("steps", [1, 2, M.MAX_STEPS])
@pytest.mark.parametrize("n", [2, 3, 4])
def test_reduce_protocol_model_back_to_back_epochs(n, steps):
    # four launches on one flag region, never reset, each waiting for its
    # own epoch's counts: every word advances once a launch whatever the
    # mode, so an allreduce, a reduce-scatter, an in-place allreduce and a
    # reduce-scatter share it
    xs = M.inputs(n, 16, 4, 20 + n)
    launches = [("ar", xs[0], False), ("rs", xs[1], False), ("ar", xs[2], True),
                ("rs", xs[3], False)]
    for seed in range(20):
        _check(launches, M.geo(16, 2, steps), seed)


@pytest.mark.parametrize("n", [2, 3, 8])
def test_reduce_protocol_model_in_place(n):
    # the result overwrites the row it was folded from: every range pushed
    # before the drain writes it, chunk r folded before it is stored
    xs = M.inputs(n, 12, 3, 40 + n)
    launches = [("ar", x, True) for x in xs]
    for seed in range(20):
        _check(launches, M.geo(12, 2, 3), seed)


@MODES
@pytest.mark.parametrize("n", [2, 4])
def test_reduce_protocol_model_with_the_kernels_own_geometry(n, mode):
    # the lanes and sub-steps geometry() gives a small card: 3 SMs, every
    # lane a whole 32-vector run, the last lane ragged
    pv = 7 * push_cuda.MIN_LANE_VECS + 40
    g = push_cuda.geometry(n, pv, 1, sms=3, resident=24, blocks_per_sm=2,
                           step_bytes=push_cuda.ALIGN_VECS * push_cuda.VEC, kernel="reduce")
    assert g.lanes == 6 and g.steps > 1 and g.lanes * g.lane >= pv > (g.lanes - 1) * g.lane
    xs = M.inputs(n, pv, 2, 60 + n)
    for seed in range(3):
        _check([(mode, xs[0], False), (mode, xs[1], mode == "ar")], g, seed)


_UNSAFE = {"push_before_barrier": ({"push_early": True}, "ar", False),
           "fold_before_reduce_arrivals": ({"fold_waits": False}, "rs", False),
           "drain_before_allgather_arrivals": ({"drain_waits": False}, "ar", False),
           "in_place_write_before_push": ({"drain_first": True}, "ar", True),
           "barrier_one_launch_behind": ({"barrier_lag": 1}, "ar", False)}
# what each unsafe order is caught as
_CAUGHT = {"push_before_barrier": "outside its part|before it was folded",
           "fold_before_reduce_arrivals": "folded launch",
           "drain_before_allgather_arrivals": "drained launch",
           "in_place_write_before_push": "in place before it pushed",
           "barrier_one_launch_behind": "outside|before it was"}


@pytest.mark.parametrize("unsafe", list(_UNSAFE))
@pytest.mark.parametrize("n", [2, 3])
def test_reduce_protocol_model_rejects_unsafe_orders(n, unsafe):
    # the model is strict enough to catch each unsafe order, as what it is
    import re

    variant, mode, in_place = _UNSAFE[unsafe]
    xs = M.inputs(n, 16, 3, 80 + n)
    caught = []
    for seed in range(30):
        try:
            M.run([(mode, x, in_place) for x in xs], M.geo(16, 2, 2), seed, variant)
        except AssertionError as e:
            caught.append(str(e))
    assert caught and all(re.search(_CAUGHT[unsafe], m) for m in caught), caught[:3]


@MODES
@pytest.mark.parametrize("n", [2, 3, 8])
def test_reduce_protocol_model_a_rank_that_never_launches_expires_the_others(n, mode):
    # rank 0 dies before launch 2: every other rank's every lane ends in the
    # bounded wait of launch 2's entry barrier, on its lane's word
    xs = M.inputs(n, 16, 2, 100 + n)
    g = M.geo(16, 2, 3)
    want = [(r, b, b * M.WORDS) for r in range(1, n) for b in range(g.lanes)]
    for seed in range(10):
        assert M.run([(mode, x, False) for x in xs], g, seed, missing=(0, 2)) == want


@needs_tpu_interpret
@pytest.mark.parametrize("n", [2, 4])
def test_reduce_protocol_model_bitwise_equals_pallas(devices, n):
    # one element a vector: the model's results against the JAX package's
    # ring kernels on the same rows (chunks of 128: no padding)
    rng = np.random.default_rng(120 + n)
    x = rng.standard_normal((n, n, 128)).astype(np.float32)
    mesh = rt.rank_mesh(n)
    for mode, fn in (("ar", pallas_ring_allreduce), ("rs", pallas_ring_reduce_scatter)):
        f = jax.jit(jax.shard_map(lambda s: fn(s[0], RANK)[None], mesh=mesh,
                                  in_specs=(P(RANK),), out_specs=P(RANK), check_vma=False))
        got, = M.run([(mode, x, False)], M.geo(128, 3, 4), 0)
        np.testing.assert_array_equal(M.bits(got.reshape(n, -1)),
                                      M.bits(f(x.reshape(n, -1))))


# ---------------------------------------------------------------------------
# The geometry.


def test_reduce_geometry_lanes_follow_the_layout():
    sms, resident = 132, 2 * 132
    big = 16 << 20  # vectors a chunk: 4 x 1 GiB
    bps = push_cuda.KNOBS["reduce"][0]
    own = push_cuda.geometry(4, big, 1, sms, resident, kernel="reduce")
    assert own.lanes == bps * sms and own.vecs == push_cuda.KNOBS["reduce"][1]
    # a card shared by the span's processes keeps the one-process cap, and
    # every process's grid fits the card together
    shared = push_cuda.geometry(4, big, 2, sms, resident, kernel="reduce")
    assert shared.lanes == min(ipc.max_lanes(4, sms, 2)["reduce"], resident // 4) == 66
    # one sub-step a lane there: each pass that waits costs a round of the
    # card's time slices; a card of its own cuts a lane into sub-steps
    assert (shared.steps, shared.step) == (1, shared.lane) and own.steps > 1
    assert push_cuda.geometry(8, big, 8, sms, 8 * 132, kernel="reduce").lanes == \
        -(-4 * sms // 8)
    assert push_cuda.geometry(4, big, 1, sms, 100, kernel="reduce").lanes == 100
    assert push_cuda.geometry(4, big, 1, sms, 8 * sms, blocks_per_sm=16,
                              kernel="reduce").lanes == ipc.max_lanes(4, sms, 1)["reduce"]
    for g in (own, shared):
        assert g.lanes * g.lane >= big > (g.lanes - 1) * g.lane
        assert g.steps * g.step >= g.lane and 1 <= g.steps <= M.MAX_STEPS
    with pytest.raises(ValueError, match="vecs"):  # no 8-vector instantiation
        push_cuda.geometry(4, 64, 1, sms, resident, vecs=8, kernel="reduce")
    with pytest.raises(ValueError, match="no reduce geometry"):
        push_cuda.geometry(1, 64, 1, sms, resident, kernel="reduce")


def test_reduce_geometry_is_a_pure_function_of_its_arguments():
    args = [(n, pv, pc) for n in (2, 4, 8) for pv in (1, 33, 4096, 1 << 22) for pc in (1, 4)]
    first = [push_cuda.geometry(*a, 132, 264, kernel="reduce") for a in args]
    assert first == [push_cuda.geometry(*a, 132, 264, kernel="reduce")
                     for a in reversed(args)][::-1]
    tiny = push_cuda.geometry(4, 8, 1, 132, 264, kernel="reduce")
    assert (tiny.lanes, tiny.steps) == (1, 1)


# ---------------------------------------------------------------------------
# The wrappers' host path, with a stand-in for the built library and the
# workspace's device memory.


class _FakeLib:
    def __init__(self, sms=4, resident=16, rc=0):
        self.sms, self.resident, self.rc = sms, resident, rc
        self.launches, self.queries = [], []

    def rnr_reduce_resident(self, n, code, vecs, device):
        self.queries.append((n, code, vecs, device))
        return self.resident

    def rnr_reduce_rank(self, *args):
        self.launches.append(args)
        return self.rc

    def rnr_reduce_error(self, code):
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


def _row(elems, dtype=torch.float32, seed=0):
    x = np.random.default_rng(seed).standard_normal((1, elems)).astype(np.float32)
    return torch.from_numpy(x).to(dtype)


# rnr_reduce_rank's arguments after the three tables
_SRC, _OUT, _N, _PV, _LANES, _LANE, _STEP, _STEPS, _VECS, _CODE, _MODE, _EPOCH, _RANK = \
    range(3, 16)


def test_allreduce_across_aligned_row_is_read_in_place_with_nothing_staged(fake):
    lib, span = fake
    s = span(4)
    x = _row(4 * 256)  # 4 chunks of 256 fp32: whole 128-element chunks
    out = R._allreduce_across(x, s, R.LANES, "ring_allreduce_across")
    args = lib.launches[-1]
    pv = 256 * 4 // 16
    assert args[_SRC] == x.data_ptr() and args[_OUT] == out.data_ptr() != x.data_ptr()
    assert out.shape == x.shape and args[_N:_PV + 1] == (4, pv)
    g = push_cuda.geometry(4, pv, 1, lib.sms, lib.resident, kernel="reduce")
    assert args[_LANES:_VECS + 1] == (g.lanes, g.lane, g.step, g.steps, g.vecs)
    assert args[_CODE:_MODE + 1] == (0, R.MODE_AR) and args[_EPOCH:_RANK + 1] == (1, s.index)
    assert args[17] == 0xD1A6 and args[19] == 77
    # the tables: every rank's input row, output row, flag region at these lanes
    ws = s.ws
    assert [list(t) for t in args[:3]] == [
        [b + ws.flag_bytes for b in ws.bases],
        [b + ws.flag_bytes + ws.capacity for b in ws.bases],
        [b + ws._flags_off("reduce", g.lanes) for b in ws.bases]]
    assert lib.queries[-1][:3] == (4, 0, g.vecs)
    assert T.staged_bytes() == dict.fromkeys(T.staged_bytes(), 0)
    assert T.launch_counts()["ring_allreduce_across"] == 1


def test_reduce_scatter_across_aligned_row_is_read_in_place_with_nothing_staged(fake):
    lib, span = fake
    s = span(3)
    x = _row(3 * 128 * 2, torch.bfloat16)
    out = R._reduce_across(x, s, R.MODE_RS, 256, 3 * 256, None, "ring_reduce_scatter_across")
    args = lib.launches[-1]
    assert args[_SRC] == x.data_ptr() and args[_OUT] == out.data_ptr()
    assert out.shape == (1, 256) and args[_PV] == 256 * 2 // 16
    assert args[_CODE:_MODE + 1] == (1, R.MODE_RS)
    assert T.staged_bytes() == dict.fromkeys(T.staged_bytes(), 0)


def test_a_padded_or_strided_row_is_staged_and_counted(fake):
    lib, span = fake
    s = span(4)
    x = _row(1000)  # chunks padded to 256: staged into a buffer of 4 x 256
    out = R._allreduce_across(x, s, R.LANES, "ring_allreduce_across")
    args = lib.launches[-1]
    assert args[_SRC] == args[_OUT] != x.data_ptr()  # reduced in place on the copy
    assert args[_PV] == 256 * 4 // 16 and out.shape == x.shape
    assert T.staged_bytes()["ring_allreduce_across_in"] == 1000 * 4
    assert T.staged_bytes()["ring_allreduce_across_out"] == 0  # sliced: a view
    # whole chunks but strided: staged in
    y = _row(2 * 4 * 256)[:, ::2]
    R._reduce_across(y, s, R.MODE_RS, 256, 4 * 256, None, "ring_reduce_scatter_across")
    assert lib.launches[-1][_SRC] != y.data_ptr()
    assert T.staged_bytes()["ring_reduce_scatter_across_in"] == 4 * 256 * 4
    # in place on a padded row: staged in, the result copied back into x
    z = _row(1000, seed=1)
    assert R._allreduce_across(z, s, 8 * R.LANES, "hbm_ring_allreduce_across",
                               into=z) is z
    assert T.staged_bytes()["hbm_ring_allreduce_across_in"] == 1000 * 4
    assert T.staged_bytes()["hbm_ring_allreduce_across_out"] == 1000 * 4
    assert T.staged_bytes()["ring_allreduce_across_in"] == 1000 * 4
    assert T.launch_counts()["ring_allreduce_across"] == 1
    assert T.launch_counts()["hbm_ring_allreduce_across"] == 1


def test_in_place_passes_the_row_as_the_result(fake):
    lib, span = fake
    s = span(2)
    x = _row(2 * 8 * 128)  # whole 8-row tiles a chunk
    assert R._allreduce_across(x, s, 8 * R.LANES, "hbm_ring_allreduce_across", into=x) is x
    args = lib.launches[-1]
    assert args[_SRC] == args[_OUT] == x.data_ptr() and args[_MODE] == R.MODE_AR
    assert T.staged_bytes() == dict.fromkeys(T.staged_bytes(), 0)
    assert T.launch_counts()["hbm_ring_allreduce_across"] == 1


def test_reduce_lanes_follow_per_card(fake):
    lib, span = fake
    lib.resident = 6  # a card of its own may launch 6 blocks, a shared one 6 / n
    x = _row(2 * 4096)  # 1024 vectors a chunk: lanes at their cap
    lanes = {}
    for pc in (1, 2):
        R._allreduce_across(x, span(2, pc), R.LANES, "ring_allreduce_across")
        lanes[pc] = lib.launches[-1][_LANES]
    assert lanes[1] == min(push_cuda.KNOBS["reduce"][0] * lib.sms, lib.resident)
    assert lanes[2] == min(-(-4 * lib.sms // 2), lib.resident // 2) == 3


def test_reduce_epoch_advances_only_when_the_launch_went_in(fake):
    lib, span = fake
    s = span(2)
    x = _row(2 * 128)
    R._allreduce_across(x, s, R.LANES, "ring_allreduce_across")
    R._reduce_across(x, s, R.MODE_RS, 128, 256, None,  # the same flag region
                     "ring_reduce_scatter_across")
    lanes = lib.launches[-1][_LANES]
    assert [a[_EPOCH] for a in lib.launches] == [1, 2]
    assert s.ws.epochs[("reduce", lanes)] == 2 and s.ws.launches == 2
    lib.rc = 1
    with pytest.raises(RuntimeError, match="reduce kernel launch across processes"):
        R._allreduce_across(x, s, R.LANES, "ring_allreduce_across")
    assert s.ws.epochs[("reduce", lanes)] == 2 and s.ws.launches == 2
    assert T.launch_counts()["ring_allreduce_across"] == 1  # a refused launch is no launch
    lib.rc = 0
    R._allreduce_across(x, s, R.LANES, "ring_allreduce_across")
    assert lib.launches[-1][_EPOCH] == 3
    assert isinstance(lib.launches[-1][0], ctypes.Array)


def test_expired_names_the_reduce_kernels_words(monkeypatch):
    W, S = M.WORDS, M.MAX_STEPS
    words = (ctypes.c_uint * ipc.DIAG_WORDS)(2, 1, 3, 3 * W + 2, 5, 6, 7, 5)
    monkeypatch.setattr(ipc, "_DIAG", [words, 0])
    msg = str(ipc.expired(2.0))
    assert "reduce (allreduce) kernel" in msg
    assert f"rank 1, lane 3, flag word {3 * W + 2} (reduce arrivals of sub-step 1)" in msg
    words[3] = 2 * W + 1 + S + 4
    assert "(allgather arrivals of sub-step 4)" in str(ipc.expired(2.0))
    words[3], words[7] = 2 * W, 6
    assert "reduce (reduce_scatter) kernel" in str(ipc.expired(2.0))
    assert "(entry barrier)" in str(ipc.expired(2.0))
