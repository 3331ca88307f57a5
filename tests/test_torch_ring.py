"""The port's ring kernels (``rocnrdma_tpu_torch.ops.ring_cuda``): the
allreduce, reduce-scatter and allgather modes of ``ops/csrc/ring.cu``.

- The plain versions against the Pallas ring kernels run in TPU interpret
  mode under ``shard_map`` on the fake CPU devices, as
  ``tests/test_pallas_ring.py`` runs them: bitwise in float32 and bfloat16
  (both fold ``mine + recvd`` per hop, rounded to the buffer dtype once per
  hop, in the same hop order and padding; the allgather only copies).
- A model of the CUDA kernel's protocol (entry barrier, direct reads in
  fold order, writes, exit arrivals, per (rank, lane), epoch-counted flags
  over back-to-back launches) in each mode, stepped through seeded random
  interleavings: the stand-in for the interpret-mode backpressure test,
  since the kernel itself runs only on the card.
- Across processes, one rank a process: the plain version that a CPU row
  takes, in 3 gloo processes, stacked, against the Pallas ring allreduce;
  and the protocol model with each rank's workspace rows copied in and out
  on its own stream, and with a rank that never launches.
- The kernels themselves run on the card: ``tests/test_torch_card.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from rocnrdma_tpu import runtime as rt
from rocnrdma_tpu.ops import (
    pallas_hbm_ring_allreduce,
    pallas_ring_allgather,
    pallas_ring_allreduce,
    pallas_ring_reduce_scatter,
)
from rocnrdma_tpu_torch import ops as T
from rocnrdma_tpu_torch.collectives.schedule import sim_ring_allreduce

from _marks import needs_tpu_interpret

RANK = rt.mesh.RANK_AXIS

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _shmap(fn, n):
    mesh = rt.rank_mesh(n)
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=(P(RANK),),
                                 out_specs=P(RANK), check_vma=False))


def _bits(a) -> np.ndarray:
    """Raw bits of a jax/numpy array or a torch tensor, as unsigned ints."""
    if isinstance(a, torch.Tensor):
        a = a.contiguous()
        a = a.view(torch.int16 if a.element_size() == 2 else torch.int32).numpy()
    a = np.asarray(a)
    return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint32)


def _inputs(n, elems, dtype, seed):
    x = np.random.default_rng(seed).standard_normal((n, elems)).astype(np.float32)
    jd, td = DTYPES[dtype]
    return jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)


@needs_tpu_interpret
@pytest.mark.parametrize("n,dtype", [(2, "float32"), (3, "float32"),
                                     (4, "float32"), (8, "float32"),
                                     (3, "bfloat16"), (8, "bfloat16")])
def test_ring_plain_bitwise_equals_pallas_ring(devices, n, dtype):
    # 1000 elements: unaligned, exercises the 128-lane chunk padding
    xj, xt = _inputs(n, 1000, dtype, seed=n)
    ref = _shmap(lambda s: pallas_ring_allreduce(s[0], RANK)[None], n)(xj)
    x_before = xt.clone()
    got = T.ring_allreduce_plain(xt)
    np.testing.assert_array_equal(_bits(got), _bits(ref))
    # the wrapper takes the plain version for a CPU tensor, out of place
    np.testing.assert_array_equal(_bits(T.ring_allreduce(xt)), _bits(ref))
    assert torch.equal(xt, x_before)


_ACROSS = """
import sys, numpy as np, torch, torch.distributed as dist
from rocnrdma_tpu_torch.ops import ring_cuda as R
from rocnrdma_tpu_torch.runtime.init import leave
from rocnrdma_tpu_torch.runtime.mesh import rank_mesh
rank, world, port, d = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=world, rank=rank)
span = rank_mesh(world, "cpu", group=dist.group.WORLD).span
x = np.load(f"{d}/x.npy")
for dtype, bits in ((torch.float32, torch.int32), (torch.bfloat16, torch.int16)):
    row = torch.from_numpy(x[rank:rank + 1]).to(dtype)
    out = R.ring_allreduce_across(row, span)  # a CPU row: the plain version
    np.save(f"{d}/{str(dtype)[6:]}_{rank}.npy", out.view(bits).numpy())
dist.destroy_process_group()
leave(0)
"""
_ACROSS_RUNS: dict = {}


def _across_rows(tmp_path_factory, n: int) -> tuple:
    """The rows ``ring_allreduce_across`` gives n gloo processes, each with
    its row of one seeded input (float32 and bfloat16), and that input."""
    if n not in _ACROSS_RUNS:
        import os
        import subprocess
        import sys

        from rocnrdma_tpu_torch.runtime.multiprocess import free_port
        d = str(tmp_path_factory.mktemp("across"))
        x = np.random.default_rng(5).standard_normal((n, 1000)).astype(np.float32)
        np.save(f"{d}/x.npy", x)
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env = dict(os.environ, PYTHONPATH=repo)
        port = free_port()
        procs = [subprocess.Popen([sys.executable, "-c", _ACROSS, str(r), str(n), str(port),
                                   d], cwd=repo, env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True) for r in range(n)]
        for p in procs:
            _, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-2000:]
        _ACROSS_RUNS[n] = (x, d)
    return _ACROSS_RUNS[n]


@needs_tpu_interpret
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ring_allreduce_across_three_processes_bitwise_equals_pallas_ring(
        devices, tmp_path_factory, dtype):
    # each of 3 gloo processes passes only its row; stacked, their rows are
    # the reference's ring allreduce of the whole input, bit for bit
    n = 3
    x, d = _across_rows(tmp_path_factory, n)
    jd, _ = DTYPES[dtype]
    ref = _shmap(lambda s: pallas_ring_allreduce(s[0], RANK)[None], n)(
        jnp.asarray(x).astype(jd))
    got = np.concatenate([np.load(f"{d}/{dtype}_{r}.npy") for r in range(n)])
    np.testing.assert_array_equal(got.view(_bits(ref).dtype), _bits(ref))


@needs_tpu_interpret
@pytest.mark.parametrize("n,dtype", [(2, "float32"), (3, "float32"),
                                     (4, "float32"), (8, "float32"),
                                     (4, "bfloat16")])
def test_hbm_ring_plain_bitwise_equals_pallas_hbm_ring_in_place(devices, n, dtype):
    # two 8x128 tiles per chunk plus a ragged tail (the tile padding path)
    xj, xt = _inputs(n, n * 8 * 128 + 57, dtype, seed=10 + n)
    ref = _shmap(lambda s: pallas_hbm_ring_allreduce(
        s[0], RANK, tile_rows=8)[None], n)(xj)
    ptr = xt.data_ptr()
    out = T.hbm_ring_allreduce(xt, tile_rows=8)
    assert out is xt and xt.data_ptr() == ptr  # in place, like the aliasing
    np.testing.assert_array_equal(_bits(xt), _bits(ref))
    xj2, xt2 = _inputs(n, n * 8 * 128 + 57, dtype, seed=10 + n)
    assert T.hbm_ring_allreduce_plain(xt2, tile_rows=8) is xt2
    np.testing.assert_array_equal(_bits(xt2), _bits(ref))


@pytest.mark.parametrize("n", [2, 3, 5, 8])
def test_ring_plain_equals_numpy_simulator(n):
    # size a multiple of n*128: the padded chunks are the simulator's chunks
    x = np.random.default_rng(n).standard_normal((n, n * 256)).astype(np.float32)
    got = T.ring_allreduce_plain(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(sim_ring_allreduce(x)))


@needs_tpu_interpret
@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_ring_reduce_scatter_plain_bitwise_equals_pallas(devices, n):
    xj, xt = _inputs(n, n * 2 * 128, "float32", seed=20 + n)  # n*128-aligned
    ref = _shmap(lambda s: pallas_ring_reduce_scatter(s[0], RANK)[None], n)(xj)
    got = T.ring_reduce_scatter_plain(xt)
    assert got.shape == (n, 2 * 128)
    np.testing.assert_array_equal(_bits(got), _bits(ref))
    # the wrapper takes the plain version for a CPU tensor; the tiling of
    # the chunk changes no bit
    np.testing.assert_array_equal(_bits(T.ring_reduce_scatter(xt)), _bits(ref))
    np.testing.assert_array_equal(_bits(T.ring_reduce_scatter(xt, tile_rows=1)),
                                  _bits(ref))


def test_ring_reduce_scatter_rejects_unaligned():
    x = torch.zeros((4, 1000))
    for fn in (T.ring_reduce_scatter, T.ring_reduce_scatter_plain):
        with pytest.raises(ValueError, match="n\\*128"):
            fn(x)
    with pytest.raises(ValueError, match="tile_rows"):
        T.ring_reduce_scatter(torch.zeros((2, 256)), tile_rows=0)


@needs_tpu_interpret
@pytest.mark.parametrize("n", [2, 4, 8])
def test_ring_allgather_plain_bitwise_equals_pallas(devices, n):
    xj, xt = _inputs(n, 700, "float32", seed=30 + n)  # unaligned chunk
    ref = _shmap(lambda s: pallas_ring_allgather(s[0], RANK).reshape(1, -1), n)(xj)
    got = T.ring_allgather_plain(xt)
    assert got.shape == (n, n * 700)
    np.testing.assert_array_equal(_bits(got), _bits(ref))
    for tr in (None, 2):  # unpadded per chunk, whatever the tiles
        np.testing.assert_array_equal(_bits(T.ring_allgather(xt, tile_rows=tr)),
                                      _bits(ref))


def test_ring_wrappers_single_rank_and_validation():
    x = torch.arange(6, dtype=torch.float32).reshape(1, 6)
    out = T.ring_allreduce(x)
    assert torch.equal(out, x) and out.data_ptr() != x.data_ptr()
    assert T.hbm_ring_allreduce(x) is x
    assert torch.equal(T.ring_reduce_scatter(x), x)
    assert torch.equal(T.ring_allgather(x), x)
    with pytest.raises(ValueError, match="rank-major"):
        T.ring_allreduce(torch.tensor(1.0))
    with pytest.raises(ValueError, match="tile_rows"):
        T.hbm_ring_allreduce(torch.zeros(2, 4), tile_rows=0)


# ---------------------------------------------------------------------------
# A model of ring.cu's protocol. Each (rank, lane) block runs the kernel's
# action list for a sequence of launches on one flag buffer, which is never
# reset; a scheduler picks a random runnable block each tick, and a wait is
# runnable only once its flag has reached this launch's count. Ranks keep no
# step with each other, as on separate cards: a rank's lane hands its input
# to launch e when it enters, and takes its output back when it leaves. The
# model asserts that no block reads a peer's input or writes a peer's
# output outside the peer's part of the same launch, that no block leaves
# before every write into its output has landed, that no block deadlocks,
# that every flag ends at launches*(n-1), and that the values equal the
# plain versions.


def _fold_ranks(mode, n, r):
    """(input ranks in fold order, (output rank, output chunk) pairs) of
    the block that owns chunk r."""
    if mode == "ag":
        return [r], [(d, r) for d in range(n)]
    if mode == "rs":  # output row r holds chunk r alone
        return [(r + 1 + k) % n for k in range(n)], [(r, 0)]
    return [(r + k) % n for k in range(n)], [(d, r) for d in range(n)]


def _lane_program(mode, n, r, e):
    """ring.cu's actions for block (r, b) in launch e (from 1)."""
    srcs, dsts = _fold_ranks(mode, n, r)
    return ([("enter",), ("signal", "bar"), ("wait", "bar", e * (n - 1))]
            + [("load", p, k) for k, p in enumerate(srcs)]
            + [("store", d, c) for d, c in dsts]
            + [("signal", "arr"), ("wait", "arr", e * (n - 1)), ("leave",)])


def _run_protocol(launches, lanes, seed, program=_lane_program, across=False,
                  missing=None):
    """Run ``launches``, a list of (mode, x, in_place): x the ranks' inputs,
    (n, n, per) for "ar"/"rs", (n, 1, per) for "ag". Returns each launch's
    outputs: (n, n, per), or (n, 1, per) for "rs".

    ``across``: one rank a process. Each rank owns one input and one output
    row (its IPC workspace), reused by every launch, and its stream runs
    ``copy_in(e)`` (its input into its workspace row), launch e's blocks and
    ``copy_out(e)`` (its output row out) in that order; the model asserts
    that no peer reads a rank's input row outside its copy of launch e, nor
    writes its output row before its launch e or after its copy out, and
    that ``copy_out(e)`` reads only landed chunks. ``missing=(rank, e)``:
    that rank never launches e (it dies first); the run must end with every
    other rank's lanes stuck in a bounded wait, returned as the expiries
    (rank, lane, flag word) in place of the outputs."""
    n, per = launches[0][1].shape[0], launches[0][1].shape[2]
    w = per // lanes
    ins, outs = [], []
    for mode, x, in_place in launches:
        ins.append(x.copy())
        outs.append(ins[-1] if in_place and not across else
                    np.full((n, 1 if mode == "rs" else n, per), np.nan, np.float32))
    # across: the workspace rows, and the launch each rank's stream has
    # copied in, released to its blocks, and copied out
    ws_in = np.full((n, n, per), np.nan, np.float32)
    ws_out = np.full((n, n, per), np.nan, np.float32)
    staged, released, copied = np.zeros(n, int), np.zeros(n, int), np.zeros(n, int)
    left = np.zeros((n, lanes), int)  # the last launch a (rank, lane) left
    progs, pcs, acc = {}, {}, {}
    for r in range(n):
        prog = [(e, act) for e, (mode, _, _) in enumerate(launches, 1)
                for act in ([("gate",)] if across else []) + program(mode, n, r, e)]
        for b in range(lanes):
            progs[(r, b)], pcs[(r, b)] = prog, 0
        if across:
            last = len(launches) if missing is None or missing[0] != r else missing[1] - 1
            progs[("stream", r)] = [(e, (act,)) for e in range(1, last + 1)
                                    for act in ("copy_in", "release", "join", "copy_out")]
            pcs[("stream", r)] = 0
    flags = {}
    # the launch whose part a (rank, lane) is in, 0 between its parts
    inside = np.zeros((n, lanes), int)
    landed = {}  # (rank, chunk, lane) -> launch of the last write
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
        mode = launches[e - 1][0]
        pcs[key] += 1
        if key[0] == "stream":
            r = key[1]
            rows = 1 if mode == "rs" else n
            if act[0] == "copy_in":
                ws_in[r, :ins[e - 1].shape[1]] = ins[e - 1][r]
                staged[r] = e
            elif act[0] == "release":
                released[r] = e
            elif act[0] == "copy_out":
                for c in range(rows):
                    for b in range(lanes):
                        assert landed.get((r, c, b)) == e, \
                            f"rank {r} copied out launch {e} before chunk {c} lane {b} landed"
                outs[e - 1][r] = ws_out[r, :rows]
                copied[r] = e
            continue
        r, b = key
        lo, hi = b * w, (b + 1) * w
        src = ws_in if across else ins[e - 1]
        dst = ws_out if across else outs[e - 1]
        if act[0] == "enter":
            inside[r, b] = e
        elif act[0] == "signal":
            for s in range(1, n):
                f = (act[1], (r + s) % n, b)
                flags[f] = flags.get(f, 0) + 1
        elif act[0] == "load":
            _, p, k = act
            assert inside[p, b] == e, f"read rank {p}'s input outside launch {e}"
            if across:
                assert staged[p] == e, f"read rank {p}'s input row before its copy_in({e})"
            v = src[p, 0 if mode == "ag" else r, lo:hi]
            acc[key] = v.copy() if k == 0 else v + acc[key]
        elif act[0] == "store":
            _, d, c = act
            assert inside[d, b] == e, f"wrote rank {d}'s output outside launch {e}"
            if across:
                assert released[d] == e and copied[d] < e, \
                    f"wrote rank {d}'s output row outside its launch {e}"
            dst[d, c, lo:hi] = acc[key]
            landed[(d, c, b)] = e
        elif act[0] == "leave":
            if not across:
                for c in range(outs[e - 1].shape[1]):
                    assert landed.get((r, c, b)) == e, \
                        f"rank {r} left launch {e} before chunk {c} landed"
            inside[r, b] = 0
            left[r, b] = e

    stuck = [k for k in progs if pcs[k] != len(progs[k])]
    if missing is not None:
        # the bounded waits that expire: each stuck lane's wait, by word
        # (lane * 2 + 0 for the entry barrier, + 1 for the exit arrivals)
        expired = []
        for k in stuck:
            if k[0] == "stream":
                continue
            act = progs[k][pcs[k]][1]
            if act[0] == "wait":
                expired.append((k[0], k[1], k[1] * 2 + ("bar", "arr").index(act[1])))
        return sorted(expired)
    assert not stuck, f"deadlock: blocks {stuck} stuck"
    for r in range(n):
        for b in range(lanes):
            for word in ("bar", "arr"):
                assert flags[(word, r, b)] == len(launches) * (n - 1)
    return outs


def _plain(mode, x):
    """The plain version's result of one launch, shaped as the model's."""
    n, per = x.shape[0], x.shape[2]
    t = torch.from_numpy(x.reshape(n, -1))
    if mode == "ar":
        return T.ring_allreduce_plain(t).numpy().reshape(n, n, per)
    if mode == "rs":
        return T.ring_reduce_scatter_plain(t).numpy().reshape(n, 1, per)
    return T.ring_allgather_plain(t).numpy().reshape(n, n, per)


def _launch_inputs(mode, n, per, rng):
    return rng.standard_normal((n, 1 if mode == "ag" else n, per)).astype(np.float32)


@pytest.mark.parametrize("n", [2, 3, 8])
def test_ring_kernel_protocol_model_random_interleavings(n):
    # 128-element chunks: the plain version's padded chunk is the model's
    per, lanes = 128, 2
    x = _launch_inputs("ar", n, per, np.random.default_rng(n))
    want = _plain("ar", x)
    for seed in range(200):
        got, = _run_protocol([("ar", x, False)], lanes, seed)
        np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("n", [2, 3, 8])
@pytest.mark.parametrize("mode", ["rs", "ag"])
def test_ring_kernel_protocol_model_rs_ag_modes(n, mode):
    # the reduce-scatter and allgather modes of the same kernel: their own
    # fold start, outputs and operands, the same barrier and arrivals
    per, lanes = 128, 2
    x = _launch_inputs(mode, n, per, np.random.default_rng(40 + n))
    want = _plain(mode, x)
    for seed in range(200):
        got, = _run_protocol([(mode, x, False)], lanes, seed)
        np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("n", [2, 3, 8])
def test_ring_kernel_protocol_model_back_to_back_epochs(n):
    # three launches on one flag buffer with no reset in between (the
    # wrapper's cached flags): an in-place allreduce, a reduce-scatter and an
    # allgather, each waiting for its own epoch's counts
    per, lanes = 128, 2
    rng = np.random.default_rng(60 + n)
    modes = ["ar", "rs", "ag"]
    xs = [_launch_inputs(m, n, per, rng) for m in modes]
    wants = [_plain(m, x) for m, x in zip(modes, xs)]
    for seed in range(200):
        gots = _run_protocol([(m, x, m == "ar") for m, x in zip(modes, xs)],
                             lanes, seed)
        for got, want in zip(gots, wants):
            np.testing.assert_array_equal(_bits(got), _bits(want))


def _write_before_barrier(mode, n, r, e):
    prog = _lane_program(mode, n, r, e)
    data = [a for a in prog if a[0] in ("load", "store")]
    rest = [a for a in prog if a[0] not in ("load", "store")]
    return rest[:2] + data + rest[2:]  # enter, signal, data, wait, ...


def _exit_before_arrivals(mode, n, r, e):
    return [a for a in _lane_program(mode, n, r, e) if a[:2] != ("wait", "arr")]


@pytest.mark.parametrize("n", [2, 3, 8])
@pytest.mark.parametrize("program", [_write_before_barrier, _exit_before_arrivals])
def test_ring_kernel_protocol_model_rejects_unsafe_orders(n, program):
    # the model is strict enough to catch a kernel that reads and writes
    # before its entry barrier, or leaves without waiting for its arrivals
    per, lanes = 128, 2
    rng = np.random.default_rng(80 + n)
    launches = [(m, _launch_inputs(m, n, per, rng), False) for m in ("ar", "rs")]
    caught = 0
    for seed in range(50):
        try:
            _run_protocol(launches, lanes, seed, program)
        except AssertionError:
            caught += 1
    assert caught > 0


@pytest.mark.parametrize("n", [2, 3, 8])
def test_ring_kernel_protocol_model_across_processes(n):
    # one rank a process: each rank's workspace rows reused by every launch,
    # copied in before its launch and out after it on its own stream; an
    # allreduce, a reduce-scatter, an allgather and an allreduce again
    per, lanes = 128, 2
    rng = np.random.default_rng(100 + n)
    modes = ["ar", "rs", "ag", "ar"]
    xs = [_launch_inputs(m, n, per, rng) for m in modes]
    wants = [_plain(m, x) for m, x in zip(modes, xs)]
    for seed in range(10):
        gots = _run_protocol([(m, x, False) for m, x in zip(modes, xs)], lanes, seed,
                             across=True)
        for got, want in zip(gots, wants):
            np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("n", [2, 3, 8])
@pytest.mark.parametrize("program", [_write_before_barrier, _exit_before_arrivals])
def test_ring_kernel_protocol_model_across_processes_rejects_unsafe_orders(n, program):
    # a kernel that writes before the barrier, or lets its stream copy out
    # (and copy the next launch in) before its peers' writes have landed
    per, lanes = 128, 2
    rng = np.random.default_rng(120 + n)
    launches = [(m, _launch_inputs(m, n, per, rng), False) for m in ("ar", "rs", "ar")]
    caught = 0
    for seed in range(10):
        try:
            _run_protocol(launches, lanes, seed, program, across=True)
        except AssertionError:
            caught += 1
    assert caught > 0


@pytest.mark.parametrize("n", [2, 3, 8])
def test_ring_kernel_protocol_model_a_rank_that_never_launches_expires_the_others(n):
    # the last rank dies before launch 2: every other rank's every lane ends
    # in the bounded wait of launch 2's entry barrier, on its lane's word,
    # and none finishes it silently
    per, lanes = 128, 2
    rng = np.random.default_rng(140 + n)
    launches = [(m, _launch_inputs(m, n, per, rng), False) for m in ("ar", "ar")]
    want = [(r, b, 2 * b) for r in range(n - 1) for b in range(lanes)]
    for seed in range(10):
        got = _run_protocol(launches, lanes, seed, across=True, missing=(n - 1, 2))
        assert got == want, (seed, got)
