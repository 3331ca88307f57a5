"""The port's ring kernels (``rocnrdma_tpu_torch.ops.ring_cuda``): the
allreduce, reduce-scatter and allgather modes of ``ops/csrc/ring.cu``.

- The plain versions against the Pallas ring kernels run in TPU interpret
  mode under ``shard_map`` on the fake CPU devices, as
  ``tests/test_pallas_ring.py`` runs them: bitwise in float32 and bfloat16
  (both fold ``mine + recvd`` per hop, rounded to the buffer dtype once per
  hop, in the same hop order and padding; the allgather only copies).
- A model of the CUDA kernel's flag protocol (send, flag, wait, fold,
  credit per (rank, lane)) in each mode, stepped through seeded random
  interleavings: the stand-in for the interpret-mode backpressure test,
  since the kernel itself runs only on the card.
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
# A model of ring.cu's protocol. Each (rank, lane) runs the kernel's action
# list; a scheduler picks a random runnable lane each tick. Waits are
# runnable only when satisfied. The model asserts that no slot is written
# while it holds data its receiver has not consumed, that no lane
# deadlocks, that every flag ends at its final sequence number, and that
# the values equal the plain version.


def _steps(mode, n):
    """Hop steps of a mode: allreduce 2(n-1), reduce-scatter and allgather n-1."""
    return 2 * (n - 1) if mode == "ar" else n - 1


def _hop(mode, n, r, step):
    """(accumulate, send chunk, recv chunk) of rank r at ``step``, as ring.cu."""
    if mode == "rs":
        return True, (r - step - 1) % n, (r - step - 2) % n
    if mode == "ag":
        return False, (r - step) % n, (r - step - 1) % n
    acc = step < n - 1
    s = step if acc else step - (n - 1)
    return (acc, (r - s) % n if acc else (r + 1 - s) % n,
            (r - s - 1) % n if acc else (r - s) % n)


def _lane_program(n, r, n_tiles, mode="ar"):
    left, right = (r - 1) % n, (r + 1) % n
    prog = [("signal_bar", (left, right)), ("wait", ("bar", r, 0), 2)]
    hops = _steps(mode, n) * n_tiles
    for g in range(hops):
        step, t = divmod(g, n_tiles)
        acc, send, recv = _hop(mode, n, r, step)
        slot, use = g % 2, g // 2
        if g >= 2:
            prog.append(("wait", ("cred", r, slot), use))
        prog.append(("write", right, slot, send, t))
        prog.append(("store_flag", ("recv", right, slot), use + 1))
        prog.append(("wait", ("recv", r, slot), use + 1))
        prog.append(("fold" if acc else "copy", slot, recv, t))
        prog.append(("add_flag", ("cred", left, slot)))
    for slot in range(min(2, hops)):
        prog.append(("wait", ("cred", r, slot), (hops - slot + 1) // 2))
    return prog, hops


def _run_protocol(x: np.ndarray, n_tiles: int, lanes: int, seed: int,
                  mode: str = "ar") -> np.ndarray:
    """x: (n, n, n_tiles, tile) float32, tile divisible by lanes: the ranks'
    working buffers after the copy-in (allgather: chunk r of rank r, the
    rest NaN, so reading a chunk that never arrived shows)."""
    n = x.shape[0]
    tile = x.shape[3]
    w = tile // lanes
    data = x.copy()
    slots = np.zeros((n, 2, tile), np.float32)
    full = np.zeros((n, 2, lanes), bool)  # slot lane holds unconsumed data
    flags = {}
    progs, pcs = {}, {}
    for r in range(n):
        prog, hops = _lane_program(n, r, n_tiles, mode)
        for b in range(lanes):
            progs[(r, b)], pcs[(r, b)] = prog, 0
    rng = np.random.default_rng(seed)

    def runnable(key):
        prog, pc = progs[key], pcs[key]
        if pc == len(prog):
            return False
        act = prog[pc]
        return act[0] != "wait" or flags.get(act[1] + (key[1],), 0) >= act[2]

    while True:
        ready = [k for k in progs if runnable(k)]
        if not ready:
            break
        r, b = key = ready[rng.integers(len(ready))]
        act = progs[key][pcs[key]]
        lo, hi = b * w, (b + 1) * w
        if act[0] == "signal_bar":
            for peer in act[1]:
                flags[("bar", peer, 0, b)] = flags.get(("bar", peer, 0, b), 0) + 1
        elif act[0] == "write":
            _, dst, slot, send, t = act
            assert not full[dst, slot, b], "slot overwritten before its credit"
            slots[dst, slot, lo:hi] = data[r, send, t, lo:hi]
            full[dst, slot, b] = True
        elif act[0] == "store_flag":
            flags[act[1] + (b,)] = act[2]
        elif act[0] in ("fold", "copy"):
            _, slot, recv, t = act
            assert full[r, slot, b], "consumed a slot that was never written"
            if act[0] == "fold":
                data[r, recv, t, lo:hi] = data[r, recv, t, lo:hi] + slots[r, slot, lo:hi]
            else:
                data[r, recv, t, lo:hi] = slots[r, slot, lo:hi]
            full[r, slot, b] = False
        elif act[0] == "add_flag":
            flags[act[1] + (b,)] = flags.get(act[1] + (b,), 0) + 1
        pcs[key] += 1

    stuck = [k for k in progs if pcs[k] != len(progs[k])]
    assert not stuck, f"deadlock: lanes {stuck} blocked"
    hops = _steps(mode, n) * n_tiles
    for r in range(n):
        for b in range(lanes):
            assert flags[("bar", r, 0, b)] == 2
            for slot in range(min(2, hops)):
                uses = (hops - slot + 1) // 2
                assert flags[("recv", r, slot, b)] == uses
                assert flags[("cred", r, slot, b)] == uses
    assert not full.any()
    return data


@pytest.mark.parametrize("n", [2, 3, 8])
def test_ring_kernel_protocol_model_random_interleavings(n):
    # chunks of 2 tiles x 64 = 128 elements: the plain version's padded
    # chunk is then exactly the model's chunk
    n_tiles, lanes, tile = 2, 2, 64
    x = np.random.default_rng(n).standard_normal(
        (n, n, n_tiles, tile)).astype(np.float32)
    want = T.ring_allreduce_plain(torch.from_numpy(x.reshape(n, -1))).numpy()
    for seed in range(200):
        got = _run_protocol(x, n_tiles, lanes, seed)
        np.testing.assert_array_equal(_bits(got.reshape(n, -1)), _bits(want))


@pytest.mark.parametrize("n", [2, 3, 8])
@pytest.mark.parametrize("mode", ["rs", "ag"])
def test_ring_kernel_protocol_model_rs_ag_modes(n, mode):
    # the reduce-scatter and allgather modes of the same kernel: n-1 hops
    # a tile, their own indices, and the drain counted for that hop count
    n_tiles, lanes, tile = 2, 2, 64
    rng = np.random.default_rng(40 + n)
    if mode == "rs":
        x = rng.standard_normal((n, n, n_tiles, tile)).astype(np.float32)
        want = T.ring_reduce_scatter_plain(torch.from_numpy(x.reshape(n, -1))).numpy()
    else:
        own = rng.standard_normal((n, n_tiles, tile)).astype(np.float32)
        x = np.full((n, n, n_tiles, tile), np.nan, np.float32)
        x[np.arange(n), np.arange(n)] = own
        want = T.ring_allgather_plain(torch.from_numpy(own.reshape(n, -1))).numpy()
    for seed in range(200):
        got = _run_protocol(x, n_tiles, lanes, seed, mode)
        if mode == "rs":
            got = got[np.arange(n), np.arange(n)]
        np.testing.assert_array_equal(_bits(got.reshape(n, -1)), _bits(want))
