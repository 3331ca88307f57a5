"""The port's alltoall kernel (``rocnrdma_tpu_torch.ops.alltoall_cuda``).

- The plain version against ``pallas_alltoall`` run in TPU interpret mode
  under ``shard_map`` on the fake CPU devices, as
  ``tests/test_pallas_ring.py`` runs it: bitwise (both only copy), and the
  ragged ``alltoallv`` through the port's ``cuda_ring`` arm against
  ``pallas_alltoallv``, with equal ``recv_counts``.
- A model of the CUDA kernel's protocol (copy home, global barrier, direct
  writes, arrivals and their drain per (rank, lane)), stepped through
  seeded random interleavings, since the kernel itself runs only on the
  card (``tests/test_torch_card.py``).
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
# A model of alltoall.cu's protocol. Each (rank, lane) runs the kernel's
# action list; a scheduler picks a random runnable lane each tick; waits
# are runnable only when satisfied. The model asserts that no block writes
# into a rank that has not entered the kernel, that every output lane is
# written exactly once, that a block's arrival wait passes only once all
# n-1 chunks of its lane have landed, that no lane deadlocks, that every
# flag ends at n-1, and that the values equal the plain version.


def _a2a_program(n, r):
    peers = [(r + s) % n for s in range(1, n)]
    prog = [("copy_home",), ("signal", "bar", peers), ("wait", "bar", n - 1)]
    prog += [("write", d) for d in peers]
    prog += [("signal", "arr", peers), ("wait", "arr", n - 1)]
    return prog


def _run_a2a_protocol(x: np.ndarray, lanes: int, seed: int) -> np.ndarray:
    """x: (n, n, per) float32, per divisible by lanes."""
    n, _, per = x.shape
    w = per // lanes
    out = np.full_like(x, np.nan)
    writes = np.zeros((n, n, lanes), int)   # (dst rank, src rank, lane)
    flags = {}
    entered = np.zeros((n, lanes), bool)
    progs = {(r, b): _a2a_program(n, r) for r in range(n) for b in range(lanes)}
    pcs = {k: 0 for k in progs}
    rng = np.random.default_rng(seed)

    def runnable(key):
        prog, pc = progs[key], pcs[key]
        if pc == len(prog):
            return False
        act = prog[pc]
        return act[0] != "wait" or flags.get((act[1], key[0], key[1]), 0) >= act[2]

    while True:
        ready = [k for k in progs if runnable(k)]
        if not ready:
            break
        r, b = key = ready[rng.integers(len(ready))]
        act = progs[key][pcs[key]]
        lo, hi = b * w, (b + 1) * w
        if act[0] == "copy_home":
            out[r, r, lo:hi] = x[r, r, lo:hi]
            writes[r, r, b] += 1
        elif act[0] == "signal":
            if act[1] == "bar":
                entered[r, b] = True
            for peer in act[2]:
                flags[(act[1], peer, b)] = flags.get((act[1], peer, b), 0) + 1
        elif act[0] == "write":
            d = act[1]
            assert entered[d, b], "wrote into a rank that had not entered"
            out[d, r, lo:hi] = x[r, d, lo:hi]
            writes[d, r, b] += 1
        elif act[0] == "wait" and act[1] == "arr":
            assert (writes[r, :, b] == 1).all(), "drained before every chunk landed"
        pcs[key] += 1

    stuck = [k for k in progs if pcs[k] != len(progs[k])]
    assert not stuck, f"deadlock: lanes {stuck} blocked"
    assert (writes == 1).all(), "an output lane written other than once"
    for r in range(n):
        for b in range(lanes):
            assert flags[("bar", r, b)] == n - 1
            assert flags[("arr", r, b)] == n - 1
    return out


@pytest.mark.parametrize("n", [2, 3, 8])
def test_alltoall_kernel_protocol_model_random_interleavings(n):
    lanes, per = 3, 3 * 128
    x = np.random.default_rng(n).standard_normal((n, n, per)).astype(np.float32)
    want = T.alltoall_plain(torch.from_numpy(x)).numpy()
    for seed in range(200):
        got = _run_a2a_protocol(x, lanes, seed)
        np.testing.assert_array_equal(_bits(got), _bits(want))
