"""The port's ``Transport`` on a 2-D ``('slice', 'intra')`` mesh whose slice
axis is the process boundary, on gloo: the reference's ``hierarchical``
task (``rocnrdma_tpu/runtime/mp_worker.py``), run in real OS processes.

- Fleets of ``run_workers(m, "hierarchical", platform="cpu")``: 2 x 2 (the
  reference's shape) and 2 x 4 at the reference's size (8), 3 slices (an
  odd count) and 2 x 4 at a size of 7 (the ragged buffer pads over the
  intra ranks). Every rank runs the reference's checks and holds each of
  its results to the one-process port on the whole input (bitwise; the
  ``fused`` cross phase and the ``fused`` verb within rtol 1e-5, atol 1e-6)
  and prints its results' sha256.
- Here, the one-process port on the same seeded input gives each rank's
  rows: their sha256 must be the rank's. The reference's schedules
  (``shard_map`` on the fake CPU devices) on the same input are bitwise
  the one-process port for the ring and khd intra phases with the ring
  cross phase, ``max``, the ragged buffer, and the rotation and fused
  alltoalls; bf16 ``cross_dtype`` and ``avg`` within rtol = atol = 1e-6
  (``tests/test_torch_hier.py``'s tolerances), and the reference's own
  bf16 check (rtol 2e-2, atol 1e-1) against the sum.
- ``shift_rows`` over 2 and 3 gloo processes against ``torch.roll`` of the
  gathered rows, and the named refusals of a mesh that spans processes,
  in this process on a gloo group of one.
"""

import hashlib
import json
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from rocnrdma_tpu import collectives as RC
from rocnrdma_tpu import runtime as rt
from rocnrdma_tpu.transport import Transport as RefTransport
from rocnrdma_tpu_torch import collectives as C
from rocnrdma_tpu_torch.runtime import init as I
from rocnrdma_tpu_torch.runtime.mesh import slice_mesh
from rocnrdma_tpu_torch.runtime.mp_worker import hier_rows
from rocnrdma_tpu_torch.runtime.multiprocess import free_port, run_workers
from rocnrdma_tpu_torch.transport import Transport
from rocnrdma_tpu_torch.transport.api import ProcessSpanError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (slices, per_slice, size)
FLEETS = [(2, 2, 8), (2, 4, 8), (3, 2, 8), (2, 4, 7)]
IDS = [f"{m}x{n}-size{s}" for m, n, s in FLEETS]
BITWISE = ("allreduce/ring", "allreduce/khd", "allreduce/max", "allreduce/ragged",
           "alltoall/fused", "alltoall/rotation", "alltoall/flat_fused")
_RUNS: dict = {}


def _line(stdout: str, key: str):
    m = re.search(rf"^{key} (.*)$", stdout, re.M)
    assert m, f"no {key} line:\n{stdout}"
    return json.loads(m.group(1))


def _fleet(m: int, n: int, size: int) -> list:
    """One fleet a shape, shared by this file's tests."""
    if (m, n, size) not in _RUNS:
        _RUNS[(m, n, size)] = run_workers(m, "hierarchical", timeout_s=120.0,
                                          platform="cpu", per_slice=n, size=size)
    return _RUNS[(m, n, size)]


def _full(m: int, n: int, size: int) -> np.ndarray:
    return hier_rows(m, n, size, [(s, i) for s in range(m) for i in range(n)]) \
        .reshape(m, n, m * n, size)


def _one_process(m: int, n: int, size: int) -> dict:
    """The one-process port's result of each of the task's calls."""
    full = torch.from_numpy(_full(m, n, size))
    t = Transport(slice_mesh(m, n, "cpu"))
    flat = full.reshape(m * n, m * n, size)
    return {
        "allreduce/ring": t.allreduce(full, "hierarchical"),
        "allreduce/khd": t.allreduce(full, "hierarchical", intra_algo="khd"),
        "allreduce/bf16": t.allreduce(full, "hierarchical", cross_dtype="bfloat16"),
        "allreduce/avg": t.allreduce(full, "hierarchical", op="avg"),
        "allreduce/max": t.allreduce(full, "hierarchical", op="max"),
        "allreduce/ragged": t.allreduce(full[:, :, 0], "hierarchical"),
        "allreduce/fused_cross": C.hierarchical_allreduce(
            flat, (m, n), cross_algo="fused").reshape(full.shape),
        "allreduce/fused": t.allreduce(full, "fused"),
        "alltoall/fused": t.alltoall(full, "hierarchical"),
        "alltoall/rotation": C.hierarchical_alltoall(
            flat, (m, n), intra_algo="rotation",
            cross_algo="rotation").reshape(full.shape),
        "alltoall/flat_fused": t.alltoall(full, "fused"),
    }


def _reference(m: int, n: int, size: int) -> dict:
    """The reference's schedules on the same input, by shard_map."""
    full = _full(m, n, size)
    r = RefTransport(rt.slice_mesh(m, n))
    mesh = rt.slice_mesh(m, n)

    def a2a(x, ia, ca):
        fn = jax.shard_map(
            lambda s: RC.hierarchical_alltoall(s[0, 0], intra_algo=ia,
                                               cross_algo=ca)[None, None],
            mesh=mesh, in_specs=(P("slice", "intra"),),
            out_specs=P("slice", "intra"))
        return np.asarray(jax.jit(fn)(x))

    return {
        "allreduce/ring": r.allreduce(r.shard(full), "hierarchical"),
        "allreduce/khd": r.allreduce(r.shard(full), "hierarchical", intra_algo="khd"),
        "allreduce/bf16": r.allreduce(r.shard(full), "hierarchical",
                                      cross_dtype="bfloat16"),
        "allreduce/avg": r.allreduce(r.shard(full), "hierarchical", op="avg"),
        "allreduce/max": r.allreduce(r.shard(full), "hierarchical", op="max"),
        "allreduce/ragged": r.allreduce(r.shard(full[:, :, 0]), "hierarchical"),
        "alltoall/fused": a2a(full, "fused", "fused"),
        "alltoall/rotation": a2a(full, "rotation", "rotation"),
        "alltoall/flat_fused": a2a(full, "fused", "fused"),
    }


def _sha(a) -> str:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


@pytest.mark.parametrize("m,n,size", FLEETS, ids=IDS)
def test_every_rank_prints_ok_and_holds_the_one_process_port(m, n, size):
    rs = _fleet(m, n, size)
    assert [r.returncode for r in rs] == [0] * m, [r.stderr[-2000:] for r in rs]
    one = _one_process(m, n, size)
    for r in rs:
        s = r.process_id
        assert f"OK rank={s}/{m} hierarchical" in r.stdout
        digests, errs = _line(r.stdout, "HIERDIGEST"), _line(r.stdout, "HIERERRS")
        assert sorted(digests) == sorted(one) == sorted(errs)
        for name, want in one.items():
            rows = want[s:s + 1]
            if name in ("allreduce/fused_cross", "allreduce/fused"):
                assert errs[name] <= 1e-6 + 1e-5 * float(rows.abs().max()), name
            else:  # the rank's rows are the one-process port's, bit for bit
                assert digests[name] == _sha(rows), (name, s)
                assert errs[name] == 0.0, name


@pytest.mark.parametrize("m,n,size", FLEETS, ids=IDS)
def test_the_ranks_equal_the_reference_through_the_one_process_port(devices, m, n, size):
    rs = _fleet(m, n, size)
    assert [r.returncode for r in rs] == [0] * m, [r.stderr[-2000:] for r in rs]
    one, ref = _one_process(m, n, size), _reference(m, n, size)
    for name in BITWISE:
        got, want = one[name].numpy(), np.asarray(ref[name])
        assert got.shape == want.shape, name
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32),
                                      err_msg=name)
        for r in rs:  # and so each rank's rows are the reference's
            s = r.process_id
            assert _line(r.stdout, "HIERDIGEST")[name] == _sha(want[s:s + 1]), name
    for name in ("allreduce/bf16", "allreduce/avg"):
        np.testing.assert_allclose(one[name].numpy(), np.asarray(ref[name]),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    total = np.broadcast_to(_full(m, n, size).sum((0, 1)), one["allreduce/bf16"].shape)
    np.testing.assert_allclose(one["allreduce/bf16"].numpy(), total, rtol=2e-2, atol=1e-1)
    np.testing.assert_allclose(one["allreduce/fused_cross"].numpy(), total,
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("m,n,size", FLEETS, ids=IDS)
def test_the_cross_leg_runs_on_gloo_unstaged_and_is_counted(m, n, size):
    rs = _fleet(m, n, size)
    for r in rs:
        assert r.returncode == 0, r.stderr[-2000:]
        cross = _line(r.stdout, "HIERCROSS")
        assert (cross["backend"], cross["staged"], cross["device"]) == ("gloo", False, "cpu")
        assert cross["calls"] > 0 and cross["bytes"] > 0
        assert cross["d2h_bytes"] == cross["h2d_bytes"] == 0
        times = _line(r.stdout, "HIERTIMES")
        assert sorted(times) == sorted(_line(r.stdout, "HIERERRS"))
        assert all(len(v) == 3 and min(v) > 0 for v in times.values())


_SHIFT = """
import sys, torch, torch.distributed as dist
from rocnrdma_tpu_torch.collectives._exchange import shift_rows
from rocnrdma_tpu_torch.runtime.mesh import slice_mesh
rank, world, port = map(int, sys.argv[1:])
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=world, rank=rank)
span = slice_mesh(world, 1, "cpu", group=dist.group.WORLD).span
g = torch.Generator().manual_seed(5)
full = torch.randn((world, 3, 5), generator=g)
for dim in (0, 1):
    rows = full.movedim(0, dim)
    mine = rows.narrow(dim, rank, 1)
    for shift in range(-world - 1, world + 2):
        got = shift_rows(mine, shift, dim, span)
        outs = [torch.empty_like(got) for _ in range(world)]
        dist.all_gather(outs, got.contiguous())
        assert torch.equal(torch.cat(outs, dim), torch.roll(rows, shift, dim)), (dim, shift)
        assert torch.equal(shift_rows(rows, shift, dim), torch.roll(rows, shift, dim))
try:
    shift_rows(full, 1, 0, span)
    raise SystemExit("two rows of a spanning axis were not refused")
except ValueError as e:
    assert "one row" in str(e)
print(f"OK rank={rank}/{world} shift_rows {span.stats['exchanges']}", flush=True)
dist.destroy_process_group()
"""


@pytest.mark.parametrize("world", [2, 3])
def test_shift_rows_across_processes_is_roll_of_the_gathered_rows(world):
    port = free_port()
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", _SHIFT, str(r), str(world), str(port)],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(world)]
    outs = [p.communicate(timeout=90) for p in procs]
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, err[-2000:]
        # every shift not a multiple of the world crossed processes, per dim
        crossed = 2 * sum(1 for s in range(-world - 1, world + 2) if s % world)
        assert f"OK rank={r}/{world} shift_rows {crossed}" in out


@pytest.fixture(scope="module")
def world_of_one():
    """This process as a gloo group of one (torch takes a new group after
    a destroy, so the other tests of the worker are unaffected)."""
    I.init_runtime(coordinator=f"127.0.0.1:{free_port()}", num_processes=1,
                   process_id=0, timeout_s=20, platform="cpu")
    try:
        yield torch.distributed.group.WORLD
    finally:
        I.shutdown_runtime()


def test_a_group_of_another_size_is_refused_by_name(world_of_one):
    with pytest.raises(ValueError, match=r"the group has 1 process\(es\), the mesh "
                                         r"asks for 2 slices"):
        slice_mesh(2, 2, "cpu", group=world_of_one)


def test_a_spanning_mesh_runs_only_allreduce_and_alltoall(world_of_one):
    mesh = slice_mesh(1, 2, "cpu", group=world_of_one)
    assert (mesh.shape, mesh.local_shape, mesh.n_ranks) == ((1, 2), (1, 2), 2)
    assert (mesh.span.index, mesh.span.size, mesh.span.backend) == (0, 1, "gloo")
    t = Transport(mesh)
    assert t.dcn and t.is_2d
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((1, 2, 2, 6))
                         .astype(np.float32))
    one = Transport(slice_mesh(1, 2, "cpu"))
    for algo in ("auto", "hierarchical", "fused"):
        assert torch.equal(t.allreduce(x, algo), one.allreduce(x, algo))
        assert torch.equal(t.alltoall(x, algo), one.alltoall(x, algo))
    assert set(t.stats()) == {"allreduce/hierarchical", "allreduce/fused",
                              "alltoall/hierarchical", "alltoall/fused", "cross/gloo"}
    refused = [lambda: t.reduce_scatter(x), lambda: t.allgather(x),
               lambda: t.broadcast(x), lambda: t.reduce(x), lambda: t.gather(x),
               lambda: t.scatter(x.reshape(1, 2, -1)), lambda: t.sendrecv(x),
               lambda: t.allreduce(x, "ring"), lambda: t.allreduce(x, "khd2d"),
               lambda: t.allreduce(x, "cuda_ring"), lambda: t.alltoall(x, "bruck"),
               lambda: t.alltoall(x, "ring"), lambda: t.jit_fn("allgather", "fused"),
               lambda: t.alltoallv(x, np.zeros((2, 2), int)),
               lambda: t.program_fn(C.prog_ring_allreduce(2))]
    for call in refused:
        with pytest.raises(ProcessSpanError, match="spans processes; there run only "
                           r"allreduce \(hierarchical\|fused\), alltoall "
                           r"\(hierarchical\|fused\).*ROADMAP.md, Queue 1"):
            call()
    with pytest.raises(ValueError, match="this process's rows, slice 0"):
        t.allreduce(torch.zeros(2, 2, 3))
    with pytest.raises(ValueError, match="bruck.*spans processes"):
        C.hierarchical_alltoall(x.reshape(2, 2, 6), (1, 2), cross_algo="bruck",
                                span=mesh.span)
    with pytest.raises(ValueError, match="the 2 ranks held here"):
        C.hierarchical_allreduce(x.reshape(1, -1), (1, 2), span=mesh.span)
    # shard takes a global buffer's rows of this slice, or the rows alone
    assert torch.equal(t.shard(x.numpy()), x)


def test_a_device_groups_gloo_leg_is_made_once(world_of_one, monkeypatch):
    # a group whose backend is not gloo (NCCL on processes sharing a GPU)
    # gets one gloo group beside it, shared by every mesh over it
    monkeypatch.setattr(torch.distributed, "get_backend", lambda group=None: "nccl")
    a = slice_mesh(1, 2, "cpu", group=world_of_one).span
    b = slice_mesh(1, 4, "cpu", group=world_of_one).span
    assert a.cross_group is b.cross_group is not world_of_one
    assert (a.backend, a.staged) == ("gloo", False)


def test_an_unstaged_exchange_lands_on_the_rows_device():
    # the NCCL leg (one GPU a process) receives on the device, not the host
    from types import SimpleNamespace

    from rocnrdma_tpu_torch.collectives._exchange import _landing
    like = torch.empty((2, 3), device="meta")
    got = _landing(like, SimpleNamespace(staged=False))
    assert (got.device, got.shape, got.dtype) == (like.device, like.shape, like.dtype)
