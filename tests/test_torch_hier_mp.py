"""The port's ``Transport`` on a 2-D ``('slice', 'intra')`` mesh whose slice
axis is the process boundary, on gloo: the reference's ``hierarchical``
task (``rocnrdma_tpu/runtime/mp_worker.py``), run in real OS processes.

- Fleets of ``run_workers(m, "hierarchical", platform="cpu")``: 2 x 2 (the
  reference's shape) and 2 x 4 at the reference's size (8), 3 slices (an
  odd count) and 2 x 4 at a size of 7 (the ragged buffer pads over the
  intra ranks). Every rank runs the reference's checks and holds each of
  its results to the one-process port on the whole input (bitwise; the
  ``fused`` reductions within rtol 1e-5, atol 1e-6: the cross phase and
  the allreduce, reduce_scatter and reduce verbs) and prints its results'
  sha256. The calls are every (verb, algo) pair of a 2-D mesh
  (``mp_worker._hier_calls``): the hierarchical allreduce and alltoall
  with each cross phase (Bruck's too), khd2d's three verbs, the fused
  verbs, the rooted ones at roots off process 0, and a ``group()``.
- Here, the one-process port on the same seeded input gives each rank's
  rows: their sha256 must be the rank's. The reference's schedules
  (its ``Transport``, or ``shard_map`` on the fake CPU devices) on the
  same input are bitwise the one-process port for every call that fixes
  its fold order or only moves data; bf16 ``cross_dtype`` and ``avg``
  within rtol = atol = 1e-6 (``tests/test_torch_hier.py``'s tolerances),
  the fused reductions within rtol 1e-5, atol 1e-6, and the reference's
  own bf16 check (rtol 2e-2, atol 1e-1) against the sum.
- ``shift_rows`` and the cross library calls over 2 and 3 gloo processes
  against ``torch.roll`` of the gathered rows and the one-process verbs,
  and, in this process on a gloo group of one, every (verb, algo) pair:
  a spanning mesh runs what a one-process 2-D mesh runs, resolves
  ``auto``, ``model``, ``RNR_ALGO`` and a tuning table as it does, and
  refuses what it refuses with its error.
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
from rocnrdma_tpu_torch.runtime.mesh import ProcessSpan, RankMesh, slice_mesh
from rocnrdma_tpu_torch.runtime.mp_worker import _hier_calls, hier_rows
from rocnrdma_tpu_torch.runtime.multiprocess import free_port, run_workers
from rocnrdma_tpu_torch.transport import Transport, api
from rocnrdma_tpu_torch.transport.tuner import Bucket, TuningTable

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (slices, per_slice, size)
FLEETS = [(2, 2, 8), (2, 4, 8), (3, 2, 8), (2, 4, 7)]
IDS = [f"{m}x{n}-size{s}" for m, n, s in FLEETS]
BITWISE = ("allreduce/ring", "allreduce/khd", "allreduce/max", "allreduce/ragged",
           "alltoall/fused", "alltoall/rotation", "alltoall/flat_fused",
           "alltoall/bruck_cross", "allreduce/khd2d", "reduce_scatter/khd2d",
           "allgather/fused", "allgather/khd2d", "broadcast/fused", "gather/fused",
           "scatter/fused", "group/khd2d_alltoall")
# the fused reductions: torch's order of summation, rtol 1e-5, atol 1e-6
FUSED = ("allreduce/fused_cross", "allreduce/fused", "reduce_scatter/fused",
         "reduce/fused")
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
    return {name: whole() for name, (_, whole, _) in
            _hier_calls(None, t, t.mesh, None, full).items()}


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

    def grouped(x):
        with r.group() as g:
            ar, a2a = g.allreduce(r.shard(x), "khd2d"), g.alltoall(r.shard(x), "fused")
        return np.concatenate([np.asarray(ar.result()).reshape(m, n, -1),
                               np.asarray(a2a.result()).reshape(m, n, -1)], axis=2)

    last, x0 = m * n - 1, full[:, :, 0]
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
        "alltoall/bruck_cross": a2a(full, "fused", "bruck"),
        "allreduce/khd2d": r.allreduce(r.shard(full), "khd2d"),
        "reduce_scatter/fused": r.reduce_scatter(r.shard(full), "fused"),
        "reduce_scatter/khd2d": r.reduce_scatter(r.shard(full), "khd2d"),
        "allgather/fused": r.allgather(r.shard(x0), "fused"),
        "allgather/khd2d": r.allgather(r.shard(x0), "khd2d"),
        "broadcast/fused": r.broadcast(r.shard(full), "fused", root=last),
        "reduce/fused": r.reduce(r.shard(full), "fused", root=n),
        "gather/fused": r.gather(r.shard(x0), "fused", root=last),
        "scatter/fused": r.scatter(r.shard(full), "fused", root=n),
        "group/khd2d_alltoall": grouped(full),
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
            if name in FUSED:
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
    for name in ("reduce_scatter/fused", "reduce/fused"):
        np.testing.assert_allclose(one[name].numpy(), np.asarray(ref[name]),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
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
from rocnrdma_tpu_torch.runtime.init import leave
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
leave(0)
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


_CROSS = """
import dataclasses, sys, torch, torch.distributed as dist
from rocnrdma_tpu_torch.collectives import _exchange as X
from rocnrdma_tpu_torch.runtime.init import leave
from rocnrdma_tpu_torch.runtime.mesh import slice_mesh
rank, world, port = map(int, sys.argv[1:])
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=world, rank=rank)


class Unpinned:  # the staged path on the CPU: pinned buffers as plain ones
    def __getattr__(self, name):
        return getattr(torch, name)

    def empty(self, *a, pin_memory=False, **k):
        return torch.empty(*a, **k)


X.torch = Unpinned()
g = torch.Generator().manual_seed(9)
x, y = torch.randn((world, 4, 3), generator=g), torch.randn((world, world, 5), generator=g)
root = world - 1
B = 4 * 3 * 4  # bytes of one slice's x
span0 = slice_mesh(world, 1, "cpu", group=dist.group.WORLD).span
for staged in (False, True):
    span = dataclasses.replace(span0, staged=staged, stats=dict(span0.stats))
    me = rank == root

    def moved(call, d2h, h2d):
        before = dict(span.stats)
        out = call()
        got = (span.stats["d2h_bytes"] - before["d2h_bytes"],
               span.stats["h2d_bytes"] - before["h2d_bytes"])
        want = (d2h, h2d) if staged else (0, 0)
        assert got == want, (call, got, want)
        assert span.stats["exchanges"] == before["exchanges"] + 1
        return out

    close = lambda a, b: torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    close(moved(lambda: X.cross_allreduce(x[rank], "sum", span), B, B), x.sum(0))
    close(moved(lambda: X.cross_reduce_scatter(y[rank], "sum", span),
                world * 20, 20), y.sum(0)[rank])
    assert torch.equal(X.cross_reduce_scatter(y[rank], "max", span), y.amax(0)[rank])
    assert torch.equal(moved(lambda: X.cross_allgather(x[rank], span), B,
                             world * B), x)
    assert torch.equal(moved(lambda: X.cross_broadcast(x[rank], root, span),
                             B if me else 0, 0 if me else B), x[root])
    red = moved(lambda: X.cross_reduce(x[rank], "sum", root, span), B, B if me else 0)
    if me:
        close(red, x.sum(0))
    else:
        assert red is None
    got = moved(lambda: X.cross_gather(x[rank], root, span), B, world * B if me else 0)
    assert torch.equal(got, x) if me else got is None
    assert torch.equal(moved(lambda: X.cross_scatter(y[rank], root, span),
                             world * 20 if me else 0, 20), y[root][rank])
print(f"OK rank={rank}/{world} cross", flush=True)
dist.destroy_process_group()
leave(0)
"""


@pytest.mark.parametrize("world", [2, 3])
def test_the_cross_calls_across_processes_and_what_they_stage(world):
    # each cross library call against the gathered rows, unstaged and
    # staged: a slice that receives nothing (a reduce's or a gather's
    # off-root slices) stages nothing back, one that sends nothing (a
    # broadcast's or a scatter's) nothing out
    port = free_port()
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", _CROSS, str(r), str(world), str(port)],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(world)]
    outs = [p.communicate(timeout=90) for p in procs]
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, err[-2000:]
        assert f"OK rank={r}/{world} cross" in out


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


ROOTED = ("broadcast", "reduce", "gather", "scatter")
# every (verb, algo) pair of the table, and each verb's policy names
PAIRS = [(v, a) for v, arms in api.SCHEDULES.items() for a in arms] + \
    [(v, a) for v in api.SCHEDULES for a in ("auto", "model")]
FUSED_REDUCTIONS = {("allreduce", "fused"), ("reduce_scatter", "fused"),
                    ("reduce", "fused")}


def _verb_input(verb: str, x: torch.Tensor) -> torch.Tensor:
    """The task's inputs: (slices, per_slice, N, size), the gathering verbs
    one buffer of ``size`` a rank."""
    return x[:, :, 0] if verb in ("allgather", "gather") else x


def _call(t, verb: str, algo: str, x: torch.Tensor):
    return getattr(t, verb)(_verb_input(verb, x), algo,
                            **({"root": 1} if verb in ROOTED else {}))


@pytest.mark.parametrize("verb,algo", PAIRS, ids=[f"{v}-{a}" for v, a in PAIRS])
def test_a_spanning_mesh_runs_what_a_2d_mesh_runs_and_refuses_the_rest(
        world_of_one, verb, algo):
    t = Transport(slice_mesh(1, 2, "cpu", group=world_of_one))
    one = Transport(slice_mesh(1, 2, "cpu"))
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((1, 2, 2, 6))
                         .astype(np.float32))
    try:
        want = _call(one, verb, algo, x)
    except ValueError as e:  # refused on a 2-D mesh: refused alike here
        assert algo in ("auto", "model") or not api.supports(verb, algo, is_2d=True)
        with pytest.raises(ValueError) as got:
            _call(t, verb, algo, x)
        assert (type(got.value), str(got.value)) == (type(e), str(e))
        return
    assert algo == "model" or api.supports(verb, algo, is_2d=True)
    got = _call(t, verb, algo, x)
    assert got.shape == want.shape and got.dtype == want.dtype
    resolved = one._resolve(algo, verb, one._msg_bytes(verb, _verb_input(verb, x)))
    if (verb, resolved) in FUSED_REDUCTIONS:
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)
    else:
        assert torch.equal(got, want)
    assert f"{verb}/{resolved}" in t.stats() and "cross/gloo" in t.stats()


def test_a_spanning_mesh_keeps_its_layout_and_the_2d_refusals(world_of_one):
    mesh = slice_mesh(1, 2, "cpu", group=world_of_one)
    assert (mesh.shape, mesh.local_shape, mesh.n_ranks) == ((1, 2), (1, 2), 2)
    assert (mesh.span.index, mesh.span.size, mesh.span.backend) == (0, 1, "gloo")
    t = Transport(mesh)
    assert t.dcn and t.is_2d
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((1, 2, 2, 6))
                         .astype(np.float32))
    one = Transport(slice_mesh(1, 2, "cpu"))
    for call in (lambda v: v.alltoallv(x, np.zeros((2, 2), int)),
                 lambda v: v.program_fn(C.prog_ring_allreduce(2)),
                 lambda v: v.jit_fn("allgather", "ring")):
        with pytest.raises(ValueError) as e:
            call(one)
        with pytest.raises(ValueError, match=re.escape(str(e.value))):
            call(t)
    with pytest.raises(ValueError, match="this process's rows, slice 0"):
        t.allreduce(torch.zeros(2, 2, 3))
    for algo in ("rotation", "bruck", "fused"):  # every cross phase runs
        assert torch.equal(
            C.hierarchical_alltoall(x.reshape(2, 2, 6), (1, 2), cross_algo=algo,
                                    span=mesh.span),
            C.hierarchical_alltoall(x.reshape(2, 2, 6), (1, 2), cross_algo=algo))
    with pytest.raises(ValueError, match="the 2 ranks held here"):
        C.hierarchical_allreduce(x.reshape(1, -1), (1, 2), span=mesh.span)
    with pytest.raises(ValueError, match="round 0 is the 1 slices"):
        C.khd_allreduce(x.reshape(2, -1), digits=(2, 1), span=mesh.span)
    # shard takes a global buffer's rows of this slice, or the rows alone
    assert torch.equal(t.shard(x.numpy()), x)


def test_policy_resolves_on_a_spanning_mesh_as_on_a_one_process_2d_mesh(monkeypatch):
    # slice 1 of a 2 x 4 mesh that spans processes (no exchange runs here),
    # against the one-process mesh with the same cost-model constants
    span = ProcessSpan(cross_group=None, backend="gloo", staged=False, index=1,
                       size=2, peers=(0, 1))
    t = Transport(RankMesh(devices=(torch.device("cpu"),) * 4,
                           axis_names=("slice", "intra"), shape=(2, 4), span=span))
    one = Transport(slice_mesh(2, 4, "cpu"), dcn=True)
    full = torch.zeros((2, 4, 8, 64))

    def both(verb: str, algo: str):
        x = _verb_input(verb, full)
        nbytes = one._msg_bytes(verb, x)
        assert t._msg_bytes(verb, x[1:]) == nbytes, verb
        out = []
        for tr in (t, one):
            try:
                out.append(tr._resolve(algo, verb, nbytes))
            except ValueError as e:
                out.append(str(e))
        return out

    for verb in api.SCHEDULES:
        for algo in ("auto", "model"):
            a, b = both(verb, algo)
            assert a == b, (verb, algo)
        for forced in api.ALGOS[1:]:
            monkeypatch.setenv("RNR_ALGO", forced)
            a, b = both(verb, "auto")
            assert a == b, (verb, forced)
        monkeypatch.delenv("RNR_ALGO")
    table = TuningTable()
    arms = {v: [a for a in algos if api.supports(v, a, is_2d=True)]
            for v, algos in api.SCHEDULES.items()}
    arms = {v: algos for v, algos in arms.items() if algos}
    for verb, algos in arms.items():
        table.set_buckets(verb, 8, 2, "cpu", [Bucket(1 << 10, algos[-1]),
                                              Bucket(1 << 30, algos[0])])
    t.tuning = one.tuning = table
    for verb, algos in arms.items():
        a, b = both(verb, "auto")
        assert a == b and a in algos, verb


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
