"""The port's ``Transport`` on a 1-D rank mesh whose rank axis is the
process boundary, one rank a process, on gloo: the 1-D counterpart of
``tests/test_torch_hier_mp.py`` (the reference's mesh over every process's
devices, ``rocnrdma_tpu/runtime/mesh.py::rank_mesh``).

- Two fleets of ``run_workers(n, "rank-mesh", platform="cpu")``: 4
  processes at size 8 (a power of two; seeded rows, so that a schedule
  that shipped the wrong segment shows) and 3 at size 7 (not a power of
  two, the allreduce buffer ragged). Every rank holds each of its results
  to the one-process port on the whole input (bitwise; the ``fused``
  allreduce, reduce_scatter and reduce within rtol 1e-5, atol 1e-6) and
  prints its results' sha256. The calls are every 1-D (verb, algo) pair
  (``mp_worker._rank_calls``), ``cuda_ring`` through its plain versions
  across processes (the CPU's); on 3 ranks ``tree`` is refused with the
  one-process error, and on both fleets the reduce_scatter kernel on a
  buffer that is not whole n*128-element chunks.
- Here, the one-process port on the same seeded input gives each rank's
  row: its sha256 must be the rank's. The reference's ``Transport`` on 4
  and 3 fake CPU devices, on the same input, is bitwise the one-process
  port for every call that fixes its fold order or only moves data, and
  ``avg`` within rtol = atol = 1e-6 (the port multiplies by 1/n); the
  ``cuda_ring`` calls are held to the reference's Pallas kernels in
  ``tests/test_torch_ring.py`` and ``tests/test_torch_alltoall.py``.
- ``permute_rows`` over 2 and 3 gloo processes against the one-process
  permutation, partial ones too (a rank that receives nothing gets None),
  staged and unstaged.
- In this process on a gloo group of one: the mesh's layout and its
  errors, every (verb, algo) pair of the table run or refused as on a
  one-process 1-D mesh, each ``cuda_ring`` entry point (the five verbs,
  ``jit_fn`` and ``group()``) bitwise the one-process port, and ``auto``,
  ``model``, ``RNR_ALGO`` and a tuning table resolving as on a
  one-process mesh.
"""

import hashlib
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from rocnrdma_tpu import runtime as rt
from rocnrdma_tpu.collectives import prog_ring_allreduce as ref_prog_ring_allreduce
from rocnrdma_tpu.transport import Transport as RefTransport
from rocnrdma_tpu_torch.runtime import init as I
from rocnrdma_tpu_torch.runtime import mp_worker as W
from rocnrdma_tpu_torch.runtime.mesh import ProcessSpan, RankMesh, rank_mesh
from rocnrdma_tpu_torch.runtime.multiprocess import free_port, run_workers
from rocnrdma_tpu_torch.transport import Transport, api
from rocnrdma_tpu_torch.transport.tuner import Bucket, TuningTable

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (processes, size, seed)
FLEETS = [(4, 8, 11), (3, 7, None)]
IDS = [f"{n}-size{s}" for n, s, _ in FLEETS]
# within a tolerance of the one-process port, or of the reference
TOLERANT = W.RANK_FUSED + ("allreduce/avg",)
_RUNS: dict = {}


def _line(stdout: str, key: str):
    m = re.search(rf"^{key} (.*)$", stdout, re.M)
    assert m, f"no {key} line:\n{stdout}"
    return json.loads(m.group(1))


def _fleet(n: int, size: int, seed) -> list:
    """One fleet a shape, shared by this file's tests."""
    if (n, size) not in _RUNS:
        _RUNS[(n, size)] = run_workers(n, "rank-mesh", timeout_s=120.0,
                                       platform="cpu", size=size, seed=seed)
    return _RUNS[(n, size)]


def _one_process(n: int, size: int, seed) -> dict:
    """The one-process port's result of each of the task's calls, or the
    error it refuses the call with."""
    full = torch.from_numpy(W.rank_rows(n, size, seed, range(n)))
    t = Transport(rank_mesh(n, "cpu"))
    out = {}
    for name, (_, whole, _) in W._rank_calls(None, t, t.mesh, None, full).items():
        try:
            out[name] = whole()
        except ValueError as e:
            out[name] = str(e)
    return out


def _reference(n: int, size: int, seed, khd_digits) -> dict:
    """The reference's Transport on the same input, on n fake CPU devices,
    for every call it runs (``tree`` on a power of two only)."""
    full = W.rank_rows(n, size, seed, range(n))
    a = W.rank_inputs(full, n)
    r = RefTransport(rt.rank_mesh(n))
    s = r.shard
    last, digits = n - 1, W.prime_digits(n)
    counts = W.rank_counts(n, a["a2a"].shape[2])
    out, rc = r.alltoallv(s(a["a2a"]), counts, "fused")
    with r.group() as g:
        gar, ga2a = g.allreduce(s(a["row"]), "khd"), g.alltoall(s(a["a2a"]), "fused")
    ref = {
        "allreduce/ring": r.allreduce(s(a["row"]), "ring"),
        "allreduce/ring_bidir": r.allreduce(s(a["row"]), "ring_bidir"),
        "allreduce/khd": r.allreduce(s(a["row"]), "khd", digits=khd_digits),
        "allreduce/khd_digits": r.allreduce(s(a["row"]), "khd", digits=digits),
        "allreduce/dtree": r.allreduce(s(a["row"]), "dtree"),
        "allreduce/ptree": r.allreduce(s(a["row"]), "ptree", chunks=4),
        "allreduce/ktree": r.allreduce(s(a["row"]), "ktree"),
        "allreduce/avg": r.allreduce(s(a["row"]), "khd", op="avg", digits=khd_digits),
        "allreduce/max": r.allreduce(s(a["row"]), "dtree", op="max"),
        "allreduce/ragged": r.allreduce(s(a["ragged"]), "ring"),
        "reduce_scatter/ring": r.reduce_scatter(s(a["even"]), "ring"),
        "reduce_scatter/khd": r.reduce_scatter(s(a["even"]), "khd"),
        "allgather/fused": r.allgather(s(a["part"]), "fused"),
        "allgather/ring": r.allgather(s(a["part"]), "ring"),
        "allgather/khd": r.allgather(s(a["part"]), "khd"),
        "alltoall/fused": r.alltoall(s(a["a2a"]), "fused"),
        "alltoall/rotation": r.alltoall(s(a["a2a"]), "ring"),
        "alltoall/bruck": r.alltoall(s(a["a2a"]), "bruck"),
        "alltoallv/fused": np.concatenate(
            [np.asarray(out).reshape(n, -1), np.asarray(rc).astype(np.float32)], 1),
        "sendrecv/shift3": r.sendrecv(s(a["row"]), shift=3),
        "program/ring_allreduce": r.program_fn(ref_prog_ring_allreduce(n))(s(a["row"])),
        "group/khd_alltoall": np.concatenate(
            [np.asarray(gar.result()), np.asarray(ga2a.result()).reshape(n, -1)], 1),
    }
    for verb, key, root in (("broadcast", "row", last), ("reduce", "row", 1),
                            ("gather", "part", last), ("scatter", "even", 1)):
        for algo in ("fused", "binomial")[verb == "reduce":]:
            ref[f"{verb}/{algo}"] = getattr(r, verb)(s(a[key]), algo, root=root)
    if not n & (n - 1):
        ref["allreduce/tree"] = r.allreduce(s(a["row"]), "tree")
    return ref


def _sha(a) -> str:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


@pytest.mark.parametrize("n,size,seed", FLEETS, ids=IDS)
def test_every_rank_prints_ok_and_holds_the_one_process_port(n, size, seed):
    rs = _fleet(n, size, seed)
    assert [r.returncode for r in rs] == [0] * n, [r.stderr[-2000:] for r in rs]
    one = _one_process(n, size, seed)
    refused = {k: v for k, v in one.items() if isinstance(v, str)}
    # a world that is not a power of two refuses tree, and the reduce_scatter
    # kernel refuses a buffer of other than whole n*128-element chunks, each
    # with one error
    assert sorted(refused) == sorted(W.rank_refused(n, size))
    assert ("allreduce/tree" in refused) == (n == 3)
    for r in rs:
        rank = r.process_id
        assert f"OK rank={rank}/{n} rank-mesh" in r.stdout
        assert _line(r.stdout, "RANKREFUSED") == refused
        # on the CPU the kernels' plain versions across processes: no launch
        assert _line(r.stdout, "RANKLAUNCHES") == dict.fromkeys(
            W.rank_launches([], n, size), 0)
        digests, errs = _line(r.stdout, "RANKDIGEST"), _line(r.stdout, "RANKERRS")
        held = [name for name in W.RANK_CALLS if name not in refused]
        assert sorted(digests) == sorted(errs) == sorted(held)
        for name in held:
            row = one[name][rank:rank + 1]
            if name in W.RANK_FUSED:
                assert errs[name] <= 1e-6 + 1e-5 * float(row.abs().max()), name
            else:  # the rank's row is the one-process port's, bit for bit
                assert digests[name] == _sha(row), (name, rank)
                assert errs[name] == 0.0, name


@pytest.mark.parametrize("n,size,seed", FLEETS, ids=IDS)
def test_the_ranks_equal_the_reference_through_the_one_process_port(devices, n, size,
                                                                     seed):
    rs = _fleet(n, size, seed)
    assert [r.returncode for r in rs] == [0] * n, [r.stderr[-2000:] for r in rs]
    one = _one_process(n, size, seed)
    nbytes = size * 4
    khd_digits = Transport(rank_mesh(n, "cpu")).khd_model_digits("allreduce", nbytes)
    ref = _reference(n, size, seed, khd_digits)
    assert sorted(ref) == sorted(k for k, v in one.items()
                                 if not isinstance(v, str) and k not in W.RANK_FUSED
                                 and "cuda_ring" not in k)
    for name, want in ref.items():
        got, want = one[name].numpy(), np.asarray(want)
        assert got.shape == want.shape, name
        if name in TOLERANT:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6, err_msg=name)
            continue
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32),
                                      err_msg=name)
        for r in rs:  # and so each rank's row is the reference's
            rank = r.process_id
            assert _line(r.stdout, "RANKDIGEST")[name] == _sha(want[rank:rank + 1]), name


@pytest.mark.parametrize("n,size,seed", FLEETS, ids=IDS)
def test_the_cross_leg_runs_on_gloo_unstaged_and_is_counted(n, size, seed):
    rs = _fleet(n, size, seed)
    for r in rs:
        assert r.returncode == 0, r.stderr[-2000:]
        cross = _line(r.stdout, "RANKCROSS")
        assert (cross["backend"], cross["staged"], cross["device"]) == ("gloo", False, "cpu")
        assert cross["calls"] > 0 and cross["bytes"] > 0 and cross["rows_bytes"] == size * 4
        assert cross["d2h_bytes"] == cross["h2d_bytes"] == 0
        times = _line(r.stdout, "RANKTIMES")
        assert sorted(times) == sorted(_line(r.stdout, "RANKERRS"))
        assert all(len(v) == 3 and min(v) > 0 for v in times.values())


def test_the_reference_rows_are_the_allreduce_tasks():
    # at the reference's size with no seed, rank r's row is r + 1
    assert np.array_equal(W.rank_rows(4, 8, None, range(4)), W._rows(4, 8, None))
    assert np.array_equal(W.rank_rows(4, 8, None, [2]), np.full((1, 8), 3, np.float32))
    # otherwise a process draws its own row, the one every process draws
    assert np.array_equal(W.rank_rows(3, 7, 5, [1]), W.rank_rows(3, 7, 5, range(3))[1:2])
    assert W.prime_digits(8) == (2, 2, 2) and W.prime_digits(12) == (2, 2, 3)


_PERMUTE = """
import dataclasses, sys, torch, torch.distributed as dist
from rocnrdma_tpu_torch.collectives import _exchange as X
from rocnrdma_tpu_torch.runtime.init import leave
from rocnrdma_tpu_torch.runtime.mesh import rank_mesh
rank, world, port = map(int, sys.argv[1:])
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=world, rank=rank)


class Unpinned:  # the staged path on the CPU: pinned buffers as plain ones
    def __getattr__(self, name):
        return getattr(torch, name)

    def empty(self, *a, pin_memory=False, **k):
        return torch.empty(*a, **k)


X.torch = Unpinned()
full = torch.randn((world, 3, 5), generator=torch.Generator().manual_seed(4))
mine = full[rank:rank + 1]
B = 3 * 5 * 4  # bytes of a row
last = world - 1
perms = [[(r, (r + 1) % world) for r in range(world)],   # a ring shift
         [(r, last - r) for r in range(world)],           # a reversal
         [(r, r) for r in range(world)],                  # every rank keeps its row
         [(0, last)],                                     # one pair: the others idle
         [(last, 0), (0, last)],
         []]
span0 = rank_mesh(world, "cpu", group=dist.group.WORLD).span
for staged in (False, True):
    span = dataclasses.replace(span0, staged=staged, stats=dict(span0.stats))
    for pairs in perms:
        before = dict(span.stats)
        got = X.permute_rows(mine, pairs, span)
        want = X.permute_rows(full, pairs)
        dst = [d for s, d in pairs]
        assert torch.equal(want[[r for r in range(world) if r not in dst]],
                           torch.zeros_like(want[[r for r in range(world) if r not in dst]]))
        sends = any(s == rank != d for s, d in pairs)
        recvs = any(d == rank != s for s, d in pairs)
        if rank in dst:
            assert torch.equal(got, want[rank:rank + 1]), pairs
        else:
            assert got is None, pairs
        moved = (span.stats["exchanges"] - before["exchanges"],
                 span.stats["d2h_bytes"] - before["d2h_bytes"],
                 span.stats["h2d_bytes"] - before["h2d_bytes"])
        assert moved == (int(sends or recvs), B * (sends and staged),
                         B * (recvs and staged)), (pairs, moved)
try:
    X.permute_rows(full, perms[0], span0)
    raise SystemExit("two rows of a spanning axis were not refused")
except ValueError as e:
    assert "one row" in str(e)
print(f"OK rank={rank}/{world} permute_rows", flush=True)
dist.destroy_process_group()
leave(0)
"""


@pytest.mark.parametrize("world", [2, 3])
def test_permute_rows_across_processes_is_the_one_process_permutation(world):
    port = free_port()
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", _PERMUTE, str(r), str(world),
                               str(port)], cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(world)]
    outs = [p.communicate(timeout=90) for p in procs]
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, err[-2000:]
        assert f"OK rank={r}/{world} permute_rows" in out


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


def test_the_spanning_rank_mesh_keeps_its_layout_and_names_its_errors(world_of_one):
    with pytest.raises(ValueError, match=r"the rank axis spans the group's processes, "
                                         r"one rank each: the group has 1 process\(es\), "
                                         r"the mesh asks for 2 ranks"):
        rank_mesh(2, "cpu", group=world_of_one)
    mesh = rank_mesh(1, "cpu", group=world_of_one)
    assert (mesh.shape, mesh.local_shape, mesh.n_ranks) == ((1,), (1,), 1)
    assert (mesh.span.index, mesh.span.size, mesh.span.backend) == (0, 1, "gloo")
    assert (mesh.span.staged, mesh.span.per_card) == (False, 1)
    t = Transport(mesh)
    assert not t.is_2d and not t.dcn and t.ranks_per_card == 1
    with pytest.raises(ValueError, match=r"1 row \(this process's row, rank 0 of a "
                                         r"1-rank 1-D mesh that spans processes"):
        t.allreduce(torch.zeros(2, 3))
    x = torch.arange(6, dtype=torch.float32).reshape(1, 6)
    assert torch.equal(t.shard(x.numpy()), x)  # a global buffer's row
    with pytest.raises(ValueError, match="several devices"):
        RankMesh(devices=(torch.device("cpu"), torch.device("meta"))).device


def _alltoallv(t, x):
    out, rc = t.alltoallv(x.reshape(1, 1, -1), np.full((1, 1), 2), "cuda_ring")
    return torch.cat([out.reshape(1, -1), rc.to(out.dtype)], 1)


def _grouped(t, x):
    with t.group() as g:
        ar, a2a = g.allreduce(x, "cuda_ring"), g.alltoall(x.reshape(1, 1, -1), "cuda_ring")
    return torch.cat([ar.result(), a2a.result().reshape(1, -1)], 1)


CUDA_RING_CALLS = {
    "allreduce": lambda t, x: t.allreduce(x, "cuda_ring"),
    "reduce_scatter": lambda t, x: t.reduce_scatter(x, "cuda_ring"),
    "allgather": lambda t, x: t.allgather(x, "cuda_ring"),
    "alltoall": lambda t, x: t.alltoall(x.reshape(1, 1, -1), "cuda_ring"),
    "alltoallv": _alltoallv,
    "jit_fn": lambda t, x: t.jit_fn("allgather", "cuda_ring")(x),
    "group": _grouped,
}


@pytest.mark.parametrize("call", sorted(CUDA_RING_CALLS))
def test_cuda_ring_on_a_spanning_rank_mesh_equals_the_one_process_port(world_of_one,
                                                                      call):
    t = Transport(rank_mesh(1, "cpu", group=world_of_one))
    one = Transport(rank_mesh(1, "cpu"))
    x = torch.from_numpy(np.random.default_rng(9).standard_normal((1, 6))
                         .astype(np.float32))
    got, want = CUDA_RING_CALLS[call](t, x), CUDA_RING_CALLS[call](one, x)
    assert got.shape == want.shape and torch.equal(got, want)
    ran = {k for k in t.stats() if k.endswith("/cuda_ring")}
    assert ran == ({k for k in one.stats() if k.endswith("/cuda_ring")}
                   if call != "jit_fn" else set())  # a bare jit_fn is not counted
    assert "cross/gloo" in t.stats()


ROOTED = ("broadcast", "reduce", "gather", "scatter")
# every (verb, algo) pair of the table, and each verb's policy names
PAIRS = [(v, a) for v, arms in api.SCHEDULES.items() for a in arms] + \
    [(v, a) for v in api.SCHEDULES for a in ("auto", "model")]
FUSED_REDUCTIONS = {("allreduce", "fused"), ("reduce_scatter", "fused"),
                    ("reduce", "fused")}


def _call(t, verb: str, algo: str, x: torch.Tensor):
    if verb == "alltoall":
        x = x.reshape(x.shape[0], 1, -1)
    return getattr(t, verb)(x, algo, **({"root": 0} if verb in ROOTED else {}))


@pytest.mark.parametrize("verb,algo", PAIRS, ids=[f"{v}-{a}" for v, a in PAIRS])
def test_a_spanning_rank_mesh_runs_what_a_1d_mesh_runs_and_refuses_the_rest(
        world_of_one, verb, algo):
    t = Transport(rank_mesh(1, "cpu", group=world_of_one))
    one = Transport(rank_mesh(1, "cpu"))
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((1, 6))
                         .astype(np.float32))
    try:
        want = _call(one, verb, algo, x)
    except ValueError as e:  # refused on a 1-D mesh: refused alike here
        assert not api.supports(verb, algo)
        with pytest.raises(ValueError) as got:
            _call(t, verb, algo, x)
        # the same error, its list of what runs here too
        assert str(got.value) == str(e)
        return
    got = _call(t, verb, algo, x)
    assert got.shape == want.shape and got.dtype == want.dtype
    resolved = one._resolve(algo, verb, one._msg_bytes(verb, x))
    if (verb, resolved) in FUSED_REDUCTIONS:
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)
    else:
        assert torch.equal(got, want)
    assert f"{verb}/{resolved}" in t.stats() and "cross/gloo" in t.stats()


H100 = "NVIDIA H100 80GB HBM3"


def test_policy_resolves_on_a_spanning_rank_mesh_as_without_cuda_ring(monkeypatch):
    # (the name predates the kernels across processes: the spanning mesh now
    # resolves exactly as the one-process mesh, cuda_ring included)
    # rank 1 of a 4-rank mesh that spans processes (no exchange runs here)
    # against the one-process mesh, both priced as 4 ranks on one H100
    span = ProcessSpan(cross_group=None, backend="gloo", staged=True, index=1,
                       size=4, peers=(0, 1, 2, 3), per_card=4)
    t = Transport(RankMesh(devices=(torch.device("cpu"),), shape=(4,), span=span))
    one = Transport(rank_mesh(4, "cpu"))
    assert t.ranks_per_card == one.ranks_per_card == 4
    for tr in (t, one):  # price as on the card, where cuda_ring competes
        tr.platform, tr.device_kind = "gpu", H100
    full, big = (torch.empty(shape, device="meta")  # sizes only
                 for shape in ((4, 64, 64), (4, 4096, 4096)))

    def both(verb: str, algo: str, size: torch.Tensor = full):
        x = size[:, 0] if verb in ("allgather", "gather") else size
        nbytes = one._msg_bytes(verb, x)
        assert t._msg_bytes(verb, x[1:2]) == nbytes, verb
        out = []
        for tr in (t, one):
            try:
                out.append(tr._resolve(algo, verb, nbytes))
            except ValueError as e:
                out.append(str(e))
        return out

    picked_cuda_ring = 0
    for verb in api.SCHEDULES:
        for size in (full, big):
            a, b = both(verb, "model", size)
            assert a == b, (verb, a, b)
            picked_cuda_ring += b == "cuda_ring"
        assert both(verb, "auto") == ["fused"] * 2
        for forced in api.ALGOS[1:]:
            monkeypatch.setenv("RNR_ALGO", forced)
            a, b = both(verb, "auto")
            assert a == b, (verb, forced)
        monkeypatch.delenv("RNR_ALGO")
    assert picked_cuda_ring  # the model picks the kernel somewhere, on both meshes
    # each mesh under its own layout's key (a table answers one layout
    # alone: tests/test_torch_tools_mp.py)
    table = TuningTable()
    arms = {v: [a for a in algos if api.supports(v, a)]
            for v, algos in api.SCHEDULES.items()}
    assert (t.table_platform, one.table_platform) == ("gpu/host-loopback", "gpu")
    for verb, algos in arms.items():
        for tr in (t, one):
            table.set_buckets(verb, 4, 1, tr.table_platform,
                              [Bucket(1 << 10, algos[-1]), Bucket(1 << 30, algos[0])])
    t.tuning = one.tuning = table
    for verb, algos in arms.items():
        for size, arm in ((full[:, :4], algos[-1]), (big, algos[0])):
            a, b = both(verb, "auto", size)
            assert a == b == arm, verb
