"""The port's ProcessGroup against the reference's, bit for bit.

The same seeded numpy inputs (``default_rng(seed)``) go through one group
of the JAX package's ``ProcessGroup`` and one of the port's, ranks as
threads, both pinned to one host wire model (``ROCNRDMA_HOST_TUNING``), at
world sizes 2-4 on the tcp and shm planes, the msg and rdma paths, and the
hierarchical path. Then a mixed group (two reference ranks, two port
ranks) shows the copy speaks the same wire, and the tensor front door is
held to the numpy path on the CPU.
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

from rocnrdma_tpu import distributed as RD
from rocnrdma_tpu import native as RN
from rocnrdma_tpu.transport import bootstrap as RB
from rocnrdma_tpu.transport import tuner as RT
from rocnrdma_tpu_torch import distributed as PD
from rocnrdma_tpu_torch import native as PN
from rocnrdma_tpu_torch.transport import tuner as PT

pytestmark = pytest.mark.skipif(
    not (RN.available() and PN.available()), reason="native library not buildable")

DTYPES = (np.float32, np.float64, np.int32)
SIZE = 5003  # elements a rank: several ring chunks, ragged at every n


@pytest.fixture(scope="module", autouse=True)
def one_host_model(tmp_path_factory):
    """Both packages load the same explicit host wire model."""
    path = tmp_path_factory.mktemp("host_model") / "host.json"
    planes = {k: RT.PlaneParams.from_dict(v["params"])
              for k, v in RT.COMMITTED_HOST_PLANES.items()}
    tables = {k: v["table"] for k, v in RT.COMMITTED_HOST_PLANES.items()}
    RT.save_host_model(str(path), planes, tables=tables)
    old = os.environ.get("ROCNRDMA_HOST_TUNING")
    os.environ["ROCNRDMA_HOST_TUNING"] = str(path)
    RT._reset_host_models()
    PT._reset_host_models()
    yield
    if old is None:
        os.environ.pop("ROCNRDMA_HOST_TUNING", None)
    else:
        os.environ["ROCNRDMA_HOST_TUNING"] = old
    RT._reset_host_models()
    PT._reset_host_models()


def run_group(pkgs, fn, plane="tcp", node_of=None, group="t"):
    """One group, rank r running ``pkgs[r]``'s ProcessGroup in a thread,
    on one reference store; returns each rank's ``fn(pg, rank)``."""
    n = len(pkgs)
    server = RB.BootstrapServer(n_ranks=n)
    outs, errs = [None] * n, []

    def worker(rank):
        pg = None
        try:
            pg = pkgs[rank].init_process_group(
                rank=rank, world_size=n, store_handle=server.handle,
                group_name=group, plane=plane, node_of=node_of,
                timeout_s=60.0)
            outs[rank] = fn(pg, rank)
        except Exception:  # surfaced by the assert below
            import traceback
            errs.append((rank, traceback.format_exc()))
        finally:
            if pg is not None:
                pg.destroy()

    threads = [threading.Thread(target=worker, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    server.close()
    assert not errs, errs[0][1]
    return outs


def _x(dtype, rank, shape=(SIZE,), salt=0):
    rng = np.random.default_rng(1000 * salt + rank)
    if np.issubdtype(dtype, np.integer):
        return rng.integers(-50, 50, shape).astype(dtype)
    return rng.standard_normal(shape).astype(dtype)


def _counts(n):
    i, j = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    return (37 + 101 * ((i + 2 * j) % n)).astype(np.int64)


def _sendrecv(pg, r, x):
    if r == 0:
        pg.send(x, 1, tag=3)
        return None
    if r == 1:
        return pg.recv(x, 0, tag=3)
    return None


def _batch(pg, r, x):
    n = pg.world_size
    hs = pg.batch_isend_irecv([("recv", x, (r - 1) % n),
                               ("send", x, (r + 1) % n)])
    out = hs[0].wait()
    hs[1].wait()
    return out


def _isend_irecv(pg, r, x):
    n = pg.world_size
    h = pg.irecv(x, (r - 1) % n, tag=5)
    s = pg.isend(x * 2 if x.dtype != np.int32 else x + 1, (r + 1) % n, tag=5)
    out = h.wait()
    s.wait()
    return out


# verb -> fn(pg, rank, dtype) -> output(s); every rank runs every verb in
# this order, so the groups see the same sequence of collectives
VERBS = {
    "all_reduce_sum": lambda pg, r, d: pg.all_reduce(_x(d, r)),
    "all_reduce_prod": lambda pg, r, d: pg.all_reduce(_x(d, r), op="prod"),
    "all_reduce_max": lambda pg, r, d: pg.all_reduce(_x(d, r), op="max"),
    "all_reduce_min": lambda pg, r, d: pg.all_reduce(_x(d, r), op="min"),
    "all_reduce_avg": lambda pg, r, d: (
        pg.all_reduce(_x(d, r), op="avg") if d != np.int32 else None),
    "all_reduce_1MiB": lambda pg, r, d: (
        pg.all_reduce(_x(d, r, (1 << 18,), 1)) if d == np.float32 else None),
    "all_reduce_rdma": lambda pg, r, d: pg.all_reduce(_x(d, r), transport="rdma"),
    "reduce_scatter": lambda pg, r, d: pg.reduce_scatter(_x(d, r)),
    "reduce_scatter_rdma": lambda pg, r, d: pg.reduce_scatter(_x(d, r),
                                                              transport="rdma"),
    "all_gather": lambda pg, r, d: pg.all_gather(_x(d, r)),
    "all_gather_rdma": lambda pg, r, d: pg.all_gather(_x(d, r), transport="rdma"),
    "broadcast": lambda pg, r, d: pg.broadcast(_x(d, r), src=pg.world_size - 1),
    "all_to_all": lambda pg, r, d: pg.all_to_all(_x(d, r, (pg.world_size, 257))),
    "all_to_all_v": lambda pg, r, d: pg.all_to_all_v(
        [_x(d, r, (int(c),), j) for j, c in enumerate(_counts(pg.world_size)[r])],
        _counts(pg.world_size), dtype=d),
    "all_gather_v": lambda pg, r, d: pg.all_gather_v(
        _x(d, r, (int(_counts(pg.world_size)[0][r]),)), _counts(pg.world_size)[0]),
    "reduce_scatter_v": lambda pg, r, d: pg.reduce_scatter_v(
        _x(d, r, (int(_counts(pg.world_size)[0].sum()),)),
        _counts(pg.world_size)[0]),
    "reduce": lambda pg, r, d: pg.reduce(_x(d, r), dst=1 % pg.world_size),
    "gather": lambda pg, r, d: pg.gather(_x(d, r), dst=0),
    "scatter": lambda pg, r, d: pg.scatter(
        _x(d, r, (pg.world_size, 301)) if r == 0 else _x(d, r, (301,)), src=0),
    "send_recv": lambda pg, r, d: _sendrecv(pg, r, _x(d, r)),
    "isend_irecv": lambda pg, r, d: _isend_irecv(pg, r, _x(d, r)),
    "batch_isend_irecv": lambda pg, r, d: _batch(pg, r, _x(d, r)),
}


def _drive(pg, r):
    return {(verb, np.dtype(d).name): fn(pg, r, d)
            for verb, fn in VERBS.items() for d in DTYPES}


def _same(a, b) -> bool:
    """Bitwise equality of two outputs (arrays, lists of arrays, None)."""
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    a, b = np.asarray(a), np.asarray(b)
    return (a.dtype == b.dtype and a.shape == b.shape
            and a.tobytes() == b.tobytes())


_CACHE: dict = {}


def _results(n, plane):
    key = (n, plane)
    if key not in _CACHE:
        _CACHE[key] = {
            name: run_group([pkg] * n, _drive, plane=plane, group=f"{name}{n}")
            for name, pkg in (("ref", RD), ("port", PD))}
    return _CACHE[key]


@pytest.mark.parametrize("verb", sorted(VERBS))
@pytest.mark.parametrize("plane", ["tcp", "shm"])
@pytest.mark.parametrize("n", [2, 3, 4])
def test_verb_bitwise_equals_reference(n, plane, verb):
    res = _results(n, plane)
    for r in range(n):
        for d in DTYPES:
            k = (verb, np.dtype(d).name)
            assert _same(res["port"][r][k], res["ref"][r][k]), (r, k)


HIER_VERBS = {
    "all_reduce": lambda pg, r, d: pg.all_reduce(_x(d, r), algorithm="hier"),
    "all_reduce_avg": lambda pg, r, d: (
        pg.all_reduce(_x(d, r), op="avg", algorithm="hier")
        if d != np.int32 else None),
    "reduce_scatter": lambda pg, r, d: pg.reduce_scatter(_x(d, r),
                                                         algorithm="hier"),
    "all_gather": lambda pg, r, d: pg.all_gather(_x(d, r), algorithm="hier"),
    "all_reduce_auto": lambda pg, r, d: pg.all_reduce(_x(d, r, (1 << 16,), 2)),
}


@pytest.mark.parametrize("verb", sorted(HIER_VERBS))
def test_hierarchical_bitwise_equals_reference(verb):
    key = ("hier", 4)
    if key not in _CACHE:
        def drive(pg, r):
            out = {(v, np.dtype(d).name): fn(pg, r, d)
                   for v, fn in HIER_VERBS.items() for d in DTYPES}
            out["wire"] = pg.wire_stats().get("hier_ops")
            return out
        _CACHE[key] = {
            name: run_group([pkg] * 4, drive, plane="tcp",
                            node_of=[0, 0, 1, 1], group=f"h{name}")
            for name, pkg in (("ref", RD), ("port", PD))}
    res = _CACHE[key]
    for r in range(4):
        assert res["port"][r]["wire"] and res["ref"][r]["wire"]  # hier ran
        for d in DTYPES:
            k = (verb, np.dtype(d).name)
            assert _same(res["port"][r][k], res["ref"][r][k]), (r, k)


@pytest.mark.parametrize("plane", ["tcp", "shm"])
def test_mixed_group_speaks_the_references_wire(plane):
    """Two reference ranks and two port ranks form one group on one store:
    every rank's allreduce/allgather equals the all-reference group's."""
    def drive(pg, r):
        return [pg.all_reduce(_x(np.float32, r)),
                pg.all_reduce(_x(np.float64, r), op="max"),
                pg.all_gather(_x(np.int32, r)),
                pg.all_reduce(_x(np.float32, r), transport="rdma")]
    mixed = run_group([RD, PD, RD, PD], drive, plane=plane, group="mix")
    ref = run_group([RD] * 4, drive, plane=plane, group="mixref")
    for r in range(4):
        assert all(_same(a, b) for a, b in zip(mixed[r], ref[r])), r


# ---------------------------------------------------------------------------
# The tensor front door on the CPU
# ---------------------------------------------------------------------------


def _variants(x: np.ndarray) -> dict:
    """The same values as a contiguous, a non-contiguous and a
    requires-grad CPU tensor."""
    wide = torch.zeros((x.size, 2), dtype=torch.from_numpy(x).dtype)
    wide[:, 0] = torch.from_numpy(x.ravel())
    strided = wide[:, 0].reshape(x.shape)
    assert not strided.is_contiguous()
    out = {"contiguous": torch.from_numpy(x.copy()), "strided": strided}
    if np.issubdtype(x.dtype, np.floating):
        out["requires_grad"] = torch.from_numpy(x.copy()).requires_grad_(True)
    return out


def _tensor_equal_numpy(t, a) -> bool:
    if a is None or t is None:
        return a is None and t is None
    if isinstance(a, list):
        return len(a) == len(t) and all(
            _tensor_equal_numpy(x, y) for x, y in zip(t, a))
    assert isinstance(t, torch.Tensor) and t.device.type == "cpu", type(t)
    return _same(t.numpy(), a)


FRONT_VERBS = ("all_reduce_sum", "all_reduce_avg", "all_reduce_rdma",
               "reduce_scatter", "all_gather", "broadcast", "all_to_all",
               "reduce", "gather", "scatter", "send_recv", "isend_irecv",
               "batch_isend_irecv")


@pytest.mark.parametrize("verb", FRONT_VERBS)
def test_front_door_cpu_tensors_equal_the_numpy_path(verb):
    key = ("front", 3)
    if key not in _CACHE:
        def drive(pg, r):
            out = {}
            for v in FRONT_VERBS:
                for d in (np.float32, np.int32):
                    want = VERBS[v](pg, r, d)
                    got = {}
                    for kind in _variants(_x(d, r)):
                        got[kind] = VERBS[v](_TensorPG(pg, kind), r, d)
                    out[(v, np.dtype(d).name)] = (want, got)
            return out
        _CACHE[key] = run_group([PD] * 3, drive, plane="shm", group="front")
    for r, res in enumerate(_CACHE[key]):
        for d in (np.float32, np.int32):
            want, got = res[(verb, np.dtype(d).name)]
            for kind, t in got.items():
                assert _tensor_equal_numpy(t, want), (r, verb, kind)


class _TensorPG:
    """Hands every array argument to the group as a tensor of one variant
    (contiguous / strided / requires_grad), leaving the rest as it is."""

    def __init__(self, pg, kind):
        self._pg, self._kind = pg, kind
        self.world_size, self.rank = pg.world_size, pg.rank

    def _t(self, obj):
        if isinstance(obj, np.ndarray):
            v = _variants(obj)
            return v.get(self._kind, v["contiguous"])
        if isinstance(obj, list):
            return [self._t(o) for o in obj]
        if isinstance(obj, tuple):
            return tuple(self._t(o) for o in obj)
        return obj

    def __getattr__(self, name):
        fn = getattr(self._pg, name)

        def call(*args, **kwargs):
            return fn(*self._t(args), **{k: self._t(v) for k, v in kwargs.items()})
        return call


def test_front_door_ragged_channel_and_async_verbs():
    def drive(pg, r):
        n = pg.world_size
        c = _counts(n)
        segs = [_x(np.float32, r, (int(k),), j) for j, k in enumerate(c[r])]
        out = {"a2av": (pg.all_to_all_v(segs, c),
                        pg.all_to_all_v([torch.from_numpy(s) for s in segs], c)),
               "agv": (pg.all_gather_v(_x(np.float64, r, (int(c[0][r]),)), c[0]),
                       pg.all_gather_v(torch.from_numpy(
                           _x(np.float64, r, (int(c[0][r]),))), torch.from_numpy(c[0]))),
               "rsv": (pg.reduce_scatter_v(_x(np.float32, r, (int(c[0].sum()),)), c[0]),
                       pg.reduce_scatter_v(torch.from_numpy(
                           _x(np.float32, r, (int(c[0].sum()),))), c[0]))}
        ch = pg.channel("bulk", bucket_bytes=1 << 20)
        x = _x(np.float32, r)
        out["ch_ar"] = (ch.all_reduce(x), ch.all_reduce(torch.from_numpy(x)))
        # a future resolves to a view of the lane's fused landing buffer,
        # so each batch is read (copied) before the next one is submitted
        futs = [ch.allreduce_async(_x(np.float32, r, (1000,), k)) for k in range(3)]
        ch.flush(timeout_s=30.0)
        want = [f.wait(30.0).copy() for f in futs]
        tfuts = [ch.allreduce_async(torch.from_numpy(_x(np.float32, r, (1000,), k)))
                 for k in range(3)]
        assert not any(f.done() for f in tfuts)
        ch.flush(timeout_s=30.0)
        out["async"] = (want, [f.wait(30.0).clone() for f in tfuts])
        g = [ch.allgather_async(torch.from_numpy(x))]
        out["async_ag"] = (ch.all_gather(x), g[0].wait(30.0))
        return out
    for r, res in enumerate(run_group([PD] * 3, drive, plane="shm", group="rag")):
        for k, (want, got) in res.items():
            assert _tensor_equal_numpy(got, want), (r, k)


def test_front_door_refuses_dtypes_without_numpy_and_never_casts():
    # bf16, e4m3fn and e5m2 fold now (below); the fnuz fp8 dtypes stay
    # refused: numpy has none, and the host plane has no fold for them
    def drive(pg, r):
        errs = []
        for dt in (torch.float8_e4m3fnuz, torch.float8_e5m2fnuz):
            x = torch.zeros(64, dtype=torch.uint8).view(dt)
            for call in (lambda: pg.all_reduce(x), lambda: pg.all_gather(x),
                         lambda: pg.recv(x, (r - 1) % 2),
                         lambda: pg.batch_isend_irecv([("send", x, 1 - r)])):
                with pytest.raises(PD.HostPlaneDtypeError, match="no numpy dtype"):
                    call()
                errs.append(dt)
        # nothing reached the wire: the group still agrees
        return errs, pg.all_reduce(torch.full((8,), float(r + 1)))
    outs = run_group([PD] * 2, drive, plane="shm", group="bf16")
    for errs, total in outs:
        assert len(errs) == 8 and isinstance(PD.HostPlaneDtypeError("x"), TypeError)
        assert torch.equal(total, torch.full((8,), 3.0))


def _bf16_calls(pg, x):
    return [pg.all_reduce(x), pg.all_reduce(x, op="prod"), pg.all_reduce(x, op="max"),
            pg.all_reduce(x, op="min"), pg.reduce_scatter(x), pg.all_gather(x)]


@pytest.mark.parametrize("plane", ["shm", "tcp"])
@pytest.mark.parametrize("n", [2, 3, 4])
def test_front_door_folds_bf16_bitwise_as_ml_dtypes_folds_it(plane, n):
    """bf16 tensors (CPU) through the port's front door, each rank's every
    result bitwise the reference's on the same values as ml_dtypes
    bfloat16 arrays: the sum, prod, max and min allreduce, reduce_scatter
    and all_gather, with ties, signed zeros and an inf among the values."""
    ml = pytest.importorskip("ml_dtypes")

    def data(r):
        x = _x(np.float32, r, salt=9)
        x[:4] = (0.0, -0.0, np.inf, 1.0 + 2.0 ** -8)  # a tie of bf16's rounding
        return x.astype(ml.bfloat16)

    ref = run_group([RD] * n, lambda pg, r: _bf16_calls(pg, data(r)), plane=plane,
                    group=f"bf16r{n}")
    got = run_group([PD] * n, lambda pg, r: _bf16_calls(
        pg, torch.from_numpy(data(r).view(np.int16)).view(torch.bfloat16)),
        plane=plane, group=f"bf16p{n}")
    for r in range(n):
        for want, have in zip(ref[r], got[r]):
            assert isinstance(have, torch.Tensor) and have.dtype == torch.bfloat16
            np.testing.assert_array_equal(have.view(torch.int16).numpy(),
                                          np.asarray(want).view(np.int16))


# fp8: (the host plane's bit dtype, ml_dtypes' name, torch's dtype)
F8 = {"e4m3fn": ("F8E4M3", "float8_e4m3fn", torch.float8_e4m3fn),
      "e5m2": ("F8E5M2", "float8_e5m2", torch.float8_e5m2)}


@pytest.mark.parametrize("op", ["sum", "prod", "max", "min"])
@pytest.mark.parametrize("fmt", list(F8))
def test_fp8_fold_of_every_operand_pair_is_ml_dtypes_bitwise(fmt, op):
    """All 256 x 256 operand pairs through the host plane's fold, bitwise
    the ml_dtypes ufunc on the same bits (NaNs, infinities, signed zeros,
    subnormals and overflow among them)."""
    ml = pytest.importorskip("ml_dtypes")
    from rocnrdma_tpu_torch.transport import plugin as PP
    bits_dt, ml_name, _ = F8[fmt]
    codes = np.arange(256, dtype=np.uint8)
    a, b = (v.ravel() for v in np.meshgrid(codes, codes, indexing="ij"))
    got = PP._NET_REDUCE_OPS[op](a.view(getattr(PP, bits_dt)), b.view(getattr(PP, bits_dt)))
    ufunc = {"sum": np.add, "prod": np.multiply, "max": np.maximum, "min": np.minimum}[op]
    with np.errstate(all="ignore"):
        want = ufunc(a.view(getattr(ml, ml_name)), b.view(getattr(ml, ml_name)))
    assert got.dtype == getattr(PP, bits_dt)
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


@pytest.mark.parametrize("fmt", list(F8))
def test_fp8_round_is_ml_dtypes_cast_bitwise(fmt):
    """The round step alone against ml_dtypes' cast: 3,000,001 values in
    [-600, 600] (e4m3fn's NaN past +-464 among them), +-0, +-inf, NaNs of
    both signs, float32 subnormals, e5m2's overflow to infinity and every
    fp8 value; the widen table against ml_dtypes' widening."""
    ml = pytest.importorskip("ml_dtypes")
    from rocnrdma_tpu_torch.transport import plugin as PP
    bits_dt, ml_name, _ = F8[fmt]
    mdt, pdt = getattr(ml, ml_name), getattr(PP, bits_dt)
    every = np.arange(256, dtype=np.uint8).view(mdt).astype(np.float32)
    tiny = np.float32(np.finfo(np.float32).tiny)
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan, 448, 464, 465,
                        57344, 61440, 61441, 1e30, -1e30, tiny, -tiny, tiny / 2,
                        np.float32(1e-45), -np.float32(1e-45)], np.float32)
    f = np.concatenate([np.linspace(-600, 600, 3_000_001, dtype=np.float32),
                        special, every, every * np.float32(1 + 2 ** -5)])
    got = PP.f8_round(f, pdt)
    assert got.dtype == pdt
    np.testing.assert_array_equal(got.view(np.uint8), f.astype(mdt).view(np.uint8))
    np.testing.assert_array_equal(PP.f8_widen(np.arange(256, dtype=np.uint8).view(pdt)),
                                  every)


def _fp8_calls(pg, r, x):
    return [pg.all_reduce(x), pg.all_reduce(x, op="prod"), pg.all_reduce(x, op="max"),
            pg.all_reduce(x, op="min"), pg.reduce_scatter(x), pg.all_gather(x),
            _sendrecv(pg, r, x), _batch(pg, r, x)]


@pytest.mark.parametrize("plane", ["shm", "tcp"])
@pytest.mark.parametrize("n", [2, 3, 4])
def test_front_door_folds_fp8_bitwise_as_ml_dtypes_folds_it(plane, n):
    """e4m3fn and e5m2 tensors (CPU) through the port's front door, each
    rank's every result bitwise the reference's on the same values as
    ml_dtypes arrays: the sum, prod, max and min allreduce,
    reduce_scatter, all_gather, send/recv and a batched ring exchange,
    with signed zeros, NaN, e5m2's inf, the largest values and sums past
    them among the values."""
    ml = pytest.importorskip("ml_dtypes")

    def data(r, fmt):
        x = _x(np.float32, r, salt=13) * 64
        x[:5] = (0.0, -0.0, np.nan, 448.0, 240.0 if fmt == "e4m3fn" else np.inf)
        return x.astype(getattr(ml, F8[fmt][1]))

    def calls(pkg_tensor):
        return lambda pg, r: [_fp8_calls(pg, r, pkg_tensor(data(r, fmt), fmt)) for fmt in F8]

    ref = run_group([RD] * n, calls(lambda a, fmt: a), plane=plane, group=f"f8r{n}")
    got = run_group([PD] * n, calls(
        lambda a, fmt: torch.from_numpy(a.view(np.uint8)).view(F8[fmt][2])),
        plane=plane, group=f"f8p{n}")
    for r in range(n):
        for fmt, want_calls, have_calls in zip(F8, ref[r], got[r]):
            for want, have in zip(want_calls, have_calls):
                if want is None:
                    assert have is None
                    continue
                assert isinstance(have, torch.Tensor) and have.dtype == F8[fmt][2]
                np.testing.assert_array_equal(have.view(torch.uint8).numpy(),
                                              np.asarray(want).view(np.uint8))


def test_fp8_formats_never_share_a_coalesced_bucket():
    """Async e4m3fn and e5m2 allreduces queued on one channel (both bit
    dtypes are 1-byte voids) flush as buckets of their own, each result
    the synchronous call's."""
    def drive(pg, r):
        ch = pg.channel("bulk", bucket_bytes=1 << 20)
        xs = [torch.from_numpy(_x(np.float32, r, (500,), k)).to(F8[fmt][2])
              for k, fmt in enumerate(F8)]
        futs = [ch.allreduce_async(x) for x in xs]
        ch.flush(timeout_s=30.0)
        got = [f.wait(30.0).clone() for f in futs]
        return got, [pg.all_reduce(x) for x in xs]
    for got, want in run_group([PD] * 2, drive, plane="shm", group="f8co"):
        for g, w, fmt in zip(got, want, F8):
            assert g.dtype == F8[fmt][2]
            assert torch.equal(g.view(torch.uint8), w.view(torch.uint8))


def test_numpy_in_numpy_out_is_untouched():
    def drive(pg, r):
        x = _x(np.float32, r)
        return [type(pg.all_reduce(x)), type(pg.all_gather(x)),
                type(_batch(pg, r, x))]
    for types in run_group([PD] * 2, drive, plane="shm", group="np"):
        assert types == [np.ndarray] * 3


def _irecvs_waited_on_another_thread(monkeypatch, group, late_rank=None):
    """Each rank posts 24 1 MiB irecvs, hands them to a second thread that
    waits on them, and sends 24 1 MiB messages from the posting thread;
    ``late_rank`` starts its sends 3 s after its peer. Returns each rank's
    messages and posted receives left, and the requests tested by two
    threads at once."""
    from rocnrdma_tpu_torch.transport import plugin as PP

    real, lock, active, overlaps = PP.Request.test, threading.Lock(), {}, []

    def test(req):
        me = threading.get_ident()
        with lock:
            threads = active.setdefault(id(req), [])
            if any(t != me for t in threads):
                overlaps.append(id(req))
            threads.append(me)
        try:
            time.sleep(1e-4)  # widens the window another thread may enter
            return real(req)
        finally:
            with lock:
                threads.remove(me)

    monkeypatch.setattr(PP.Request, "test", test)
    # 24 MiB a direction outruns the 16 MiB put arena, so the sends wait
    # for credit, testing the posted receives meanwhile
    k, elems = 24, 1 << 18

    def drive(pg, r):
        peer = 1 - r
        # first contact wires both directions (a lone irecv waits for
        # the peer's dial)
        for h in pg.batch_isend_irecv([("recv", np.empty(4), peer, 9),
                                       ("send", np.ones(4), peer, 9)]):
            h.wait()
        handles = [pg.irecv(np.empty(elems, np.float32), peer, tag=7)
                   for _ in range(k)]
        got, errors = [None] * k, []

        def waiter():
            # the last first: until it lands, the others are tested only
            # by the sends and by this wait's progress
            try:
                for i in reversed(range(k)):
                    got[i] = handles[i].wait()
            except BaseException as e:  # surfaced below, not lost in the thread
                errors.append(e)

        t = threading.Thread(target=waiter)
        t.start()
        if r == late_rank:
            time.sleep(3.0)
        for i in range(k):
            pg.send(_x(np.float32, r, (elems,), salt=i), peer, tag=7)
        t.join(timeout=150)
        assert not t.is_alive() and not errors, errors
        left = len(PD._P2P_POSTED.get(pg, []))
        return got, left

    return (run_group([PD] * 2, drive, plane="shm", group=group), k, elems,
            overlaps)


def _check_irecvs(outs, k, elems):
    for r, (got, left) in enumerate(outs):
        assert left == 0
        assert len(got) == k
        for i, a in enumerate(got):
            assert _same(a, _x(np.float32, 1 - r, (elems,), salt=i))


def test_an_irecv_waited_on_another_thread_is_never_tested_twice_at_once(
        monkeypatch):
    """Each rank posts 24 1 MiB irecvs, hands them to a second thread
    that waits on them, and sends 24 1 MiB messages from the posting
    thread, whose blocking sends test its posted receives until a wait()
    claims them. No request is ever tested by two threads at once, every
    message arrives intact, and no claimed receive stays posted."""
    outs, k, elems, overlaps = _irecvs_waited_on_another_thread(
        monkeypatch, "p2p2t")
    _check_irecvs(outs, k, elems)
    assert not overlaps


def test_a_late_sender_gets_credit_from_a_peer_whose_sends_are_done(
        monkeypatch):
    """Rank 1 starts its sends 3 s late, so rank 0's sends are done while
    rank 1 still has more than the arena to send. Rank 0's waiting thread
    must keep testing the receives its posting thread left posted, or
    rank 1 waits for credit that never returns."""
    outs, k, elems, overlaps = _irecvs_waited_on_another_thread(
        monkeypatch, "p2plate", late_rank=1)
    _check_irecvs(outs, k, elems)
    assert not overlaps


def test_posted_receives_go_with_their_group_and_a_claim_stops_their_tests():
    import gc
    import weakref

    class Group:  # stands for a ProcessGroup: only its identity matters
        pass

    class Req:
        def __init__(self):
            self.tests = 0

        def test(self):
            self.tests += 1

    a, b = Group(), Group()
    req = Req()
    entry = PD._PostedRecv([(0, 4, req)])
    PD._posted_p2p_recvs(a).append(entry)
    assert PD._posted_p2p_recvs(b) == []
    entry.test()
    assert req.tests == 1
    with entry.lock:  # a claim in progress: the sender's round skips
        entry.test()
    assert req.tests == 1
    entry.claim()
    entry.test()
    assert req.tests == 1
    gone = weakref.ref(a)
    del a
    gc.collect()
    # the entries went with their group; other groups of this process
    # may hold entries of their own
    assert gone() is None
    assert b in PD._P2P_POSTED and PD._posted_p2p_recvs(b) == []
