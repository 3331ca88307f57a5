"""The port's tuner (device half), its calibration accessors and the
Transport's policies against the JAX reference, on the CPU.

- The pure functions (radix ladder, ``model_time``, ``fused_model_time``,
  ``model_pick``, ``model_table``'s buckets) are held EQUAL to the
  reference's: floats bitwise, picks equal. Both packages read the same
  pinned calibration file (``RNR_HW_CAL``), so the fold-ladder scale they
  price with is the same. The reference's ``pallas_ring`` rows are the
  port's ``cuda_ring`` rows, priced from the port's kernels, so those rows
  are held to the kernels' byte counts instead.
- ``TuningTable`` (save, load, merge, lookup), ``merge_tables`` and
  ``_coalesce`` behave as the reference's on the same data, the shipped
  ``results/tuning_cpu8.json`` included.
- ``Transport(algo="model")``, ``tuning=`` and ``RNR_TUNING`` resolve to the
  reference Transport's arm on the 8 fake CPU devices.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from rocnrdma_tpu import hw as ref_hw
from rocnrdma_tpu import runtime as rt
from rocnrdma_tpu.transport import Transport as RefTransport
from rocnrdma_tpu.transport import tuner as RT
from rocnrdma_tpu_torch import hw
from rocnrdma_tpu_torch.runtime import rank_mesh, slice_mesh
from rocnrdma_tpu_torch.transport import Transport
from rocnrdma_tpu_torch.transport import tuner as PT

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KiB, MiB, GiB = 1 << 10, 1 << 20, 1 << 30
SIZES = (4 * KiB, 16 * KiB, 64 * KiB, MiB, 16 * MiB, 256 * MiB, GiB)
H100 = "NVIDIA H100 80GB HBM3"


@pytest.fixture
def pinned_cal(tmp_path, monkeypatch):
    """One calibration file both packages read: a non-flat ladder, so the
    fold terms are exercised."""
    path = tmp_path / "hw_pinned.json"
    path.write_text(json.dumps({"fold_ladder": {
        "2": 600.0, "3": 655.5, "4": 690.0, "8": 731.25, "16": 744.0,
        "32": 770.5, "64": 702.0}}))
    monkeypatch.setenv("RNR_HW_CAL", str(path))
    return str(path)


def _port_algo(algo: str) -> str:
    return "cuda_ring" if algo == "pallas_ring" else algo


# ------------------------------------------------------------ radix ladder

@pytest.mark.parametrize("n", range(2, 65))
def test_khd_radix_candidates_and_model_digits_equal_reference(n):
    assert PT.khd_radix_candidates(n) == RT.khd_radix_candidates(n)
    consts = (PT.ALPHA_S, PT.BETA_S_PER_B, 0.0)
    assert consts == (RT.ALPHA_S, RT.BETA_S_PER_B, 0.0)
    for verb in ("allreduce", "reduce_scatter", "allgather"):
        for size in SIZES:
            for emb in ("switch", "ring"):
                assert PT.khd_model_digits(verb, n, size, *consts, emb) == \
                    RT.khd_model_digits(verb, n, size, *consts, emb), (verb, size, emb)


def test_khd_model_digits_with_a_fold_term_equal_reference(pinned_cal):
    for n in (4, 6, 8, 12, 16, 48, 64, 256):
        for size in SIZES:
            for verb in ("allreduce", "reduce_scatter"):
                args = (verb, n, size, 2e-6, 3e-12, 1.5e-12)
                assert PT.khd_model_digits(*args) == RT.khd_model_digits(*args)
                assert PT.khd_model_digits(*args, "ring") == \
                    RT.khd_model_digits(*args, "ring")


def test_fold_rate_scale_and_calibration_precedence_equal_reference(pinned_cal, tmp_path,
                                                                    monkeypatch):
    for w in (1, 2, 3, 5, 8, 9, 20, 64, 100):
        assert hw.fold_rate_scale(w) == ref_hw.fold_rate_scale(w)
    # the kind-specific file in RNR_HW_CAL_DIR, then the MEASURED row, then flat
    monkeypatch.delenv("RNR_HW_CAL")
    monkeypatch.setenv("RNR_HW_CAL_DIR", str(tmp_path / "cal"))
    assert hw.fold_ladder_for("cpu") == {2: 1.0}
    assert hw.fold_rate_scale(64, "cpu") == 1.0
    assert (hw.hbm_frac("cpu"), hw.dispatch_alpha_s("cpu")) == (1.0, 0.0)
    assert hw.dispatch_alpha_range_s("cpu") is None
    row = hw._match(hw.MEASURED, H100)
    if row is not None:
        assert hw.fold_ladder_for(H100) == row.fold_ladder
        assert hw.dispatch_alpha_range_s(H100) == row.dispatch_alpha_range_s
    path = hw.save_calibration(H100, {"fold_ladder": {"2": 2000.0, "4": 1000.0},
                                      "dispatch_alpha_s": 5e-6})
    assert path == os.path.join(str(tmp_path / "cal"), "hw_nvidia_h100_80gb_hbm3.json")
    hw.save_calibration(H100, {"hbm_frac": 0.6})  # merges, keeps the ladder
    assert hw.fold_ladder_for(H100) == {2: 2000.0, 4: 1000.0}
    assert hw.fold_rate_scale(3, H100) == 2000.0 / 1500.0
    assert (hw.dispatch_alpha_s(H100), hw.hbm_frac(H100)) == (5e-6, 0.6)
    # the default directory is the port's own, never the repo's results/
    monkeypatch.delenv("RNR_HW_CAL_DIR")
    assert hw.calibration_path(H100).startswith(
        os.path.join(REPO, "rocnrdma_tpu_torch", "results") + os.sep)


# ------------------------------------------------------------- schedule prices

def _cases(verb, algo):
    """(n, mesh_shape, dcn) points of one (verb, algo) row."""
    if algo in ("khd2d", "hierarchical"):
        return [(int(np.prod(s)), s, d) for s in ((2, 4), (2, 2), (4, 4), (2, 3))
                for d in (None, (1.2e-5, 1.6e-10))]
    return [(n, None, None) for n in (2, 3, 4, 6, 8, 12, 16, 64)]


@pytest.mark.parametrize("verb", ["allreduce", "reduce_scatter", "allgather",
                                  "alltoall", "broadcast", "reduce", "gather",
                                  "scatter", "sendrecv"])
def test_model_time_pick_and_fused_bitwise_equal_reference(verb, pinned_cal):
    ref_rows = {a for v, a in RT._MODEL if v == verb}
    port_rows = {a for v, a in PT._MODEL if v == verb}
    assert port_rows == {_port_algo(a) for a in ref_rows}
    # declaration order (model_pick's last tie-break) is the reference's
    assert [k for k in PT._MODEL] == [(v, _port_algo(a)) for v, a in RT._MODEL]
    consts = dict(alpha=2e-6, beta=3e-12, hbm_beta=1.5e-12)
    algos = sorted(a for a in ref_rows if a != "pallas_ring")
    for algo in algos:
        for n, shape, dcn in _cases(verb, algo):
            for size in (4 * KiB, MiB, GiB):
                for itemsize in (4, 2):
                    for emb in ("switch", "ring"):
                        kw = dict(consts, mesh_shape=shape, dcn=dcn,
                                  embedding=emb, itemsize=itemsize)
                        got = PT.model_time(verb, algo, n, size, **kw)
                        want = RT.model_time(verb, algo, n, size, **kw)
                        assert got == want, (algo, n, shape, dcn, size, itemsize, emb)
    for shape, dcn in [(None, None), ((2, 4), None), ((2, 4), (1.2e-5, 1.6e-10))]:
        for n in ((2, 8, 16) if shape is None else (8,)):
            for size in (4 * KiB, 256 * KiB, MiB, 64 * MiB, GiB):
                kw = dict(consts, mesh_shape=shape, dcn=dcn)
                assert PT.fused_model_time(verb, n, size, **kw) == \
                    RT.fused_model_time(verb, n, size, **kw)
                cands = algos + ["fused"]
                assert PT.model_pick(verb, n, size, candidates=cands, **kw) == \
                    RT.model_pick(verb, n, size, candidates=cands, **kw)
                assert PT.model_pick(verb, n, size, candidates=algos, **kw) == \
                    RT.model_pick(verb, n, size, candidates=algos, **kw)


@pytest.mark.parametrize("n", [2, 3, 8, 12])
def test_cuda_ring_rows_price_the_kernels_bytes(n):
    # with a card's one-memory constants (beta = 2m/R a copy byte, the m
    # ranks of the card sharing rate R) a row's time is the kernel's bytes
    # at R: each input element read once, each output written once, as
    # chip_smoke's byte counters count the kernels (aligned shapes)
    R = 3.0e12
    beta = 2.0 * n / R
    per = 128 * 1024  # elements per chunk
    isz = 4
    bytes_of = {
        "allreduce": (n * per * isz, chip_smoke.ring_bytes("ar", n, per, isz)),
        "reduce_scatter": (n * per * isz, chip_smoke.ring_bytes("rs", n, per, isz)),
        "allgather": (n * per * isz, chip_smoke.ring_bytes("ag", n, per, isz)),
        "alltoall": (n * per * isz, chip_smoke.alltoall_bytes(n, per, isz)),
    }
    for verb, (S, moved) in bytes_of.items():
        t = PT.model_time(verb, "cuda_ring", n, S, alpha=0.0, beta=beta, hbm_beta=n / R)
        assert t * R == pytest.approx(moved, rel=1e-12), verb
        # one launch with one barrier inside
        assert PT.model_time(verb, "cuda_ring", n, S, alpha=1.0, beta=0.0) == 2.0
    # a tie with an explicit schedule breaks away from the kernel arm
    assert PT.model_pick("alltoall", n, MiB, candidates=("cuda_ring", "ring"),
                         alpha=0.0, beta=0.0) == "ring"


def test_constants_for_and_dcn():
    assert PT.constants_for("cpu", "allreduce", 8) == (PT.ALPHA_S, PT.BETA_S_PER_B, 0.0)
    assert PT.dcn_constants_for("cpu") == (PT.ALPHA_S, PT.BETA_S_PER_B)
    chip = hw.chip_for(H100)
    rate = chip.hbm_GBps * hw.hbm_frac(H100) * 1e9
    disp = hw.dispatch_alpha_s(H100)
    # every rank on the one card: copies in its one memory, alpha = dispatch
    assert PT.constants_for(H100, "allreduce", 8) == (disp, 16 / rate, 8 / rate)
    assert PT.constants_for(H100, "allgather", 8) == (disp, 16 / rate, 0.0)
    # one rank per card: NVLink (one direction) and the hop latency
    a, b, h = PT.constants_for(H100, "reduce_scatter", 1)
    assert (a, b, h) == (chip.link_hop_s + disp, 1 / 450e9, 1 / rate)
    assert PT.constants_for(H100, "alltoall", 8, dispatch_alpha=1e-6)[0] == 1e-6
    assert PT.dcn_constants_for(H100) == (chip.nic_hop_s + disp, 1 / 50e9)


def test_measure_alpha_on_cpu():
    a = PT.measure_alpha(k1=4, k2=32, repeats=2, trials=1, device="cpu")
    assert 0 < a < 1e-2


# ------------------------------------------------------------------- tables

def _tables(mod):
    t = mod.TuningTable(meta={"provenance": "a"})
    t.set_buckets("allreduce", 8, 1, "cpu",
                  [mod.Bucket(1 << 20, "ring"), mod.Bucket(4096, "tree")])
    t.set_buckets("alltoall", 4, 1, "gpu", [mod.Bucket(65536, "bruck")])
    o = mod.TuningTable(meta={"provenance": "b"})
    o.set_buckets("alltoall", 4, 1, "gpu", [mod.Bucket(1 << 30, "fused")])
    o.set_buckets("allgather", 8, 2, "cpu", [mod.Bucket(1 << 30, "khd2d")])
    return t, o


def test_tuning_table_merge_save_load_equal_reference(tmp_path):
    (pt, po), (rt_, ro) = _tables(PT), _tables(RT)
    keys = [("allreduce", 8, 1, "cpu"), ("alltoall", 4, 1, "gpu"),
            ("allgather", 8, 2, "cpu"), ("allreduce", 8, 1, "tpu")]
    for stage in ("built", "saved", "merged"):
        if stage == "saved":
            pt.save(str(tmp_path / "p.json"))
            rt_.save(str(tmp_path / "r.json"))
            assert (tmp_path / "p.json").read_text() == (tmp_path / "r.json").read_text()
            pt, rt_ = PT.TuningTable.load(str(tmp_path / "p.json")), \
                RT.TuningTable.load(str(tmp_path / "r.json"))
        if stage == "merged":
            pt, rt_ = PT.merge_tables(pt, po), RT.merge_tables(rt_, ro)
            assert pt.meta == rt_.meta and "mixed" in pt.meta["provenance"]
        assert pt.to_dict() == rt_.to_dict() and len(pt) == len(rt_)
        for v, n, nd, plat in keys:
            for size in (1, 4096, 4097, 65536, 1 << 20, 1 << 31):
                assert pt.lookup(v, size, n, nd, plat) == rt_.lookup(v, size, n, nd, plat)
    runs = [(4096, "tree"), (65536, "tree"), (1 << 20, "ring"), (1 << 24, "tree"),
            (1 << 28, "tree")]
    assert [(b.max_bytes, b.algo) for b in PT._coalesce([PT.Bucket(*r) for r in runs])] == \
        [(b.max_bytes, b.algo) for b in RT._coalesce([RT.Bucket(*r) for r in runs])]


def test_reference_tables_load_and_look_up_equal():
    for name in ("tuning_cpu8.json", "tuning_cpu8_2d.json", "tuning_v5e.json"):
        path = os.path.join(REPO, "results", name)
        p, r = PT.TuningTable.load(path), RT.TuningTable.load(path)
        assert p.to_dict() == r.to_dict()
        for key in r._entries:
            verb, n, nd, plat = key.split("|")
            for size in (1, 4096, 65536, 1 << 20, 1 << 24, 1 << 30, 1 << 34):
                assert p.lookup(verb, size, int(n), int(nd), plat) == \
                    r.lookup(verb, size, int(n), int(nd), plat)
            # a TPU-keyed row never matches the port's platforms
            if plat == "tpu":
                assert p.lookup(verb, 4096, int(n), int(nd), "gpu") is None


def test_model_table_cpu_buckets_equal_reference():
    ranks, verbs = [4, 8, 16, 64], ["allreduce", "reduce_scatter", "allgather", "alltoall"]
    p = PT.model_table("cpu", ranks, verbs, list(SIZES), mesh_shapes=[(2, 4)])
    r = RT.model_table("cpu", ranks, verbs, list(SIZES), mesh_shapes=[(2, 4)],
                       _audit=False)
    one_d = {k.rsplit("|", 1)[0]: v for k, v in r.to_dict().items()
             if k != "_meta" and k.split("|")[2] == "1"}
    mine = {k.rsplit("|", 1)[0]: v for k, v in p.to_dict().items()
            if k != "_meta" and k.split("|")[2] == "1"}
    assert mine == one_d and len(mine) == 16
    assert all(k.endswith("|cpu") for k in p._entries)
    assert {k for k in p._entries if k.split("|")[2] == "2"} == {
        f"{v}|8|2|cpu" for v in verbs}
    assert p.meta["alpha_sensitivity"]["unstable_keys"] == {}


def test_model_table_on_the_card_kind_lets_the_kernel_arm_compete():
    t = PT.model_table(H100, [8], ["allreduce", "alltoall"], [4 * KiB, GiB], _audit=False)
    assert all(k.endswith("|gpu") for k in t._entries)
    alpha, beta, hbm = PT.constants_for(H100, "allreduce", 8)
    for size in (4 * KiB, GiB):
        # every 1-D row competes, cuda_ring among them
        want = PT.model_pick("allreduce", 8, size, alpha=alpha, beta=beta,
                             hbm_beta=hbm, device_kind=H100)
        assert t.lookup("allreduce", size, 8, 1, "gpu") == want


# ------------------------------------------------------------ the Transport

VERBS = ("allreduce", "reduce_scatter", "allgather", "alltoall", "broadcast",
         "reduce", "gather", "scatter")


def test_model_policy_resolves_as_reference(devices):
    for n in (4, 8):
        p, r = Transport(rank_mesh(n, "cpu")), RefTransport(rt.rank_mesh(n))
        for verb in VERBS:
            for size in (256, 4 * KiB, 64 * KiB, MiB, 64 * MiB):
                for itemsize in (4, 2):
                    assert p._resolve("model", verb, size, itemsize) == \
                        r._resolve("model", verb, size, itemsize), (n, verb, size)
            assert p._resolve("model", verb) == r._resolve("model", verb)
    p2, r2 = Transport(slice_mesh(2, 4, "cpu")), RefTransport(rt.slice_mesh(2, 4))
    assert (p2.dcn, r2.dcn) == (False, False)
    for verb in ("allreduce", "reduce_scatter", "allgather", "alltoall"):
        for size in (4 * KiB, MiB, 64 * MiB):
            assert p2._resolve("model", verb, size) == r2._resolve("model", verb, size)
    p3, r3 = Transport(slice_mesh(2, 4, "cpu"), dcn=True), RefTransport(rt.slice_mesh(2, 4),
                                                                        dcn=True)
    assert p3.dcn and r3.dcn


def test_model_dispatch_equals_reference(devices):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, 1024)).astype(np.float32)
    p, r = Transport(rank_mesh(8, "cpu")), RefTransport(rt.rank_mesh(8))
    for verb, arr in (("allreduce", x), ("reduce_scatter", x),
                      ("allgather", x[:, :128]), ("alltoall", x.reshape(8, 8, 128))):
        got = getattr(p, verb)(p.shard(arr), "model")
        want = np.asarray(getattr(r, verb)(r.shard(arr), "model"))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert set(p.stats()) == set(r.stats())


def _policy_table(mod, n):
    t = mod.TuningTable(meta={"provenance": "test"})
    t.set_buckets("allreduce", n, 1, "cpu",
                  [mod.Bucket(4 * KiB, "tree"), mod.Bucket(16 * KiB, "khd"),
                   mod.Bucket(1 << 40, "ring")])
    t.set_buckets("reduce_scatter", n, 1, "cpu", [mod.Bucket(1 << 40, "khd")])
    t.set_buckets("alltoall", n, 1, "cpu", [mod.Bucket(1 << 40, "bruck")])
    # a 2-D-only arm on a 1-D row never leaks through
    t.set_buckets("allgather", n, 1, "cpu", [mod.Bucket(1 << 40, "khd2d")])
    return t


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a)).view(np.uint32)


@pytest.mark.parametrize("form", ["table", "path", "env"])
def test_tuning_table_resolves_and_dispatches_as_reference(devices, form, tmp_path,
                                                           monkeypatch):
    n = 8
    ptab, rtab = _policy_table(PT, n), _policy_table(RT, n)
    if form == "table":
        p = Transport(rank_mesh(n, "cpu"), tuning=ptab)
        r = RefTransport(rt.rank_mesh(n), tuning=rtab)
    else:
        path = str(tmp_path / "t.json")
        ptab.save(path)
        if form == "path":
            p = Transport(rank_mesh(n, "cpu"), tuning=path)
            r = RefTransport(rt.rank_mesh(n), tuning=path)
        else:
            monkeypatch.setenv("RNR_TUNING", path)
            p, r = Transport(rank_mesh(n, "cpu")), RefTransport(rt.rank_mesh(n))
    for verb in VERBS:
        for size in (1024, 4 * KiB, 4 * KiB + 4, 16 * KiB, MiB):
            assert p._resolve("auto", verb, size) == r._resolve("auto", verb, size)
    assert p._resolve("auto", "allreduce", 8 * KiB) == "khd"
    assert p._resolve("auto", "allgather", 8 * KiB) == "fused"
    # explicit algos are never overridden; RNR_ALGO beats the table
    assert p._resolve("ring_bidir", "allreduce", KiB) == "ring_bidir"
    monkeypatch.setenv("RNR_ALGO", "ring")
    assert p._resolve("auto", "allreduce", KiB) == r._resolve("auto", "allreduce", KiB) == "ring"
    monkeypatch.delenv("RNR_ALGO")
    rng = np.random.default_rng(3)
    for elems in (512, 2048):  # 2 KiB (tree) and 8 KiB (khd) a rank
        x = rng.standard_normal((n, elems)).astype(np.float32)
        np.testing.assert_array_equal(_bits(p.allreduce(p.shard(x)).numpy()),
                                      _bits(r.allreduce(r.shard(x))))
    assert set(p.stats()) == set(r.stats()) == {"allreduce/tree", "allreduce/khd"}


def test_shipped_cpu_table_resolves_as_reference(devices):
    path = os.path.join(REPO, "results", "tuning_cpu8.json")
    p, r = Transport(rank_mesh(8, "cpu"), tuning=path), RefTransport(rt.rank_mesh(8),
                                                                     tuning=path)
    for verb in VERBS:
        for size in (4 * KiB, MiB, 4 * MiB):
            assert p._resolve("auto", verb, size) == r._resolve("auto", verb, size)


def test_autotuner_sweep_feeds_a_transport():
    t = Transport(rank_mesh(4, "cpu"))
    tuner = PT.Autotuner(t, warmup=1, repeats=1, calls_per_repeat=1)
    assert tuner._candidates("allreduce") == [
        "fused", "ring", "ring_bidir", "tree", "khd", "dtree", "ptree", "ktree"]
    assert "cuda_ring" in tuner._candidates("alltoall", ("cuda_ring", "ring"))
    seen = []
    table = tuner.sweep(["allreduce", "allgather"], [4 * KiB, 64 * KiB],
                        progress=lambda *a: seen.append(a))
    assert {(v, s, a) for v, s, a, _ in seen} == {
        (v, s, a) for v in ("allreduce", "allgather") for s in (4 * KiB, 64 * KiB)
        for a in tuner._candidates(v)}
    times = table.meta["times_s"]
    assert set(times["allreduce"]) == {"4096", "65536"}
    t2 = Transport(rank_mesh(4, "cpu"), tuning=table)
    for verb in ("allreduce", "allgather"):
        for size in (4 * KiB, 64 * KiB):
            row = times[verb][str(size)]
            winner = min(row, key=row.get)
            assert table.lookup(verb, size, 4, 1, "cpu") == winner
            x = tuner._example(verb, size, "float32")
            assert t2._msg_bytes(verb, x) == size  # the sweep's size key
            getattr(t2, verb)(x)
            assert t2.stats()[f"{verb}/{winner}"]["calls"] >= 1
    # the sweep times khd at the digits its dispatch resolves
    assert table.meta["provenance"].startswith("measured Autotuner sweep (platform=cpu")


def test_khd_dispatch_uses_the_model_digits(monkeypatch):
    from rocnrdma_tpu_torch import collectives as C
    seen = {}
    real = C.khd_allreduce

    def spy(x, **kw):
        seen.update(kw)
        return real(x, **kw)

    monkeypatch.setattr(C, "khd_allreduce", spy)
    t = Transport(rank_mesh(8, "cpu"))
    x = torch.zeros((8, 4096))
    t.allreduce(x, "khd")
    assert seen["digits"] == t.khd_model_digits("allreduce", 4096 * 4) == (2, 2, 2)
    seen.clear()
    t.allreduce(x, "khd", max_radix=8)
    assert seen["digits"] == (8,)
    seen.clear()
    t.allreduce(x, "model", digits=(4, 2))  # the knob forces khd under model
    assert seen["digits"] == (4, 2)


# ------------------------------------------------------------------ the CLIs

def _run(args, tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["RNR_HW_CAL_DIR"] = str(tmp_path / "cal")
    return subprocess.run([sys.executable, "-m"] + args, cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)


def test_cli_fold_ladder_and_model_table_on_cpu(tmp_path):
    out = tmp_path / "ladder.jsonl"
    r = _run(["rocnrdma_tpu_torch.bench.fold_ladder", "--platform", "cpu",
              "--widths", "2,3,8", "--out", str(out)], tmp_path)
    assert r.returncode == 0, r.stderr
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert [row["n_ops"] for row in rows] == [2, 3, 8]
    assert all(row["GBps_median"] > 0 and row["platform"] == "cpu" for row in rows)
    # a calibration is refused where no card row would read it
    r = _run(["rocnrdma_tpu_torch.bench.fold_ladder", "--platform", "cpu",
              "--widths", "2", "--save-calibration"], tmp_path)
    assert r.returncode != 0 and not (tmp_path / "cal").exists()
    table = tmp_path / "model.json"
    r = _run(["rocnrdma_tpu_torch.transport.tuner", "--model-table", "cpu",
              "--table-ranks", "4,8", "--sizes", "4K,1M", "--verbs",
              "allreduce,alltoall", "--mesh-shapes", "2x4", "--out", str(table)], tmp_path)
    assert r.returncode == 0, r.stderr
    back = PT.TuningTable.load(str(table))
    ref = RT.model_table("cpu", [4, 8], ["allreduce", "alltoall"], [4096, 1 << 20],
                         _audit=False)
    for verb in ("allreduce", "alltoall"):
        for n in (4, 8):
            for size in (4096, 1 << 20):
                assert back.lookup(verb, size, n, 1, "cpu") == \
                    ref.lookup(verb, size, n, 1, "tpu")
    assert back.lookup("allreduce", 4096, 8, 2, "cpu") is not None


def test_cli_sweep_on_cpu(tmp_path, capsys):
    out = tmp_path / "sweep.json"
    assert PT.main(["--platform", "cpu", "--fake-devices", "4", "--verbs",
                    "allreduce,alltoall", "--sizes", "4K", "--algos",
                    "fused,ring,bruck", "--out", str(out)]) == 0
    table = PT.TuningTable.load(str(out))
    assert table.lookup("allreduce", 4096, 4, 1, "cpu") in ("fused", "ring")
    assert table.lookup("alltoall", 4096, 4, 1, "cpu") in ("fused", "ring", "bruck")
    assert table.meta["command"].startswith("python -m rocnrdma_tpu_torch.transport.tuner")
    assert set(table.meta["times_s"]["alltoall"]["4096"]) == {"fused", "ring", "bruck"}
    assert PT.main(["--platform", "cpu", "--fake-devices", "4", "--verbs",
                    "reduce_scatter", "--sizes", "4K", "--algos", "ring",
                    "--out", str(out), "--merge"]) == 0
    merged = PT.TuningTable.load(str(out))
    assert merged.lookup("reduce_scatter", 4096, 4, 1, "cpu") == "ring"
    assert merged.lookup("allreduce", 4096, 4, 1, "cpu") is not None


def test_cli_sweep_in_one_process_takes_ranks_beyond_the_backends_devices(tmp_path):
    """In one process ``--ranks`` is the mesh's rank count as asked, even
    above the ranks the backend hosts (ranks share a device): the table is
    keyed by that count, not capped at the backend's."""
    out = tmp_path / "sweep.json"
    assert PT.main(["--platform", "cpu", "--fake-devices", "2", "--ranks", "4",
                    "--verbs", "allreduce", "--sizes", "4K", "--algos", "fused,ring",
                    "--out", str(out)]) == 0
    table = PT.TuningTable.load(str(out))
    assert table.lookup("allreduce", 4096, 4, 1, "cpu") in ("fused", "ring")
    assert table.lookup("allreduce", 4096, 2, 1, "cpu") is None
