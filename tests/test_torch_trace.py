"""The port's schedule tracer (``rocnrdma_tpu_torch/trace.py``) against the
JAX reference's (``rocnrdma_tpu/trace.py``), on the CPU.

- The pure half is a copy: ``schedule_events`` (every generator, at n in
  {2, 3, 4, 6, 8, 12, 16}, the 2-D schedules on 2x4, khd with pinned
  digits), ``to_chrome_trace``, ``measured_to_chrome`` and ``align_steps``
  are held equal to the reference's, exactly.
- Structure: under a live capture every traced (collective, algo) opens
  exactly as many step spans as ``schedule_events`` has steps (the
  counterpart of ``tests/test_trace.py``'s ppermute count), its output is
  bitwise the output without the capture, and with no capture the span
  helper opens no ``record_function`` at all.
"""

import json
import os

import numpy as np
import pytest
import torch

from rocnrdma_tpu import trace as RT
from rocnrdma_tpu_torch import trace as T
from rocnrdma_tpu_torch.collectives import _steps
from rocnrdma_tpu_torch.collectives import hierarchical_alltoall
from rocnrdma_tpu_torch.collectives.schedule import khd_digits
from rocnrdma_tpu_torch.runtime import rank_mesh
from rocnrdma_tpu_torch.transport import Transport

RESULTS = os.path.join(os.path.dirname(__file__), "..", "rocnrdma_tpu_torch", "results")


def _tuples(events):
    return [(e.name, e.rank, e.step, e.nbytes) for e in events]


def _steps_of(events) -> int:
    return max(e.step for e in events) + 1


def _spans(lanes) -> list[int]:
    return [sum("ppermute" in name for name, _, _ in evs) for _, evs in lanes]


@pytest.mark.parametrize("key", sorted(RT._GENERATORS))
@pytest.mark.parametrize("n", [2, 3, 4, 6, 8, 12, 16])
def test_schedule_events_equal_reference(key, n):
    assert sorted(T._GENERATORS) == sorted(RT._GENERATORS)
    for nbytes in (1 << 20, 3000, 12):
        try:
            want = _tuples(RT.schedule_events(*key, n, nbytes))
        except ValueError as e:  # the tree arm needs a power of two
            with pytest.raises(ValueError, match=str(e)[:20]):
                T.schedule_events(*key, n, nbytes)
            continue
        assert _tuples(T.schedule_events(*key, n, nbytes)) == want


@pytest.mark.parametrize("case", [
    ("allreduce", "hierarchical", 8, (2, 4), None),
    ("alltoall", "hierarchical", 8, (2, 4), None),
    ("allreduce", "khd2d", 8, (2, 4), None),
    ("allreduce", "khd", 8, None, (4, 2)),
    ("reducescatter", "khd", 8, None, (4, 2)),
    ("allgather", "khd", 8, None, (2, 2, 2)),
])
def test_2d_and_pinned_digit_events_equal_reference(case):
    coll, algo, n, mesh2d, digits = case
    for nbytes in (1 << 20, 3000):
        assert (_tuples(T.schedule_events(coll, algo, n, nbytes, mesh2d, digits=digits))
                == _tuples(RT.schedule_events(coll, algo, n, nbytes, mesh2d,
                                              digits=digits)))
    for bad in (("allreduce", "ring", 8, 4096, None, (4, 2)),
                ("alltoall", "hierarchical", 8, 4096, None, None)):
        with pytest.raises(ValueError):
            T.schedule_events(*bad[:5], digits=bad[5])


@pytest.mark.parametrize("alpha,beta", [(T.ALPHA_S, T.BETA_S_PER_B), (4.7e-6, 3e-13)])
def test_chrome_trace_equal_reference(alpha, beta):
    assert (T.ALPHA_S, T.BETA_S_PER_B) == (RT.ALPHA_S, RT.BETA_S_PER_B)
    for key in (("allreduce", "dtree"), ("allreduce", "ptree"), ("alltoall", "bruck")):
        ev_p, ev_r = T.schedule_events(*key, 8, 1 << 20), RT.schedule_events(*key, 8, 1 << 20)
        assert (json.dumps(T.to_chrome_trace(ev_p, alpha, beta))
                == json.dumps(RT.to_chrome_trace(ev_r, alpha, beta)))
    assert T.to_chrome_trace([]) == RT.to_chrome_trace([])


def test_align_steps_and_measured_lane_equal_reference():
    ev_p = T.schedule_events("allreduce", "ring", 4, 4096)
    ev_r = RT.schedule_events("allreduce", "ring", 4, 4096)
    rng = np.random.default_rng(3)
    starts = np.cumsum(rng.integers(1_000, 9_000, size=6))
    lane_a = [(f"ppermute ring rs step {k}", int(s), int(d)) for k, (s, d) in
              enumerate(zip(starts, rng.integers(500, 900, size=6)))]
    lane_b = [(f"ppermute step {k}", int(s) + 7, int(d)) for k, (s, d) in
              enumerate(zip(starts, rng.integers(500, 900, size=6)))]
    extra = [("aten::add_", 50, 10)]
    for lanes in ([("a", lane_a)], [("a", lane_a + extra), ("b", lane_b)],
                  [("short", lane_a[:3])], []):
        assert T.align_steps(ev_p, lanes) == RT.align_steps(ev_r, lanes)
        assert T.align_steps(ev_p, lanes, 1e-6, 1e-12) == RT.align_steps(ev_r, lanes, 1e-6, 1e-12)
        assert T.measured_to_chrome(lanes) == RT.measured_to_chrome(lanes)
    assert T.align_steps([], [("a", lane_a)]) == ([], [])


TRACED = [("allreduce", "ring"), ("allreduce", "ring_bidir"), ("allreduce", "tree"),
          ("allreduce", "khd"), ("allreduce", "dtree"), ("allreduce", "ptree"),
          ("reducescatter", "khd"), ("allgather", "khd"), ("alltoall", "ring"),
          ("alltoall", "bruck"), ("broadcast", "binomial"), ("reduce", "binomial")]


@pytest.mark.parametrize("key", TRACED)
@pytest.mark.parametrize("n", [4, 6, 8])
def test_every_step_opens_one_span(key, n):
    assert key in T._GENERATORS
    if key[1] == "tree" and n & (n - 1):  # halving-doubling needs 2^k ranks
        with pytest.raises(ValueError):
            T.schedule_events(*key, n, 16384)
        with pytest.raises(ValueError):
            T.profile_collective(*key, n, 16384, None, n, "cpu")
        return
    digits = tuple(khd_digits(n)) if key[1] == "khd" else None
    ev = T.schedule_events(*key, n, 16384)
    # profile_collective raises unless the captured output is bitwise the
    # uncaptured one
    lanes = T.profile_collective(*key, n, 16384, None, n, "cpu", digits=digits)
    assert _spans(lanes) == [_steps_of(ev)]
    if digits is not None and n == 8:  # the ladder's pick differs from radix 8
        ev2 = T.schedule_events(*key, n, 16384, digits=(4, 2))
        lanes2 = T.profile_collective(*key, n, 16384, None, n, "cpu", digits=(4, 2))
        assert _spans(lanes2) == [_steps_of(ev2)]


@pytest.mark.parametrize("mesh2d", [(2, 4), (2, 3), (4, 2)])
def test_2d_schedules_open_one_span_a_step(mesh2d):
    m, per = mesh2d
    for coll, algo in (("allreduce", "hierarchical"), ("allreduce", "khd2d")):
        ev = T.schedule_events(coll, algo, m * per, 16384, mesh2d)
        lanes = T.profile_collective(coll, algo, m * per, 16384, mesh2d, m * per, "cpu")
        assert _spans(lanes) == [_steps_of(ev)], (coll, algo)
    # the hierarchical alltoall with its rotation phases (the Transport's
    # default phases are the fused transpose, which has no steps)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (m * per, m * per, 5), dtype=np.float32))
    plain = hierarchical_alltoall(x, mesh2d)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof, \
            _steps.capturing():
        got = hierarchical_alltoall(x, mesh2d, intra_algo="rotation",
                                    cross_algo="rotation")
    names = [e.name for e in prof.events() if "ppermute" in e.name]
    assert len(names) == _steps_of(T.schedule_events("alltoall", "hierarchical",
                                                     m * per, 4096, mesh2d))
    assert torch.equal(got, plain)


def test_no_capture_opens_no_record_function(monkeypatch):
    opened = []
    real = torch.profiler.record_function

    def counting(name, *a, **k):
        opened.append(name)
        return real(name, *a, **k)
    monkeypatch.setattr(torch.profiler, "record_function", counting)
    t = Transport(rank_mesh(8, "cpu"))
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((8, 4096), dtype=np.float32))
    calls = [("ring", {}), ("dtree", {}), ("khd", {"digits": (8,)}), ("ptree", {})]
    outs = [t.allreduce(x, a, **k) for a, k in calls]
    assert opened == []
    with _steps.capturing():
        again = [t.allreduce(x, a, **k) for a, k in calls]
    assert len(opened) == sum(_steps_of(T.schedule_events("allreduce", a, 8, 4 * 4096,
                                                          digits=k.get("digits")))
                              for a, k in calls)
    assert all(o.startswith("ppermute ") for o in opened)
    for a, b in zip(outs, again):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert not _steps._CAPTURING


def test_profile_json_round_trips_and_xplane_raises(tmp_path, capsys):
    prof_json = str(tmp_path / "cap.json")
    out1, out2 = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    base = ["--algo", "dtree", "--ranks", "8", "--size", "64K", "--measured",
            "--align-steps"]
    lanes = T.profile_collective("allreduce", "dtree", 8, 65536, None, 8, "cpu",
                                 json_out=prof_json)
    assert T.main(base + ["--platform", "cpu", "--fake-devices", "8", "--out", out1]) == 0
    assert T.main(base + ["--profile-json", prof_json, "--out", out2]) == 0
    a, b = (json.load(open(p))["otherData"] for p in (out1, out2))
    assert len(a["step_diff"]) == len(b["step_diff"]) == 20
    assert [r["name"] for r in a["step_diff"]] == [r["name"] for r in b["step_diff"]]
    assert b["step_diff"] == T.align_steps(T.schedule_events("allreduce", "dtree", 8, 65536),
                                           lanes)[1]
    assert a["capture_bitwise_equal"] and a["device"] == "cpu"
    assert all(r["measured_max_us"] > 0 and r["lanes"] == 1 for r in a["step_diff"])
    assert T.measured_lanes(prof_json) == lanes
    assert _spans(lanes) == [20]
    assert T.measured_lanes(prof_json, device=True) == []  # no device events here
    with pytest.raises(ValueError, match="xplane"):
        T.measured_lanes(str(tmp_path / "x.xplane.pb"))
    with pytest.raises(SystemExit, match="requires --measured"):
        T.main(["--align-steps"])


def test_cli_writes_predicted_trace(tmp_path, capsys):
    out = tmp_path / "t.json"
    assert T.main(["--collective", "allreduce", "--algo", "khd", "--ranks", "8",
                   "--size", "4M", "--digits", "4,2", "--out", str(out)]) == 0
    doc = json.load(open(out))
    assert doc["otherData"]["n_steps"] == 12
    assert T.main(["--algo", "ring", "--ranks", "4", "--size", "64K"]) == 0
    assert json.loads(capsys.readouterr().out)["otherData"]["n_steps"] == 6


@pytest.mark.parametrize("name", ["ring8", "dtree8", "khd8"])
def test_committed_card_alignments_load(name):
    # the three alignments chip_smoke.py's tooling phase captured on the card
    doc = json.load(open(os.path.join(RESULTS, f"trace_align_{name}_h100.trace.json")))
    od = doc["otherData"]
    cfg = od["config"]
    ev = T.schedule_events(cfg["collective"], cfg["algo"], cfg["ranks"],
                           cfg["size_bytes"], digits=cfg["digits"])
    assert len(od["step_diff"]) == od["n_steps"] == _steps_of(ev)
    if name in ("ring8", "dtree8"):
        assert od["n_steps"] == {"ring8": 14, "dtree8": 20}[name]
    assert "H100" in od["nvidia_smi"] and od["capture_bitwise_equal"]
    for row in od["step_diff"]:
        assert row["measured_max_us"] > 0 and row["predicted_us"] > 0
