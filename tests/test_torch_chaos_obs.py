"""The port's ``trace-delay`` and ``evade-straggler`` fleets on the CPU,
with the assertions of the reference's tests of the same tasks
(``tests/test_obs_trace.py``, ``tests/test_evasion.py``): real OS processes
on the host plane, no torch in the workers, full tracing.
"""

import json
import re

import pytest

from rocnrdma_tpu_torch import native
from rocnrdma_tpu_torch.obs import trace
from rocnrdma_tpu_torch.runtime.multiprocess import run_workers

pytestmark = [
    pytest.mark.chaos,
    pytest.mark.skipif(not native.available(),
                       reason="native rqp library not buildable"),
]


def _line(result, key):
    m = re.search(rf"^{key} (.+)$", result.stdout, re.M)
    assert m, f"rank {result.process_id} printed no {key} line:\n" \
              f"{result.stdout}\n{result.stderr}"
    return m.group(1)


def test_delayed_rank_owns_the_critical_path(monkeypatch):
    """4 ranks, only rank 3's receive completions held: the assembled
    critical paths name rank 3 on (nearly) every op, each rank's buckets
    sum to its op wall, and two same-seed runs print identical structural
    trace digests on every rank."""
    monkeypatch.setenv("ROCNRDMA_TRACE_SAMPLE", "1")
    n, seed, rounds, victim = 4, 7, 3, 3
    runs = [run_workers(n, "trace-delay", timeout_s=150.0,
                        fault_rank=victim, seed=seed, rounds=rounds,
                        size=2048) for _ in range(2)]
    for results in runs:
        for r in results:
            assert r.returncode == 0, \
                f"rank {r.process_id} exited {r.returncode}:\n" \
                f"{r.stdout}\n{r.stderr}"
    records = [rec for r in runs[0] for rec in json.loads(_line(r, "TRACE"))]
    trees = trace.assemble(records, world=n)
    assert len(trees) == rounds
    blamed = 0
    for t in trees:
        assert t["critical_path"], t
        blamed += t["cp_rank"] == victim
        for rank_s, info in t["ranks"].items():
            got = sum(info["attribution"].values())
            assert got == pytest.approx(info["wall_s"], abs=1e-9), \
                (rank_s, info)
    assert blamed >= rounds - 1, [t["cp_share"] for t in trees]
    sb = trace.scoreboard(trees)
    assert sb["straggler"] == victim
    assert sb["share"][str(victim)] > 0.5
    assert [_line(r, "TRACELOG") for r in runs[0]] == \
        [_line(r, "TRACELOG") for r in runs[1]]
    assert all(json.loads(_line(r, "TRACE")) for r in runs[0])


def test_straggler_evaded_before_watchdog_fires(monkeypatch):
    """4 members + 1 warm spare, rank 2 chronically degraded: tier 1 moves
    it to the ring tail, tier 2 drains it and promotes the spare into
    ORIGINAL rank 2 before any death confirmation, no op is lost,
    recovered algbw clears 1.5x degraded, and two same-seed runs replay
    digest-equal."""
    monkeypatch.setenv("ROCNRDMA_TRACE_SAMPLE", "1")
    n, seed, rounds, victim = 5, 11, 8, 2
    runs = [run_workers(n, "evade-straggler", timeout_s=150.0,
                        fault_rank=victim, seed=seed, rounds=rounds,
                        size=4096, spares=1) for _ in range(2)]
    for res in runs:
        for r in res:
            assert r.returncode == 0, \
                f"rank {r.process_id} exited {r.returncode}:\n" \
                f"{r.stdout}\n{r.stderr}"
            assert "BAD-RESULT" not in r.stdout
            assert "CLEAN-ABORT" not in r.stdout
        assert f"DRAINED rank={victim}" in res[victim].stdout
        assert json.loads(_line(res[victim], "FAULTS"))["degraded"] > 0
        assert "OK rank=4/5" in res[n - 1].stdout
        state = json.loads(_line(res[0], "EVASTATE"))
        assert state["promoted"] == [victim]
        assert state["actions"] == 2
        assert _line(res[0], "MEMBERS") == "[0, 1, 3, 2]"
        assert _line(res[0], "EPOCH") == "2"
        assert float(_line(res[0], "RECOVERY_RATIO")) >= 1.5
        assert float(_line(res[0], "RECOVERED_ALGBW")) > 0.0
    for key in ("FAULTLOG", "EVASIONLOG", "HEALLOG", "FLEET"):
        assert [_line(r, key) for r in runs[0]] == \
            [_line(r, key) for r in runs[1]], key
