"""The port's ``kill-the-store``, ``conformance-drift`` and
``chaos-allreduce`` fleets on the CPU, with the assertions of the
reference's tests of the same tasks (``tests/test_store_failover.py``,
``tests/test_conformance.py``, ``tests/test_chaos_soak.py``): real OS
processes on the host plane, no torch in the workers.
"""

import json
import re

import pytest

from rocnrdma_tpu_torch import native
from rocnrdma_tpu_torch.metrics import FaultCounters
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


def _no_hangs(results):
    for r in results:
        assert r.returncode != -9, \
            f"rank {r.process_id} HUNG to the harness kill:\n{r.stderr}"


def test_store_host_death_heals_against_replica_replay_equal():
    """Kill the store-hosting RANK mid-round: survivors re-elect the
    replica and the in-flight heal completes against it (epoch 1, the
    shrunk membership, every round bitwise), every survivor's clients
    re-pointed. One fleet; the seeded faults land as the seed says."""
    n, seed, victim = 4, 3, 0
    results = run_workers(n, "kill-the-store", timeout_s=150.0, seed=seed,
                          rounds=8, size=256, kill_ranks=str(victim),
                          kill_ops="6")
    _no_hangs(results)
    rc = {r.process_id: r.returncode for r in results}
    assert rc[victim] == 7, results[victim].stdout
    assert "FAULT: killed at op 6" in results[victim].stdout
    for r in results:
        if r.process_id == victim:
            continue
        assert r.returncode == 0, \
            f"survivor {r.process_id} exited {r.returncode}:\n" \
            f"{r.stdout}\n{r.stderr}"
        assert _line(r, "EPOCH") == "1"
        assert _line(r, "MEMBERS") == "[1, 2, 3]"
        assert _line(r, "STOREWINNER") == "1"
        assert int(_line(r, "STOREPOINT")) >= 1
        assert re.fullmatch(r"[0-9a-f]{64}", _line(r, "STORELOG"))
        # the odd ranks drop their store connection at their 5th store op
        want = {"store-conn-dropped": 1} if r.process_id % 2 else {}
        assert json.loads(_line(r, "FAULTS")) == want, r.process_id


def test_seeded_drift_names_its_cell_and_replays_digest_equal():
    """3 ranks, rank 1 degraded 1000x: every rank names the drifting
    ``plane|verb|lgK`` cell identically, ``tune_wire`` fires on it, the
    bitwise oracle loses no op, and two same-seed runs replay digest-equal
    on every structural line."""
    n, seed = 3, 23
    runs = [run_workers(n, "conformance-drift", timeout_s=240.0,
                        fault_rank=1, seed=seed, rounds=6, size=4096)
            for _ in range(2)]
    for res in runs:
        for r in res:
            assert r.returncode == 0, \
                f"rank {r.process_id} exited {r.returncode}:\n" \
                f"{r.stdout}\n{r.stderr}"
            assert "BAD-RESULT" not in r.stdout
            assert "CLEAN-ABORT" not in r.stdout
        stats = [json.loads(_line(r, "CONFSTATS")) for r in res]
        assert stats.count(stats[0]) == n
        drift = stats[0]["drift"]
        assert drift, "the seeded degrade produced no drift verdict"
        assert all(c.startswith("shm|") for c in drift)
        assert any("|lg13" in c for c in drift)
        assert stats[0]["top"]["cell"] in drift
        for r in res:
            assert json.loads(_line(r, "TUNED-DRIFT")) == sorted(drift)
    for key in ("CONFLOG", "FAULTLOG", "TUNERLOG", "TRACELOG", "FLEET"):
        assert [_line(r, key) for r in runs[0]] == \
            [_line(r, key) for r in runs[1]], key


@pytest.mark.slow  # as the reference's soak
def test_chaos_soak_replayable_from_seed():
    """4 ranks over FaultNet, hundreds of injected faults: every rank ends
    bitwise-correct or in a named clean abort, never hung, and a second
    run injects the identical fault log on every rank."""
    n, seed, rounds = 4, 1234, 30
    runs = [run_workers(n, "chaos-allreduce", timeout_s=240.0, seed=seed,
                        rounds=rounds) for _ in range(2)]
    for results in runs:
        for r in results:
            assert r.returncode != -9, r.stderr
            assert r.returncode in (0, 4), r.stdout + r.stderr
            assert ("OK rank" if r.returncode == 0 else "CLEAN-ABORT") in r.stdout
    total = FaultCounters()
    for r in runs[0]:
        total.merge(FaultCounters.from_json(_line(r, "FAULTS")))
    assert total.total() >= 200, total.counts
    assert total.counts.get("connect-refused", 0) >= n
    assert total.counts.get("test-delayed", 0) > 0
    assert total.counts.get("close-dropped", 0) > 0
    assert [_line(r, "FAULTLOG") for r in runs[0]] == \
        [_line(r, "FAULTLOG") for r in runs[1]]
    assert all(FaultCounters.from_json(_line(r, "FAULTS")).total() > 0
               for r in runs[0])


def test_chaos_allreduce_round_is_bitwise_and_replays():
    """A short run of the soak's fleet for every tier: the same profile of
    faults, every rank bitwise-correct or cleanly aborted, and the fault
    log of each rank equal across two runs of the seed."""
    n, seed = 4, 77
    runs = [run_workers(n, "chaos-allreduce", timeout_s=120.0, seed=seed,
                        rounds=3, size=1024) for _ in range(2)]
    for results in runs:
        for r in results:
            assert r.returncode in (0, 4), \
                f"rank {r.process_id} exited {r.returncode}:\n" \
                f"{r.stdout}\n{r.stderr}"
            assert ("OK rank" if r.returncode == 0 else "CLEAN-ABORT") in r.stdout
            assert FaultCounters.from_json(_line(r, "FAULTS")).total() > 0
    assert [_line(r, "FAULTLOG") for r in runs[0]] == \
        [_line(r, "FAULTLOG") for r in runs[1]]
