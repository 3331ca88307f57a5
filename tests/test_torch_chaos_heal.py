"""The port's ``kill-and-heal`` and ``die-mid-collective`` held to the
reference's own runs: the same seed and kills through the reference's
harness (``rocnrdma_tpu/runtime``) and the port's, real OS processes on the
host plane (no torch in the workers), and every survivor's fault and heal
timeline digests equal across the two packages.
"""

import json
import re

import pytest

from rocnrdma_tpu import native as RN
from rocnrdma_tpu.runtime import multiprocess as RM
from rocnrdma_tpu_torch import native as PN
from rocnrdma_tpu_torch.runtime import multiprocess as PM

pytestmark = [
    pytest.mark.chaos,
    pytest.mark.skipif(not (RN.available() and PN.available()),
                       reason="native rqp library not buildable"),
]


def _line(result, key):
    m = re.search(rf"^{key} (.+)$", result.stdout, re.M)
    assert m, f"rank {result.process_id} printed no {key} line:\n" \
              f"{result.stdout}\n{result.stderr}"
    return m.group(1)


def _hung(results):
    for r in results:
        assert r.returncode != -9, \
            f"rank {r.process_id} HUNG to the harness kill:\n{r.stderr}"


def test_kill_and_heal_logs_equal_the_references():
    """4 ranks, rank 2 hard-killed at op 49 mid-allreduce: the port's
    survivors heal to epoch 1 on [0, 1, 3], finish every round bitwise, fence
    the stranded ping, walk ok -> degraded -> healing -> ok, and print the
    FAULTLOG and HEALLOG the reference's survivors print for the same seed
    and kill."""
    n, victim = 4, 2
    kw = dict(timeout_s=150.0, seed=11, rounds=6, kill_ranks=str(victim),
              kill_ops="49")
    port = PM.run_workers(n, "kill-and-heal", **kw)
    ref = RM.run_workers(n, "kill-and-heal", **kw)
    for results in (port, ref):
        _hung(results)
        assert results[victim].returncode == 7, results[victim].stdout
        assert "FAULT: killed at op 49" in results[victim].stdout
    for r in port:
        if r.process_id == victim:
            continue
        assert r.returncode == 0, \
            f"survivor {r.process_id} exited {r.returncode}:\n" \
            f"{r.stdout}\n{r.stderr}"
        assert _line(r, "EPOCH") == "1"
        assert _line(r, "MEMBERS") == "[0, 1, 3]"
        assert int(_line(r, "FENCED")) > 0
        assert json.loads(_line(r, "HEALTH")) == [["ok", "degraded", 0],
                                                  ["degraded", "healing", 0],
                                                  ["healing", "ok", 1]]
        assert "tuner-fence" in _line(r, "TUNERLOG")
    snap = json.loads(_line(port[0], "FLEETSNAP"))
    assert snap["epoch"] == 1 and snap["members"] == [0, 1, 3]
    assert snap["health"] == {"0": "ok", "1": "ok", "3": "ok"}
    assert snap["missing"] == [] and snap["stale_dropped"] == 0
    for p, r in zip(port, ref):
        if p.process_id == victim:
            continue
        assert r.returncode == 0, r.stdout + r.stderr
        for key in ("FAULTLOG", "HEALLOG", "FENCED"):
            assert _line(p, key) == _line(r, key), (p.process_id, key)


def test_die_mid_collective_logs_equal_the_references():
    """Rank 2 dies inside round 3's collective: every survivor of the port
    aborts named inside its deadline (exit 4), dumps a flight postmortem
    naming the stalled hop, frame and peer, and prints the FAULTLOG the
    reference's survivor prints for the same seed."""
    n, victim = 4, 2
    kw = dict(timeout_s=120.0, seed=7, rounds=6, fault_rank=victim)
    port = PM.run_workers(n, "die-mid-collective", **kw)
    ref = RM.run_workers(n, "die-mid-collective", **kw)
    for results in (port, ref):
        _hung(results)
        assert results[victim].returncode == 7, results[victim].stderr
    for p, r in zip(port, ref):
        if p.process_id == victim:
            continue
        assert p.returncode == 4, \
            f"survivor {p.process_id} exited {p.returncode}:\n" \
            f"{p.stdout}\n{p.stderr}"
        assert re.search(r"CLEAN-ABORT: (TimeoutError|OSError|"
                         r"ConnectionRefusedError)", p.stdout)
        assert "FLIGHT POSTMORTEM" in p.stderr
        m = re.search(r"ring wire stalled: (recv|send|flush) hop (\d+) "
                      r"frame (\S+) peer rank (\d+)", p.stdout)
        assert m, p.stdout
        assert int(m.group(4)) in {0, 1, 2, 3} - {p.process_id}
        assert r.returncode == 4, r.stdout + r.stderr
        assert _line(p, "FAULTLOG") == _line(r, "FAULTLOG"), p.process_id
