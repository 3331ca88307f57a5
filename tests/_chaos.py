"""Shared by the port's ``kill-and-heal`` variant tests: one fleet through
the port's harness and one through the reference's, with the reference's
seed and kill, and every survivor's replay lines compared."""

import re

from rocnrdma_tpu.runtime import multiprocess as RM
from rocnrdma_tpu_torch.runtime import multiprocess as PM


def line(result, key):
    m = re.search(rf"^{key} (.+)$", result.stdout, re.M)
    assert m, f"rank {result.process_id} printed no {key} line:\n" \
              f"{result.stdout}\n{result.stderr}"
    return m.group(1)


def variant_equals_reference(monkeypatch, variant: dict, kill_op: str,
                             lines: tuple) -> None:
    # the variants record more flight events a round: the ring holds the
    # whole run, as the reference's tests size it
    monkeypatch.setenv("ROCNRDMA_FLIGHT_EVENTS", "32768")
    n, victim = 4, 2
    kw = dict(timeout_s=150.0, seed=11, rounds=6, kill_ranks=str(victim),
              kill_ops=kill_op, **variant)
    port = PM.run_workers(n, "kill-and-heal", **kw)
    ref = RM.run_workers(n, "kill-and-heal", **kw)
    fenced = 0
    for p, r in zip(port, ref):
        assert p.returncode != -9, p.stderr
        if p.process_id == victim:
            assert p.returncode == 7 and r.returncode == 7, p.stdout
            continue
        assert p.returncode == 0, \
            f"survivor {p.process_id} exited {p.returncode}:\n" \
            f"{p.stdout}\n{p.stderr}"
        assert r.returncode == 0, r.stdout + r.stderr
        assert line(p, "EPOCH") == "1"
        assert line(p, "MEMBERS") == "[0, 1, 3]"
        fenced += int(line(p, "FENCED"))
        for key in ("FAULTLOG", "HEALLOG", "FENCED") + lines:
            assert line(p, key) == line(r, key), (p.process_id, key)
    assert fenced > 0  # the heal fenced the stranded frames
