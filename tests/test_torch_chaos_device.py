"""The port's ``kill-a-host`` on the CPU: real OS processes drive both
planes, the self-healing host plane and a gloo process group (the device
plane), and the victim host is hard-killed mid-collective.

These are the contracts of the reference's ``tests/test_device_heal.py``
acceptance runs, held on the port. The reference cannot run them in this
environment (its restartable client imports ``xla_extension``, which this
jax release no longer has), so the contract, not a reference run, is the
ground truth here. ``DEVICE-LOCAL`` is the ``cuda_ring`` allreduce (its plain
version on the CPU); ``DEVICE-GLOBAL`` is the re-created group's own
``all_reduce``. The card's run of the same fleet is in
``tests/test_torch_card.py``.
"""

import json
import re
import time

import pytest

from rocnrdma_tpu_torch import native
from rocnrdma_tpu_torch.runtime.multiprocess import run_workers

pytestmark = [
    pytest.mark.chaos,
    pytest.mark.skipif(not native.available(),
                       reason="native rqp library not buildable"),
]

KILL = dict(seed=11, rounds=4, kill_ranks="1", kill_ops="25", size=2048,
            platform="cpu")


def _line(result, key):
    m = re.search(rf"^{key} (.+)$", result.stdout, re.M)
    assert m, f"rank {result.process_id} printed no {key} line:\n" \
              f"{result.stdout}\n{result.stderr}"
    return m.group(1)


def _no_hangs_no_aborts(results):
    for r in results:
        assert r.returncode != -9, \
            f"rank {r.process_id} HUNG to the harness kill:\n{r.stderr}"
        assert r.returncode != -6, \
            f"rank {r.process_id} SIGABRTed:\n{r.stderr}"


def test_kill_a_host_device_plane_heals_replay_equal():
    """3 hosts each driving BOTH planes, rank 1 hard-killed mid-allreduce at
    a deterministic op. Survivors heal the host plane (epoch 1, members
    [0, 2]), re-create the device plane on the agreed membership (its store
    re-elected by lowest surviving original rank) and prove it with the
    bitwise oracle, locally and across the new group; two runs of the seed
    give equal FAULTLOG/HEALLOG/DEVICEHEAL/FENCED lines on every survivor."""
    victim = 1
    runs = [run_workers(3, "kill-a-host", timeout_s=180.0, **KILL)
            for _ in range(2)]
    for results in runs:
        _no_hangs_no_aborts(results)
        rc = {r.process_id: r.returncode for r in results}
        assert rc[victim] == 7, results[victim].stdout
        assert "FAULT: killed at op 25" in results[victim].stdout
        for r in results:
            if r.process_id == victim:
                continue
            assert r.returncode == 0, \
                f"survivor {r.process_id} exited {r.returncode}:\n" \
                f"{r.stdout}\n{r.stderr}"
            assert _line(r, "EPOCH") == "1"
            assert _line(r, "MEMBERS") == "[0, 2]"
            assert int(_line(r, "FENCED")) > 0
            for epoch in (0, 1):
                assert f"DEVICE-LOCAL ok epoch={epoch}" in r.stdout, r.stdout
                assert f"DEVICE-GLOBAL ok epoch={epoch}" in r.stdout, r.stdout
            # on the CPU the wrapper runs the plain version: no launch
            assert re.search(r"^DEVICE-LAUNCHES epoch=1 on=cpu \{\}$",
                             r.stdout, re.M), r.stdout
            reinit_ms = json.loads(_line(r, "DEVICEHEAL_MS"))
            assert len(reinit_ms) == 1 and reinit_ms[0] > 0.0
            spans = json.loads(_line(r, "DEVICESPANS"))
            assert [s[:2] for s in spans] == [["shutdown", 1], ["election", 1],
                                              ["reinit", 1], ["reprobe", 1]]
        assert sum(int(_line(r, "RESUMED")) for r in results
                   if r.process_id != victim) > 0
    for a, b in zip(*runs):
        if a.process_id == victim:
            continue
        for key in ("FAULTLOG", "HEALLOG", "DEVICEHEAL", "FENCED"):
            assert _line(a, key) == _line(b, key), (a.process_id, key)


def test_kill_a_host_spare_promotion_keeps_world_size():
    """With one warm spare the device plane follows the PROMOTION: the
    spare's first device init happens inside the promotion hook, the world
    stays at 3 (epoch 1, members [0, 1, 2]) and every member's device plane
    passes the bitwise oracle."""
    victim, spare = 2, 3
    results = run_workers(4, "kill-a-host", timeout_s=180.0, spares=1,
                          **dict(KILL, seed=13, kill_ranks=str(victim)))
    _no_hangs_no_aborts(results)
    rc = {r.process_id: r.returncode for r in results}
    assert rc[victim] == 7, results[victim].stdout
    for r in results:
        if r.process_id == victim:
            continue
        assert r.returncode == 0, \
            f"rank {r.process_id} exited {r.returncode}:\n" \
            f"{r.stdout}\n{r.stderr}"
        assert _line(r, "EPOCH") == "1"
        assert _line(r, "MEMBERS") == "[0, 1, 2]"
        assert "DEVICE-LOCAL ok epoch=1" in r.stdout, r.stdout
        assert "DEVICE-GLOBAL ok epoch=1" in r.stdout, r.stdout
        reinit_ms = json.loads(_line(r, "DEVICEHEAL_MS"))
        assert len(reinit_ms) == 1 and reinit_ms[0] > 0.0
    assert "now-rank=2/3" in results[spare].stdout
    # the spare's device plane first came up at the promotion
    assert "DEVICE-LOCAL ok epoch=0" not in results[spare].stdout


@pytest.mark.slow  # as the reference's: the <90 s wall bound is the contract
def test_device_heal_failure_degrades_named_host_still_serves():
    """The re-elected coordinator is a bound-but-silent port, so the device
    re-init can only fail: every survivor surfaces the named device-heal
    failure, carrying the coordinator and the healed membership, inside its
    deadline, then proves the HOST plane still serves (exit 4)."""
    victim = 1
    t0 = time.monotonic()
    results = run_workers(3, "kill-a-host", timeout_s=180.0,
                          device_heal_fail=True, **KILL)
    elapsed = time.monotonic() - t0
    _no_hangs_no_aborts(results)
    rc = {r.process_id: r.returncode for r in results}
    assert rc[victim] == 7, results[victim].stdout
    assert elapsed < 90.0, f"degraded mode took {elapsed:.0f}s"
    for r in results:
        if r.process_id == victim:
            continue
        assert r.returncode == 4, \
            f"survivor {r.process_id} exited {r.returncode}:\n" \
            f"{r.stdout}\n{r.stderr}"
        failed = _line(r, "DEVICEHEAL-FAILED")
        assert "device-plane heal failed" in failed
        assert "host plane healthy" in failed
        assert re.search(r"coordinator='127\.0\.0\.1:\d+'", failed)
        assert "HOST-PLANE-OK" in r.stdout, r.stdout
        assert "HOST-PLANE-BAD" not in r.stdout
        assert json.loads(_line(r, "DEVICEHEAL_MS")) == []
