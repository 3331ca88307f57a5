"""The port's device-plane heal in one process (``runtime/init.py``'s heal
half and ``runtime/mesh.py``'s ``reprobe_topology``), on the CPU.

The election, the re-probe's refusals and the non-member refusal are held
to the reference's (``rocnrdma_tpu/runtime``) on the same inputs: the same
winner, the same flight events, the same messages. The rest is the port's
own process group: torch takes a new ``init_process_group`` in the process
after a destroy or an abort (the reference had to clear jax's backends), a
re-init on a world of one runs every phase, and a silent coordinator ends
in a named error inside the deadline, never a hang.
"""

import re
import socket
import time

import pytest
import torch

from rocnrdma_tpu.obs import FLIGHT as RFLIGHT
from rocnrdma_tpu.runtime import init as RI
from rocnrdma_tpu.runtime import mesh as RM
from rocnrdma_tpu_torch.obs import FLIGHT as PFLIGHT
from rocnrdma_tpu_torch.runtime import init as PI
from rocnrdma_tpu_torch.runtime import mesh as PM
from rocnrdma_tpu_torch.runtime.multiprocess import free_port


def _fake_agree():
    store = {}

    def agree(key, value=None, timeout_s=30.0):
        if value is not None:
            return store.setdefault(key, value)
        assert key in store, "non-leader asked before any proposal"
        return store[key]
    return agree, store


def _mark() -> float:
    return time.perf_counter()  # the recorders' clock


def _events_since(flight, mark: float, prefix: str) -> list:
    # by time, not by index: the ring may be full with earlier tests' events
    return [(kind, args) for t, kind, args in flight.events()
            if t >= mark and kind.startswith(prefix)]


@pytest.mark.parametrize("members,leader", [([2, 5], 2), ([5, 2, 7], 2), ([0], 0)])
def test_elect_coordinator_gives_the_references_winner_and_events(members, leader):
    outs = {}
    for name, mod, flight in (("ref", RI, RFLIGHT), ("port", PI, PFLIGHT)):
        agree, store = _fake_agree()
        mark = _mark()
        winner = mod.elect_coordinator(agree, members, my_orig=leader, epoch=3)
        adopted = [mod.elect_coordinator(agree, members, my_orig=m, epoch=3)
                   for m in members if m != leader]
        assert re.fullmatch(r"127\.0\.0\.1:\d+", winner)
        assert store == {"deviceheal/e3/coord": winner}
        assert adopted == [winner] * (len(members) - 1)
        outs[name] = _events_since(flight, mark, "deviceheal-")
    assert outs["port"] == outs["ref"]
    assert outs["port"] == [("deviceheal-elected", {"epoch": 3, "leader": leader})] \
        * len(members)


def test_reprobe_topology_refusals_name_the_world_as_the_reference():
    topo = PM.reprobe_topology(platform="cpu")  # no expectation: a plain probe
    assert (topo.n_processes, topo.process_index) == (1, 0)
    with pytest.raises(RuntimeError, match="disagree on the world") as port:
        PM.reprobe_topology(expected_processes=2, platform="cpu")
    with pytest.raises(RuntimeError, match="disagree on the world") as ref:
        RM.reprobe_topology(expected_processes=2)
    assert str(port.value) == str(ref.value)  # one process on both sides
    with pytest.raises(RuntimeError, match=r"re-probed 1 device\(s\), expected 3"):
        PM.reprobe_topology(expected_devices=3, platform="cpu")


def test_device_fence_without_a_group_raises():
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="no distributed runtime"):
        PI.device_fence([0, 1], my_orig=0, epoch=0, timeout_s=1.0)


def test_reinit_runtime_refuses_a_non_member_as_the_reference():
    with pytest.raises(ValueError, match="not in the agreed membership") as port:
        PI.reinit_runtime([0, 2], epoch=1, my_orig=5, coordinator="x:1",
                          platform="cpu")
    with pytest.raises(ValueError) as ref:
        RI.reinit_runtime([0, 2], epoch=1, my_orig=5, coordinator="x:1")
    assert str(port.value) == str(ref.value)


def test_shutdown_runtime_without_a_group_is_a_clean_noop():
    mark = _mark()
    assert PI.shutdown_runtime(timeout_s=1.0) is True
    assert PI.shutdown_runtime(timeout_s=1.0, abort=True) is True
    assert _events_since(PFLIGHT, mark, "device-plane-") == [
        ("device-plane-shutdown", {"clean": True})] * 2


def _reduced(value: float) -> float:
    x = torch.full((4,), value)
    torch.distributed.all_reduce(x)
    return float(x[0])


def test_one_process_joins_again_after_destroy_and_after_a_reinit():
    """No backend has to be cleared: a destroyed group, then an aborted
    one, each give way to a new ``init_process_group`` in this process,
    and the re-init runs every phase on the flight timeline."""
    dist = torch.distributed
    try:
        info = PI.init_runtime(coordinator=f"127.0.0.1:{free_port()}",
                               num_processes=1, process_id=0, timeout_s=20,
                               platform="cpu")
        assert (info.backend, info.epoch, info.reinit_s) == ("gloo", 0, 0.0)
        assert info.topology.n_processes == 1 and _reduced(2.0) == 2.0
        assert PI.device_fence([0], 0, 0) == {0: "m0e0"}
        assert PI.shutdown_runtime(timeout_s=10.0) is True
        assert not dist.is_initialized()
        PI.init_runtime(coordinator=f"127.0.0.1:{free_port()}",
                        num_processes=1, process_id=0, timeout_s=20,
                        platform="cpu")
        assert _reduced(3.0) == 3.0
        agree, store = _fake_agree()
        mark = _mark()
        healed = PI.reinit_runtime([0], 1, 0, agree=agree, timeout_s=20.0,
                                   platform="cpu")
        assert (healed.epoch, healed.world_size, healed.rank) == (1, 1, 0)
        assert healed.reinit_s > 0.0 and healed.distributed
        assert _reduced(4.0) == 4.0
        assert PI.device_fence([0], 0, 1) == {0: "m0e1"}
        assert list(store) == ["deviceheal/e1/coord"]
        kinds = [k for k, _ in _events_since(PFLIGHT, mark, "")
                 if k.startswith(("deviceheal-", "member-device-",
                                  "device-plane-"))]
        assert kinds == ["deviceheal-start", "device-plane-shutdown",
                         "member-device-shutdown", "deviceheal-elected",
                         "member-device-election", "member-device-reinit",
                         "member-device-reprobe", "deviceheal-done"]
        done = _events_since(PFLIGHT, mark, "deviceheal-done")
        assert done == [("deviceheal-done", {"epoch": 1, "rank": 0, "procs": 1,
                                             "devices": 1})]
    finally:
        PI.shutdown_runtime(timeout_s=10.0)
    assert not dist.is_initialized()


def test_reinit_against_a_silent_coordinator_times_out_named():
    """A coordinator that accepts and never answers: the store ping of the
    preflight times out, and the re-init fails named, carrying the
    coordinator and the members, inside its deadline."""
    squat = socket.socket()
    squat.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    squat.bind(("127.0.0.1", 0))
    squat.listen(1)
    addr = f"127.0.0.1:{squat.getsockname()[1]}"
    mark = _mark()
    t0 = time.monotonic()
    try:
        with pytest.raises(RuntimeError) as e:
            PI.reinit_runtime([0, 2], 1, 2, coordinator=addr, timeout_s=2.0,
                              platform="cpu")
    finally:
        squat.close()
    assert time.monotonic() - t0 < 2.0 + 3.0
    msg = str(e.value)
    assert f"coordinator={addr!r}" in msg and "members=[0, 2]" in msg
    assert "did not answer" in msg
    assert ("deviceheal-abort", {"epoch": 1, "rank": 2, "error": "TimeoutError"}) \
        in _events_since(PFLIGHT, mark, "deviceheal-")
    assert not torch.distributed.is_initialized()


def test_the_preflight_passes_a_live_store_and_refuses_a_closed_port():
    import datetime
    port = free_port()
    store = torch.distributed.TCPStore("127.0.0.1", port, 1, is_master=True,
                                       timeout=datetime.timedelta(seconds=5),
                                       wait_for_workers=False)
    PI._coordinator_preflight(f"127.0.0.1:{port}", 5.0)  # answers: returns
    del store
    closed = free_port()
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match=f"127.0.0.1:{closed}"):
        PI._coordinator_preflight(f"127.0.0.1:{closed}", 1.0)
    assert time.monotonic() - t0 < 4.0
