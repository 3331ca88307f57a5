"""The port's process runtime on gloo (``runtime/init.py``,
``runtime/multiprocess.py``, ``runtime/mp_worker.py``), on the CPU.

Real OS processes join a ``tcp://`` rendezvous through ``init_runtime``
and run their task over the process group, as the reference's workers run
theirs over ``jax.distributed``: the allreduce and alltoall tasks check the
reference's values, ``fault`` must end in a named clean abort inside the
deadline (never a harness kill), and ``hang``'s whole process group must be
reaped. The card (NCCL) half is exercised by ``chip_smoke.py``.
"""

import os
import time

import pytest
import torch

from rocnrdma_tpu.runtime import multiprocess as RM
from rocnrdma_tpu_torch.runtime import init as I
from rocnrdma_tpu_torch.runtime import mesh as rm
from rocnrdma_tpu_torch.runtime import mp_worker as W
from rocnrdma_tpu_torch.runtime import multiprocess as M


@pytest.mark.parametrize("task", ["allreduce", "alltoall"])
@pytest.mark.parametrize("n", [2, 3])
def test_collective_tasks_print_ok(task, n):
    rs = M.run_workers(n, task, timeout_s=90, platform="cpu")
    assert [r.returncode for r in rs] == [0] * n, [r.stderr[-800:] for r in rs]
    for r in rs:
        assert f"OK rank={r.process_id}/{n} backend=gloo" in r.stdout


def test_seeded_buffers_of_any_size():
    for task in ("allreduce", "alltoall"):
        rs = M.run_workers(3, task, timeout_s=90, seed=7, size=1000,
                           platform="cpu")
        assert all(r.returncode == 0 and "OK rank=" in r.stdout for r in rs), \
            [r.stderr[-800:] for r in rs]


def test_fault_ends_in_a_clean_abort_inside_the_deadline():
    t0 = time.monotonic()
    rs = M.run_workers(2, "fault", timeout_s=60, fault_rank=1, platform="cpu")
    assert time.monotonic() - t0 < 60
    by = {r.process_id: r for r in rs}
    assert by[1].returncode == 3 and "FAULT" in by[1].stdout
    assert by[0].returncode == 4, by[0].stderr[-800:]  # never -9
    assert "CLEAN-ABORT" in by[0].stdout and "127.0.0.1:" in by[0].stdout
    assert "num_processes=2" in by[0].stdout and "process_id=0" in by[0].stdout


def _alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/status") as fp:
            return "\nState:\tZ" not in fp.read()
    except OSError:
        return False


def test_hang_reaps_the_whole_process_group():
    t0 = time.monotonic()
    rs = M.run_workers(2, "hang", timeout_s=8, platform="cpu")
    assert time.monotonic() - t0 < 30
    assert [r.returncode for r in rs] == [-9, -9]
    kids = [int(r.stdout.split("CHILD ")[1].split()[0]) for r in rs]
    deadline = time.monotonic() + 10
    while any(_alive(k) for k in kids) and time.monotonic() < deadline:
        time.sleep(0.1)
    assert not any(_alive(k) for k in kids)
    assert all("[HARNESS] timeout" in r.stderr for r in rs)


def test_dead_coordinator_raises_a_named_error_inside_the_timeout():
    port = M.free_port()
    t0 = time.monotonic()
    with pytest.raises(RuntimeError) as e:
        I.init_runtime(coordinator=f"127.0.0.1:{port}", num_processes=2,
                       process_id=1, timeout_s=2, platform="cpu")
    assert time.monotonic() - t0 < 6
    msg = str(e.value)
    assert f"127.0.0.1:{port}" in msg and "num_processes=2" in msg
    assert "process_id=1" in msg and "gloo" in msg
    assert not torch.distributed.is_initialized()


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the no-GPU refusal")
def test_auto_platform_without_a_gpu_raises():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        I.init_runtime(platform="auto")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.run_workers(2, "allreduce", platform="auto")
    # the launcher and the worker CLI run on the card unless asked for the CPU
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.run_workers(2, "allreduce")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        W.main(["--coordinator", "127.0.0.1:1", "--num-processes", "1",
                "--process-id", "0", "--task", "allreduce"])


def test_more_nccl_processes_than_gpus_raise_before_spawning(monkeypatch):
    monkeypatch.setattr(rm, "resolve_device", lambda platform="auto": torch.device("cuda", 0))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    spawned = []
    monkeypatch.setattr(M.subprocess, "Popen", lambda *a, **k: spawned.append(a))
    for task in ("allreduce", "alltoall"):
        with pytest.raises(RuntimeError, match="fewer GPUs than processes"):
            M.run_workers(2, task, platform="auto")
    assert spawned == []
    M._check_devices(1, "allreduce", "auto")  # one process per GPU is fine
    M._check_devices(2, "fault", "auto")      # fault builds no communicator
    # kill-a-host's NCCL group issues no collective with fewer GPUs than
    # members (DEVICE-GLOBAL is named unsupported); the host-plane chaos
    # tasks touch no device at all
    M._check_devices(3, "kill-a-host", "auto")
    M._check_devices(4, "kill-and-heal", "auto")
    assert I.backend_for(torch.device("cuda", 0)) == "nccl"
    assert I.backend_for(torch.device("cpu")) == "gloo"
    with pytest.raises(ValueError, match="unknown task"):
        M.run_workers(2, "kill-everything")


def test_launcher_environment_and_shutdown(monkeypatch):
    for v in ("COORDINATOR_ADDRESS", "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(v, raising=False)
    assert not I._should_init_distributed(None, None)
    assert I._should_init_distributed("h:1", None) and I._should_init_distributed(None, 2)
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "29500")
    assert not I._should_init_distributed(None, None)  # torchrun sets all three
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "2")
    assert I._should_init_distributed(None, None)
    assert I._from_env(None, None, None) == ("127.0.0.1:29500", 4, 2)
    monkeypatch.setenv("COORDINATOR_ADDRESS", "10.0.0.1:1234")
    assert I._from_env(None, None, None) == ("10.0.0.1:1234", 4, 2)
    for v in ("COORDINATOR_ADDRESS", "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(v)
    info = I.init_runtime(platform="cpu")  # no launcher: one process, no group
    assert (info.distributed, info.backend, info.world_size) == (False, None, 1)
    assert info.topology.platform == "cpu"
    assert I.shutdown_runtime() is True  # no process group: nothing to tear down


def test_port_reservation_and_bind_collision_match_reference():
    port, sock = M.reserve_port()
    try:
        assert 0 < port < 65536
    finally:
        sock.close()
    dead = M.WorkerResult(0, 1, "", "EADDRINUSE: address already in use")
    ref_dead = RM.WorkerResult(0, 1, "", "Address already in use")
    assert M._bind_collision([dead]) and RM._bind_collision([ref_dead])
    assert not M._bind_collision([M.WorkerResult(0, 0, "", "address already in use")])
    assert not M._bind_collision([M.WorkerResult(1, 1, "", "address already in use")])
    # a degraded device heal whose elected address was taken is no collision
    assert not M._bind_collision([M.WorkerResult(
        0, 4, "DEVICEHEAL-FAILED RuntimeError: ... [Errno 98] Address already "
              "in use", "")])
    assert os.path.isdir(M._ROOT) and os.path.exists(os.path.join(M._ROOT, "rocnrdma_tpu_torch"))
