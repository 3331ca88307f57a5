"""Multi-process harness: N local worker processes in one process group.

Counterpart of ``rocnrdma_tpu/runtime/multiprocess.py``. Spawns N python
processes that each run ``init_runtime`` against a local ``tcp://``
rendezvous: the real process-boundary code path of a multi-GPU job,
exercised on one machine. Under ``platform="cpu"`` the group is gloo; on
the card it is NCCL with one process per GPU, and a task that builds an
NCCL communicator refuses, before anything is spawned, to run more
processes than there are GPUs (NCCL refuses two ranks on one GPU).

Also the fault-injection hook: ``task="fault"`` makes one rank die before
the rendezvous, and the survivors must abort with a named error inside the
deadline instead of hanging.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import socket
import subprocess
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@dataclasses.dataclass
class WorkerResult:
    process_id: int
    returncode: int
    stdout: str
    stderr: str


def reserve_port(host: str = "127.0.0.1") -> tuple[int, socket.socket]:
    """Reserve a free port and KEEP it held until the returned socket is
    closed: bound with ``SO_REUSEADDR`` and listening, so neither another
    explicit binder nor the kernel's ephemeral allocator takes the number
    before the spawned rank 0 binds it. ``run_workers`` closes it just
    before the spawn and retries once on the residual bind collision."""
    s = socket.socket()
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.bind((host, 0))
    s.listen(1)
    return s.getsockname()[1], s


def free_port() -> int:
    """A free port number, released immediately (prefer
    :func:`reserve_port`: the number can be re-drawn by anyone between
    this close and your bind)."""
    port, sock = reserve_port()
    sock.close()
    return port


def _bind_collision(results: list) -> bool:
    """Did this run die on the reserved-port race? Rank 0 binds the
    rendezvous store first thing; a lost race surfaces there as
    EADDRINUSE before any real work ran, as a traceback on stderr or
    inside the worker's named abort on stdout."""
    r0 = next((r for r in results if r.process_id == 0), None)
    if r0 is None or r0.returncode in (0, None):
        return False
    text = ((r0.stderr or "") + (r0.stdout or "")).lower()
    return "address already in use" in text or "eaddrinuse" in text


def _reap(proc: subprocess.Popen) -> tuple[str, str]:
    """Kill ``proc``'s WHOLE process group (workers are spawned as session
    leaders, so children they forked die with them) and collect whatever
    stdout/stderr it managed to write."""
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except (ProcessLookupError, PermissionError, OSError):
        proc.kill()  # already gone, or pgid unavailable: kill the leader
    out, err = proc.communicate()
    return out, err


def _check_devices(n: int, task: str, platform: str) -> None:
    """Refuse, before spawning, a card run NCCL would refuse."""
    from rocnrdma_tpu_torch.runtime.mesh import resolve_device
    from rocnrdma_tpu_torch.runtime.mp_worker import NCCL_TASKS

    if platform == "cpu":
        return
    resolve_device(platform)  # raises without a GPU
    import torch
    gpus = torch.cuda.device_count()
    if task in NCCL_TASKS and gpus < n:
        raise RuntimeError(
            f"fewer GPUs than processes: task {task!r} builds an NCCL "
            f"communicator over {n} processes, one per GPU, and this machine "
            f"has {gpus} GPU(s); NCCL refuses two ranks on one GPU")


def run_workers(n: int, task: str, timeout_s: float = 120.0,
                fault_rank: int | None = None, seed: int | None = None,
                size: int | None = None, platform: str = "auto",
                _retry_left: int = 1) -> list[WorkerResult]:
    """Spawn ``n`` worker processes running ``task``; wait for all.

    ``timeout_s`` is ONE overall deadline for the whole fleet. A worker
    that outlives it has its entire process group killed (children
    included) and is reported with returncode -9 and its partial
    stdout/stderr. ``fault_rank``: the victim of ``fault``; ``seed`` and
    ``size``: the ``allreduce``/``alltoall`` buffers (see ``mp_worker``).
    ``platform``: ``auto`` (the default: NCCL on the card, one process per
    GPU; raises without one) or ``cpu`` (gloo). The rendezvous port is held reserved until the instant
    before the spawn, and a run that still loses the bind race is retried
    once with a fresh port."""
    from rocnrdma_tpu_torch.runtime.mp_worker import TASKS

    if task not in TASKS:
        raise ValueError(f"unknown task {task!r}; know {sorted(TASKS)}")
    _check_devices(n, task, platform)
    port, res = reserve_port()
    coordinator = f"127.0.0.1:{port}"
    env = dict(os.environ)
    env["PYTHONPATH"] = _ROOT + os.pathsep + env.get("PYTHONPATH", "")
    extra = ["--platform", platform]
    for flag, val in (("--fault-rank", fault_rank), ("--seed", seed),
                      ("--size", size)):
        if val is not None:
            extra += [flag, str(val)]
    res.close()  # the spawned rank 0 binds this port next
    deadline = time.monotonic() + timeout_s
    procs = []
    for i in range(n):
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "rocnrdma_tpu_torch.runtime.mp_worker",
             "--coordinator", coordinator, "--num-processes", str(n),
             "--process-id", str(i), "--task", task] + extra,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env, cwd=_ROOT, start_new_session=True))
    results = []
    for i, p in enumerate(procs):
        try:
            out, err = p.communicate(
                timeout=max(0.1, deadline - time.monotonic()))
            results.append(WorkerResult(i, p.returncode, out, err))
        except subprocess.TimeoutExpired:
            out, err = _reap(p)
            results.append(WorkerResult(i, -9, out or "",
                                        (err or "") + "\n[HARNESS] timeout"))
    if _retry_left > 0 and _bind_collision(results):
        return run_workers(n, task, timeout_s, fault_rank, seed, size,
                           platform, _retry_left=_retry_left - 1)
    return results
