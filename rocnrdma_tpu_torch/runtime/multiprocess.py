"""Multi-process harness: N local worker processes of one job.

Counterpart of ``rocnrdma_tpu/runtime/multiprocess.py``. Spawns N python
processes running one ``mp_worker`` task: the real process-boundary code
path of a multi-GPU job, exercised on one machine. The device tasks join a
torch process group through ``init_runtime``: gloo under
``platform="cpu"``, NCCL on the card with one process per GPU, and a task
that builds an NCCL communicator refuses, before anything is spawned, to
run more processes than there are GPUs (NCCL refuses two ranks on one GPU).
The chaos tasks drive the host plane (``kill-a-host`` both planes) with
the reference's seeded, replayable faults.

Also the fault-injection hook: ``task="fault"`` makes one rank die before
the rendezvous, and the survivors must abort with a named error inside the
deadline instead of hanging.

``run_cli`` runs a program's CLI (``python -m module argv``) as a fleet of
N processes the way a launcher does: each process gets the reference's
launcher environment (``COORDINATOR_ADDRESS``, ``WORLD_SIZE``, ``RANK``
and ``LOCAL_RANK``), and the CLI joins the process group through
``init_runtime`` itself (``bench/cli_common.py``).
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
    if "DEVICEHEAL-FAILED" in (r0.stdout or ""):
        # a device heal that found its elected address taken ran long
        # past the rendezvous: degraded mode, not the reservation race
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
    """Refuse, before spawning, a card run NCCL would refuse. The
    host-plane chaos tasks touch no device; ``kill-a-host`` may run more
    processes than GPUs, because its NCCL group then issues no collective
    (``DEVICE-GLOBAL`` is printed as unsupported), and so may
    ``hierarchical``, whose cross leg then runs on a gloo group through
    the host."""
    from rocnrdma_tpu_torch.runtime.mp_worker import CHAOS_TASKS, NCCL_TASKS

    if platform == "cpu" or task in CHAOS_TASKS:
        return
    from rocnrdma_tpu_torch.runtime.mesh import resolve_device
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
                rounds: int | None = None,
                kill_ranks: str | None = None,
                kill_ops: str | None = None,
                spares: int | None = None,
                join: int | None = None,
                grow_round: int | None = None,
                die_at_promotion: int | None = None,
                device_heal_fail: bool = False,
                lanes: bool = False,
                coalesce: bool = False,
                codec: str | None = None,
                hier: bool = False,
                store_death: str | None = None,
                kill_store_op: int | None = None,
                per_slice: int | None = None,
                calls: str | None = None,
                cases: str | None = None,
                _retry_left: int = 1) -> list[WorkerResult]:
    """Spawn ``n`` worker processes running ``task``; wait for all.

    ``timeout_s`` is ONE overall deadline for the whole fleet. A worker
    that outlives it has its entire process group killed (children
    included) and is reported with returncode -9 and its partial
    stdout/stderr — the outcome the chaos tests assert NEVER happens.
    ``fault_rank``: the victim of ``fault``, ``die-mid-collective``,
    ``trace-delay``, ``evade-straggler`` and ``conformance-drift``;
    ``seed`` and ``size``: the buffers (see ``mp_worker``). ``platform``:
    ``auto`` (the default: NCCL on the card, one process per GPU; raises
    without one) or ``cpu`` (gloo); the host-plane chaos tasks ignore it.
    ``rounds``, ``kill_ranks``/``kill_ops`` (comma lists: the op-space
    kills), ``spares``/``join``/``grow_round``/``die_at_promotion`` (the
    elastic fleet), ``device_heal_fail`` (``kill-a-host``'s degraded
    mode), ``lanes``/``coalesce``/``codec``/``hier`` (the
    ``kill-and-heal`` variants) and ``store_death``/``kill_store_op``
    (``kill-the-store``) are the reference's; ``per_slice``: the ranks each
    process holds in ``hierarchical`` (default 2); ``calls``: the comma list
    of ``rank-mesh`` calls to run (default all); ``cases``: its
    ``SIZE:SEED,...`` cases, run in turn in one fleet. The rendezvous ports are
    held reserved until the instant before the spawn, and a run that still
    loses the bind race is retried once with fresh ports."""
    from rocnrdma_tpu_torch.runtime.mp_worker import DEVICE_TASKS, TASKS

    if task not in TASKS:
        raise ValueError(f"unknown task {task!r}; know {sorted(TASKS)}")
    _check_devices(n, task, platform)
    port, res = reserve_port()
    coordinator = f"127.0.0.1:{port}"
    dev_res = None
    env = dict(os.environ)
    env["PYTHONPATH"] = _ROOT + os.pathsep + env.get("PYTHONPATH", "")
    extra = ["--platform", platform]
    for flag, val in (("--fault-rank", fault_rank), ("--seed", seed),
                      ("--size", size), ("--rounds", rounds),
                      ("--kill-ranks", kill_ranks), ("--kill-ops", kill_ops),
                      ("--spares", spares), ("--join", join),
                      ("--grow-round", grow_round),
                      ("--die-at-promotion", die_at_promotion),
                      ("--codec", codec), ("--store-death", store_death),
                      ("--kill-store-op", kill_store_op),
                      ("--per-slice", per_slice), ("--calls", calls),
                      ("--cases", cases)):
        if val is not None:
            extra += [flag, str(val)]
    for flag, on in (("--device-heal-fail", device_heal_fail),
                     ("--lanes", lanes), ("--coalesce", coalesce),
                     ("--hier", hier)):
        if on:
            extra.append(flag)
    if task in DEVICE_TASKS:
        # the device tasks run TWO rendezvous planes: the bootstrap store
        # (host plane) and the process group's store (device plane)
        dev_port, dev_res = reserve_port()
        extra += ["--device-coordinator", f"127.0.0.1:{dev_port}"]
    # release the reservations at the last instant: the spawned rank 0
    # binds these ports next
    res.close()
    if dev_res is not None:
        dev_res.close()
    deadline = time.monotonic() + timeout_s
    procs = []
    for i in range(n):
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "rocnrdma_tpu_torch.runtime.mp_worker",
             "--coordinator", coordinator, "--num-processes", str(n),
             "--process-id", str(i), "--task", task] + extra,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env, cwd=_ROOT, start_new_session=True))
    results = _wait_fleet(procs, deadline)
    if _retry_left > 0 and _bind_collision(results):
        return run_workers(n, task, timeout_s, fault_rank, seed, size,
                           platform, rounds, kill_ranks, kill_ops, spares,
                           join, grow_round, die_at_promotion,
                           device_heal_fail, lanes, coalesce, codec, hier,
                           store_death, kill_store_op, per_slice, calls, cases,
                           _retry_left=_retry_left - 1)
    return results


def _wait_fleet(procs: list, deadline: float) -> list[WorkerResult]:
    """Collect every process of a fleet; one past ``deadline`` has its
    whole process group killed and is reported with returncode -9."""
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
    return results


def run_cli(n: int, module: str, argv: list, platform: str = "auto",
            timeout_s: float = 300.0, env: dict | None = None,
            _retry_left: int = 1) -> list[WorkerResult]:
    """Run ``python -m module *argv --platform platform`` as ``n``
    processes, rank i with the launcher's environment of rank i of n (a
    coordinator port held reserved until the instant before the spawn),
    and wait for all of them under ONE deadline for the fleet,
    ``timeout_s``: a process that outlives it has its whole process group
    killed and is reported with returncode -9. ``platform``: ``auto`` (a
    process a GPU while there are enough, else sharing them) or ``cpu``
    (gloo). ``env``: more variables for every process. A run that loses
    the port's bind race is retried once with a fresh port."""
    port, res = reserve_port()
    base = dict(os.environ)
    base["PYTHONPATH"] = _ROOT + os.pathsep + base.get("PYTHONPATH", "")
    base.update(env or {})
    args = list(argv) + (["--platform", platform]
                         if "--platform" not in argv else [])
    res.close()  # rank 0 binds the port next
    deadline = time.monotonic() + timeout_s
    procs = []
    for i in range(n):
        penv = dict(base, COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                    WORLD_SIZE=str(n), RANK=str(i), LOCAL_RANK=str(i))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", module] + args, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, env=penv, cwd=_ROOT,
            start_new_session=True))
    results = _wait_fleet(procs, deadline)
    if _retry_left > 0 and _bind_collision(results):
        return run_cli(n, module, argv, platform, timeout_s, env,
                       _retry_left=_retry_left - 1)
    return results
