"""Runtime bootstrap: the process group and the topology probe.

Counterpart of ``rocnrdma_tpu/runtime/init.py``'s first half.
``init_runtime`` is the entry point a multi-process program calls first.
Where the reference runs ``jax.distributed.initialize`` against a
coordination service, the port runs ``torch.distributed.init_process_group``
with an explicit ``tcp://`` rendezvous (the store rank 0 hosts), world size,
rank and timeout. The backend follows the device: ``nccl`` on the card,
``gloo`` only under ``platform="cpu"``; there is no quiet switch from one to
the other.

Failure disposition (as the reference's): every init failure raises
``RuntimeError`` naming the coordinator, world size and rank. A rank other
than 0 first proves, with a bounded TCP probe, that something listens at the
coordinator, and the probe and the init share one ``timeout_s``.

The reference's heal half (``elect_coordinator``, ``reinit_runtime``,
``device_fence``), which consumes the host plane's ``ProcessGroup.heal``,
waits for the host-plane slice of the port.
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import os
import socket
import threading
import time

import torch

from rocnrdma_tpu_torch.runtime.mesh import Topology, detect_topology, resolve_device

log = logging.getLogger("rocnrdma_tpu_torch")

# the launchers' environments: the reference's, and torchrun's
_COORDINATOR_ENV = "COORDINATOR_ADDRESS"
_TORCHRUN_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE")


@dataclasses.dataclass(frozen=True)
class RuntimeInfo:
    topology: Topology
    distributed: bool          # did we run init_process_group?
    backend: str | None = None  # "nccl" | "gloo" when distributed
    world_size: int = 1
    rank: int = 0


def _should_init_distributed(coordinator, num_processes) -> bool:
    if coordinator is not None or num_processes is not None:
        return True
    return (_COORDINATOR_ENV in os.environ
            or all(v in os.environ for v in _TORCHRUN_ENV))


def _from_env(coordinator, num_processes, process_id):
    """Fill what the caller left out from the launcher's environment."""
    if coordinator is None:
        coordinator = os.environ.get(_COORDINATOR_ENV) or None
        if coordinator is None and os.environ.get("MASTER_ADDR"):
            coordinator = (f"{os.environ['MASTER_ADDR']}:"
                           f"{os.environ.get('MASTER_PORT', '')}")
    if num_processes is None and os.environ.get("WORLD_SIZE"):
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and os.environ.get("RANK"):
        process_id = int(os.environ["RANK"])
    return coordinator, num_processes, process_id


def backend_for(device: torch.device) -> str:
    """The process group's backend for ranks on ``device``."""
    return "nccl" if device.type == "cuda" else "gloo"


def _coordinator_preflight(coordinator: str, timeout_s: float) -> None:
    """Bounded proof that something listens at ``coordinator`` (the store
    rank 0 hosts) before the process group dials it: connects retry with a
    growing pause until ``timeout_s``, then ``TimeoutError`` names the
    address. Rank 0 never calls this: it binds the store itself."""
    host, port = coordinator.rsplit(":", 1)
    deadline = time.monotonic() + timeout_s
    pause, last = 0.02, "no answer"
    while True:
        remaining = deadline - time.monotonic()
        if remaining <= 0.0:
            raise TimeoutError(f"coordinator {coordinator!r} did not answer "
                               f"within {timeout_s:.1f}s ({last})")
        try:
            with socket.create_connection((host, int(port)),
                                          timeout=min(2.0, remaining)):
                return
        except OSError as e:
            last = f"{type(e).__name__}: {e}"
        time.sleep(min(pause, max(0.0, deadline - time.monotonic())))
        pause = min(2 * pause, 0.5)


def init_runtime(coordinator: str | None = None,
                 num_processes: int | None = None,
                 process_id: int | None = None,
                 timeout_s: float = 60,
                 platform: str = "auto") -> RuntimeInfo:
    """Join the process group (when a coordinator, a world size or a
    launcher's environment asks for one) and probe the topology.

    ``coordinator``: ``host:port`` of the rendezvous store, which rank 0
    binds. ``platform``: ``auto`` (the card, raising without one; backend
    ``nccl``, each process on GPU ``LOCAL_RANK`` or ``process_id`` modulo
    the GPUs) or ``cpu`` (``gloo``). ``timeout_s`` bounds the probe and the
    init together."""
    device = resolve_device(platform)
    distributed, backend = False, None
    world, rank = 1, 0
    if _should_init_distributed(coordinator, num_processes):
        coordinator, num_processes, process_id = _from_env(
            coordinator, num_processes, process_id)
        backend = backend_for(device)
        try:
            if None in (coordinator, num_processes, process_id):
                raise ValueError("the process group needs a coordinator, a "
                                 "world size and a rank")
            deadline = time.monotonic() + timeout_s
            if process_id != 0:
                _coordinator_preflight(coordinator, timeout_s)
            if device.type == "cuda":
                local = int(os.environ.get("LOCAL_RANK", process_id))
                torch.cuda.set_device(local % torch.cuda.device_count())
            torch.distributed.init_process_group(
                backend, init_method=f"tcp://{coordinator}",
                world_size=num_processes, rank=process_id,
                timeout=datetime.timedelta(
                    seconds=max(1.0, deadline - time.monotonic())))
        except Exception as e:  # re-raise with the address for diagnosability
            raise RuntimeError(
                f"torch.distributed init_process_group failed (backend="
                f"{backend}, coordinator={coordinator!r}, num_processes="
                f"{num_processes}, process_id={process_id}): "
                f"{type(e).__name__}: {e}") from e
        distributed = True
        world, rank = num_processes, process_id

    topo = detect_topology(platform)
    log.info("runtime: platform=%s devices=%d processes=%d backend=%s%s",
             topo.platform, topo.n_devices, world, backend,
             " [CPU oracle path]" if topo.is_oracle else "")
    return RuntimeInfo(topology=topo, distributed=distributed, backend=backend,
                       world_size=world, rank=rank)


def shutdown_runtime(timeout_s: float = 5.0) -> bool:
    """Bounded ``destroy_process_group``: the teardown runs on a daemon
    thread and the caller waits at most ``timeout_s`` (a dead peer must not
    hold a survivor's exit). True when it finished inside the bound, or
    when there was no process group."""
    dist = torch.distributed
    if not (dist.is_available() and dist.is_initialized()):
        return True

    def _destroy():
        try:
            dist.destroy_process_group()
        except Exception:  # a broken group still has to let the caller go
            pass

    t = threading.Thread(target=_destroy, daemon=True)
    t.start()
    t.join(timeout=max(0.0, timeout_s))
    return not t.is_alive()
