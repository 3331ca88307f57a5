"""Runtime bootstrap: the process group, the topology probe, and the
device-plane heal.

Counterpart of ``rocnrdma_tpu/runtime/init.py``. ``init_runtime`` is the
entry point a multi-process program calls first. Where the reference runs
``jax.distributed.initialize`` against a coordination service, the port
runs ``torch.distributed.init_process_group`` on a ``TCPStore`` it builds
itself (rank 0 hosts it at ``coordinator``), with an explicit world size,
rank and timeout. The backend follows the device: ``nccl`` on the card,
``gloo`` only under ``platform="cpu"``; there is no quiet switch from one to
the other.

Failure disposition (as the reference's): every init failure raises
``RuntimeError`` naming the coordinator, world size and rank. A rank other
than the store's host first proves, with a bounded store ping, that a store
answers at the coordinator (a ``TCPStore`` client handed a silent port
waits forever), and the ping and the init share one ``timeout_s``.

``reinit_runtime`` is the restartable half (the device-plane heal): when the
host plane's ``ProcessGroup.heal()`` agrees on a shrunk or promoted
membership, every survivor aborts the dead generation's communicators,
re-elects the store's host (the lowest surviving original rank, through the
same first-writer-wins proposal ``heal()`` uses), and joins a new process
group on the agreed members, so the device plane follows the host plane out
of a host death. ``device_fence`` proves the new generation's store serves
every member.

``leave`` ends a process after its teardown without the interpreter's
finalization, where gloo's threads can abort a process after a clean
destroy of its group.
"""

from __future__ import annotations

import atexit
import dataclasses
import datetime
import logging
import os
import socket
import struct
import sys
import threading
import time

import torch

from rocnrdma_tpu_torch.obs import FLIGHT as _FLIGHT
from rocnrdma_tpu_torch.runtime.mesh import (Topology, detect_topology,
                                             reprobe_topology, resolve_device)

log = logging.getLogger("rocnrdma_tpu_torch")

# the launchers' environments: the reference's, and torchrun's
_COORDINATOR_ENV = "COORDINATOR_ADDRESS"
_TORCHRUN_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE")
# torchrun's c10d agent already hosts a store at MASTER_PORT; its workers
# dial it, under a prefix per restart attempt
_AGENT_STORE_ENV = "TORCHELASTIC_USE_AGENT_STORE"


def _agent_store() -> bool:
    """Does a launcher's agent host the rendezvous store (torchrun)?"""
    return os.environ.get(_AGENT_STORE_ENV, "").lower() == "true"


@dataclasses.dataclass(frozen=True)
class RuntimeInfo:
    topology: Topology
    distributed: bool          # did we run init_process_group?
    backend: str | None = None  # "nccl" | "gloo" when distributed
    world_size: int = 1
    rank: int = 0
    epoch: int = 0             # host-plane generation this runtime serves
    reinit_s: float = 0.0      # wall time of the restart (0.0 on first init)


# the process group's store of the live generation; a dead generation's
# store is retired, never closed: a member whose teardown is still running
# must not find its store gone (the reference keeps its coordination
# services alive for the same reason)
_STORE: dict = {"store": None}
_RETIRED_STORES: list = []


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


def launcher_env() -> tuple | None:
    """``(coordinator, world size, rank)`` that a launcher's environment
    names (any of them None where it names none), or None where no
    launcher's environment is present."""
    if not _should_init_distributed(None, None):
        return None
    return _from_env(None, None, None)


def backend_for(device: torch.device) -> str:
    """The process group's backend for ranks on ``device``."""
    return "nccl" if device.type == "cuda" else "gloo"


# the TCPStore wire: a client opens with VALIDATE + the magic number, and a
# PING carries a nonce the server echoes (c10d's TCPStoreBackend.hpp)
_STORE_VALIDATE = struct.pack("<BI", 0, 0x3C85F7CE)
_STORE_PING = 13


def _coordinator_preflight(coordinator: str, timeout_s: float) -> None:
    """Bounded proof that a store ANSWERS at ``coordinator`` before a
    ``TCPStore`` client may dial it: the client's own handshake waits for
    the reply with no bound, so a silent listener on the port would hold
    the process for good. Dial, validate, ping, and require the nonce
    back; refused connects and silent listeners retry under the shared
    backoff until ``timeout_s``, then ``TimeoutError`` names the address.
    The store's host never calls this: it binds the store itself."""
    from rocnrdma_tpu_torch.transport.backoff import poll_backoff
    host, port = coordinator.rsplit(":", 1)
    deadline = time.monotonic() + timeout_s
    back = poll_backoff()
    last, nonce = "no answer", os.getpid() & 0xFFFFFFFF
    while True:
        remaining = deadline - time.monotonic()
        if remaining <= 0.0:
            raise TimeoutError(
                f"coordinator {coordinator!r} did not answer within "
                f"{timeout_s:.1f}s ({last}) — refusing to hand it to the "
                f"store client, which would wait on it forever")
        try:
            with socket.create_connection(
                    (host, int(port)), timeout=min(2.0, remaining)) as s:
                s.settimeout(min(2.0, remaining))
                s.sendall(_STORE_VALIDATE + struct.pack("<BI", _STORE_PING,
                                                        nonce))
                got = b""
                while len(got) < 4:
                    chunk = s.recv(4 - len(got))
                    if not chunk:
                        break
                    got += chunk
                if len(got) == 4:
                    return  # a live store echoed the ping
                last = "connection closed without an answer"
        except OSError as e:
            last = f"{type(e).__name__}: {e}"
        back.pause()


def _listen(host: str, port: int) -> int:
    """A listening socket on exactly ``host:port``, handed over as its fd.
    The store's host binds it itself: a ``TCPStore`` left to bind its own
    server may bind another address of the port while a squatter holds
    ``host:port``, and its client's handshake would then wait on the
    squatter for good. A taken address raises here, named."""
    s = socket.socket()
    try:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((host, port))
        s.listen(128)
    except OSError:
        s.close()
        raise
    return s.detach()


def _join(coordinator: str, world: int, rank: int, is_host: bool,
          backend: str, timeout_s: float, agent: bool = False) -> None:
    """Build the generation's ``TCPStore`` (hosted by ``is_host`` on a
    socket it bound, dialled by the rest after the preflight) and join the
    default process group on it, all inside ``timeout_s``. Where
    ``agent`` (torchrun's agent hosts the store at the coordinator), every
    rank dials it, under the attempt's prefix as torchrun's own workers
    do."""
    dist = torch.distributed
    deadline = time.monotonic() + timeout_s
    host, port = coordinator.rsplit(":", 1)
    fd = _listen(host, int(port)) if is_host else None
    if not is_host:
        _coordinator_preflight(coordinator, timeout_s)
    left = lambda: datetime.timedelta(  # noqa: E731
        seconds=max(1.0, deadline - time.monotonic()))
    # the host waits for every member to dial in, inside the deadline: the
    # rendezvous of the group (NCCL would otherwise wait on a missing
    # member at its first collective, not here)
    store = dist.TCPStore(host, int(port), world, is_master=is_host,
                          timeout=left(), master_listen_fd=fd)
    if agent:
        attempt = os.environ.get("TORCHELASTIC_RESTART_COUNT", "0")
        store = dist.PrefixStore(f"/worker/attempt_{attempt}", store)
    _STORE["store"] = store
    dist.init_process_group(backend, store=store, world_size=world,
                            rank=rank, timeout=left())


def init_runtime(coordinator: str | None = None,
                 num_processes: int | None = None,
                 process_id: int | None = None,
                 timeout_s: float = 60,
                 platform: str = "auto") -> RuntimeInfo:
    """Join the process group (when a coordinator, a world size or a
    launcher's environment asks for one) and probe the topology.

    ``coordinator``: ``host:port`` of the rendezvous store, which rank 0
    binds, or under torchrun's agent (``TORCHELASTIC_USE_AGENT_STORE``)
    the agent's store, which every rank dials. ``platform``: ``auto``
    (the card, raising without one; backend ``nccl``, each process on GPU
    ``LOCAL_RANK`` or ``process_id`` modulo the GPUs) or ``cpu``
    (``gloo``). ``timeout_s`` bounds the preflight and the init
    together."""
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
            _set_cuda_device(device, process_id)
            agent = _agent_store()
            _join(coordinator, num_processes, process_id,
                  process_id == 0 and not agent, backend, timeout_s, agent)
        except Exception as e:  # re-raise with the address for diagnosability
            _FLIGHT.record("device-init-abort", error=type(e).__name__)
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


def _set_cuda_device(device: torch.device, process_id: int) -> None:
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", process_id))
        torch.cuda.set_device(local % torch.cuda.device_count())


# ---------------------------------------------------------------------------
# The device-plane heal: the restartable process group.
# ---------------------------------------------------------------------------


def _abort_communicators() -> None:
    """Abort every communicator of the process group and detach it, so a
    collective hung on a dead peer returns and a new group can be made in
    this process (NCCL's ``ncclCommAbort`` needs no peer; gloo's abort
    just drops its pairs)."""
    torch.distributed.distributed_c10d._abort_process_group()


def shutdown_runtime(timeout_s: float = 5.0, abort: bool = False) -> bool:
    """Best-effort, BOUNDED teardown of the process group.

    With a dead peer (the reason the device plane is healing at all) a
    collective or an orderly destroy can wait on it for good. So with
    ``abort`` (what a heal asks for) the communicators are aborted instead
    of destroyed in order; either runs on a daemon thread, and the caller
    waits at most ``timeout_s``.
    Returns True when the teardown finished inside the bound, or when
    there was no process group; False when it was abandoned to the
    background. The generation's store is retired, not closed: a member
    whose teardown is still running must not lose it. The outcome is
    recorded as a ``device-plane-shutdown`` flight event, OUTSIDE the
    ``deviceheal-`` replay digest, because clean-vs-abandoned is
    wall-clock-determined."""
    dist = torch.distributed
    ipc = sys.modules.get("rocnrdma_tpu_torch.ops.ipc")
    if ipc is not None:
        # the kernels' IPC workspaces: peers unmapped before the group goes;
        # an aborted job's peers may be gone, so no wait on them then
        ipc.close_all(collective=not abort)
    store, _STORE["store"] = _STORE["store"], None
    if store is not None:
        _RETIRED_STORES.append(store)
    if not (dist.is_available() and dist.is_initialized()):
        _FLIGHT.record("device-plane-shutdown", clean=True)
        return True

    def _wind_down():
        try:
            if abort:
                _abort_communicators()
            else:
                dist.destroy_process_group()
        except Exception:  # a broken group still has to let the caller go
            pass

    t = threading.Thread(target=_wind_down, daemon=True)
    t.start()
    t.join(timeout=max(0.0, timeout_s))
    clean = not t.is_alive()
    _FLIGHT.record("device-plane-shutdown", clean=clean)
    return clean


def leave(code: int):
    """End this process with ``code`` once its process group is torn down
    (``shutdown_runtime`` or ``destroy_process_group``): run the atexit
    hooks, flush stdout and stderr, and exit without the interpreter's
    finalization. There, after a clean destroy, gloo's threads can abort
    the process ("terminate called without an active exception", SIGABRT),
    a few times in a hundred two-process groups on a busy host."""
    atexit._run_exitfuncs()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)


def elect_coordinator(agree, members: list, my_orig: int, epoch: int,
                      timeout_s: float = 30.0,
                      host: str = "127.0.0.1") -> str:
    """Re-elect the device plane's store host for ``epoch``: the lowest
    surviving ORIGINAL rank reserves a fresh port on its host and proposes
    ``host:port`` under the group's store, first-writer-wins — the same
    split-brain-free proposal shape ``heal()`` uses for the member list.
    Everyone (proposer included) adopts the winning value.

    ``agree`` is the group's agreement primitive
    (:meth:`ProcessGroup.agree`): ``agree(key, value)`` proposes
    set-if-absent and returns the winner; ``agree(key, None, timeout_s)``
    blocks for it. The key is epoch-qualified so a later heal's election
    can never read a dead generation's coordinator."""
    from rocnrdma_tpu_torch.runtime.multiprocess import reserve_port
    key = f"deviceheal/e{epoch}/coord"
    if my_orig == min(members):
        port, res = reserve_port(host)
        res.close()  # the new generation's store binds it next
        winner = agree(key, f"{host}:{port}")
    else:
        winner = agree(key, None, timeout_s)
    # on the replay-equal DEVICEHEAL timeline by leader identity, never
    # by port (ports vary run to run)
    _FLIGHT.record("deviceheal-elected", epoch=epoch,
                   leader=min(members))
    return winner


def reinit_runtime(members: list, epoch: int, my_orig: int,
                   agree=None, coordinator: str | None = None,
                   host: str = "127.0.0.1",
                   timeout_s: float = 60.0,
                   platform: str = "auto") -> RuntimeInfo:
    """Coordinated device-plane restart on the agreed membership — the
    device half of a heal (or grow/promotion): every member calls this
    with the SAME ``members`` (original ranks, current-rank order) and
    ``epoch`` the host plane just agreed on.

    The sequence, under ONE overall deadline (``timeout_s``):

    1. bounded :func:`shutdown_runtime` of the dead generation, its
       communicators aborted first (never a hang on the dead peer);
    2. nothing to clear: torch takes a new ``init_process_group`` in the
       same process once the old group is gone;
    3. re-election of the store's host (:func:`elect_coordinator`) unless
       the caller already knows the address;
    4. a new ``TCPStore``, hosted by ``min(members)`` whatever the
       members' order, and ``init_process_group`` on it with
       ``rank = members.index(my_orig)`` — failures retry under the shared
       backoff inside the deadline;
    5. topology re-probe checked against the agreed membership
       (:func:`~rocnrdma_tpu_torch.runtime.mesh.reprobe_topology`).

    A failure at any step records a ``deviceheal-abort`` flight event and
    raises a named ``RuntimeError`` carrying the coordinator address and
    membership — never a hang (the host plane stays healthy; the caller
    decides whether to retry, degrade, or exit)."""
    from rocnrdma_tpu_torch.transport.backoff import poll_backoff

    t0 = time.monotonic()
    deadline = t0 + timeout_s
    remaining = lambda: max(0.1, deadline - time.monotonic())  # noqa: E731
    if my_orig not in members:
        raise ValueError(f"reinit_runtime: rank {my_orig} is not in the "
                         f"agreed membership {members}")
    _FLIGHT.record("deviceheal-start", epoch=epoch, rank=my_orig,
                   members=",".join(str(m) for m in members))

    # each restart phase leaves a member-device-* span (perf_counter dur)
    # on the flight timeline, OUTSIDE the deviceheal- digest prefix: phase
    # durations are wall time, and the DEVICEHEAL replay log must stay a
    # pure function of the seed
    def _phase(name: str, t_from: float) -> float:
        now = time.perf_counter()
        _FLIGHT.record(f"member-device-{name}", epoch=epoch,
                       dur=now - t_from)
        return now
    try:
        device = resolve_device(platform)
        backend = backend_for(device)
        tp = time.perf_counter()
        shutdown_runtime(timeout_s=min(5.0, timeout_s / 4.0), abort=True)
        tp = _phase("shutdown", tp)
        if coordinator is None:
            if agree is None:
                raise ValueError(
                    "reinit_runtime needs either an explicit coordinator "
                    "or an agree primitive to elect one")
            coordinator = elect_coordinator(agree, members, my_orig, epoch,
                                            timeout_s=remaining(),
                                            host=host)
        tp = _phase("election", tp)
        rank = members.index(my_orig)
        _set_cuda_device(device, rank)
        back = poll_backoff()
        while True:
            try:
                _join(coordinator, len(members), rank,
                      my_orig == min(members), backend, remaining())
                break
            except Exception as e:
                # a transient race (the elected host's store still
                # binding) retries under the shared backoff; what never
                # succeeds surfaces named below. The half-made group is
                # torn down first. Recorded OUTSIDE the deviceheal- digest
                # prefix: retry counts are wall-clock-determined.
                _FLIGHT.record("device-reinit-retry", epoch=epoch,
                               error=type(e).__name__)
                shutdown_runtime(timeout_s=1.0, abort=True)
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"device re-init against {coordinator!r} still "
                        f"failing at the deadline: {e}") from e
                back.pause()
        tp = _phase("reinit", tp)
        topo = reprobe_topology(expected_processes=len(members),
                                platform=platform)
        _phase("reprobe", tp)
    except BaseException as e:
        _FLIGHT.record("deviceheal-abort", epoch=epoch, rank=my_orig,
                       error=type(e).__name__)
        if not isinstance(e, Exception):
            raise  # KeyboardInterrupt/SystemExit are not re-init failures
        raise RuntimeError(
            f"device-plane re-init failed on epoch {epoch} "
            f"(coordinator={coordinator!r}, members={members}, "
            f"rank {my_orig}): {e}") from e
    _FLIGHT.record("deviceheal-done", epoch=epoch, rank=my_orig,
                   procs=topo.n_processes, devices=topo.n_devices)
    log.info("device heal: epoch=%d members=%s coordinator=%s "
             "procs=%d devices=%d", epoch, members, coordinator,
             topo.n_processes, topo.n_devices)
    return RuntimeInfo(topology=topo, distributed=True, backend=backend,
                       world_size=len(members), rank=rank, epoch=epoch,
                       reinit_s=time.monotonic() - t0)


def device_fence(members: list, my_orig: int, epoch: int,
                 timeout_s: float = 30.0) -> dict:
    """Cross-process handshake THROUGH the live generation's store: every
    member publishes a deterministic token under its original rank and
    blocks (bounded) for every peer's — the proof that the re-elected
    store actually serves the whole agreed membership. Returns
    ``{orig: token}``; a member the store never saw surfaces as a named
    TimeoutError."""
    store = _STORE["store"]
    if store is None:
        raise RuntimeError("device_fence: no distributed runtime "
                           "(initialize/reinit first)")
    ns = f"rocnrdma/deviceheal/e{epoch}"
    token = f"m{my_orig}e{epoch}"
    store.set(f"{ns}/{my_orig}", token)
    out = {}
    deadline = time.monotonic() + timeout_s
    for m in members:
        try:
            store.wait([f"{ns}/{m}"], datetime.timedelta(
                seconds=max(0.1, deadline - time.monotonic())))
            out[m] = store.get(f"{ns}/{m}").decode()
        except Exception as e:
            raise TimeoutError(
                f"device_fence: member (original rank {m}) never "
                f"published through the epoch-{epoch} store: {e}") from e
        if out[m] != f"m{m}e{epoch}":
            raise RuntimeError(
                f"device_fence: member {m} published {out[m]!r} on "
                f"epoch {epoch} (wrong generation answered)")
    return out
