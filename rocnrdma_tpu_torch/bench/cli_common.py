"""Backend bootstrap shared by the bench CLIs: one place owns the
``--fake-devices`` / ``--platform`` rules and the process group.

``--fake-devices N`` hosts N ranks on ONE physical device: the GPU under
the default ``--platform auto`` (which raises without one), the CPU under
``--platform cpu``. ``--platform cpu`` alone hosts ``max(default_ranks, 2)``
ranks on the CPU, as the reference's CPU oracle does. ``--mesh2d SxI``
names a 2-D ``('slice', 'intra')`` mesh of S slices of I ranks.

Across processes: where a launcher's environment names a coordinator
(the reference's ``COORDINATOR_ADDRESS`` with ``WORLD_SIZE`` and
``RANK``, or torchrun's ``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/
``RANK``), ``setup_backend(across=True)`` (the sweep runner, the headline
and the workload CLIs, the CLIs ported across processes) joins the
process group first, through ``runtime.init_runtime``, as the
reference's joins the coordination service; an environment that cannot
be joined raises with the coordinator named, and nothing carries on in
one process. Each process is then one rank of the fleet: the 1-D mesh is
``rank_mesh(world, group=WORLD)``, a ``--mesh2d SxI`` is ``slice_mesh(S,
I, group=WORLD)`` where S is the world size (a slice of I ranks a
process), and ``--fake-devices`` is refused. Every other CLI (the tools:
``trace``, ``first_contact``, the tuner, ``bench_local``,
``fold_ladder``, ``mfu_profile``) runs in one process and refuses a
launcher's fleet by name (``refuse_fleet``) rather than run N copies of
itself. ``main`` runs a CLI and tears the group down at its exit, the
kernels' IPC workspace first.
"""

from __future__ import annotations

import os
import sys
import traceback

import torch

from rocnrdma_tpu_torch.runtime import (RankMesh, Topology, detect_topology,
                                        rank_mesh, slice_mesh)


# did this process join a process group (it then leaves as ``main`` says)
_JOINED = {"ever": False}


def joined() -> bool:
    """Is this process in a process group (one rank of a fleet)?"""
    dist = torch.distributed
    return dist.is_available() and dist.is_initialized()


def join(platform: str) -> bool:
    """Join the process group where a launcher's environment asks for one
    (``init_runtime``, which raises naming the coordinator when it cannot);
    True when this process is in one."""
    if not joined():
        from rocnrdma_tpu_torch.runtime.init import init_runtime
        init_runtime(timeout_s=60, platform=platform)
    _JOINED["ever"] |= joined()
    return joined()


def refuse_fleet() -> None:
    """Refuse a launcher's fleet of more than one process for a CLI that
    runs in one process only (the tools are not ported across processes
    yet: ROADMAP Queue 1), naming the launcher's
    world size: N copies of a one-process program would each run the
    whole mesh and write the same ``--out``."""
    from rocnrdma_tpu_torch.runtime.init import launcher_env
    env = launcher_env()
    if env is not None and env[1] != 1:
        coordinator, world, _ = env
        raise SystemExit(
            f"{os.path.basename(sys.argv[0])}: a launcher's environment asks "
            f"for a fleet (coordinator={coordinator!r}, world size {world}); "
            f"this CLI runs in one process only (not yet across processes: "
            f"ROADMAP Queue 1) - launch it as one process")


def setup_backend(fake_devices: int | None, platform: str,
                  default_ranks: int | None = None,
                  across: bool = False) -> Topology:
    """The topology a CLI runs on. ``across``: the CLI runs across
    processes, one rank each, where a launcher's environment asks (it
    joins the group here); without it a launcher's fleet is refused."""
    if not across:
        refuse_fleet()
    elif join(platform):
        if fake_devices:
            raise SystemExit(
                f"--fake-devices {fake_devices} hosts ranks in one process; "
                f"under a process group of {torch.distributed.get_world_size()} "
                f"processes each process is one rank (drop --fake-devices)")
        return detect_topology(platform)
    if not fake_devices and platform == "cpu":
        fake_devices = max(default_ranks or 8, 2)
    return detect_topology(platform, fake_devices)


def parse_mesh2d(spec: str) -> tuple[int, int]:
    """'SLICESxPER' -> (slices, per_slice), e.g. '2x4' -> (2, 4)."""
    try:
        s, per = spec.lower().split("x")
        return int(s), int(per)
    except ValueError as e:
        raise SystemExit(f"--mesh2d wants SLICESxPER (e.g. 2x4), got {spec!r}") from e


def check_slices(slices: int, per: int, topo: Topology) -> None:
    """Under a process group the slice axis is the process boundary: a 2-D
    mesh of any other slice count is refused, both numbers named."""
    if joined() and slices != topo.n_processes:
        raise SystemExit(
            f"--mesh2d {slices}x{per}: under a process group the slice axis "
            f"is the process boundary, one slice a process, so S must be the "
            f"world size {topo.n_processes}, got S = {slices}")


def mesh_for(mesh2d: tuple | None, n_ranks: int, topo: Topology) -> RankMesh:
    """The mesh of ``n_ranks`` ranks (2-D where ``mesh2d`` is (S, I)) on
    ``topo``'s device; under a process group the one that spans its
    processes, refused where the ranks are not one a process (1-D) or one
    slice a process (2-D)."""
    if not joined():
        return (slice_mesh(*mesh2d, topo.device) if mesh2d
                else rank_mesh(n_ranks, topo.device))
    world = torch.distributed.group.WORLD
    if mesh2d:
        check_slices(*mesh2d, topo)
        return slice_mesh(*mesh2d, topo.device, group=world)
    if n_ranks != topo.n_processes:
        raise SystemExit(
            f"{n_ranks} ranks: under a process group the 1-D mesh is the "
            f"world's {topo.n_processes} processes, one rank a process")
    return rank_mesh(n_ranks, topo.device, group=world)


def build_mesh(mesh2d: str | None, ranks: int | None, topo: Topology) -> RankMesh:
    """The mesh a workload CLI runs over, on ``topo``'s device: 2-D when
    asked, else a 1-D ring of ``ranks`` (default: every rank the backend
    hosts), capped at those in one process. Under a process group the
    mesh spans its processes by ``mesh_for``'s rules: ``--ranks`` other
    than the world size and a ``--mesh2d SxI`` whose S is not are
    refused, both numbers named."""
    if joined():
        return mesh_for(parse_mesh2d(mesh2d) if mesh2d else None,
                        ranks or topo.n_processes, topo)
    if mesh2d:
        return slice_mesh(*parse_mesh2d(mesh2d), topo.device)
    return rank_mesh(min(ranks or topo.n_devices, topo.n_devices), topo.device)


def link_extra(topo, span, n_ranks: int) -> dict:
    """A record's ``link`` where it has more than one rank: ``cpu-loopback``
    on the CPU, ``hbm-loopback`` with the ranks on one GPU in one process,
    and across processes ``nvlink`` (NCCL, a GPU a process) or
    ``host-loopback`` (processes sharing a GPU, gloo staged); across
    processes also ``processes``, their count."""
    extra = {}
    if n_ranks > 1:
        if topo.platform != "gpu":
            extra["link"] = "cpu-loopback"
        elif span is None:
            extra["link"] = "hbm-loopback"
        else:
            extra["link"] = "host-loopback" if span.staged else "nvlink"
    if span is not None:
        extra["processes"] = span.size
    return extra


def is_lead() -> bool:
    """Does this process print the results (rank 0 of the group, or the
    only process)?"""
    return not joined() or torch.distributed.get_rank() == 0


def main(cli_main) -> int:
    """Run ``cli_main()`` as a process's program: where it joined a process
    group, tear the group down at the end (``shutdown_runtime``: the
    kernels' IPC workspace after its peers, then the group; aborted where
    the CLI raised, so no peer waits on this rank) and leave without the
    interpreter's finalization (``runtime.init.leave``)."""
    clean = False
    try:
        code = cli_main()
        clean = True
    except (Exception, SystemExit) as e:
        if not _JOINED["ever"]:
            raise
        if isinstance(e, SystemExit):
            code = e.code
        else:
            traceback.print_exc()
            code = 1
    if not _JOINED["ever"]:
        return code
    if not isinstance(code, int):  # as sys.exit treats its argument
        if code is not None:
            print(code, file=sys.stderr)
        code = 0 if code is None else 1
    from rocnrdma_tpu_torch.runtime.init import leave, shutdown_runtime
    shutdown_runtime(abort=not clean)
    leave(code)
