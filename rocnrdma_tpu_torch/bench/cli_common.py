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
process), and ``--fake-devices`` is refused. The card's
micro-benchmarks (``bench_kernel_variants``, ``bench_pipe_sweep``,
``bench_ring_tiles``) run in one process only: ``setup_backend`` without
``across`` refuses a launcher's fleet, naming it. A tool that folds on its own
card (``bench_local``, ``fold_ladder``, ``mfu_profile``, a calibration)
agrees its checks and gathers its rows on ``fleet_span``: one row a rank
(``gather_rows``), a calibration the fleet's median (``fleet_median``),
written once (``save_calibration``). ``main`` runs a CLI and tears the
group down at its exit, the kernels' IPC workspace first.
"""

from __future__ import annotations

import os
import statistics
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


def setup_backend(fake_devices: int | None, platform: str,
                  default_ranks: int | None = None,
                  across: bool = False) -> Topology:
    """The topology a CLI runs on. ``across``: the CLI runs across
    processes, one rank each, where a launcher's environment asks (it
    joins the group here). Without it the CLI runs in one process only
    and a launcher's fleet of more than one is refused, the coordinator
    and the world size named: N copies of a one-process program would
    each time their kernels on the same card and write the same
    ``--out``."""
    if not across:
        from rocnrdma_tpu_torch.runtime.init import launcher_env
        env = launcher_env()
        if env is not None and env[1] != 1:
            raise SystemExit(
                f"{os.path.basename(sys.argv[0])}: a launcher's environment "
                f"asks for a fleet (coordinator={env[0]!r}, world size "
                f"{env[1]}); this CLI runs in one process only - launch it "
                f"as one process")
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


def link_of(platform: str, span) -> str:
    """The link between a mesh's ranks on ``platform`` (``detect_topology``'s
    "gpu" or "cpu") whose leading axis crosses the processes of ``span``
    (a ``ProcessSpan``, or None): ``cpu-loopback`` on the CPU,
    ``hbm-loopback`` with the ranks on one GPU in one process, and across
    processes ``nvlink`` (NCCL, a GPU a process) or ``host-loopback``
    (processes sharing a GPU, gloo staged). A record's ``link`` and, across
    processes, a tuning table's key (``tuner.table_platform``)."""
    if platform != "gpu":
        return "cpu-loopback"
    if span is None:
        return "hbm-loopback"
    return "host-loopback" if span.staged else "nvlink"


def link_extra(topo, span, n_ranks: int) -> dict:
    """A record's ``link`` (``link_of``) where it has more than one rank;
    across processes also ``processes``, their count."""
    extra = {}
    if n_ranks > 1:
        extra["link"] = link_of(topo.platform, span)
    if span is not None:
        extra["processes"] = span.size
    return extra


def fleet_span(topo: Topology):
    """The ``ProcessSpan`` of the world's 1-D mesh (one rank a process)
    where this process is in a group, else None: what a tool with no mesh
    of its own agrees its checks and gathers its rows on. Every process
    of the world calls it together (the first mesh over the group makes
    its cross leg)."""
    if not joined():
        return None
    return rank_mesh(topo.n_processes, topo.device,
                     group=torch.distributed.group.WORLD).span


def gather_rows(rows, span) -> list:
    """``rows`` of every rank of ``span``, in its order, on every rank (one
    ``all_gather_object`` on its cross group); ``[rows]`` without one."""
    if span is None:
        return [rows]
    out = [None] * span.size
    torch.distributed.all_gather_object(out, rows, group=span.cross_group)
    return out


def fleet_median(values: list, span) -> list:
    """Each of ``values`` (the same count on every rank, one measurement
    of this rank's card each) as its median over the ranks of ``span``;
    ``values`` themselves without one."""
    per_rank = gather_rows([float(v) for v in values], span)
    return [statistics.median(col) for col in zip(*per_rank)]


def save_calibration(device_kind: str, data: dict, span,
                     base_dir: str | None = None) -> str:
    """``hw.save_calibration`` on rank 0 of ``span`` alone (the file is
    last-writer-wins: N writers would keep one arbitrary card's numbers);
    after a barrier every rank drops its cached calibration, so the fleet
    prices with the same constants. Returns the file's path."""
    from rocnrdma_tpu_torch import hw
    from rocnrdma_tpu_torch.bench.timing import fleet_barrier

    if span is None or span.index == 0:
        path = hw.save_calibration(device_kind, data, base_dir=base_dir)
    else:
        path = hw.calibration_path(device_kind, base_dir)
    if span is not None:
        fleet_barrier(span)
        hw._CAL_CACHE.clear()
    return path


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
