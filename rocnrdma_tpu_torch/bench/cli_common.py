"""Backend bootstrap shared by the bench CLIs: one place owns the
``--fake-devices`` / ``--platform`` rules.

``--fake-devices N`` hosts N ranks on ONE physical device: the GPU under
the default ``--platform auto`` (which raises without one), the CPU under
``--platform cpu``. ``--platform cpu`` alone hosts ``max(default_ranks, 2)``
ranks on the CPU, as the reference's CPU oracle does. ``--mesh2d SxI``
names a 2-D ``('slice', 'intra')`` mesh of S slices of I ranks.
"""

from __future__ import annotations

from rocnrdma_tpu_torch.runtime import (RankMesh, Topology, detect_topology,
                                        rank_mesh, slice_mesh)


def setup_backend(fake_devices: int | None, platform: str,
                  default_ranks: int | None = None) -> Topology:
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


def build_mesh(mesh2d: str | None, ranks: int | None, topo: Topology) -> RankMesh:
    """The mesh a workload CLI runs over, on ``topo``'s device: 2-D when
    asked, else a 1-D ring of ``ranks`` (default: every rank the backend
    hosts), capped at those."""
    if mesh2d:
        return slice_mesh(*parse_mesh2d(mesh2d), topo.device)
    return rank_mesh(min(ranks or topo.n_devices, topo.n_devices), topo.device)
