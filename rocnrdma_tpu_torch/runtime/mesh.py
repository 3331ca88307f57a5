"""Topology discovery and the rank mesh.

In this slice every rank of a mesh lives on ONE device: ``rank_mesh(n)``
on a GPU maps all n ranks to ``cuda:0`` (the counterpart of the
reference's ``--fake-devices N`` CPU oracle, which faked N devices on one
host), and on the CPU to ``cpu``. The collectives then act on one
rank-major tensor whose row r is rank r's buffer. A 2-D
``('slice', 'intra')`` mesh (``slice_mesh``) is ``(slices, per_slice,
...)`` rank-major: row ``(s, i)`` is the buffer of rank (slice s, intra i),
flat rank ``s * per_slice + i``.

Device rule: ``platform="auto"`` means the GPU; if there is none, the call
raises. Only ``platform="cpu"`` selects the CPU.
"""

from __future__ import annotations

import dataclasses

import torch

RANK_AXIS = "rank"
SLICE_AXIS = "slice"
INTRA_AXIS = "intra"

PLATFORMS = ("auto", "cpu")


def resolve_device(platform: str = "auto") -> torch.device:
    """``auto`` -> ``cuda:0`` (raises without a GPU); ``cpu`` -> ``cpu``."""
    if platform == "cpu":
        return torch.device("cpu")
    if platform != "auto":
        raise ValueError(f"unknown platform {platform!r}; know {PLATFORMS}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; the port runs on the GPU unless the "
            "caller asks for the CPU (--platform cpu / device='cpu')")
    return torch.device("cuda", torch.cuda.current_device())


@dataclasses.dataclass(frozen=True)
class Topology:
    """What the runtime learned about the machine."""

    platform: str        # "gpu" | "cpu"
    n_devices: int       # ranks the backend can host (fake devices count)
    device_name: str
    device: torch.device
    n_processes: int = 1     # the process group's world size (1 without one)
    process_index: int = 0   # this process's rank in it (0 without one)

    @property
    def is_oracle(self) -> bool:
        """True on the CPU correctness-oracle backend."""
        return self.platform == "cpu"


def detect_topology(platform: str = "auto",
                    fake_devices: int | None = None) -> Topology:
    """Probe the backend. ``fake_devices``: host that many ranks on the one
    physical device (``--fake-devices N``)."""
    device = resolve_device(platform)
    if device.type == "cuda":
        name = torch.cuda.get_device_name(device)
        real = torch.cuda.device_count()
        plat = "gpu"
    else:
        name, real, plat = "cpu", 1, "cpu"
    dist = torch.distributed
    up = dist.is_available() and dist.is_initialized()
    return Topology(platform=plat, n_devices=fake_devices or real,
                    device_name=name, device=device,
                    n_processes=dist.get_world_size() if up else 1,
                    process_index=dist.get_rank() if up else 0)


def reprobe_topology(expected_processes: int | None = None,
                     expected_devices: int | None = None,
                     platform: str = "auto") -> Topology:
    """Re-probe the topology after a device-plane restart
    (``runtime.init.reinit_runtime``) and check it against the membership
    the host plane agreed on: a process group that came up on the wrong
    world would desync every consumer of the mesh, so it raises here,
    named, before any of them is rebuilt."""
    topo = detect_topology(platform)
    if (expected_processes is not None
            and topo.n_processes != expected_processes):
        raise RuntimeError(
            f"device plane re-probed {topo.n_processes} process(es) but "
            f"the healed membership has {expected_processes} — the "
            f"coordination service and the host plane disagree on the "
            f"world")
    if expected_devices is not None and topo.n_devices != expected_devices:
        raise RuntimeError(
            f"device plane re-probed {topo.n_devices} device(s), "
            f"expected {expected_devices} on the healed membership")
    return topo


@dataclasses.dataclass(frozen=True)
class RankMesh:
    """Ranks on a 1-D ring (``axis_names == ("rank",)``) or a 2-D
    ``("slice", "intra")`` grid, each with its torch device; ``shape`` is
    the mesh shape, the leading dims of a rank-major tensor on it."""

    devices: tuple
    axis_names: tuple = (RANK_AXIS,)
    shape: tuple = ()

    def __post_init__(self):
        if not self.shape:
            object.__setattr__(self, "shape", (len(self.devices),))

    @property
    def n_ranks(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        """The one device every rank lives on (this slice's layout)."""
        if len(set(self.devices)) != 1:
            raise ValueError(
                f"ranks span several devices {sorted(set(map(str, self.devices)))}; "
                f"this slice runs every rank on one device")
        return self.devices[0]


def rank_mesh(n: int, device: torch.device | str | None = None) -> RankMesh:
    """``n`` ranks on ``device`` (default: the GPU; raises without one).
    Over this process's device it is also the counterpart of the
    reference's ``local_mesh``: the mesh a process rebuilds and runs on
    its own after a device-plane heal."""
    if n < 1:
        raise ValueError(f"need n >= 1 ranks, got {n}")
    return RankMesh(devices=(_mesh_device(device),) * n)


def slice_mesh(n_slices: int, per_slice: int,
               device: torch.device | str | None = None) -> RankMesh:
    """A 2-D ``('slice', 'intra')`` mesh of ``n_slices`` slices of
    ``per_slice`` ranks, every rank on ``device`` (default: the GPU; raises
    without one): the hierarchical schedules' layout, simulated on one
    device as the reference simulates it on fake CPU devices."""
    if n_slices < 1 or per_slice < 1:
        raise ValueError(f"need a mesh of >= 1 x >= 1 ranks, got "
                         f"{n_slices} x {per_slice}")
    return RankMesh(devices=(_mesh_device(device),) * (n_slices * per_slice),
                    axis_names=(SLICE_AXIS, INTRA_AXIS),
                    shape=(n_slices, per_slice))


def _mesh_device(device) -> torch.device:
    dev = resolve_device() if device is None else torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
