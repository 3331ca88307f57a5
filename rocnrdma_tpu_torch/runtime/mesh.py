"""Topology discovery and the rank mesh.

A mesh's ranks are the rows of one rank-major tensor in each process, on
that process's one device. Its layouts:

- ``rank_mesh(n)``: a 1-D ring of n ranks, all in this process, on
  ``cuda:0`` on a GPU (the counterpart of the reference's ``--fake-devices
  N`` CPU oracle, which faked N devices on one host) or on ``cpu``; row r
  is rank r's buffer.
- ``slice_mesh(m, n)``: a 2-D ``('slice', 'intra')`` mesh, ``(slices,
  per_slice, ...)`` rank-major: row ``(s, i)`` is the buffer of rank
  (slice s, intra i), flat rank ``s * per_slice + i``.
- Either across processes (``group=g``): the leading axis (the rank axis
  of a 1-D mesh, the slice axis of a 2-D one) is the process boundary.
  Process g of the group holds rank g, or slice g's ``per_slice`` ranks,
  as rows on its own device, so a tensor on that mesh is this process's
  rows, ``(1, ...)`` or ``(1, per_slice, ...)``, and so is a result. The
  mesh's ``span`` says which index is local and how that axis's
  exchanges cross processes.

Device rule: ``platform="auto"`` means the GPU; if there is none, the call
raises. Only ``platform="cpu"`` selects the CPU.
"""

from __future__ import annotations

import dataclasses
import math

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
    n_devices: int       # ranks the backend can host: fake devices count;
    #                      under a process group, the world's ranks (one a process)
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
    physical device (``--fake-devices N``). Under a process group the
    backend hosts the world's ranks, one a process, whatever this
    process's ``torch.cuda.device_count()``."""
    device = resolve_device(platform)
    if device.type == "cuda":
        name = torch.cuda.get_device_name(device)
        real = torch.cuda.device_count()
        plat = "gpu"
    else:
        name, real, plat = "cpu", 1, "cpu"
    dist = torch.distributed
    up = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if up else 1
    return Topology(platform=plat,
                    n_devices=fake_devices or (world if up else real),
                    device_name=name, device=device,
                    n_processes=world,
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


def _span_stats() -> dict:
    return {"exchanges": 0, "bytes": 0, "wire_s": 0.0, "d2h_bytes": 0,
            "d2h_s": 0.0, "h2d_bytes": 0, "h2d_s": 0.0}


@dataclasses.dataclass(eq=False)
class ProcessSpan:
    """How a mesh's leading axis crosses processes (the rank axis of a 1-D
    mesh, the slice axis of a 2-D one): this process is index ``index`` of
    ``size`` on it, one rank or slice per process of the mesh's group.

    That axis's exchanges run on ``cross_group``, whose backend is
    ``backend``: the mesh's own group when it can carry this process's
    tensors, else a gloo group made beside it (once per group). ``staged``: the tensors
    are on a GPU and the cross group is gloo (the group's processes share
    a GPU, and NCCL refuses two ranks on one), so each exchange copies to
    pinned host buffers, exchanges them and copies back. ``peers[t]`` is
    index t's global rank. ``per_card``: the group's processes on this
    process's card (1 on the CPU or with a GPU a process). ``stats``: exchanges, the bytes sent and the
    host seconds they took (``wire_s``; on an unstaged NCCL leg, the
    seconds to enqueue them), and the bytes and host seconds staged each
    way, each copy timed after the device's queued work. ``workspace``:
    the CUDA IPC workspace of the kernels across processes (one rank a
    process, ``ops/ipc.py``), made at their first launch on the span and
    freed by ``close``."""

    cross_group: object
    backend: str
    staged: bool
    index: int
    size: int
    peers: tuple
    per_card: int = 1
    stats: dict = dataclasses.field(default_factory=_span_stats)
    _ipc: object = dataclasses.field(default=None, init=False, repr=False)

    def workspace(self, device: torch.device):
        """This span's IPC workspace on ``device`` (made once; collective at
        its first use, as every process of the span launches together)."""
        if self._ipc is None:
            from rocnrdma_tpu_torch.ops import ipc
            self._ipc = ipc.Workspace(self, device)
        elif self._ipc.device != device:
            raise ValueError(f"the span's IPC workspace is on {self._ipc.device}, "
                             f"not {device}")
        return self._ipc

    def close(self) -> None:
        """Unmap the peers' IPC workspaces and free this process's."""
        if self._ipc is not None:
            self._ipc.close()
            self._ipc = None

    def count(self, what: str, nbytes: int, seconds: float) -> None:
        """Add an exchange (``what="exchange"``: bytes sent, host seconds
        until it completed) or a staging copy (``"d2h"`` / ``"h2d"``)."""
        if what == "exchange":
            self.stats["exchanges"] += 1
            self.stats["bytes"] += nbytes
            self.stats["wire_s"] += seconds
        else:
            self.stats[f"{what}_bytes"] += nbytes
            self.stats[f"{what}_s"] += seconds


@dataclasses.dataclass(frozen=True)
class RankMesh:
    """Ranks on a 1-D ring (``axis_names == ("rank",)``) or a 2-D
    ``("slice", "intra")`` grid, each with its torch device; ``shape`` is
    the mesh shape, the leading dims of a rank-major tensor on it. With a
    ``span`` the leading axis spans processes: ``devices`` are this
    process's ranks only, and ``local_shape`` leads a tensor on it."""

    devices: tuple
    axis_names: tuple = (RANK_AXIS,)
    shape: tuple = ()
    span: ProcessSpan | None = None

    def __post_init__(self):
        if not self.shape:
            object.__setattr__(self, "shape", (len(self.devices),))

    @property
    def n_ranks(self) -> int:
        return math.prod(self.shape)

    @property
    def local_shape(self) -> tuple:
        """The leading dims of a tensor on the mesh in this process: the
        mesh shape, or where the mesh spans processes ``(1,)`` (1-D) or
        ``(1, per_slice)`` (2-D)."""
        return self.shape if self.span is None else (1,) + tuple(self.shape[1:])

    @property
    def device(self) -> torch.device:
        """The one device this process's ranks live on."""
        if len(set(self.devices)) != 1:
            raise ValueError(
                f"ranks span several devices {sorted(set(map(str, self.devices)))}; "
                f"a process holds its ranks of a mesh on one device (ranks on "
                f"other devices belong to other processes: rank_mesh or "
                f"slice_mesh with group=)")
        return self.devices[0]


def rank_mesh(n: int, device: torch.device | str | None = None, *,
              group=None) -> RankMesh:
    """``n`` ranks on ``device`` (default: the GPU; raises without one).
    Over this process's device it is also the counterpart of the
    reference's ``local_mesh``: the mesh a process rebuilds and runs on
    its own after a device-plane heal.

    With a process group (``torch.distributed.group.WORLD`` or a subgroup)
    the rank axis is the process boundary, as the reference's mesh over
    every process's devices: process g of the group is rank g and holds
    its row on ``device``; the group must have ``n`` processes. The cross
    leg is picked as for ``slice_mesh``, so every process of the world
    makes the first such mesh over a group together."""
    if n < 1:
        raise ValueError(f"need n >= 1 ranks, got {n}")
    dev = _mesh_device(device)
    if group is None:
        return RankMesh(devices=(dev,) * n)
    return RankMesh(devices=(dev,), shape=(n,),
                    span=_process_span(n, group, dev, RANK_AXIS))


def slice_mesh(n_slices: int, per_slice: int,
               device: torch.device | str | None = None, *,
               group=None) -> RankMesh:
    """A 2-D ``('slice', 'intra')`` mesh of ``n_slices`` slices of
    ``per_slice`` ranks on ``device`` (default: the GPU; raises without
    one): the hierarchical schedules' layout.

    Without ``group`` every rank is on this process's device, simulated
    there as the reference simulates it on fake CPU devices. With a
    process group (``torch.distributed.group.WORLD`` or a subgroup) the
    slice axis is the process boundary: process g of the group is slice g
    and holds its ``per_slice`` ranks on ``device``; the group must have
    ``n_slices`` processes. The first such mesh over a group whose
    processes share a GPU makes the gloo group its cross leg runs on, so
    every process of the world calls that one together."""
    if n_slices < 1 or per_slice < 1:
        raise ValueError(f"need a mesh of >= 1 x >= 1 ranks, got "
                         f"{n_slices} x {per_slice}")
    dev = _mesh_device(device)
    if group is None:
        return RankMesh(devices=(dev,) * (n_slices * per_slice),
                        axis_names=(SLICE_AXIS, INTRA_AXIS),
                        shape=(n_slices, per_slice))
    return RankMesh(devices=(dev,) * per_slice,
                    axis_names=(SLICE_AXIS, INTRA_AXIS),
                    shape=(n_slices, per_slice),
                    span=_process_span(n_slices, group, dev, SLICE_AXIS))


# the gloo group made beside each non-gloo group a mesh spans, made by the
# first such mesh and shared by the ones after it
_GLOO_BESIDE: dict = {}


def _process_span(n: int, group, device: torch.device, axis: str) -> ProcessSpan:
    """The leading axis ``axis`` (``rank`` or ``slice``) of a mesh over
    ``group``'s processes, one index of its ``n`` a process. The cross
    leg's backend is decided here, once, from what this process can see:
    NCCL where the group is NCCL and every process has a GPU of its own,
    else gloo (the group itself when it is gloo, else a gloo group made
    beside it on the same store), staged through the host when the
    tensors are on a GPU."""
    dist = torch.distributed
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("a mesh that spans processes needs a process "
                           "group: join one first (runtime.init_runtime)")
    size = dist.get_world_size(group)
    if size != n:
        raise ValueError(
            f"the {axis} axis spans the group's processes, one {axis} each: "
            f"the group has {size} process(es), the mesh asks for "
            f"{n} {axis}s")
    backend = dist.get_backend(group)
    ranks = tuple(dist.get_process_group_ranks(group))
    if device.type == "cuda" and backend == "nccl" \
            and torch.cuda.device_count() >= size:
        cross, cross_backend = group, "nccl"
    elif backend == "gloo":
        cross, cross_backend = group, "gloo"
    else:
        # the processes share a GPU (NCCL refuses two ranks on one), or
        # the tensors are on the CPU: the host carries the cross leg
        if group not in _GLOO_BESIDE:
            _GLOO_BESIDE[group] = dist.new_group(list(ranks), backend="gloo")
        cross, cross_backend = _GLOO_BESIDE[group], "gloo"
    return ProcessSpan(cross_group=cross, backend=cross_backend,
                       staged=device.type == "cuda" and cross_backend == "gloo",
                       index=dist.get_rank(group), size=size, peers=ranks,
                       per_card=(-(-size // torch.cuda.device_count())
                                 if device.type == "cuda" else 1))


def _mesh_device(device) -> torch.device:
    dev = resolve_device() if device is None else torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
