"""Runtime: device resolution, topology probe and the rank mesh."""

from rocnrdma_tpu_torch.runtime.mesh import (  # noqa: F401
    INTRA_AXIS,
    PLATFORMS,
    RANK_AXIS,
    SLICE_AXIS,
    RankMesh,
    Topology,
    detect_topology,
    rank_mesh,
    resolve_device,
    slice_mesh,
)
