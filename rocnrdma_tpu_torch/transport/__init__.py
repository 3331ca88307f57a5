"""Transport: the collective verbs over a rank mesh, and the host plane.

Two surfaces, as in ``rocnrdma_tpu/transport/__init__.py``:

- the HOST plane (the net-plugin vtables over the native TCP/shm queue
  pairs, the bootstrap store, backoff, lanes, ``FaultNet``, the ring
  collectives over numpy) imports eagerly and torch-free, so the
  ``bench_host`` workers and the store sidecars start without paying the
  torch import;
- the DEVICE plane (``Transport``, ``ALGOS``, ``SCHEDULES``, ``supports``,
  ``Group``) imports torch, so it loads on first attribute access
  (PEP 562).
"""

from rocnrdma_tpu_torch.transport.backoff import (  # noqa: F401
    Backoff,
    poll_backoff,
    retry_with_backoff,
)
from rocnrdma_tpu_torch.transport.bootstrap import (  # noqa: F401
    BootstrapClient,
    BootstrapServer,
    NodeProxyStore,
    bootstrap_ring,
)
from rocnrdma_tpu_torch.transport.faults import FaultNet, FaultSchedule  # noqa: F401
from rocnrdma_tpu_torch.transport.lanes import (  # noqa: F401
    Lane,
    LaneRegistry,
    lane_context,
    lane_id,
)
from rocnrdma_tpu_torch.transport.plugin import (  # noqa: F401
    DeviceMeshNet,
    HostQPNet,
    NetProperties,
    Request,
    TCPNet,
    ring_allgather_over_net,
    ring_allreduce_over_net,
    ring_allgather_rdma,
    ring_allreduce_rdma,
    ring_reduce_scatter_rdma,
    ring_alltoallv_over_net,
    ring_allgatherv_over_net,
    ring_reduce_scatter_v_over_net,
    ring_gather_over_net,
    ring_reduce_over_net,
    ring_reduce_scatter_over_net,
    ring_scatter_over_net,
    ring_alltoall_over_net,
    ring_broadcast_over_net,
)

# torch-heavy exports, resolved on first access so that importing the
# host plane never pays the torch import
_LAZY = {
    "Transport": "rocnrdma_tpu_torch.transport.api",
    "ALGOS": "rocnrdma_tpu_torch.transport.api",
    "SCHEDULES": "rocnrdma_tpu_torch.transport.api",
    "supports": "rocnrdma_tpu_torch.transport.api",
    "Group": "rocnrdma_tpu_torch.transport.group",
    "GroupError": "rocnrdma_tpu_torch.transport.group",
    "GroupHandle": "rocnrdma_tpu_torch.transport.group",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib
        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
