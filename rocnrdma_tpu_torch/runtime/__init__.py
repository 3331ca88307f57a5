"""Runtime: device resolution, topology probe, the rank mesh and the
process group's bootstrap and heal.

The exports load lazily, so a process that imports only the torch-free
parts of the runtime (``multiprocess``, the host-plane tasks of
``mp_worker``) never imports torch.
"""

import importlib

_LAZY = {
    **{name: "rocnrdma_tpu_torch.runtime.mesh" for name in (
        "INTRA_AXIS", "PLATFORMS", "RANK_AXIS", "SLICE_AXIS", "RankMesh",
        "Topology", "detect_topology", "rank_mesh", "reprobe_topology",
        "resolve_device", "slice_mesh", "ProcessSpan")},
    **{name: "rocnrdma_tpu_torch.runtime.init" for name in (
        "RuntimeInfo", "device_fence", "elect_coordinator", "init_runtime",
        "reinit_runtime", "shutdown_runtime")},
}


def __getattr__(name):
    module = _LAZY.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(module), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
