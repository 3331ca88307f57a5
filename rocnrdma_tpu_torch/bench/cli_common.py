"""Backend bootstrap shared by the bench CLIs: one place owns the
``--fake-devices`` / ``--platform`` rules.

``--fake-devices N`` hosts N ranks on ONE physical device: the GPU under
the default ``--platform auto`` (which raises without one), the CPU under
``--platform cpu``. ``--platform cpu`` alone hosts ``max(default_ranks, 2)``
ranks on the CPU, as the reference's CPU oracle does.
"""

from __future__ import annotations

from rocnrdma_tpu_torch.runtime import Topology, detect_topology


def setup_backend(fake_devices: int | None, platform: str,
                  default_ranks: int | None = None) -> Topology:
    if not fake_devices and platform == "cpu":
        fake_devices = max(default_ranks or 8, 2)
    return detect_topology(platform, fake_devices)
