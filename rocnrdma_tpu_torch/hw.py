"""Chip constants for the port's rooflines.

One row, from NVIDIA's H100 SXM data sheet (dense rates, 700 W part). These
are DATASHEET figures, not measurements: a card set below 700 W runs
slower, so every measured number is kept beside the card's name and power
limit as ``nvidia-smi`` reports them.

Match rule: first key that is a substring of the lowercased device name
wins (``torch.cuda.get_device_name()`` gives e.g. "NVIDIA H100 80GB HBM3").
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Chip:
    hbm_GBps: float      # peak device-memory bandwidth
    link_GBps: float     # aggregate NVLink bandwidth to the other cards
    bf16_tflops: float   # peak dense bf16 tensor-core throughput
    fp32_tflops: float   # peak fp32 outside the tensor cores
    source: str


CHIPS: dict[str, Chip] = {
    "h100": Chip(hbm_GBps=3350.0, link_GBps=900.0, bf16_tflops=989.0,
                 fp32_tflops=67.0,
                 source="NVIDIA H100 SXM datasheet (not measured)"),
}


def chip_for(device_name: str) -> Chip | None:
    name = (device_name or "").lower()
    for key, chip in CHIPS.items():
        if key in name:
            return chip
    return None


def _chip(device_name: str) -> Chip:
    chip = chip_for(device_name)
    if chip is None:
        raise ValueError(f"no datasheet row for device {device_name!r}")
    return chip


def bytes_bound_ms(nbytes: float, device_name: str) -> float:
    """Least time to move ``nbytes`` through device memory at peak rate."""
    return nbytes / (_chip(device_name).hbm_GBps * 1e9) * 1e3


def fp32_ops_bound_ms(ops: float, device_name: str) -> float:
    """Least time for ``ops`` fp32 operations outside the tensor cores."""
    return ops / (_chip(device_name).fp32_tflops * 1e12) * 1e3
