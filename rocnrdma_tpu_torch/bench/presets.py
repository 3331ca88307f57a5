"""Named measurement presets: the allreduce configs of BASELINE.json that
this slice's arms can run (``loopback2``, ``ring8``). The ``tree64`` and
``multislice`` presets name schedules and 2-D meshes not yet ported.

A preset fixes the rank count and sweep; CLI flags override fields. A
preset scales down to what the backend hosts unless ``--strict-preset``.
"""

from __future__ import annotations

import dataclasses

from rocnrdma_tpu_torch.metrics import KiB, MiB


@dataclasses.dataclass(frozen=True)
class Preset:
    name: str
    baseline_config: str        # the BASELINE.json line this preset realises
    n_ranks: int
    sizes: tuple                # bytes per rank
    dtypes: tuple
    algos: tuple
    check: bool = True          # verify vs numpy before timing

    def scaled_to(self, n_devices: int, max_bytes: int) -> "Preset":
        """Shrink to what the current backend can host."""
        sizes = tuple(b for b in self.sizes if b <= max_bytes) \
            or (min(min(self.sizes), max_bytes),)
        return dataclasses.replace(self, n_ranks=min(self.n_ranks, n_devices),
                                   sizes=sizes)


def _sweep(lo: int, hi: int) -> tuple:
    out, b = [], lo
    while b <= hi:
        out.append(b)
        b *= 4
    return tuple(out)


PRESETS = {
    # BASELINE.json:7 - the loopback correctness anchor
    "loopback2": Preset(
        name="loopback2",
        baseline_config="2-rank loopback allreduce, 4 KiB fp32 (CPU/gloo reference path)",
        n_ranks=2, sizes=(4 * KiB,), dtypes=("float32",),
        algos=("ring", "fused")),
    # BASELINE.json:8
    "ring8": Preset(
        name="ring8",
        baseline_config="8-rank single-host ring allreduce, 256 MiB fp32/bf16 sweep",
        n_ranks=8, sizes=_sweep(4 * KiB, 256 * MiB),
        dtypes=("float32", "bfloat16"), algos=("ring", "ring_bidir", "fused")),
}


def get_preset(name: str) -> Preset:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; know {sorted(PRESETS)}")
    return PRESETS[name]
