"""Named measurement presets: the four sweep configs of BASELINE.json
(``loopback2``, ``ring8``, ``tree64``, ``multislice``).

A preset fixes the topology and sweep; CLI flags override fields. A preset
scales down to what the backend hosts unless ``--strict-preset``: on one
card with ``--fake-devices 8``, ``tree64`` runs 8 ranks at 1 GiB (64 ranks
of 1 GiB do not fit in 80 GB) and ``multislice`` a ``2x4`` mesh. Across
processes it scales to the fleet's ranks, one a process: ``ring8`` runs 4
ranks on 4 GPUs, a tree preset the largest power of two, and a 2-D preset
one slice a process of at most ``PER_PROCESS`` ranks.
"""

from __future__ import annotations

import dataclasses

from rocnrdma_tpu_torch.metrics import GiB, KiB, MiB


# the ranks a process holds of a 2-D preset across processes: the slice
# the one-card scaling gives (multislice on 8 ranks of one GPU is 2x4)
PER_PROCESS = 4


@dataclasses.dataclass(frozen=True)
class Preset:
    name: str
    baseline_config: str        # the BASELINE.json line this preset realises
    n_ranks: int
    mesh2d: tuple | None        # (slices, per_slice) for hierarchical presets
    sizes: tuple                # bytes per rank
    dtypes: tuple
    algos: tuple
    check: bool = True          # verify vs numpy before timing

    def scaled_to(self, n_devices: int, max_bytes: int,
                  processes: int | None = None) -> "Preset":
        """Shrink to what the current backend can host: ``n_devices`` ranks,
        or across ``processes`` processes (a process group's; None: one
        process) the world's ranks, one a process, and a 2-D mesh of one
        slice a process."""
        n = min(self.n_ranks, n_devices)
        # keep power-of-two rank counts for tree presets
        if "tree" in self.algos:
            while n & (n - 1):
                n -= 1
        mesh2d = self.mesh2d
        if mesh2d is not None and processes:
            mesh2d = (processes, min(mesh2d[1], PER_PROCESS))
            n = processes * mesh2d[1]
        elif mesh2d is not None:
            s = min(mesh2d[0], max(2, n_devices // max(1, mesh2d[1])))
            per = n_devices // s
            if per < 1:
                # too small for even a 2-slice simulation: a flat ring
                # rather than a degenerate (s, 0) mesh
                mesh2d = None
                n = min(n, n_devices)
            else:
                mesh2d = (s, per)
                n = s * per
        sizes = tuple(b for b in self.sizes if b <= max_bytes) \
            or (min(min(self.sizes), max_bytes),)
        return dataclasses.replace(self, n_ranks=n, mesh2d=mesh2d, sizes=sizes)


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
        n_ranks=2, mesh2d=None, sizes=(4 * KiB,), dtypes=("float32",),
        algos=("ring", "fused")),
    # BASELINE.json:8
    "ring8": Preset(
        name="ring8",
        baseline_config="8-rank single-host ring allreduce, 256 MiB fp32/bf16 sweep",
        n_ranks=8, mesh2d=None, sizes=_sweep(4 * KiB, 256 * MiB),
        dtypes=("float32", "bfloat16"), algos=("ring", "ring_bidir", "fused")),
    # BASELINE.json:9
    "tree64": Preset(
        name="tree64",
        baseline_config="64-rank tree allreduce + allgather, 1 GiB (single ICI slice)",
        n_ranks=64, mesh2d=None, sizes=(1 * GiB,), dtypes=("float32",),
        algos=("tree", "khd", "dtree", "fused")),
    # BASELINE.json:11 - hierarchical across slices; simulated as 2 slices
    # of ranks on one device
    "multislice": Preset(
        name="multislice",
        baseline_config="Multi-slice 2xv5p-128 hierarchical allreduce + MoE alltoall over DCN",
        n_ranks=256, mesh2d=(2, 128), sizes=_sweep(1 * MiB, 256 * MiB),
        dtypes=("float32",), algos=("hierarchical", "fused")),
}


def get_preset(name: str) -> Preset:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; know {sorted(PRESETS)}")
    return PRESETS[name]
