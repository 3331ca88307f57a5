"""Chip constants for the port's rooflines and cost model.

Two kinds of figure live here, kept apart:

- ``CHIPS``: one row, from NVIDIA's H100 SXM data sheet (dense rates,
  700 W part). These are DATASHEET figures, not measurements. The link
  latencies have no data-sheet figure at all: they are orders of
  magnitude, marked so. A card set below 700 W runs slower, so every
  measured number is kept beside the card's name and power limit as
  ``nvidia-smi`` reports them.
- ``MEASURED``: the card's own calibration for the tuner's cost model (HBM
  fraction, per-launch dispatch alpha and its range, the fold ladder), each
  beside the call that measured it.

Match rule: first key that is a substring of the lowercased device name
wins (``torch.cuda.get_device_name()`` gives e.g. "NVIDIA H100 80GB HBM3").

Calibration precedence (the accessors ``hbm_frac``, ``dispatch_alpha_s``,
``dispatch_alpha_range_s``, ``fold_ladder_for``), as in the reference's ``hw.py``:

1. the file named by ``RNR_HW_CAL`` (one file, any device kind);
2. ``<RNR_HW_CAL_DIR or rocnrdma_tpu_torch/results>/hw_<slug>.json`` for
   this kind (written by ``save_calibration``; never the repo's
   ``results/``, which holds the reference's TPU artifacts);
3. the ``MEASURED`` row of this kind;
4. for a kind with none of these (``cpu`` among them): a flat fold ladder
   (every width at the pairwise rate), an HBM fraction of 1 and a dispatch
   alpha of 0. ``tuner.constants_for`` prices such kinds with its generic
   ranking ratios and no HBM term, so their picks rest on steps and wire
   alone.

Artifact schema: ``{"device_kind": ..., "fold_ladder": {"2": GBps, ...},
"hbm_frac": float, "dispatch_alpha_s": float, "dispatch_alpha_range_s":
[lo, hi], "provenance...": ...}``; any field may be absent.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess


@dataclasses.dataclass(frozen=True)
class Chip:
    hbm_GBps: float      # peak device-memory bandwidth
    link_GBps: float     # aggregate NVLink bandwidth to the other cards
    bf16_tflops: float   # peak dense bf16 tensor-core throughput
    fp32_tflops: float   # peak fp32 outside the tensor cores
    link_hop_s: float    # latency of one small NVLink transfer
    nic_GBps: float      # network rate per card (the cross-node wire)
    nic_hop_s: float     # latency of one cross-node transfer
    source: str


CHIPS: dict[str, Chip] = {
    # nic_GBps: one 400 Gb/s ConnectX-7 per GPU (DGX H100 data sheet). The
    # two latencies are orders of magnitude with no data-sheet figure
    # behind them; neither is measured.
    "h100": Chip(hbm_GBps=3350.0, link_GBps=900.0, bf16_tflops=989.0,
                 fp32_tflops=67.0, link_hop_s=2.0e-6, nic_GBps=50.0,
                 nic_hop_s=5.0e-6,
                 source="NVIDIA H100 SXM datasheet (not measured)"),
}


@dataclasses.dataclass(frozen=True)
class Calibration:
    hbm_frac: float                  # achieved / datasheet HBM rate
    dispatch_alpha_s: float          # seconds per launch of a tiny op
    dispatch_alpha_range_s: tuple    # (lo, hi) over the measurement runs
    fold_ladder: dict                # fold width -> accounted GB/s
    source: str


# The H100's calibration, from one chip call running
#   python -m rocnrdma_tpu_torch.transport.tuner --measure-alpha --save-calibration
#   python -m rocnrdma_tpu_torch.bench.fold_ladder --save-calibration
# on an "NVIDIA H100 80GB HBM3, 700.00 W" (nvidia-smi name, power.limit),
# copied here from the calibration file those two commands wrote.
#
# - fold_ladder: accounted GB/s of a width-w fold as the port's schedules
#   run it, w-1 in-place pairwise adds into one accumulator, at (w+1)
#   bytes per element (bench/fold_ladder.py; every operand 64 MiB or more,
#   so no width runs out of the 50 MB L2). A pairwise add moves 3 bytes
#   per element whatever the width, so the accounted rate falls as w
#   grows: the ladder tells the model that a wide fold costs the port
#   3(w-1) bytes per element, not the fused fold's w+1.
# - hbm_frac: the width-2 rung over the datasheet 3350 GB/s.
# - dispatch_alpha_s: the median of the five measure_alpha runs (the
#   chained marginal of a 4 KiB in-place add, host enqueue included:
#   the card waits on the host at that size); the range is their min and max.
MEASURED: dict[str, Calibration] = {
    "h100": Calibration(
        hbm_frac=0.9244060783261816,
        dispatch_alpha_s=4.72024129703641e-06,
        dispatch_alpha_range_s=(4.387705121189356e-06, 7.052714071635689e-06),
        fold_ladder={2: 3096.7603623927084, 3: 2063.745044968516,
                     4: 1716.4819584797385, 8: 1322.5031017193692,
                     9: 1285.3691684590358, 12: 1211.5463626684768,
                     16: 1157.8996679099712, 24: 1102.1135110840592,
                     32: 1071.3326213077073, 48: 1034.1648439479068,
                     64: 1009.7156047649402},
        source="tuner --measure-alpha and bench.fold_ladder on an "
               "NVIDIA H100 80GB HBM3, 700.00 W"),
}

MEASURED_DISPATCH_ALPHA_RANGE_S = MEASURED["h100"].dispatch_alpha_range_s


def _match(table: dict, device_name: str):
    name = (device_name or "").lower()
    for key, row in table.items():
        if key in name:
            return row
    return None


def chip_for(device_name: str) -> Chip | None:
    return _match(CHIPS, device_name)


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


def smi_line() -> str:
    """``nvidia-smi``'s "name, power.limit" of the cards, one line each,
    or "" where there is no ``nvidia-smi``."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return ""


# -- calibration artifacts ---------------------------------------------------

_CAL_CACHE: dict[str, dict | None] = {}
RESULTS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "results")


def _cal_slug(device_kind: str) -> str:
    return "".join(c if c.isalnum() else "_" for c in
                   (device_kind or "").lower()).strip("_") or "unknown"


def calibration_path(device_kind: str, base_dir: str | None = None) -> str:
    """Where this kind's calibration artifact lives. An explicit
    ``base_dir`` wins over the env pins, so a caller quarantining an
    artifact never overwrites an ``RNR_HW_CAL``-pinned file."""
    if base_dir:
        return os.path.join(base_dir, f"hw_{_cal_slug(device_kind)}.json")
    env = os.environ.get("RNR_HW_CAL", "").strip()
    if env:
        return env
    base = os.environ.get("RNR_HW_CAL_DIR", "").strip() or RESULTS_DIR
    return os.path.join(base, f"hw_{_cal_slug(device_kind)}.json")


def calibration_for(device_kind: str) -> dict | None:
    """The persisted calibration artifact of this kind, or None. Cached per
    path; a malformed file counts as absent (a torn write must not crash a
    caller)."""
    path = calibration_path(device_kind)
    if path not in _CAL_CACHE:
        try:
            with open(path) as fp:
                _CAL_CACHE[path] = json.load(fp)
        except (OSError, ValueError):
            _CAL_CACHE[path] = None
    return _CAL_CACHE[path]


def save_calibration(device_kind: str, data: dict,
                     base_dir: str | None = None) -> str:
    """Merge ``data`` into this kind's calibration artifact (atomically) and
    drop the cache, so the writing process reads its own measurement."""
    path = calibration_path(device_kind, base_dir)
    try:
        with open(path) as fp:
            old = json.load(fp)
    except (OSError, ValueError):
        old = {}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as fp:
        json.dump({**old, "device_kind": device_kind, **data}, fp, indent=1,
                  sort_keys=True)
    os.replace(tmp, path)
    _CAL_CACHE.pop(path, None)
    return path


def hbm_frac(device_kind: str = "") -> float:
    cal = calibration_for(device_kind)
    if cal and isinstance(cal.get("hbm_frac"), (int, float)):
        return float(cal["hbm_frac"])
    row = _match(MEASURED, device_kind)
    return row.hbm_frac if row else 1.0


def dispatch_alpha_s(device_kind: str = "") -> float:
    cal = calibration_for(device_kind)
    if cal and isinstance(cal.get("dispatch_alpha_s"), (int, float)):
        return float(cal["dispatch_alpha_s"])
    row = _match(MEASURED, device_kind)
    return row.dispatch_alpha_s if row else 0.0


def dispatch_alpha_range_s(device_kind: str = "") -> tuple | None:
    """(lo, hi) of this kind's dispatch-alpha measurements, or None."""
    cal = calibration_for(device_kind)
    rng = (cal or {}).get("dispatch_alpha_range_s")
    if isinstance(rng, list) and len(rng) == 2:
        return float(rng[0]), float(rng[1])
    row = _match(MEASURED, device_kind)
    return row.dispatch_alpha_range_s if row else None


_FLAT_LADDER = {2: 1.0}


def fold_ladder_for(device_kind: str = "") -> dict[int, float]:
    cal = calibration_for(device_kind)
    lad = (cal or {}).get("fold_ladder")
    if isinstance(lad, dict) and lad:
        try:
            out = {int(k): float(v) for k, v in lad.items()}
            if 2 in out:  # the pairwise anchor is load-bearing
                return out
        except (TypeError, ValueError):
            pass
    row = _match(MEASURED, device_kind)
    return row.fold_ladder if row else _FLAT_LADDER


def fold_rate_scale(n_ops: int, device_kind: str = "") -> float:
    """HBM-time multiplier of an ``n_ops``-wide fold relative to the
    pairwise anchor: rate(2)/rate(n_ops), linearly interpolated between
    measured widths and CLAMPED at the widest measured one (unmeasured
    widths get no extrapolated price). 1.0 for the pairwise fold, and for
    every width of a flat ladder."""
    lad = fold_ladder_for(device_kind)
    base = lad[2]
    if n_ops in lad:
        return base / lad[n_ops]
    ws = sorted(lad)
    if n_ops <= ws[0]:
        return base / lad[ws[0]]
    if n_ops >= ws[-1]:
        return base / lad[ws[-1]]
    lo = max(w for w in ws if w < n_ops)
    hi = min(w for w in ws if w > n_ops)
    frac = (n_ops - lo) / (hi - lo)
    return base / (lad[lo] + frac * (lad[hi] - lad[lo]))
