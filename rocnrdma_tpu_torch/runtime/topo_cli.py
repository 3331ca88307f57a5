"""Topology dump CLI — the RCCL topo-dump (``NCCL_TOPO_DUMP_FILE``) analogue.

Counterpart of ``rocnrdma_tpu/runtime/topo_cli.py``. Prints what the
runtime knows about the machine: platform, the devices (on the card each
GPU's nvidia-smi index and CUDA ordinal, matched by UUID, its name,
``nvidia-smi`` power limit and PCI bus id), the link matrix of
``nvidia-smi topo -m`` (or, where that cannot run, the NVLink P2P matrix:
``link_matrix``), the ring order the explicit schedules' ring would
follow over those links and the distance of each of its hops (the "is my
ring physically contiguous?" diagnostic). ``--json`` emits the same
machine-readably. With ``--platform cpu`` nothing calls ``nvidia-smi``; on
the card a failing ``nvidia-smi`` is an error, not an empty matrix.

Usage::

    python -m rocnrdma_tpu_torch.runtime.topo_cli [--json]
    python -m rocnrdma_tpu_torch.runtime.topo_cli --platform cpu --fake-devices 8 --json
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys


def _smi(args: list[str]) -> str:
    """``nvidia-smi <args>``'s standard output; raises when it fails."""
    try:
        return subprocess.run(["nvidia-smi", *args], capture_output=True,
                              text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        said = " ".join(((getattr(e, "stdout", None) or "")
                         + (getattr(e, "stderr", None) or "")).split())
        raise RuntimeError(f"nvidia-smi {' '.join(args)} failed: {e}"
                           + (f" ({said[:200]})" if said else "")) from e


def _norm_uuid(u: str) -> str:
    """``GPU-9b16fb99-c628-...`` (nvidia-smi) and ``9b16fb99-c628-...``
    (the CUDA driver) as one key."""
    u = u.strip().lower()
    return (u[4:] if u.startswith("gpu-") else u).replace("-", "")


def cuda_ids() -> list[dict]:
    """Each CUDA ordinal's UUID and PCI bus id (``domain:bus:device.0``),
    as the CUDA driver reports them, in CUDA's own order (which follows
    ``CUDA_VISIBLE_DEVICES`` and ``CUDA_DEVICE_ORDER``, not nvidia-smi's)."""
    import torch

    ids = []
    for i in range(torch.cuda.device_count()):
        pr = torch.cuda.get_device_properties(i)
        ids.append({"uuid": _norm_uuid(str(getattr(pr, "uuid", "") or "")),
                    "pci_bus_id": f"{pr.pci_domain_id:08X}:{pr.pci_bus_id:02X}:"
                                  f"{pr.pci_device_id:02X}.0"})
    return ids


def gpu_inventory() -> list[dict]:
    """One dict per GPU ``nvidia-smi`` lists: its index there (``gpu``,
    the index ``topo -m`` uses), name and power limit, and ``cuda``, the
    CUDA ordinal of the same GPU, or None where this process cannot see it.
    nvidia-smi lists GPUs in PCI order and ignores ``CUDA_VISIBLE_DEVICES``,
    so the two are matched by UUID (by PCI bus id where the driver gives
    no UUID); a visible GPU that matches no row is an error. ``pci_bus_id``
    is the CUDA driver's (``nvidia-smi`` prints N/A for it inside some
    containers)."""
    out = _smi(["--query-gpu=index,uuid,pci.bus_id,name,power.limit",
                "--format=csv,noheader"])
    gpus = []
    for line in out.strip().splitlines():
        idx, uuid, pci, name, power = (c.strip() for c in line.split(","))
        gpus.append({"gpu": int(idx), "name": name, "power_limit": power,
                     "cuda": None, "_uuid": _norm_uuid(uuid), "_pci": pci.upper()})
    for c, ids in enumerate(cuda_ids()):
        match = [g for g in gpus if ids["uuid"] and g["_uuid"] == ids["uuid"]] or \
                [g for g in gpus if g["_pci"] == ids["pci_bus_id"]]
        if len(match) != 1:
            raise RuntimeError(
                f"CUDA device {c} (uuid {ids['uuid'] or '?'}, pci "
                f"{ids['pci_bus_id']}) matches {len(match)} of nvidia-smi's "
                f"GPUs {[g['gpu'] for g in gpus]}")
        match[0].update(cuda=c, pci_bus_id=ids["pci_bus_id"])
    for g in gpus:
        del g["_uuid"], g["_pci"]
    return gpus


def topo_text() -> str:
    """The raw ``nvidia-smi topo -m`` matrix."""
    return _smi(["topo", "-m"])


def link_matrix() -> tuple[dict, str, str]:
    """(links, source, raw text) of this machine's GPUs. The source is
    ``nvidia-smi topo -m``; where that cannot run (a container without the
    PCI tree answers "Failed to run topology matrix"), the NVLink P2P
    matrix ``topo -p2p n`` with ``nvlink -s``'s link counts, and the
    source says so. Raises when neither runs: never an empty matrix."""
    from rocnrdma_tpu_torch.runtime import topology as tp
    try:
        raw = topo_text()
        return tp.parse_topo_matrix(raw), "nvidia-smi topo -m", raw
    except RuntimeError as e:
        why = str(e)
    raw = _smi(["topo", "-p2p", "n"])
    nv = _smi(["nvlink", "-s"])
    links = tp.parse_p2p_matrix(raw, tp.parse_nvlink_status(nv))
    return links, f"nvidia-smi topo -p2p n + nvlink -s ({why})", raw + nv


def describe(platform: str = "auto", fake_devices: int | None = None) -> dict:
    """The topology document (pure data; the CLI renders it)."""
    import torch

    from rocnrdma_tpu_torch.runtime import mesh as rm
    from rocnrdma_tpu_torch.runtime import topology as tp

    topo = rm.detect_topology(platform, fake_devices)
    dist = torch.distributed
    world = dist.is_available() and dist.is_initialized()
    doc = {
        "platform": topo.platform,
        "n_devices": topo.n_devices,
        "n_processes": dist.get_world_size() if world else 1,
        "process_index": dist.get_rank() if world else 0,
        "is_oracle": topo.is_oracle,
    }
    if topo.platform == "cpu":
        devices = [{"id": i, "kind": "cpu", "process": doc["process_index"],
                    "gpu": None, "cuda": None} for i in range(topo.n_devices)]
        links, source = {}, None
    else:
        # by CUDA ordinal; "gpu" is nvidia-smi's index, which the matrix uses
        inv = {g["cuda"]: g for g in gpu_inventory() if g["cuda"] is not None}
        links, source, _ = link_matrix()
        # ranks: one per GPU, or --fake-devices N ranks on the one GPU in use
        ordinals = ([topo.device.index] * topo.n_devices if fake_devices
                    else list(range(topo.n_devices)))
        devices = [{"id": i, "kind": inv[c]["name"], "process": doc["process_index"],
                    **inv[c]} for i, c in enumerate(ordinals)]
    gpu_of = {d["id"]: d["gpu"] for d in devices}
    # the links between ranks are those between their GPUs
    rank_links = {(a, b): links[(gpu_of[a], gpu_of[b])] for a in gpu_of for b in gpu_of
                  if (gpu_of[a], gpu_of[b]) in links}
    order = tp.ring_order([d["id"] for d in devices], rank_links)
    hops = tp.ring_hop_lengths(order, rank_links)
    gpus = sorted({g for g, _ in links})
    doc.update({
        "devices": devices,
        "ring_order": order,
        # the parsed matrix, row and column i = the i-th of "gpus"
        "gpus": gpus,
        "links": [[links[(a, b)] for b in gpus] for a in gpus],
        "links_source": source,
        "ring_hop_lengths": hops,
        "ring_contiguous": all(h <= 1 for h in hops),
    })
    return doc


def render(doc: dict) -> str:
    lines = [
        f"platform {doc['platform']}  devices {doc['n_devices']}  "
        f"processes {doc['n_processes']} (this: {doc['process_index']})"
        f"{'  [CPU oracle]' if doc['is_oracle'] else ''}",
        "",
        f"{'id':>4} {'gpu':>4} {'cuda':>4} {'kind':>24} {'power':>10} {'pci bus':>18}",
    ]
    for d in doc["devices"]:
        gpu = "-" if d["gpu"] is None else d["gpu"]
        cuda = "-" if d.get("cuda") is None else d["cuda"]
        lines.append(f"{d['id']:>4} {gpu:>4} {cuda:>4} {d['kind']:>24} "
                     f"{d.get('power_limit', '-'):>10} {d.get('pci_bus_id', '-'):>18}")
    if doc["gpus"]:
        lines += ["", f"links from {doc['links_source']}"]
        pairs = [f"GPU{a}-GPU{b} {doc['links'][i][j]}"
                 for i, a in enumerate(doc["gpus"])
                 for j, b in enumerate(doc["gpus"]) if i < j]
        lines.append("links: " + ("  ".join(pairs) or "(one GPU)"))
    lines.append("")
    lines.append("ring order: " + " -> ".join(map(str, doc["ring_order"])))
    lines.append(f"hop lengths: {doc['ring_hop_lengths']}  "
                 f"contiguous: {doc['ring_contiguous']}")
    return "\n".join(lines)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="rocnrdma_topo",
        description="Dump the device/link topology and the ring order "
                    "(the RCCL topo-dump analogue)")
    p.add_argument("--fake-devices", type=int, default=None,
                   help="host this many ranks on the one device")
    p.add_argument("--platform", choices=("auto", "cpu"), default="auto")
    p.add_argument("--json", action="store_true")
    args = p.parse_args(argv)

    doc = describe(args.platform, args.fake_devices)
    print(json.dumps(doc) if args.json else render(doc))
    return 0


if __name__ == "__main__":
    sys.exit(main())
