"""The port's GPU topology (``runtime/topology.py``) and topology dump
(``runtime/topo_cli.py``), on the CPU.

The reference orders TPU chips along a snake walk of their ICI
coordinates; a GPU's counterpart is the link matrix of ``nvidia-smi topo
-m``. Canned matrices stand in for the machines: one GPU, an 8-GPU
NVSwitch box (every pair ``NV18``) and an 8-GPU PCIe box with two NUMA
nodes. Where no matrix exists (the CPU) the port keeps the given order, as
the reference does for devices without coordinates.
"""

import json
import subprocess

import jax
import pytest
import torch

from rocnrdma_tpu.runtime import topo_cli as RC
from rocnrdma_tpu.runtime import topology as RT
from rocnrdma_tpu_torch.runtime import mesh as rm
from rocnrdma_tpu_torch.runtime import topo_cli as C
from rocnrdma_tpu_torch.runtime import topology as T

ONE_GPU = ("\t\x1b[4mGPU0\tCPU Affinity\tNUMA Affinity\tGPU NUMA ID\x1b[0m\n"
           "GPU0\t X \t0-25\t0\t\tN/A\n\nLegend:\n\n  X    = Self\n"
           "  SYS  = Connection traversing PCIe as well as the SMP interconnect\n"
           "  NV#  = Connection traversing a bonded set of # NVLinks\n")


# the one-card machine's own outputs (an "NVIDIA H100 80GB HBM3, 700.00 W"):
# `topo -m` cannot run in its container; the NVLink P2P table and the link
# status can
H100_TOPO_M = "Failed to run topology matrix\n"
H100_P2P = (" \t\x1b[4mGPU0\t\x1b[0m\n GPU0\tX\t\n\nLegend:\n\n  X    = Self\n"
            "  OK   = Status Ok\n  CNS  = Chipset not supported\n  GNS  = GPU not "
            "supported\n  TNS  = Topology not supported\n  NS   = Not supported\n"
            "  U    = Unknown\n")
H100_NVLINK = ("GPU 0: NVIDIA H100 80GB HBM3 (UUID: GPU-REDACTED)\n"
               + "".join(f"\t Link {i}: 26.562 GB/s\n" for i in range(18)))


def _matrix(n: int, link, nics: int = 0) -> str:
    cols = [f"GPU{i}" for i in range(n)] + [f"NIC{i}" for i in range(nics)]
    lines = ["\t" + "\t".join(cols) + "\tCPU Affinity\tNUMA Affinity\tGPU NUMA ID"]
    for a in range(n):
        cells = [" X " if a == b else link(a, b) for b in range(n)] + ["PXB"] * nics
        lines.append(f"GPU{a}\t" + "\t".join(cells) + f"\t0-55\t{a // 4}\t\tN/A")
    for i in range(nics):
        lines.append(f"NIC{i}\t" + "\t".join(["PXB"] * n + [" X "] * nics))
    return "\n".join(lines) + "\n\nLegend:\n\n  X    = Self\n"


DGX = _matrix(8, lambda a, b: "NV18", nics=2)
# two NUMA nodes of four: one PCIe switch per pair, the host bridge within
# a node, SYS across; listed so that id order zig-zags across the nodes
_NODE = [0, 1, 0, 1, 0, 1, 0, 1]


def _pcie(a, b):
    if _NODE[a] != _NODE[b]:
        return "SYS"
    return "PIX" if abs(a - b) == 2 else "NODE"


PCIE = _matrix(8, _pcie)


def test_link_classes_and_distances():
    assert T.parse_topo_matrix(ONE_GPU) == {(0, 0): "X"}
    dgx = T.parse_topo_matrix(DGX)
    assert len(dgx) == 64 and {dgx[(a, b)] for a in range(8) for b in range(8) if a != b} == {"NV18"}
    assert all(dgx[(a, a)] == "X" for a in range(8))
    pcie = T.parse_topo_matrix(PCIE)
    assert pcie[(0, 1)] == "SYS" and pcie[(0, 2)] == "PIX" and pcie[(0, 4)] == "NODE"
    assert [T.link_distance(k) for k in ("X", "NV4", "NV18", "PIX", "PXB", "PHB",
                                         "NODE", "SYS")] == [0, 1, 1, 2, 3, 4, 5, 6]
    with pytest.raises(ValueError, match="unknown link class"):
        T.link_distance("QPI")
    with pytest.raises(ValueError, match="no GPU header"):
        T.parse_topo_matrix("No devices were found\n")
    with pytest.raises(ValueError, match="unknown link class"):
        T.parse_topo_matrix(ONE_GPU.replace(" X ", "ZZ"))


def test_p2p_matrix_and_nvlink_status():
    assert T.parse_nvlink_status(H100_NVLINK) == {0: 18}
    assert T.parse_p2p_matrix(H100_P2P, {0: 18}) == {(0, 0): "X"}
    with pytest.raises(ValueError, match="no GPU header"):
        T.parse_topo_matrix(H100_TOPO_M)
    p2p8 = _matrix(8, lambda a, b: "OK" if a // 4 == b // 4 else "NS").replace(" X ", "X")
    status = "".join(f"GPU {g}: NVIDIA H100 80GB HBM3\n" + "".join(
        f"\t Link {i}: 26.562 GB/s\n" if i < 4 else f"\t Link {i}: <inactive>\n"
        for i in range(6)) for g in range(8))
    links = T.parse_p2p_matrix(p2p8, T.parse_nvlink_status(status))
    assert links[(0, 3)] == "NV4" and links[(0, 4)] == "SYS" and links[(5, 5)] == "X"
    assert T.ring_order(range(8), links) == list(range(8))
    assert T.ring_hop_lengths(range(8), links) == [1, 1, 1, 6, 1, 1, 1, 6]
    with pytest.raises(ValueError, match="unknown P2P status"):
        T.parse_p2p_matrix(H100_P2P.replace("GPU0\tX", "GPU0\tPIX"), {})


def test_ring_order_and_hops():
    one = T.parse_topo_matrix(ONE_GPU)
    assert T.ring_order([0], one) == [0] and T.ring_hop_lengths([0], one) == [0]
    dgx = T.parse_topo_matrix(DGX)
    assert T.ring_order(range(8), dgx) == list(range(8))  # NVSwitch: id order
    assert T.ring_hop_lengths(range(8), dgx) == [1] * 8
    pcie = T.parse_topo_matrix(PCIE)
    order = T.ring_order(range(8), pcie)
    # each NUMA node's GPUs before the ring crosses: exactly two SYS hops
    assert order == [0, 2, 4, 6, 1, 3, 5, 7]
    assert T.ring_hop_lengths(order, pcie) == [2, 2, 2, 6, 2, 2, 2, 6]
    assert T.ring_hop_lengths(range(8), pcie).count(6) == 8  # id order: all SYS
    # no matrix (the CPU) or a partial one: the given order, no wire
    assert T.ring_order([3, 1, 2], None) == [3, 1, 2]
    assert T.ring_order([0, 1, 2], {(0, 1): "NV4"}) == [0, 1, 2]
    assert T.ring_hop_lengths([3, 1, 2], None) == [0, 0, 0]


def test_cpu_ring_order_matches_reference_fallback():
    # CPU devices have no coordinates in the reference: the given order
    devs = jax.devices()
    assert [d.id for d in RT.ring_order(devs)] == T.ring_order([d.id for d in devs], None)
    assert T.ring_hop_lengths(range(len(devs)), None) == RT.ring_hop_lengths(devs)


def test_describe_on_the_cpu_keeps_the_reference_keys(monkeypatch, capsys):
    def no_smi(*a, **k):
        raise AssertionError("nvidia-smi must not run under --platform cpu")
    monkeypatch.setattr(subprocess, "run", no_smi)
    doc = C.describe("cpu", 4)
    ref = RC.describe()
    for key in ("platform", "n_devices", "n_processes", "process_index",
                "is_oracle", "devices", "ring_order"):
        assert key in doc and key in ref
    assert (doc["platform"], doc["n_devices"], doc["is_oracle"]) == ("cpu", 4, True)
    assert doc["ring_order"] == [0, 1, 2, 3] and doc["links"] == []
    assert doc["ring_contiguous"] and doc["ring_hop_lengths"] == [0, 0, 0, 0]
    assert C.main(["--platform", "cpu", "--fake-devices", "3", "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["ring_order"] == [0, 1, 2]
    assert C.main(["--platform", "cpu", "--fake-devices", "2"]) == 0
    assert "ring order: 0 -> 1\n" in capsys.readouterr().out


def _fake_card(monkeypatch, n_gpus: int, matrix: str):
    topo = rm.Topology(platform="gpu", n_devices=n_gpus,
                       device_name="NVIDIA H100 80GB HBM3", device=torch.device("cpu"))
    monkeypatch.setattr(rm, "detect_topology", lambda platform, fake=None: topo)
    monkeypatch.setattr(C, "gpu_inventory", lambda: [
        {"gpu": i, "cuda": i, "name": "NVIDIA H100 80GB HBM3", "power_limit": "700.00 W",
         "pci_bus_id": f"00000000:{0x18 + i:02X}:00.0"} for i in range(n_gpus)])
    monkeypatch.setattr(C, "topo_text", lambda: matrix)


def test_describe_on_a_card(monkeypatch):
    _fake_card(monkeypatch, 1, ONE_GPU)
    doc = C.describe()
    assert doc["links_source"] == "nvidia-smi topo -m"
    assert doc["devices"][0]["power_limit"] == "700.00 W"
    assert doc["devices"][0]["name"] == "NVIDIA H100 80GB HBM3"
    assert doc["ring_order"] == [0] and doc["links"] == [["X"]]
    assert doc["ring_contiguous"]
    assert "700.00 W" in C.render(doc) and "(one GPU)" in C.render(doc)
    _fake_card(monkeypatch, 8, DGX)
    doc = C.describe()
    assert doc["ring_order"] == list(range(8)) and doc["ring_contiguous"]
    assert doc["gpus"] == list(range(8)) and doc["links"][0][1] == "NV18"
    _fake_card(monkeypatch, 8, PCIE)
    doc = C.describe()
    assert doc["ring_order"] == [0, 2, 4, 6, 1, 3, 5, 7] and not doc["ring_contiguous"]


# a four-GPU box as nvidia-smi lists it (PCI order): GPUs 0-1 and 2-3 are
# NVLink pairs, and each pair is on its own NUMA node; 3 runs at a lower limit
BOX4 = _matrix(4, lambda a, b: "NV4" if a // 2 == b // 2 else "SYS")
_UUIDS = ["9b16fb99-c628-0765-49d6-b2d9a7de9076", "f901e558-060c-722c-0e87-53a1046cac92",
          "1c2d3e4f-0000-1111-2222-333344445555", "a0b1c2d3-e4f5-0617-2839-4a5b6c7d8e9f"]
BOX4_QUERY = "".join(
    f"{i}, GPU-{u}, 00000000:{0x18 + 0x20 * i:02X}:00.0, NVIDIA H100 80GB HBM3, "
    f"{'500.00 W' if i == 3 else '700.00 W'}\n" for i, u in enumerate(_UUIDS))


def _masked_card(monkeypatch, visible, uuids=True):
    """BOX4 seen through ``CUDA_VISIBLE_DEVICES=<visible>``: CUDA ordinal c
    is nvidia-smi's GPU visible[c]."""
    topo = rm.Topology(platform="gpu", n_devices=len(visible),
                       device_name="NVIDIA H100 80GB HBM3", device=torch.device("cpu"))
    monkeypatch.setattr(rm, "detect_topology", lambda platform, fake=None: topo)
    outputs = {"--query-gpu=index,uuid,pci.bus_id,name,power.limit": BOX4_QUERY,
               "topo": BOX4}
    monkeypatch.setattr(C, "_smi", lambda args: outputs[args[0]])
    monkeypatch.setattr(C, "cuda_ids", lambda: [
        {"uuid": C._norm_uuid(_UUIDS[g]) if uuids else "",
         "pci_bus_id": f"00000000:{0x18 + 0x20 * g:02X}:00.0"} for g in visible])


@pytest.mark.parametrize("uuids", [True, False], ids=["by-uuid", "by-pci-bus-id"])
def test_describe_matches_cuda_ordinals_to_nvidia_smi_rows(monkeypatch, uuids):
    # CUDA_VISIBLE_DEVICES=2,3: ordinals 0, 1 are nvidia-smi's GPUs 2, 3
    _masked_card(monkeypatch, [2, 3], uuids)
    inv = C.gpu_inventory()
    assert [(g["gpu"], g["cuda"]) for g in inv] == [(0, None), (1, None), (2, 0), (3, 1)]
    doc = C.describe()
    assert [(d["id"], d["gpu"], d["cuda"]) for d in doc["devices"]] == [(0, 2, 0), (1, 3, 1)]
    assert [d["power_limit"] for d in doc["devices"]] == ["700.00 W", "500.00 W"]
    assert doc["devices"][1]["pci_bus_id"] == "00000000:78:00.0"
    assert doc["ring_hop_lengths"] == [1, 1] and doc["ring_contiguous"]  # the 2-3 NVLink
    # CUDA_VISIBLE_DEVICES=3,1: across the NUMA nodes, in CUDA's order
    _masked_card(monkeypatch, [3, 1], uuids)
    doc = C.describe()
    assert [(d["id"], d["gpu"]) for d in doc["devices"]] == [(0, 3), (1, 1)]
    assert doc["devices"][0]["power_limit"] == "500.00 W"
    assert doc["ring_hop_lengths"] == [6, 6] and not doc["ring_contiguous"]


def test_a_cuda_device_nvidia_smi_does_not_list_is_an_error(monkeypatch):
    _masked_card(monkeypatch, [2])
    monkeypatch.setattr(C, "cuda_ids", lambda: [
        {"uuid": "deadbeef", "pci_bus_id": "00000000:01:00.0"}])
    with pytest.raises(RuntimeError, match="CUDA device 0 .* matches 0 of nvidia-smi"):
        C.gpu_inventory()


def test_link_matrix_falls_back_to_p2p_and_says_so(monkeypatch):
    outputs = {("topo", "-m"): None, ("topo", "-p2p", "n"): H100_P2P,
               ("nvlink", "-s"): H100_NVLINK}

    def smi(args):
        out = outputs[tuple(args)]
        if out is None:
            raise RuntimeError(f"nvidia-smi {' '.join(args)} failed: exit 255")
        return out
    monkeypatch.setattr(C, "_smi", smi)
    links, source, raw = C.link_matrix()
    assert links == {(0, 0): "X"} and "topo -p2p n" in source and "exit 255" in source
    assert raw.startswith(H100_P2P)
    outputs[("topo", "-m")] = DGX
    links, source, raw = C.link_matrix()
    assert source == "nvidia-smi topo -m" and links[(0, 7)] == "NV18"
    outputs[("topo", "-m")] = outputs[("topo", "-p2p", "n")] = None
    with pytest.raises(RuntimeError, match="-p2p"):
        C.link_matrix()


def test_a_failing_nvidia_smi_is_an_error(monkeypatch):
    def broken(*a, **k):
        raise subprocess.CalledProcessError(9, a[0])
    monkeypatch.setattr(subprocess, "run", broken)
    with pytest.raises(RuntimeError, match="nvidia-smi"):
        C.topo_text()
    with pytest.raises(RuntimeError, match="nvidia-smi"):
        C.gpu_inventory()
