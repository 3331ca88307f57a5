"""Physical ring ordering over the GPUs' links.

Counterpart of ``rocnrdma_tpu/runtime/topology.py``. There the explicit
schedules' ring follows a snake walk of the TPU chips' ICI coordinates, so
that consecutive ranks are torus neighbours. A GPU has no such coordinates;
what it has is the link matrix ``nvidia-smi topo -m`` prints, one link class
per GPU pair:

- ``X``: the same GPU (distance 0);
- ``NV#``: NVLink, # bonded links (distance 1);
- ``PIX``, ``PXB``, ``PHB``, ``NODE``, ``SYS``: PCIe through one switch,
  several switches, the host bridge, the NUMA node's interconnect, and
  across NUMA nodes (distance 2 to 6, in that order).

Where ``topo -m`` cannot run, ``nvidia-smi topo -p2p n`` (the NVLink
peer-to-peer status) and ``nvidia-smi nvlink -s`` (each GPU's active links)
give the same classes for NVLink pairs (``parse_p2p_matrix``).

``ring_order`` orders the GPUs so that the ring's hops take the shortest
links first: on an NVSwitch box, where every pair is ``NV#``, that is the
id order. The reference's ICI-only helpers (``snake_rank``,
``torus_distance``, ``grid_dims``) have no GPU meaning and are not here.
With one GPU, or with no matrix (the CPU), the order is the given one, as
the reference keeps the given order for devices without coordinates.
"""

from __future__ import annotations

import re

_PCIE_DISTANCE = {"X": 0, "PIX": 2, "PXB": 3, "PHB": 4, "NODE": 5, "SYS": 6}
_ANSI = re.compile(r"\x1b\[[0-9;]*m")
_GPU = re.compile(r"^GPU(\d+)$")


def link_distance(link: str) -> int:
    """The distance of one link class: 0 on one GPU, 1 over NVLink, 2..6
    over PCIe and the host."""
    if re.fullmatch(r"NV\d+", link):
        return 1
    if link not in _PCIE_DISTANCE:
        raise ValueError(f"unknown link class {link!r}; know X, NV#, "
                         f"{', '.join(k for k in _PCIE_DISTANCE if k != 'X')}")
    return _PCIE_DISTANCE[link]


def _matrix_cells(text: str) -> dict[tuple[int, int], str]:
    """The GPU x GPU cells of an ``nvidia-smi topo`` table: the first row
    led by ``GPU<i>`` is the header (its leading ``GPU<j>`` cells are the
    columns); each later such row gives its cells under those columns.
    NIC rows and columns, affinity columns and the legend are dropped."""
    cols, cells = None, {}
    for ln in (_ANSI.sub("", ln) for ln in text.splitlines()):
        toks = ln.split()
        m = _GPU.match(toks[0]) if toks else None
        if not m:
            continue
        if cols is None:
            cols = []
            for tok in toks:
                if not _GPU.match(tok):
                    break
                cols.append(int(tok[3:]))
            continue
        if len(toks) < 1 + len(cols):
            raise ValueError(f"topology row {ln!r} has fewer than {len(cols)} GPU columns")
        for col, cell in zip(cols, toks[1:1 + len(cols)]):
            cells[(int(m.group(1)), col)] = cell
    if cols is None:
        raise ValueError("no GPU header row in the topology matrix")
    if not cells:
        raise ValueError("no GPU rows in the topology matrix")
    return cells


def parse_topo_matrix(text: str) -> dict[tuple[int, int], str]:
    """``nvidia-smi topo -m`` output -> ``{(gpu_a, gpu_b): link class}`` for
    every ordered pair of GPUs. Raises on a table with no GPU header or an
    unknown link class."""
    links = _matrix_cells(text)
    for link in links.values():
        link_distance(link)  # validates
    return links


def parse_nvlink_status(text: str) -> dict[int, int]:
    """``nvidia-smi nvlink -s`` output -> ``{gpu: active NVLink links}``
    (a link listed with a rate is active, ``<inactive>`` is not)."""
    counts, gpu = {}, None
    for ln in text.splitlines():
        m = re.match(r"\s*GPU (\d+):", ln)
        if m:
            gpu = int(m.group(1))
            counts[gpu] = 0
        elif gpu is not None and re.match(r"\s*Link \d+: [\d.]+ GB/s", ln):
            counts[gpu] += 1
    return counts


def parse_p2p_matrix(text: str, nvlinks: dict[int, int]) -> dict[tuple[int, int], str]:
    """``nvidia-smi topo -p2p n`` output (NVLink peer-to-peer status: ``X``
    self, ``OK``, or why not: CNS/GNS/TNS/NS/U) -> the link classes of
    ``parse_topo_matrix``: ``X``, ``NV<links>`` where NVLink P2P is OK
    (``<links>`` = the row GPU's active links, ``parse_nvlink_status``),
    and ``SYS`` elsewhere: the table does not say which PCIe path is left,
    so the farthest is assumed. Where ``topo -m`` cannot run, this is the
    matrix."""
    out = {}
    for (a, b), cell in _matrix_cells(text).items():
        if cell == "X":
            out[(a, b)] = "X"
        elif cell == "OK":
            out[(a, b)] = f"NV{max(1, nvlinks.get(a, 0))}"
        elif cell in ("CNS", "GNS", "TNS", "NS", "U"):
            out[(a, b)] = "SYS"
        else:
            raise ValueError(f"unknown P2P status {cell!r}")
    return out


def ring_order(gpus, links: dict | None) -> list:
    """Order ``gpus`` (GPU ids) so the ring's hops take the shortest links:
    a nearest-neighbour walk from the first GPU, ties to the earliest, so
    an all-NVLink box keeps the id order and a PCIe box visits each NUMA
    node's GPUs before it crosses. With fewer than three GPUs, or without
    a link for every pair, the given order."""
    gpus = list(gpus)
    if len(gpus) < 3 or not links or any(
            (a, b) not in links for a in gpus for b in gpus):
        return gpus
    order, left = [gpus[0]], gpus[1:]
    while left:
        here = order[-1]
        nxt = min(left, key=lambda g: (link_distance(links[(here, g)]), gpus.index(g)))
        order.append(nxt)
        left.remove(nxt)
    return order


def ring_hop_lengths(order, links: dict | None) -> list[int]:
    """The distance of every ring hop, the closing one included. A hop with
    no link in ``links`` (the CPU, a GPU missing from the matrix)
    contributes 0: there is no physical wire to count."""
    order = list(order)
    n = len(order)
    out = []
    for i in range(n):
        a, b = order[i], order[(i + 1) % n]
        link = (links or {}).get((a, b))
        out.append(0 if link is None else link_distance(link))
    return out
