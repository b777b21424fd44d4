"""Cluster topology model for BandPilot.

Models an AI cluster as a set of hosts, each with a fixed number of
accelerators and a published intra-host interconnect topology.  The five GPU
host classes reproduce the paper's Appendix E tables verbatim (RTX 4090,
V100, A6000, A800, H100); a TPU v5e host class is added for the framework
integration (ICI-connected 8-chip tray).

The cluster object is pure topology + availability state.  Bandwidth
semantics live in :mod:`repro.core.bandwidth_sim`.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Link types.  P2P_BW are *unidirectional effective* GB/s used by the
# ground-truth simulator.  Magnitudes are calibrated so the H100 cluster
# reproduces the paper's Fig. 1 headline numbers (see bandwidth_sim.py);
# relative ordering follows NVIDIA topology classes.  The 4090's SYS > PXB
# inversion reproduces the paper's Fig. 2 "anti-locality" measurement.
# ---------------------------------------------------------------------------

P2P_BW: Dict[str, float] = {
    "NV16": 55.0,   # H100 NVLink4 (per-direction effective, per peer pair)
    "NV8": 28.0,    # A800 NVLink3 x8
    "NV4": 14.0,    # A6000 NVLink3 x4
    "NV2": 7.5,     # V100 NVLink2 x2
    "NV1": 4.0,     # V100 NVLink2 x1
    "PIX": 1.9,     # single PCIe switch hop
    "PXB": 1.55,    # multiple PCIe bridges (no CPU hop)
    "SYS": 1.7,     # cross-NUMA; > PXB on 4090 hosts (anti-locality, Fig. 2)
    "X": 0.0,       # self
    "ICI": 45.0,    # TPU v5e intra-tray inter-chip interconnect (per link)
}

# Static link weights used by the *Topo* compactness baseline (Algorithm 5).
# Higher = "closer".  Deliberately mirrors what a Slurm topology file would
# encode: NVLink > PCIe-switch > PCIe-bridge > cross-NUMA.
TOPO_WEIGHT: Dict[str, float] = {
    "NV16": 100.0, "NV8": 80.0, "NV4": 60.0, "NV2": 40.0, "NV1": 30.0,
    "PIX": 12.0, "PXB": 10.0, "SYS": 4.0, "X": 0.0, "ICI": 90.0,
}
INTER_HOST_TOPO_WEIGHT = 1.0  # any cross-host pair


def _sym(rows: Sequence[str]) -> List[List[str]]:
    """Parse a compact topology table (list of space-separated rows)."""
    mat = [r.split() for r in rows]
    n = len(mat)
    assert all(len(r) == n for r in mat), "topology table must be square"
    return mat


# Appendix E tables (verbatim).
_TOPOLOGY_4090 = _sym([
    "X   PXB PXB PXB SYS SYS SYS SYS",
    "PXB X   PXB PXB SYS SYS SYS SYS",
    "PXB PXB X   PIX SYS SYS SYS SYS",
    "PXB PXB PIX X   SYS SYS SYS SYS",
    "SYS SYS SYS SYS X   PXB PXB PXB",
    "SYS SYS SYS SYS PXB X   PXB PXB",
    "SYS SYS SYS SYS PXB PXB X   PIX",
    "SYS SYS SYS SYS PXB PXB PIX X",
])

_TOPOLOGY_V100 = _sym([
    "X   NV1 NV2 NV1 SYS SYS SYS NV2",
    "NV1 X   NV1 NV2 SYS SYS NV2 SYS",
    "NV2 NV1 X   NV2 SYS NV1 SYS SYS",
    "NV1 NV2 NV2 X   NV1 SYS SYS SYS",
    "SYS SYS SYS NV1 X   NV2 NV2 NV1",
    "SYS SYS NV1 SYS NV2 X   NV1 NV2",
    "SYS NV2 SYS SYS NV2 NV1 X   NV1",
    "NV2 SYS SYS SYS NV1 NV2 NV1 X",
])

_TOPOLOGY_A6000 = _sym([
    "X   NV4 PXB PXB SYS SYS SYS SYS",
    "NV4 X   PXB PXB SYS SYS SYS SYS",
    "PXB PXB X   NV4 SYS SYS SYS SYS",
    "PXB PXB NV4 X   SYS SYS SYS SYS",
    "SYS SYS SYS SYS X   NV4 PXB PXB",
    "SYS SYS SYS SYS NV4 X   PXB PXB",
    "SYS SYS SYS SYS PXB PXB X   NV4",
    "SYS SYS SYS SYS PXB PXB NV4 X",
])


def _uniform_topology(link: str, n: int = 8) -> List[List[str]]:
    return [[("X" if i == j else link) for j in range(n)] for i in range(n)]


_TOPOLOGY_A800 = _uniform_topology("NV8")
_TOPOLOGY_H100 = _uniform_topology("NV16")
_TOPOLOGY_TPU_V5E = _uniform_topology("ICI")  # 2x4 tray modeled as uniform ICI


@dataclasses.dataclass(frozen=True)
class HostType:
    """A host class: accelerator model + intra-host interconnect topology.

    Attributes:
      name: host class name (e.g. "H100").
      topology: n_gpus x n_gpus link-type matrix.
      nic_rail_bw: per-accelerator NIC ("rail") bandwidth in GB/s.  Modern
        H100 boxes are rail-optimized with one 400 Gb/s NIC per GPU; legacy
        hosts share fewer/slower NICs, expressed as a lower per-rail figure.
      nvswitch: True if intra-host fabric is a non-blocking switch (NVSwitch
        or ICI tray) rather than point-to-point links.
    """

    name: str
    topology: Tuple[Tuple[str, ...], ...]
    nic_rail_bw: float
    nvswitch: bool

    @property
    def n_gpus(self) -> int:
        return len(self.topology)

    def link(self, i: int, j: int) -> str:
        return self.topology[i][j]

    def p2p_bw(self, i: int, j: int) -> float:
        return P2P_BW[self.topology[i][j]]


def _ht(name, table, nic_rail_bw, nvswitch) -> HostType:
    return HostType(name, tuple(tuple(r) for r in table), nic_rail_bw, nvswitch)


HOST_TYPES: Dict[str, HostType] = {
    # nic_rail_bw: H100 cluster uses a 400Gb/s (50 GB/s) Quantum IB fabric,
    # rail-optimized (one rail per GPU).  The paper's heterogeneous sims set
    # the switch bandwidth to 1/4 of the H100 fabric.
    "H100": _ht("H100", _TOPOLOGY_H100, 50.0, True),
    "A800": _ht("A800", _TOPOLOGY_A800, 12.5, True),
    "A6000": _ht("A6000", _TOPOLOGY_A6000, 12.5, False),
    "V100": _ht("V100", _TOPOLOGY_V100, 12.5, False),
    "RTX4090": _ht("RTX4090", _TOPOLOGY_4090, 12.5, False),
    "TPU_V5E": _ht("TPU_V5E", _TOPOLOGY_TPU_V5E, 25.0, True),
}


@dataclasses.dataclass(frozen=True)
class Host:
    """A physical host: host class + the global ids of its accelerators."""

    host_id: int
    host_type: HostType
    gpu_ids: Tuple[int, ...]

    @property
    def n_gpus(self) -> int:
        return len(self.gpu_ids)

    def local_index(self, gpu_id: int) -> int:
        return self.gpu_ids.index(gpu_id)


class Cluster:
    """An accelerator pool: hosts, global-id mapping, availability state.

    GPUs are globally numbered 0..N-1; ``gpu_host[g]`` gives the host index
    and ``gpu_local[g]`` the index within the host (row of the topology
    table).
    """

    def __init__(self, hosts: Sequence[Tuple[str, int]], name: str = "cluster"):
        """Args:
        hosts: sequence of (host_type_name, n_hosts_of_that_type).
        """
        self.name = name
        self.hosts: List[Host] = []
        self.gpu_host: List[int] = []
        self.gpu_local: List[int] = []
        gid = 0
        hid = 0
        for type_name, count in hosts:
            ht = HOST_TYPES[type_name]
            for _ in range(count):
                ids = tuple(range(gid, gid + ht.n_gpus))
                self.hosts.append(Host(hid, ht, ids))
                for local, g in enumerate(ids):
                    self.gpu_host.append(hid)
                    self.gpu_local.append(local)
                gid += ht.n_gpus
                hid += 1
        self.n_gpus = gid
        self.n_hosts = hid

    # -- subset utilities ---------------------------------------------------

    def partition_by_host(self, subset: Sequence[int]) -> Dict[int, List[int]]:
        """Partition a set of global GPU ids by host id (Alg. 1 line 1)."""
        out: Dict[int, List[int]] = {}
        for g in subset:
            out.setdefault(self.gpu_host[g], []).append(g)
        return out

    def local_tuple(self, host_id: int, subset: Sequence[int]) -> Tuple[int, ...]:
        """Sorted local indices of ``subset`` (global ids) on ``host_id``."""
        h = self.hosts[host_id]
        return tuple(sorted(h.gpu_ids.index(g) for g in subset))

    def host_of(self, gpu_id: int) -> Host:
        return self.hosts[self.gpu_host[gpu_id]]

    def all_gpus(self) -> List[int]:
        return list(range(self.n_gpus))

    def topo_weight(self, i: int, j: int) -> float:
        """Static pairwise link weight for the Topo baseline."""
        if i == j:
            return 0.0
        hi, hj = self.gpu_host[i], self.gpu_host[j]
        if hi != hj:
            return INTER_HOST_TOPO_WEIGHT
        h = self.hosts[hi]
        return TOPO_WEIGHT[h.host_type.link(self.gpu_local[i], self.gpu_local[j])]

    def describe(self) -> str:
        parts = [f"{h.host_type.name}x{h.n_gpus}" for h in self.hosts]
        return f"{self.name}: {self.n_gpus} GPUs on {self.n_hosts} hosts ({', '.join(parts)})"


# ---------------------------------------------------------------------------
# The paper's four evaluation clusters (Table 1) + TPU pods for integration.
# ---------------------------------------------------------------------------

def h100_cluster() -> Cluster:
    """Homogeneous: 4 hosts x 8 H100 = 32 GPUs (the physical testbed)."""
    return Cluster([("H100", 4)], name="H100")


def het_ra_cluster() -> Cluster:
    """Heterogeneous: 16x RTX4090 + 16x A800 (2+2 hosts)."""
    return Cluster([("RTX4090", 2), ("A800", 2)], name="Het-RA")


def het_va_cluster() -> Cluster:
    """Heterogeneous: 16x V100 + 16x A6000 (2+2 hosts)."""
    return Cluster([("V100", 2), ("A6000", 2)], name="Het-VA")


def het_4mix_cluster() -> Cluster:
    """Heterogeneous: 8 GPUs of each of 4090/V100/A6000/A800 (4 hosts)."""
    return Cluster(
        [("RTX4090", 1), ("V100", 1), ("A6000", 1), ("A800", 1)], name="Het-4Mix"
    )


def tpu_pod_cluster(n_hosts: int = 32) -> Cluster:
    """A TPU v5e pod slice: ``n_hosts`` trays of 8 chips (256 chips default).

    Used by the framework integration: the dispatcher selects chips/hosts to
    build the production mesh from, with DCN as the inter-host fabric.
    """
    return Cluster([("TPU_V5E", n_hosts)], name=f"TPUv5e-{n_hosts * 8}")


PAPER_CLUSTERS = {
    "H100": h100_cluster,
    "Het-RA": het_ra_cluster,
    "Het-VA": het_va_cluster,
    "Het-4Mix": het_4mix_cluster,
}


def enumerate_host_subsets(n: int, k: int) -> List[Tuple[int, ...]]:
    """All k-combinations of local indices 0..n-1 (used for intra lookups)."""
    return list(itertools.combinations(range(n), k))


def availability_scenario(
    cluster: Cluster, rng: np.random.Generator, frac_busy: Optional[float] = None
) -> List[int]:
    """Sample an availability scenario: each GPU is busy w.p. ``frac_busy``.

    Mirrors the paper's evaluation protocol (Sec. 5.3): random subsets of the
    pool are marked unavailable for each request.
    """
    if frac_busy is None:
        frac_busy = float(rng.uniform(0.0, 0.5))
    mask = rng.random(cluster.n_gpus) >= frac_busy
    avail = [g for g in range(cluster.n_gpus) if mask[g]]
    if not avail:  # never return an empty pool
        avail = [int(rng.integers(cluster.n_gpus))]
    return avail
