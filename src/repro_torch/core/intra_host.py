"""Stage-1 of the hierarchical surrogate: exhaustive intra-host lookup tables.

The paper (Sec. 4.2.1) measures end-to-end collective bandwidth for *all*
2^8 - 1 = 255 non-empty GPU combinations of every host once, offline, and
stores them in per-host key-value dictionaries (~12 KB each).  The same
tables power:

  * Stage-1 of the hierarchical surrogate (perfect intra-host features),
  * EHA's single-host prioritization (best k-subset on one host),
  * PTS's node-insertion pruning,
  * the exact Oracle (per-count best subsets, see baselines.py).
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.bandwidth_sim import BandwidthSimulator
from repro_torch.core.cluster import Cluster

LocalSubset = Tuple[int, ...]


class IntraHostTables:
    """Per-host-instance dictionaries: local GPU subset -> measured bandwidth."""

    def __init__(self, cluster: Cluster, sim: BandwidthSimulator):
        self.cluster = cluster
        self.tables: List[Dict[LocalSubset, float]] = []
        # measurement_seconds mirrors the paper's Table 3 cost accounting:
        # one nccl-tests invocation per combination (few seconds each).
        self.n_measurements = 0
        for host in cluster.hosts:
            table: Dict[LocalSubset, float] = {}
            n = host.n_gpus
            for size in range(1, n + 1):
                for sub in itertools.combinations(range(n), size):
                    table[sub] = sim.intra_bandwidth(host.host_id, sub)
                    self.n_measurements += 1
            self.tables.append(table)
        # best-subset-by-count index used by oracle/EHA:
        #   best[host_id][n] = (bw, subset) over *all* local subsets of size n
        self._best_full: List[Dict[int, Tuple[float, LocalSubset]]] = []
        for host in cluster.hosts:
            per_n: Dict[int, Tuple[float, LocalSubset]] = {}
            for sub, bw in self.tables[host.host_id].items():
                n = len(sub)
                if n not in per_n or bw > per_n[n][0]:
                    per_n[n] = (bw, sub)
            self._best_full.append(per_n)

    # -- queries --------------------------------------------------------------

    def lookup(self, host_id: int, local_subset: Sequence[int]) -> float:
        return self.tables[host_id][tuple(sorted(local_subset))]

    def lookup_global(self, gpu_ids: Sequence[int]) -> float:
        """Lookup for a set of *global* ids known to live on one host."""
        hid = self.cluster.gpu_host[gpu_ids[0]]
        return self.lookup(hid, self.cluster.local_tuple(hid, gpu_ids))

    def best_subset(
        self, host_id: int, n: int, avail_locals: Optional[Sequence[int]] = None
    ) -> Tuple[float, LocalSubset]:
        """Best bandwidth n-subset on a host, optionally restricted to
        available local indices.  Returns (bw, local_subset)."""
        if avail_locals is None:
            return self._best_full[host_id][n]
        avail = tuple(sorted(avail_locals))
        if len(avail) < n:
            raise ValueError(f"host {host_id}: {len(avail)} available < {n}")
        if len(avail) == self.cluster.hosts[host_id].n_gpus:
            return self._best_full[host_id][n]
        table = self.tables[host_id]
        best_bw, best_sub = -1.0, None
        for sub in itertools.combinations(avail, n):
            bw = table[sub]
            if bw > best_bw:
                best_bw, best_sub = bw, sub
        return best_bw, best_sub

    def to_globals(self, host_id: int, local_subset: Sequence[int]) -> List[int]:
        host = self.cluster.hosts[host_id]
        return [host.gpu_ids[i] for i in local_subset]

    def storage_bytes(self) -> int:
        """~12 KB per 8-GPU host, as reported in Sec. 5.4."""
        total = 0
        for table in self.tables:
            # key: packed bitmask (2 bytes) + float32 value + dict overhead
            # approximated at the paper's accounting of ~48 B/entry
            total += len(table) * 48
        return total
