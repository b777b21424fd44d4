"""Benchmark dispatchers (Appendix D) and the exact Oracle.

* Random — Algorithm 3: uniform k-subset of the available pool.
* Default — Algorithm 4: NUMA/CPU-affinity proximity heuristic.
* Topo — Algorithm 5: Slurm-style compactness over a static weighted
  topology graph.
* Oracle — arg max of the *ground truth* B(S); made exact (and fast) by
  enumerating per-host count vectors and exploiting that, for fixed counts,
  B is maximized by independently maximizing each host's intra-host
  bandwidth (B is monotone in every intra term; the inter term depends only
  on the counts).  Cross-checked against brute force in the tests.
"""

from __future__ import annotations

import itertools
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.bandwidth_sim import BandwidthSimulator
from repro_torch.core.cluster import Cluster
from repro_torch.core.intra_host import IntraHostTables

Subset = List[int]


def random_dispatch(
    cluster: Cluster, avail: Sequence[int], k: int, rng: np.random.Generator
) -> Subset:
    """Algorithm 3."""
    sel = rng.choice(len(avail), size=k, replace=False)
    return sorted(avail[i] for i in sel)


def default_dispatch(cluster: Cluster, avail: Sequence[int], k: int) -> Subset:
    """Algorithm 4 — NUMA proximity: fill GPUs with adjacent local indices
    (same socket / CPU affinity), no interconnect awareness."""
    by_host = cluster.partition_by_host(avail)
    singles = {h: g for h, g in by_host.items() if len(g) >= k}
    if singles:
        hid = min(singles)  # "select any host": deterministic lowest id
        gpus = sorted(singles[hid], key=lambda g: cluster.gpu_local[g])
        return sorted(gpus[:k])
    # multi-host: pool the largest hosts, take the first k in local order
    hosts = sorted(by_host.items(), key=lambda kv: (-len(kv[1]), kv[0]))
    out: Subset = []
    for hid, gpus in hosts:
        gpus = sorted(gpus, key=lambda g: cluster.gpu_local[g])
        take = min(k - len(out), len(gpus))
        out.extend(gpus[:take])
        if len(out) == k:
            break
    return sorted(out)


def _topo_score(cluster: Cluster, subset: Sequence[int]) -> float:
    return sum(
        cluster.topo_weight(a, b) for a, b in itertools.combinations(subset, 2)
    )


def topo_dispatch(cluster: Cluster, avail: Sequence[int], k: int) -> Subset:
    """Algorithm 5 — compactness: maximize the sum of static link weights.

    Single-host: exact argmax over k-subsets of that host.  Multi-host: the
    canonical Slurm behaviour — greedily fill the hosts with the most
    available GPUs (maximum locality, e.g. 6+2 over 4+4), choosing within
    each host the subset with the best static score.
    """
    by_host = cluster.partition_by_host(avail)
    singles = {h: g for h, g in by_host.items() if len(g) >= k}
    if singles:
        best_sub, best_score = None, -1.0
        for hid, gpus in singles.items():
            for sub in itertools.combinations(sorted(gpus), k):
                s = _topo_score(cluster, sub)
                if s > best_score:
                    best_score, best_sub = s, list(sub)
        return sorted(best_sub)
    hosts = sorted(by_host.items(), key=lambda kv: (-len(kv[1]), kv[0]))
    out: Subset = []
    for hid, gpus in hosts:
        need = k - len(out)
        if need <= 0:
            break
        if len(gpus) <= need:
            out.extend(gpus)
        else:
            best_sub, best_score = None, -1.0
            for sub in itertools.combinations(sorted(gpus), need):
                s = _topo_score(cluster, sub)
                if s > best_score:
                    best_score, best_sub = s, list(sub)
            out.extend(best_sub)
    return sorted(out)


# ---------------------------------------------------------------------------
# Oracle
# ---------------------------------------------------------------------------

def _count_vectors(caps: Sequence[int], k: int) -> Iterable[Tuple[int, ...]]:
    """All vectors 0 <= n_i <= caps[i] with sum k (depth-first, pruned)."""
    n = len(caps)
    suffix = [0] * (n + 1)
    for i in range(n - 1, -1, -1):
        suffix[i] = suffix[i + 1] + caps[i]
    vec = [0] * n

    def rec(i: int, remaining: int):
        if i == n:
            if remaining == 0:
                yield tuple(vec)
            return
        if remaining > suffix[i]:
            return
        lo = max(0, remaining - suffix[i + 1])
        hi = min(caps[i], remaining)
        for c in range(lo, hi + 1):
            vec[i] = c
            yield from rec(i + 1, remaining - c)
        vec[i] = 0

    yield from rec(0, k)


def oracle_dispatch(
    cluster: Cluster,
    sim: BandwidthSimulator,
    tables: IntraHostTables,
    avail: Sequence[int],
    k: int,
    max_vectors: int = 200_000,
    ledger=None,
) -> Tuple[Subset, float]:
    """Exact arg max_S B(S).  Returns (subset, true_bandwidth).

    With a ``ledger`` of live jobs the argmax is taken over the
    *contention-degraded* B(S | ledger).  The per-host decomposition stays
    exact: rail contention depends only on which hosts S occupies (live
    allocations are disjoint from ``avail``), so for a fixed count vector the
    best subset still maximizes each host's intra-host bandwidth
    independently.
    """
    by_host = cluster.partition_by_host(avail)
    host_ids = sorted(by_host)
    caps = [len(by_host[h]) for h in host_ids]
    if ledger is not None:
        if not ledger.busy().isdisjoint(avail):
            raise ValueError(
                "oracle_dispatch: avail overlaps live allocations in the "
                "ledger; release (or exclude) those jobs first"
            )
        # candidates come from avail, hence GPU-disjoint from every live
        # job: freeze the per-host contender counts once instead of
        # recomputing them for each of up to max_vectors count vectors
        ledger = ledger.snapshot()
    best_bw, best_sub = -1.0, None
    n_vec = 0
    for counts in _count_vectors(caps, k):
        n_vec += 1
        if n_vec > max_vectors:
            raise RuntimeError(
                f"oracle: >{max_vectors} count vectors; cluster too large for "
                "exact search"
            )
        subset: Subset = []
        for hid, n_h in zip(host_ids, counts):
            if n_h == 0:
                continue
            locals_ = [cluster.gpu_local[g] for g in by_host[hid]]
            _, sub = tables.best_subset(hid, n_h, locals_)
            subset.extend(tables.to_globals(hid, sub))
        bw = sim.true_bandwidth(subset, ledger=ledger)
        if bw > best_bw:
            best_bw, best_sub = bw, sorted(subset)
    return best_sub, best_bw


def brute_force_oracle(
    cluster: Cluster,
    sim: BandwidthSimulator,
    avail: Sequence[int],
    k: int,
    ledger=None,
) -> Tuple[Subset, float]:
    """Reference oracle: literally enumerate C(|avail|, k).  Test-only."""
    if ledger is not None and not ledger.busy().isdisjoint(avail):
        raise ValueError(
            "brute_force_oracle: avail overlaps live allocations in the "
            "ledger; release (or exclude) those jobs first"
        )
    best_bw, best_sub = -1.0, None
    for sub in itertools.combinations(sorted(avail), k):
        bw = sim.true_bandwidth(sub, ledger=ledger)
        if bw > best_bw:
            best_bw, best_sub = bw, list(sub)
    return best_sub, best_bw
