"""Ground-truth collective-bandwidth simulator.

The paper's own heterogeneous evaluation (Sec. 5.1.1) synthesizes end-to-end
bandwidth as *"the minimum of the pre-computed intra-host bandwidths of the
involved hosts and the modeled inter-host link bandwidth"*.  We implement
exactly that bottleneck composition, with the two terms modeled as:

**Intra-host term** (per host h with n_h selected GPUs):
  - switch-fabric hosts (NVSwitch H100/A800, TPU ICI tray): uniform links, so
    aggregate bandwidth = p2p * n_h, derated to 0.82 for counts not in
    {1,2,4,8} (Li et al. [11]: NVSwitch is near-ideal only at balanced
    counts).
  - point-to-point hosts (4090/V100/A6000): NCCL builds a ring through the
    best links; we brute-force the max-bottleneck Hamiltonian cycle over the
    selected GPUs and take aggregate = bottleneck_p2p * n_h.
  The whole-collective constraint contributed by host h is
  ``C_intra(h) = k * intra_aggregate(S_h) / n_h`` (every rank of the k-way
  collective is rate-limited by the slowest host's per-GPU throughput).

**Inter-host term** (rail model): modern fabrics are rail-optimized (one NIC
rail per GPU).  Cross-host rings can only keep ``min_h n_h`` rails fully
busy; hosts with more selected GPUs funnel traffic through the partner
host's fewer rails.  With all-reduce accounting (2(k-1)/k) and a fabric
efficiency eta:

  ``C_inter = rail_bw * min_h(n_h) * 2(k-1)/k * eta``.

This reproduces the paper's Fig. 1 headline measurements on the H100 cluster
(paper -> model): 4+4: 337.2 -> 322.0; 6+2: 153.4 -> 161.0; 5+5: 412.5 ->
414.0; 8+2: 157.3 -> 165.6 GB/s — within 5% everywhere, with the *ordering*
(the thing dispatchers are graded on) exactly preserved.

``B(S) = min(min_h C_intra(h), C_inter)`` for multi-host S, else the intra
aggregate.  A deterministic +-2% per-(host,subset) jitter makes the
landscape non-degenerate (distinct optima) while remaining reproducible; an
optional Gaussian noise models nccl-tests measurement error for training
data only.

**Multi-tenant contention** (Sec. 4.4): when a :class:`~repro.core.tenancy.
JobLedger` of live jobs is supplied, each host's NIC rails are fair-shared
among the collectives crossing them.  With ``c_h`` concurrent cross-host
collectives on host h (the candidate plus every GPU-disjoint live cross-host
job occupying h), the effective per-rail bandwidth on h drops to
``rail_bw(h) / c_h`` and the inter-host term becomes

  ``C_inter = min_h(rail_bw(h) / c_h) * min_h(n_h) * 2(k-1)/k * eta``.

Intra-host terms are unaffected (NVSwitch/ring traffic stays private to the
job's own GPUs).  With an empty ledger every ``c_h`` is 1 and the expression
— including the deterministic jitter — reduces *exactly* to the isolated
``B(S)``, so releasing all co-tenants provably restores isolated bandwidth.

**Contention models.**  The fair split above is ``contention="fair"`` (the
default, bit-identical to the original fair-share behaviour).  ``contention="saturating"``
is the richer ground truth the *learned* contention subsystem trains
against: real fabrics neither split evenly nor multiplex for free.  The
candidate's share of host h's rail capacity becomes

  ``share_h = (n_h / (n_h + sum_j w_jh)) * 1 / (1 + alpha_h * (c_h - 1))``

where ``w_jh`` is contender j's GPU count on h (demand-weighted sharing: a
2-GPU tail of a cross-host job draws less rail traffic than an 8-GPU one)
and the second factor models the non-linear goodput loss of multiplexing
``c_h`` collectives through one NIC stack, with ``alpha_h`` keyed to the
host class (link heterogeneity: legacy shared-NIC hosts degrade ~2.5x
harder than modern rail-optimized fabrics).  With an empty ledger
``share_h = 1`` and the model is again *exactly* the isolated ``B(S)``.
The analytic virtual-merge estimator keeps predicting the even split — by
design: the gap between the two is what the learned surrogate absorbs
(see ``docs/contention.md``).
"""

from __future__ import annotations

import hashlib
import itertools
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.cluster import Cluster, Host, HostType, P2P_BW

# Calibration constants (see module docstring).
UNBALANCED_SWITCH_EFF = 0.82   # NVSwitch derate for counts not in {1,2,4,8}
INTER_EFF = 0.92               # fabric efficiency eta
SINGLE_GPU_BW = 500.0          # "bandwidth" of a 1-GPU allocation (no comm)
JITTER = 0.02                  # deterministic per-subset jitter amplitude
BW_SCALE = 500.0               # normalization scale for model features/targets
BALANCED_COUNTS = (1, 2, 4, 8)

# Saturating contention model (see module docstring): per-host-class
# multiplexing loss.  Modern rail-optimized fabrics (>= 25 GB/s per rail:
# H100, TPU trays) time-slice collectives with little overhead; legacy
# shared-NIC hosts pay heavily for concurrent flows.
CONTENTION_MODELS = ("fair", "saturating")
SATURATION_ALPHA_FAST = 0.08
SATURATION_ALPHA_SLOW = 0.20
_FAST_RAIL_BW = 25.0


def _stable_unit_hash(*key) -> float:
    """Deterministic hash of ``key`` -> float in [-1, 1)."""
    h = hashlib.md5(repr(key).encode()).digest()
    v = int.from_bytes(h[:8], "little") / 2**64  # [0, 1)
    return 2.0 * v - 1.0


def _jitter(*key) -> float:
    return 1.0 + JITTER * _stable_unit_hash(*key)


def ring_bottleneck_bw(host_type: HostType, local_subset: Sequence[int]) -> float:
    """Max-over-rings of the min p2p link along the ring (GB/s).

    NCCL searches for the best ring through the topology; for <=8 GPUs we can
    afford exact enumeration (fix the first element, permute the rest).
    """
    sub = tuple(sorted(local_subset))
    n = len(sub)
    if n == 1:
        return SINGLE_GPU_BW
    if n == 2:
        return host_type.p2p_bw(sub[0], sub[1])
    best = 0.0
    first = sub[0]
    for perm in itertools.permutations(sub[1:]):
        ring = (first,) + perm
        bottleneck = min(
            host_type.p2p_bw(ring[i], ring[(i + 1) % n]) for i in range(n)
        )
        if bottleneck > best:
            best = bottleneck
    return best


def intra_aggregate_bw(host_type: HostType, local_subset: Sequence[int]) -> float:
    """Aggregate effective collective bandwidth of a within-host subset."""
    n = len(local_subset)
    if n == 0:
        raise ValueError("empty subset")
    if n == 1:
        return SINGLE_GPU_BW
    if host_type.nvswitch:
        link = host_type.link(local_subset[0], local_subset[1])
        eff = 1.0 if n in BALANCED_COUNTS else UNBALANCED_SWITCH_EFF
        return P2P_BW[link] * n * eff
    return ring_bottleneck_bw(host_type, local_subset) * n


def inter_constraint_bw(
    counts: Sequence[int], rail_bw: float, k: int, eta: float = INTER_EFF
) -> float:
    """Rail-model inter-host capacity for a multi-host allocation."""
    return rail_bw * min(counts) * (2.0 * (k - 1) / k) * eta


def saturation_alpha(host_type) -> float:
    """Multiplexing-loss coefficient of a host class (link heterogeneity)."""
    return (
        SATURATION_ALPHA_FAST
        if host_type.nic_rail_bw >= _FAST_RAIL_BW
        else SATURATION_ALPHA_SLOW
    )


def saturating_rail_share(
    n_h: int, demands: Sequence[int], alpha: float
) -> float:
    """Candidate's share of one host's rail capacity under the saturating
    model: demand-weighted split times the non-linear multiplexing loss.
    No contenders -> exactly 1.0 (the isolated rail)."""
    c = 1 + len(demands)
    if c == 1:
        return 1.0
    return (n_h / (n_h + sum(demands))) / (1.0 + alpha * (c - 1))


def contended_inter_term(
    cluster, by_host: Dict[int, List[int]], rail_contenders,
    eta: float = INTER_EFF, rail_share=None, rail_factor=None,
) -> float:
    """THE jittered, fair-shared inter-host term — the single definition the
    contended ground truth and the virtual-merge estimator both evaluate, so
    the two can never drift apart.

    ``rail_contenders(host_id) -> c_h`` supplies the number of collectives
    (candidate included) competing for that host's NIC rails.  When
    ``rail_share(host_id) -> fraction`` is given (the saturating model) it
    replaces the even ``1 / c_h`` split; the default path is bit-identical
    to the historical fair split.  ``rail_factor(host_id) -> f`` is the
    health-degrade multiplier on the host's NIC rail (nic_flap /
    link_degrade faults, see :mod:`repro.core.faults`); applied to the
    rail capacity *before* contention sharing, and absent (None) on
    healthy fabric so the no-fault path is byte-identical.
    """
    counts: List[int] = []
    rail = float("inf")
    for hid, gpus in by_host.items():
        counts.append(len(gpus))
        host = cluster.hosts[hid]
        nic = host.host_type.nic_rail_bw
        if rail_factor is not None:
            nic = nic * rail_factor(hid)
        if rail_share is None:
            rail = min(rail, nic / rail_contenders(hid))
        else:
            rail = min(rail, nic * rail_share(hid))
    k = sum(counts)
    inter = inter_constraint_bw(counts, rail, k, eta=eta)
    return inter * _jitter(
        cluster.name, "inter", tuple(sorted(zip(by_host.keys(), counts)))
    )


class BandwidthSimulator:
    """Ground-truth B(S) for a :class:`Cluster` (the paper's black box).

    Also serves as the *measurement apparatus*: ``measure`` adds Gaussian
    noise emulating an nccl-tests run, ``true_bandwidth`` is noiseless and is
    what GBE is computed against.
    """

    def __init__(
        self,
        cluster: Cluster,
        noise_std: float = 0.01,
        contention: str = "fair",
    ):
        if contention not in CONTENTION_MODELS:
            raise ValueError(
                f"unknown contention model {contention!r}; "
                f"expected one of {CONTENTION_MODELS}"
            )
        self.cluster = cluster
        self.noise_std = noise_std
        self.contention = contention
        self._intra_cache: Dict[Tuple[int, Tuple[int, ...]], float] = {}

    # -- intra-host ---------------------------------------------------------

    def intra_bandwidth(
        self, host_id: int, local_subset: Sequence[int], ledger=None
    ) -> float:
        """Jittered intra-host aggregate bandwidth (per host *instance*).

        With a health-carrying ``ledger``, a degraded host scales its intra
        term by the degrade factor — applied *outside* the cache, which
        stores only the permanent (host, subset) jittered base."""
        key = (host_id, tuple(sorted(local_subset)))
        if key not in self._intra_cache:
            host = self.cluster.hosts[host_id]
            base = intra_aggregate_bw(host.host_type, key[1])
            self._intra_cache[key] = base * _jitter(
                self.cluster.name, host_id, key[1]
            )
        bw = self._intra_cache[key]
        if ledger is not None and getattr(ledger, "health_active", False):
            f = ledger.host_degrade(host_id)
            if f != 1.0:
                bw = bw * f
        return bw

    # -- end-to-end ---------------------------------------------------------

    def true_bandwidth(self, subset: Sequence[int], ledger=None) -> float:
        """Noiseless ground-truth B(S) for a global-id subset.

        When ``ledger`` (a :class:`repro.core.tenancy.JobLedger`) is given,
        the inter-host rail capacity is fair-shared with every live
        cross-host job that occupies one of S's hosts and is GPU-disjoint
        from S (see module docstring).  An empty ledger — or one whose only
        overlapping entry is S itself — yields exactly the isolated B(S).
        """
        if len(subset) == 0:
            raise ValueError("empty allocation")
        if len(set(subset)) != len(subset):
            raise ValueError(f"duplicate GPU ids in allocation: {subset}")
        # Health view (see repro.core.faults): dead GPUs produce no
        # bandwidth, degraded hosts scale both their intra term and their
        # NIC rail.  Gated on health_active so a never-faulted ledger takes
        # the exact historical float program.
        health = ledger is not None and getattr(ledger, "health_active", False)
        if health:
            gpu_health = getattr(ledger, "gpu_health", None)
            if gpu_health is not None and any(
                gpu_health(g) == "dead" for g in subset
            ):
                return 0.0
        hl = ledger if health else None
        by_host = self.cluster.partition_by_host(subset)
        k = len(subset)
        if len(by_host) == 1:
            (hid, gpus), = by_host.items()
            return self.intra_bandwidth(
                hid, self.cluster.local_tuple(hid, gpus), ledger=hl
            )
        constraints: List[float] = []
        for hid, gpus in by_host.items():
            n_h = len(gpus)
            intra = self.intra_bandwidth(
                hid, self.cluster.local_tuple(hid, gpus), ledger=hl
            )
            constraints.append(k * intra / n_h)

        def contenders(hid: int) -> int:
            if ledger is None:
                return 1
            return 1 + ledger.rail_contenders(hid, against=subset)

        rail_share = None
        if ledger is not None and self.contention == "saturating":
            def rail_share(hid: int) -> float:
                return saturating_rail_share(
                    len(by_host[hid]),
                    ledger.contender_demands(hid, against=subset),
                    saturation_alpha(self.cluster.hosts[hid].host_type),
                )

        rail_factor = ledger.host_degrade if health else None
        inter = contended_inter_term(
            self.cluster, by_host, contenders, rail_share=rail_share,
            rail_factor=rail_factor,
        )
        return min(min(constraints), inter)

    def measure(
        self,
        subset: Sequence[int],
        rng: Optional[np.random.Generator] = None,
        ledger=None,
    ) -> float:
        """One simulated nccl-tests measurement (ground truth + noise).

        With a ``ledger`` the measurement is of the *contention-degraded*
        bandwidth — what a live job's telemetry would actually report."""
        bw = self.true_bandwidth(subset, ledger=ledger)
        if rng is not None and self.noise_std > 0:
            bw *= float(1.0 + rng.normal(0.0, self.noise_std))
        return max(bw, 1e-3)

    # -- dataset generation ---------------------------------------------------

    def sample_allocations(
        self,
        n_samples: int,
        rng: np.random.Generator,
        k_range: Optional[Tuple[int, int]] = None,
        multi_host_only: bool = True,
        small_k_weight: float = 0.0,
    ) -> List[List[int]]:
        """Sparse random allocations for surrogate training (Sec. 4.1.2).

        ``multi_host_only`` mirrors the paper: intra-host combinations are
        measured exhaustively (Stage-1), so the *training set* for the
        Transformer consists of inter-host samples.

        ``small_k_weight`` oversamples small-k / near-crossover shapes (the
        ROADMAP's residual Het-VA error mode: allocations where the intra
        and inter constraints nearly cross and uniform-k sampling sees too
        few examples): with that probability, k is drawn from the bottom of
        the range (``lo .. lo+3``) instead of uniformly.  The default 0.0
        draws nothing extra from the rng, so existing seeded datasets are
        reproduced bit-for-bit.
        """
        if not 0.0 <= small_k_weight <= 1.0:
            raise ValueError("small_k_weight must be in [0, 1]")
        n = self.cluster.n_gpus
        lo, hi = k_range if k_range else (2, n)
        small_hi = min(lo + 3, hi)
        out: List[List[int]] = []
        seen = set()
        max_tries = n_samples * 50
        tries = 0
        while len(out) < n_samples and tries < max_tries:
            tries += 1
            if small_k_weight > 0.0 and rng.random() < small_k_weight:
                k = int(rng.integers(lo, small_hi + 1))
            else:
                k = int(rng.integers(lo, hi + 1))
            subset = sorted(rng.choice(n, size=k, replace=False).tolist())
            if multi_host_only and len(self.cluster.partition_by_host(subset)) < 2:
                continue
            key = tuple(subset)
            if key in seen:
                continue
            seen.add(key)
            out.append(subset)
        return out

    def build_dataset(
        self,
        n_samples: int,
        rng: np.random.Generator,
        noisy: bool = True,
        k_range: Optional[Tuple[int, int]] = None,
        small_k_weight: float = 0.0,
    ) -> List[Tuple[List[int], float]]:
        allocs = self.sample_allocations(
            n_samples, rng, k_range=k_range, small_k_weight=small_k_weight
        )
        return [
            (a, self.measure(a, rng if noisy else None)) for a in allocs
        ]
