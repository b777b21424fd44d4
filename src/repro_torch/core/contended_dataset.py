"""Contended training data for the learned-contention subsystem.

The Stage-2 surrogate of the paper learns isolated bandwidth from sparse
nccl-tests measurements; the ROADMAP's contention-aware-surrogate item asks
for the same trick under tenancy: train on **(subset, ledger, contended
bandwidth)** triples so the model absorbs the rail split the analytic
virtual-merge cap only approximates.  Two generators live here:

* **Synthetic sampling** (`build_contended_dataset` / `make_contended_split`):
  sample multi-host candidate allocations exactly like the isolated
  protocol, pair each with a randomly sampled co-tenant ledger
  (`sample_cotenant_ledger` — GPU-disjoint jobs biased toward the
  candidate's own hosts so rails actually contend), and measure
  ``BandwidthSimulator.true_bandwidth(S, ledger)`` (plus nccl-tests noise
  for training targets).

* **Telemetry harvesting** (`TelemetryHarvester` / `harvest_trace`): record
  the contention-degraded bandwidths live admissions actually observe —
  the :class:`~repro.core.scheduler.AdmissionScheduler` feeds every graded
  admission to an attached harvester, and a production
  ``DispatcherService`` forwards job-reported measurements through
  ``report_bandwidth``.  Harvested triples drive
  :func:`repro.core.training.online_finetune_contended` — the paper's
  Sec. 4.1.2 online-adaptation loop, now contended.

A sample stores its co-tenants as a tuple of GPU tuples (``cotenants``), not
a live :class:`~repro.core.tenancy.JobLedger`: samples are picklable,
hashable (dedupable) and independent of ledger mutation.
``materialize_ledger`` / ``to_triples`` rebuild ledgers for featurization.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.bandwidth_sim import BandwidthSimulator
from repro_torch.core.cluster import Cluster
from repro_torch.core.tenancy import JobLedger

Cotenants = Tuple[Tuple[int, ...], ...]


@dataclasses.dataclass(frozen=True)
class ContendedSample:
    """One (subset, co-tenant ledger, contended bandwidth) observation."""

    subset: Tuple[int, ...]
    cotenants: Cotenants  # GPU tuples of live jobs disjoint from subset
    bw: float             # contended bandwidth (GB/s; possibly noisy)

    @property
    def key(self) -> Tuple:
        """Dedup/split key: the (subset, ledger) configuration."""
        return (self.subset, tuple(sorted(self.cotenants)))

    @property
    def contended(self) -> bool:
        return bool(self.cotenants)


def materialize_ledger(cluster: Cluster, cotenants: Cotenants) -> JobLedger:
    """Rebuild a live ledger from a sample's co-tenant GPU tuples."""
    ledger = JobLedger(cluster)
    for i, gpus in enumerate(cotenants):
        ledger.admit(f"ct-{i:03d}", gpus)
    return ledger


def to_triples(
    cluster: Cluster, samples: Sequence[ContendedSample]
) -> List[Tuple[List[int], Optional[JobLedger], float]]:
    """-> (subset, ledger-or-None, bw) triples for the training/eval APIs."""
    return [
        (
            list(s.subset),
            materialize_ledger(cluster, s.cotenants) if s.cotenants else None,
            s.bw,
        )
        for s in samples
    ]


# ---------------------------------------------------------------------------
# Synthetic co-tenant sampling
# ---------------------------------------------------------------------------

def sample_cotenant_ledger(
    cluster: Cluster,
    rng: np.random.Generator,
    exclude: Sequence[int] = (),
    max_cotenants: int = 3,
    focus_hosts: Sequence[int] = (),
    cross_bias: float = 0.75,
) -> List[Tuple[int, ...]]:
    """Sample up to ``max_cotenants`` pairwise GPU-disjoint co-tenant jobs,
    all disjoint from ``exclude`` (the candidate).

    ``cross_bias`` of the jobs span two hosts (the rail-contending kind),
    preferring hosts in ``focus_hosts`` so the sampled ledger usually
    contends with the candidate rather than idling on far hosts; the rest
    are single-host (they only move the occupancy channel).
    """
    busy = set(exclude)
    jobs: List[Tuple[int, ...]] = []
    n_jobs = int(rng.integers(0, max_cotenants + 1))
    focus = set(focus_hosts)
    for _ in range(n_jobs):
        by_host: Dict[int, List[int]] = {
            h.host_id: [g for g in h.gpu_ids if g not in busy]
            for h in cluster.hosts
        }
        nonempty = [h for h, gs in by_host.items() if gs]
        if not nonempty:
            break
        if len(nonempty) >= 2 and rng.random() < cross_bias:
            focused = [h for h in nonempty if h in focus]
            h1 = int(rng.choice(focused if focused else nonempty))
            others = [h for h in nonempty if h != h1]
            focused2 = [h for h in others if h in focus]
            h2 = int(rng.choice(focused2 if focused2 else others))
            gpus: List[int] = []
            for h in (h1, h2):
                n_h = int(rng.integers(1, min(4, len(by_host[h])) + 1))
                gpus.extend(
                    int(g) for g in rng.choice(by_host[h], n_h, replace=False)
                )
        else:
            h = int(rng.choice(nonempty))
            n_h = int(rng.integers(1, min(4, len(by_host[h])) + 1))
            gpus = [
                int(g) for g in rng.choice(by_host[h], n_h, replace=False)
            ]
        job = tuple(sorted(gpus))
        jobs.append(job)
        busy.update(job)
    return jobs


def build_contended_dataset(
    sim: BandwidthSimulator,
    n_samples: int,
    rng: np.random.Generator,
    isolated_frac: float = 0.25,
    noisy: bool = True,
    max_cotenants: int = 3,
    k_range: Optional[Tuple[int, int]] = None,
) -> List[ContendedSample]:
    """The curriculum: multi-host candidates, ``isolated_frac`` of them with
    an empty ledger (anchoring the zero-context behaviour), the rest paired
    with a sampled co-tenant ledger and measured against it."""
    cluster = sim.cluster
    subsets = sim.sample_allocations(n_samples, rng, k_range=k_range)
    out: List[ContendedSample] = []
    for s in subsets:
        if rng.random() < isolated_frac:
            cot: Cotenants = ()
        else:
            cot = tuple(sample_cotenant_ledger(
                cluster, rng, exclude=s, max_cotenants=max_cotenants,
                focus_hosts=sorted(cluster.partition_by_host(s)),
            ))
        ledger = materialize_ledger(cluster, cot) if cot else None
        bw = sim.measure(s, rng if noisy else None, ledger=ledger)
        out.append(ContendedSample(tuple(sorted(s)), cot, float(bw)))
    return out


def make_contended_split(
    sim: BandwidthSimulator,
    n_train: int,
    test_mult: int = 2,
    seed: int = 0,
    **kwargs,
) -> Tuple[List[ContendedSample], List[ContendedSample]]:
    """Train/held-out split over (subset, ledger) configurations.

    Mirrors the isolated protocol: noisy training targets, *noiseless* test
    targets, and the held-out set disjoint from training in the full
    (subset, co-tenant ledger) key."""
    rng = np.random.default_rng(seed)
    total = build_contended_dataset(
        sim, n_train * (test_mult + 1), rng, noisy=True, **kwargs
    )
    seen = set()
    unique = []
    for s in total:
        if s.key not in seen:
            seen.add(s.key)
            unique.append(s)
    train = unique[:n_train]
    test = [
        dataclasses.replace(
            s,
            bw=sim.true_bandwidth(
                list(s.subset),
                ledger=materialize_ledger(sim.cluster, s.cotenants)
                if s.cotenants else None,
            ),
        )
        for s in unique[n_train:]
    ]
    return train, test


# ---------------------------------------------------------------------------
# Telemetry harvesting (online adaptation under tenancy)
# ---------------------------------------------------------------------------

class TelemetryHarvester:
    """Collects contended-bandwidth observations from live admissions.

    Attach one to an :class:`~repro.core.scheduler.AdmissionScheduler`
    (``harvester=...``) to capture every graded admission, or to a
    ``DispatcherService`` (``service.harvester = h``) so job-reported
    measurements flow in via ``service.report_bandwidth(job_id, bw)``.
    Keeps at most ``max_samples`` (most recent — telemetry freshness is the
    point of the online loop).

    The harvester is also the drift tap: pass a
    :class:`~repro.core.telemetry.DriftMonitor` as ``drift=`` and every
    observation that carries a ``predicted`` B-hat (the scheduler's grading
    path) or a ``job_id`` with a previously-stamped prediction (the
    ``report_bandwidth`` path) is forwarded to the monitor — one
    observation pipeline, two consumers.
    """

    def __init__(
        self,
        cluster: Cluster,
        max_samples: int = 4096,
        drift: Optional["object"] = None,
    ):
        self.cluster = cluster
        self.max_samples = max_samples
        self.samples: List[ContendedSample] = []
        self.n_observed = 0  # lifetime count (before the ring-buffer trim)
        self.drift = drift   # optional repro.core.telemetry.DriftMonitor

    def __len__(self) -> int:
        return len(self.samples)

    def observe(
        self,
        ledger: JobLedger,
        subset: Sequence[int],
        bw: float,
        *,
        job_id: str = "",
        predicted: Optional[float] = None,
        tenant: str = "",
        t: float = 0.0,
        source: str = "grade",
    ) -> ContendedSample:
        """Record one observation: the co-tenant spec is every live job
        GPU-disjoint from ``subset`` (the job's own ledger entry, when it is
        already admitted, self-excludes by overlap — same predicate as the
        contended ground truth).

        Keyword-only extras feed the attached drift monitor: ``predicted``
        is the B-hat the admission committed on (grading path), or None to
        resolve through the monitor's pending map by ``job_id``
        (``report_bandwidth`` path)."""
        sset = set(subset)
        cot = tuple(
            a.gpus
            for a in sorted(ledger.jobs(), key=lambda a: a.job_id)
            if sset.isdisjoint(a.gpus)
        )
        sample = ContendedSample(tuple(sorted(subset)), cot, float(bw))
        self.samples.append(sample)
        self.n_observed += 1
        if len(self.samples) > self.max_samples:
            del self.samples[: len(self.samples) - self.max_samples]
        if self.drift is not None:
            from repro_torch.core.telemetry import snapshot_digest

            self.drift.observe(
                float(bw), job_id=job_id, subset=tuple(sorted(subset)),
                predicted=predicted,
                digest=snapshot_digest(ledger, subset),
                tenant=tenant, t=t, source=source,
            )
        return sample

    def triples(self) -> List[Tuple[List[int], Optional[JobLedger], float]]:
        """Materialized (subset, ledger, bw) triples for (fine-)tuning."""
        return to_triples(self.cluster, self.samples)

    def clear(self) -> None:
        self.samples.clear()


def harvest_trace(
    cluster: Cluster,
    sim: BandwidthSimulator,
    tables,
    dispatcher,
    trace,
    rng: Optional[np.random.Generator] = None,
    config=None,
    harvester: Optional[TelemetryHarvester] = None,
):
    """Replay a trace with a harvester attached; -> (records, harvester).

    Convenience wrapper over the admission scheduler: the returned harvester
    holds one contended observation per admission, ready for
    :func:`repro.core.training.online_finetune_contended`."""
    from repro_torch.core.scheduler import AdmissionScheduler

    if harvester is None:
        harvester = TelemetryHarvester(cluster)
    sched = AdmissionScheduler(
        cluster, sim, tables, dispatcher, config=config, rng=rng,
        harvester=harvester,
    )
    records = sched.run(trace)
    return records, harvester
