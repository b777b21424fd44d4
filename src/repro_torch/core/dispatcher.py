"""BandPilot dispatching service + evaluation harnesses (Secs. 4.1, 4.4, 5.3).

Two layers:

* **Service** — every dispatcher is stateful: it owns a
  :class:`~repro.core.tenancy.JobLedger` and exposes an
  ``admit(job_id, k)`` / ``release(job_id)`` lifecycle.  Availability is
  derived from the ledger, and BandPilot's search runs against a
  contention-aware predictor (the virtual-merge wrapper of
  :mod:`repro.core.contention`) so placements route around live cross-host
  tenants.  The legacy pure ``dispatch(avail, k)`` remains for single-shot
  use — with an empty ledger the two are identical.

* **Harnesses** — ``evaluate_dispatchers`` reproduces the paper's
  single-request GBE protocol (Sec. 5.3); ``replay_trace`` is the
  multi-tenant protocol: seeded Poisson arrivals with sampled durations
  stream through a dispatcher, and every admission is graded with
  contention-degraded GBE against the ledger-aware exact Oracle.  The
  queue/clock now live in :mod:`repro.core.scheduler` (pluggable admission
  policies); ``replay_trace`` is a thin wrapper over it with the ``fifo``
  policy, which reproduces the legacy records bit-for-bit.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core import baselines, forensics, search, telemetry
from repro_torch.core.bandwidth_sim import BandwidthSimulator
from repro_torch.core.cluster import Cluster, availability_scenario
from repro_torch.core.contention import ContentionAwarePredictor
from repro_torch.core.intra_host import IntraHostTables
from repro_torch.core.predict_cache import (
    PredictionCache,
    PredictorStats,
    collect_stats,
)
from repro_torch.core.scheduler import (  # re-exported: the public trace surface
    AdmissionScheduler,
    SchedulerConfig,
    TenantRecord,
    TraceJob,
    poisson_trace,
    summarize_trace,
)
from repro_torch.core.surrogate import SurrogatePredictor
from repro_torch.core.tenancy import (  # typed admit errors re-exported here
    Allocation,
    CapacityError,
    InvalidPlacementError,
    JobLedger,
)

Subset = List[int]

__all__ = [  # keeps `from repro.core.dispatcher import TraceJob, ...` valid
    "AdmissionScheduler", "SchedulerConfig", "TenantRecord", "TraceJob",
    "poisson_trace", "summarize_trace", "replay_trace",
    "BandPilotDispatcher", "BaselineDispatcher", "DispatcherService",
    "CapacityError", "InvalidPlacementError",
    "GroundTruthPredictor", "EvalRecord", "evaluate_dispatchers",
    "summarize", "gbe_by_k", "bw_loss_by_k", "compare_contention_awareness",
]


class GroundTruthPredictor:
    """Predictor view over the true B(S) — powers Ideal-BP and the Oracle
    comparisons (isolates search quality from surrogate error)."""

    def __init__(self, sim: BandwidthSimulator):
        self.sim = sim
        self.stats = PredictorStats()

    @property
    def n_model_calls(self) -> int:
        return self.stats.n_model_calls

    @n_model_calls.setter
    def n_model_calls(self, v: int) -> None:
        self.stats.n_model_calls = v

    @property
    def predict_seconds(self) -> float:
        return self.stats.predict_seconds

    @predict_seconds.setter
    def predict_seconds(self, v: float) -> None:
        self.stats.predict_seconds = v

    def predict(self, subsets: Sequence[Sequence[int]]) -> np.ndarray:
        t0 = time.time()
        out = np.asarray([self.sim.true_bandwidth(s) for s in subsets])
        self.stats.predict_seconds += time.time() - t0
        self.stats.n_model_calls += len(subsets)
        return out


class DispatcherService:
    """Stateful lifecycle shared by every dispatcher.

    Subclasses implement the placement policy as ``dispatch(avail, k)``;
    this base turns it into a long-lived service over a job ledger.
    """

    name = "Dispatcher"
    needs_rng = False  # True when dispatch() requires an rng (Random baseline)

    def __init__(self, cluster: Cluster):
        self.cluster = cluster
        self.ledger = JobLedger(cluster)
        # Optional telemetry sink (repro.core.contended_dataset.
        # TelemetryHarvester): measured bandwidths reported by live jobs are
        # recorded with their co-tenant context for online fine-tuning.
        self.harvester = None

    def dispatch(self, avail: Sequence[int], k: int, rng=None) -> Subset:
        raise NotImplementedError

    def report_bandwidth(self, job_id: str, bw: float) -> Optional[Allocation]:
        """Production telemetry entry point: a live job reports the
        collective bandwidth it actually measured.  Forwarded (with the
        job's current co-tenant ledger context) to the attached harvester;
        a no-op sink otherwise.  Returns the job's allocation, or None for
        a stale report (job already released — an ordinary race between a
        job's last measurement and its departure; the sample is dropped
        because its co-tenant context is gone).

        The lookup is a single atomic ``ledger.get`` — the historical
        ``in`` + ``allocation()`` pair was a TOCTOU that turns into a real
        KeyError once releases commit concurrently — and the harvest runs
        under the ledger lock so the co-tenant snapshot it records belongs
        to the same version as the allocation it saw."""
        with self.ledger.lock:
            alloc = self.ledger.get(job_id)
            if alloc is None:
                return None
            if self.harvester is not None:
                # job_id lets an attached DriftMonitor pair this realized
                # measurement with the B-hat stamped at admission
                self.harvester.observe(
                    self.ledger, alloc.gpus, bw,
                    job_id=job_id, source="report",
                )
        return alloc

    def admit(self, job_id: str, k: int, rng=None,
              tenant: str = "") -> Allocation:
        """Place a k-GPU job on currently-free GPUs and record it live.

        ``tenant`` tags the allocation (and its journal line) for
        per-tenant accounting — forensics regret, QoS — without affecting
        placement.

        Raises :class:`CapacityError` (queueable: retry at the next
        release) when too few GPUs are free, and
        :class:`InvalidPlacementError` (a policy bug: crash loudly, never
        queue) when the policy returns a subset violating the request.
        Both subclass ValueError, so legacy catch sites keep working.
        """
        avail = self.ledger.available()
        if k > len(avail):
            raise CapacityError(
                f"admit({job_id!r}, k={k}): only {len(avail)} GPUs free"
            )
        subset = self.dispatch(avail, k, rng=rng)
        if len(subset) != k or not set(subset) <= set(avail):
            raise InvalidPlacementError(
                f"{self.name} returned an invalid allocation for k={k}: "
                f"{subset}"
            )
        return self.ledger.admit(job_id, subset, tenant=tenant)

    def release(self, job_id: str) -> Allocation:
        """Free a live job's GPUs."""
        return self.ledger.release(job_id)


class BandPilotDispatcher(DispatcherService):
    """The full system: hierarchical surrogate + hybrid EHA/PTS search.

    ``contention_aware=True`` (default) wraps the predictor with the
    virtual-merge estimator, so ``admit`` degrades candidate scores by the
    fair-share rail capacity left next to live cross-host tenants.
    ``contention_mode="learned"`` (with a trained ``contended_predictor``)
    swaps the analytic cap for the ContendedSurrogate, so the search ranks
    candidates by *learned* contended bandwidth.  With an empty ledger both
    wrappers are an exact no-op, so single-shot ``dispatch`` behaviour (and
    the Sec. 5.3 harness) is unchanged.

    ``frag_weight > 0`` additionally applies the fragmentation tie-break
    (:func:`repro.core.defrag.make_frag_penalty`) to every search this
    dispatcher runs — near-equal candidates prefer topping up partially
    busy hosts over cracking open clean ones, keeping large blocks intact
    for future arrivals.  The default 0.0 is bit-identical to the previous
    behaviour.

    ``cache=True`` (the default) enables the dispatch fast path's
    prediction memo (:mod:`repro.core.predict_cache`): isolated B̂(S) —
    ledger-independent while the params are fixed — is memoized for the
    service lifetime, and contention-degraded scores are memoized per
    ledger version, so re-scoring the same subset within an admission is
    free and any admit/release invalidates by construction.  Cached values
    are stored predictor outputs, so subset selection is bit-identical with
    the cache on or off (regression-pinned in ``tests/test_fast_path.py``).

    ``aot_warm=True`` (the default) AOT-compiles the on-device elimination
    scan's hot shape buckets at construction (``warm_scan`` on the raw
    predictor, when present), eliminating the first-admission compile
    spike; the wall time spent is recorded in ``aot_warm_seconds`` so the
    throughput bench can report cold-start separately from warm latency.
    """

    def __init__(
        self,
        cluster: Cluster,
        tables: IntraHostTables,
        predictor,
        name: str = "BandPilot",
        contention_aware: bool = True,
        contention_mode: str = "analytic",
        contended_predictor=None,
        frag_weight: float = 0.0,
        cache: bool = True,
        aot_warm: bool = True,
    ):
        super().__init__(cluster)
        self.tables = tables
        self.raw_predictor = predictor
        self.contention_aware = contention_aware
        self.contention_mode = contention_mode
        self.contended_predictor = contended_predictor
        self.frag_weight = frag_weight
        self.iso_cache: Optional[PredictionCache] = None
        self.prediction_cache: Optional[PredictionCache] = None
        if cache:
            self.iso_cache = PredictionCache()  # ledger-independent memo
            predictor = self.iso_cache.wrap(
                predictor, mode="isolated", versioned=False
            )
        # base_predictor is what joint search / defrag proposers re-wrap per
        # scratch ledger: keeping the isolated memo inside it shares the
        # expensive inference across orders, trials, and passes.
        self.base_predictor = predictor
        if contention_aware:
            self.contention_predictor = ContentionAwarePredictor(
                cluster, predictor, self.ledger,
                mode=contention_mode, contended=contended_predictor,
            )
            if cache:
                self.prediction_cache = PredictionCache(self.ledger)
                self.predictor = self.prediction_cache.wrap(
                    self.contention_predictor, mode=contention_mode
                )
            else:
                self.predictor = self.contention_predictor
        else:
            self.predictor = predictor
        self.name = name
        self.last_result: Optional[search.HybridResult] = None
        # AOT-compile the on-device elimination scan's hot (bucket, H)
        # shapes now, at construction, so the first admission pays warm
        # per-descent latency instead of an XLA compile spike.  Predictors
        # without a scan path (naive featurizer, ground truth) expose no
        # ``warm_scan`` and skip this.
        self.aot_warm_seconds = 0.0
        if aot_warm:
            warm = getattr(self.raw_predictor, "warm_scan", None)
            if warm is not None:
                self.aot_warm_seconds = warm()

    def predictor_stats(self) -> PredictorStats:
        """Merged instrumentation across the dispatcher's predictor chain
        (cache wrappers, contention wrapper, base model) — what the
        benchmarks report per configuration."""
        return collect_stats(
            self.predictor, self.base_predictor,
            getattr(self, "contended_predictor", None),
        )

    def dispatch(self, avail: Sequence[int], k: int, rng=None) -> Subset:
        with telemetry.span(
            "dispatcher.dispatch", k=k, n_avail=len(avail),
            mode=self.contention_mode if self.contention_aware else "off",
        ) as sp:
            before = self.predictor_stats() if sp else None
            penalty = None
            if self.frag_weight > 0:
                from repro_torch.core.defrag import make_frag_penalty

                penalty = make_frag_penalty(
                    self.cluster, self.ledger, self.frag_weight
                )
            res = search.hybrid_search(
                self.cluster, self.tables, self.predictor, avail, k,
                frag_penalty=penalty,
            )
            self.last_result = res
            df = forensics.draft()
            if df is not None:  # post-selection: cannot alter the choice
                df.note_decomposition(forensics.bandwidth_decomposition(
                    self.cluster, self.tables, self.ledger, res.subset,
                    self.base_predictor,
                    predicted_bw=float(res.predicted_bw),
                    contention_mode=(
                        self.contention_mode if self.contention_aware
                        else "off"
                    ),
                ))
            if sp:
                after = self.predictor_stats()
                sp["winner"] = res.winner
                sp["predicted_bw"] = res.predicted_bw
                sp["cache_hits"] = after.cache_hits - before.cache_hits
                sp["cache_misses"] = after.cache_misses - before.cache_misses
                sp["n_capped"] = after.n_capped - before.n_capped
                sp["n_model_calls"] = (
                    after.n_model_calls - before.n_model_calls
                )
                sp["n_scan_steps"] = after.n_scan_steps - before.n_scan_steps
            return res.subset


class BaselineDispatcher(DispatcherService):
    def __init__(self, cluster: Cluster, kind: str):
        super().__init__(cluster)
        self.name = {"random": "Random", "default": "Default", "topo": "Topo"}[kind]
        self.kind = kind
        self.needs_rng = kind == "random"

    def dispatch(self, avail: Sequence[int], k: int, rng=None) -> Subset:
        if self.kind == "random":
            if rng is None:
                raise ValueError("Random dispatcher needs an rng")
            return baselines.random_dispatch(self.cluster, avail, k, rng)
        if self.kind == "default":
            return baselines.default_dispatch(self.cluster, avail, k)
        return baselines.topo_dispatch(self.cluster, avail, k)


# ---------------------------------------------------------------------------
# Evaluation harness (Sec. 5.3 protocol)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class EvalRecord:
    dispatcher: str
    k: int
    scenario: int
    gbe: float
    bw: float
    optimal_bw: float
    seconds: float


def evaluate_dispatchers(
    cluster: Cluster,
    sim: BandwidthSimulator,
    tables: IntraHostTables,
    dispatchers: Sequence,
    request_sizes: Optional[Sequence[int]] = None,
    n_scenarios: int = 50,
    seed: int = 0,
) -> List[EvalRecord]:
    """For every request size and availability scenario, run each dispatcher
    and grade it with GBE against the exact Oracle."""
    rng = np.random.default_rng(seed)
    if request_sizes is None:
        request_sizes = range(1, cluster.n_gpus + 1)
    records: List[EvalRecord] = []
    for k in request_sizes:
        for s in range(n_scenarios):
            avail = availability_scenario(cluster, rng)
            if len(avail) < k:
                avail = cluster.all_gpus()  # k must be satisfiable
            _, opt_bw = baselines.oracle_dispatch(cluster, sim, tables, avail, k)
            for d in dispatchers:
                t0 = time.time()
                subset = d.dispatch(avail, k, rng=rng)
                dt = time.time() - t0
                assert len(subset) == k and set(subset) <= set(avail), (
                    f"{d.name} returned invalid allocation"
                )
                bw = sim.true_bandwidth(subset)
                records.append(
                    EvalRecord(d.name, k, s, bw / opt_bw, bw, opt_bw, dt)
                )
    return records


def summarize(records: Sequence[EvalRecord]) -> Dict[str, Dict[str, float]]:
    """-> {dispatcher: {mean_gbe, mean_bw_loss, mean_seconds}} (Table 2)."""
    out: Dict[str, Dict[str, float]] = {}
    names = sorted({r.dispatcher for r in records})
    for name in names:
        rs = [r for r in records if r.dispatcher == name]
        out[name] = {
            "mean_gbe": float(np.mean([r.gbe for r in rs])),
            "mean_bw_loss": float(np.mean([r.optimal_bw - r.bw for r in rs])),
            "mean_seconds": float(np.mean([r.seconds for r in rs])),
            "n": len(rs),
        }
    return out


def gbe_by_k(records: Sequence[EvalRecord]) -> Dict[str, Dict[int, float]]:
    """-> {dispatcher: {k: mean_gbe}} (Fig. 6 curves)."""
    out: Dict[str, Dict[int, float]] = {}
    for r in records:
        out.setdefault(r.dispatcher, {}).setdefault(r.k, []).append(r.gbe)
    return {
        name: {k: float(np.mean(v)) for k, v in sorted(ks.items())}
        for name, ks in out.items()
    }


def bw_loss_by_k(records: Sequence[EvalRecord]) -> Dict[str, Dict[int, float]]:
    """-> {dispatcher: {k: mean bandwidth loss vs oracle}} (Fig. 7)."""
    out: Dict[str, Dict[int, List[float]]] = {}
    for r in records:
        out.setdefault(r.dispatcher, {}).setdefault(r.k, []).append(
            r.optimal_bw - r.bw
        )
    return {
        name: {k: float(np.mean(v)) for k, v in sorted(ks.items())}
        for name, ks in out.items()
    }


# ---------------------------------------------------------------------------
# Multi-tenant trace harness (Sec. 4.4 protocol)
# ---------------------------------------------------------------------------
# TraceJob / TenantRecord / poisson_trace / summarize_trace live in
# repro.core.scheduler (imported above); replay_trace remains here as the
# legacy entry point.

def replay_trace(
    cluster: Cluster,
    sim: BandwidthSimulator,
    tables: IntraHostTables,
    dispatcher: DispatcherService,
    trace: Sequence[TraceJob],
    rng: Optional[np.random.Generator] = None,
    config: Optional[SchedulerConfig] = None,
) -> List[TenantRecord]:
    """Stream a trace through one dispatcher service, grading each admission.

    Thin wrapper over :class:`repro.core.scheduler.AdmissionScheduler`.  The
    default ``fifo`` config reproduces the historical behaviour bit-for-bit
    (regression-pinned in ``tests/test_scheduler.py``): arrivals in time
    order, departures release GPUs, jobs that do not fit wait in a FIFO
    queue (head-of-line) and are admitted at the release that frees enough
    capacity.  Pass a :class:`SchedulerConfig` for backfill/batched queue
    policies or release-time re-dispatch.
    """
    sched = AdmissionScheduler(
        cluster, sim, tables, dispatcher, config=config, rng=rng
    )
    return sched.run(trace)


def compare_contention_awareness(
    cluster: Cluster,
    sim: BandwidthSimulator,
    tables: IntraHostTables,
    predictor_factory: Callable[[], object],
    trace: Sequence[TraceJob],
    seed: int = 0,
    name: str = "BandPilot",
    include_baselines: bool = True,
) -> Dict[str, List[TenantRecord]]:
    """Replay one trace through contention-aware vs -oblivious BandPilot plus
    (optionally) the three baselines (fresh rng per replay: identical
    arrivals, identical randomness).  -> {variant name: records}."""
    out: Dict[str, List[TenantRecord]] = {}
    variants: List[DispatcherService] = [
        BandPilotDispatcher(
            cluster, tables, predictor_factory(), name=name,
            contention_aware=True,
        ),
        BandPilotDispatcher(
            cluster, tables, predictor_factory(), name=f"{name}-oblivious",
            contention_aware=False,
        ),
    ]
    if include_baselines:
        variants += [
            BaselineDispatcher(cluster, "topo"),
            BaselineDispatcher(cluster, "default"),
            BaselineDispatcher(cluster, "random"),
        ]
    for disp in variants:
        rng = np.random.default_rng(seed)
        out[disp.name] = replay_trace(cluster, sim, tables, disp, trace, rng=rng)
    return out
