"""Event-driven admission scheduler: queue policies over the dispatch service.

The dispatch service made dispatching stateful (``DispatcherService`` over a
:class:`~repro.core.tenancy.JobLedger`), but the trace harness still admitted
strictly FIFO: one job at a time against a stale ledger, with head-of-line
blocking.  This module owns the queue and the clock — the event loop that
used to be hard-coded inside ``replay_trace`` — and makes the admission
*policy* pluggable:

* ``fifo`` — bit-for-bit the legacy behaviour: arrivals admit in order, a
  job that does not fit blocks everything behind it (regression-pinned in
  ``tests/test_scheduler.py``).
* ``backfill`` — smaller waiting jobs may overtake a blocked job, guarded
  by an **aging bound**: every overtake increments the skipped jobs'
  counters, and a job whose counter reaches ``aging_limit`` becomes a hard
  fence that nothing behind it may pass, so nothing starves.
* ``batched`` — arrivals within ``batch_window`` of each other form a
  batch.  Batches drain strictly FIFO, but *within* the head batch jobs may
  be selected and placed **jointly** (``search.joint_hybrid_search``): the
  batch is ordered, a scratch ledger is threaded through per-job hybrid
  searches so each placement sees its batch-mates as live co-tenants, and
  the order with the best total contention-degraded estimate wins.  A job
  arriving to spare capacity with an empty queue is never held back, so the
  window costs no latency; with ``batch_window=0`` every batch is a
  singleton placed in arrival order and the policy degenerates to ``fifo``
  exactly.

On every ``release`` the scheduler can additionally run an **elastic
re-dispatch hook** (``redispatch=True``): among the live cross-host jobs it
re-places the one whose contention-degraded bandwidth would improve the
most, charged with a migration-cost term (``migration_cost``, shared with
:mod:`repro.ft.elastic`), and only if no other live job's degraded
bandwidth drops.  A declined move restores the exact prior placement.
The trial-move machinery (gain rule, no-harm check, exact ledger restore)
lives in :mod:`repro.core.defrag` and is shared with the **defragmentation
triggers** (``defrag=True``): a rate-limited background consolidation pass
at release time plus an on-demand make-room pass when an admission would
otherwise be forced into a cross-host rail-contended placement that a
cheap consolidation could avoid (see ``docs/defrag.md``).

``repro.core.dispatcher.replay_trace`` is now a thin wrapper over this
module with the ``fifo`` policy.
"""

from __future__ import annotations

import dataclasses
import heapq
import math
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import (
    baselines,
    defrag as defrag_mod,
    faults as faults_mod,
    forensics,
    search,
    telemetry,
)
from repro_torch.core.bandwidth_sim import BandwidthSimulator
from repro_torch.core.cluster import Cluster
from repro_torch.core.controlplane import TenantPolicy  # per-tenant QoS rows
from repro_torch.core.defrag import (  # shared migration economics (moved there)
    DefragConfig,
    migration_cost,
)
from repro_torch.core.intra_host import IntraHostTables
from repro_torch.core.predict_cache import GradingCache, InferenceBatcher
from repro_torch.core.tenancy import Allocation, InvalidPlacementError, JobLedger

Subset = List[int]

POLICIES = ("fifo", "backfill", "batched")


# ---------------------------------------------------------------------------
# Trace model (moved here from dispatcher.py; re-exported there)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TraceJob:
    """One job of a tenancy trace: arrives, holds k GPUs, departs.

    ``tenant`` attributes the job to a QoS policy row
    (``SchedulerConfig(tenant_policies=...)``); the default "" tenant has
    no policy, so legacy traces behave exactly as before."""

    job_id: str
    arrival: float
    duration: float
    k: int
    tenant: str = ""


@dataclasses.dataclass
class TenantRecord:
    """Grading of one admission under the live ledger at admit time."""

    dispatcher: str
    job_id: str
    k: int
    t_admit: float
    wait: float            # t_admit - arrival (queueing delay)
    gbe: float             # contention-degraded B(S) / B(S*_ledger)
    bw: float              # contention-degraded B(S | ledger)
    isolated_bw: float     # B(S) with co-tenants ignored
    optimal_bw: float      # ledger-aware exact-Oracle bandwidth
    n_live: int            # live jobs at admit time (excl. this one)
    n_contended_hosts: int  # hosts where S's rails are shared (0 unless S is
    #                         cross-host: single-host jobs never touch a NIC)
    # -- queue-policy fields (defaults keep legacy constructions valid) -----
    policy: str = "fifo"   # admission policy that placed this job
    overtakes: int = 0     # waiting jobs this admission jumped ahead of
    batch_size: int = 1    # jobs co-admitted in the same joint flush
    migrations: int = 0    # times this job was re-placed while live
    # -- fragmentation state right after this admission (defrag metrics) ----
    stranding: float = 0.0  # fraction of free GPUs on partially-busy hosts
    clean_hosts: int = 0    # fully-free hosts left after this admission
    # -- observability: the B-hat the search committed on (NaN for baseline
    #    dispatchers that place without a predictor) — paired with ``bw`` by
    #    the drift flight recorder (docs/observability.md)
    predicted_bw: float = float("nan")

    def to_dict(self) -> Dict[str, float]:
        return dataclasses.asdict(self)


def poisson_trace(
    cluster: Cluster,
    n_jobs: int,
    rng: np.random.Generator,
    mean_interarrival: float = 1.0,
    mean_duration: float = 4.0,
    k_choices: Optional[Sequence[int]] = None,
) -> List[TraceJob]:
    """Seeded Poisson arrival process with exponential durations.

    ``k_choices`` defaults to 2..max(n_gpus/2, 3), clamped to the cluster
    size: large enough that placements regularly span hosts (the
    contention-relevant regime) while — on the paper-scale clusters —
    several jobs fit concurrently.  Pass explicit ``k_choices`` on clusters
    below ~6 GPUs, where the default load serializes.
    """
    if k_choices is None:
        hi = min(max(cluster.n_gpus // 2, 3), cluster.n_gpus)
        k_choices = range(min(2, hi), hi + 1)
    k_choices = list(k_choices)
    if max(k_choices) > cluster.n_gpus:
        raise ValueError("k_choices exceed cluster size")
    jobs: List[TraceJob] = []
    t = 0.0
    for i in range(n_jobs):
        t += float(rng.exponential(mean_interarrival))
        dur = max(float(rng.exponential(mean_duration)), 1e-3)
        k = int(k_choices[rng.integers(len(k_choices))])
        jobs.append(TraceJob(f"job-{i:04d}", t, dur, k))
    return jobs


def summarize_trace(
    records: Sequence[TenantRecord],
) -> Dict[str, Dict[str, float]]:
    """-> {dispatcher: mean contention-degraded GBE / bw / wait / contention
    + the queue-policy fields (overtakes, batch size, migrations)}."""
    out: Dict[str, Dict[str, float]] = {}
    for name in sorted({r.dispatcher for r in records}):
        rs = [r for r in records if r.dispatcher == name]
        contended = [r for r in rs if r.n_contended_hosts > 0]
        out[name] = {
            "mean_gbe": float(np.mean([r.gbe for r in rs])),
            "mean_bw": float(np.mean([r.bw for r in rs])),
            "mean_degradation": float(
                np.mean([1.0 - r.bw / r.isolated_bw for r in rs])
            ),
            "mean_wait": float(np.mean([r.wait for r in rs])),
            "frac_contended": len(contended) / max(len(rs), 1),
            # NaN, not 1.0: "no contended admissions" must stay visibly
            # different from "perfect GBE under contention"
            "mean_gbe_contended": float(
                np.mean([r.gbe for r in contended]) if contended
                else float("nan")
            ),
            "mean_batch_size": float(np.mean([r.batch_size for r in rs])),
            "total_overtakes": int(sum(r.overtakes for r in rs)),
            "total_migrations": int(sum(r.migrations for r in rs)),
            # fragmentation state faced across the trace (defrag metrics)
            "mean_stranding": float(np.mean([r.stranding for r in rs])),
            "mean_clean_hosts": float(np.mean([r.clean_hosts for r in rs])),
            "n": len(rs),
        }
    return out


# ---------------------------------------------------------------------------
# Migration events.  migration_cost itself now lives in repro.core.defrag
# (one home for the migration economics shared by re-dispatch, the defrag
# planner, and repro.ft.elastic) and is re-exported above.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MigrationEvent:
    """One committed live-job move, for inspection/benchmarks."""

    t: float
    job_id: str
    old_gpus: Tuple[int, ...]
    new_gpus: Tuple[int, ...]
    old_bw: float    # contention-degraded, before the move
    new_bw: float    # contention-degraded, after the move
    cost: float      # migration_cost charged against the gain
    kind: str = "redispatch"  # or "defrag" / "make-room" (trigger passes)

    def to_dict(self) -> Dict[str, float]:
        return dataclasses.asdict(self)


# ---------------------------------------------------------------------------
# Scheduler
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SchedulerConfig:
    policy: str = "fifo"
    batch_window: float = 0.0        # batched: co-arrival coalescing window
    aging_limit: int = 4             # backfill: overtakes before a job fences
    redispatch: bool = False         # elastic re-dispatch on release
    migration_cost_per_gpu: float = 2.0  # GB/s of degraded-bw gain per moved GPU
    defrag: bool = False             # background + make-room consolidation
    defrag_config: Optional[DefragConfig] = None  # knobs; defaults when None
    batch_applies: bool = False      # fuse surrogate applies across the
    # concurrent scratch searches of one joint plan (batched policy) into
    # shared device calls; value-neutral (padding identity), default off
    # -- control-plane integration (all default-off) ------------------------
    tenant_policies: Optional[Dict[str, TenantPolicy]] = None  # QoS rows:
    # max_concurrent gates admission, max_queued rejects at enqueue,
    # priority_boost reorders backfill/batched candidates
    concurrent_workers: int = 0      # >0: fifo admissions go through the
    # AdmissionControlPlane with this many staging workers (opt-in; serial
    # replay is byte-identical at 0)
    journal_path: Optional[str] = None  # write-ahead ledger journal file;
    # journaling never changes placements (regression-pinned)
    # -- failure domain (fault-free runs are byte-identical) ----------------
    fault_schedule: Optional[object] = None  # faults.FaultSchedule (or any
    # iterable of FaultEvent); None disables injection entirely — the event
    # loop then never consults the fault heap and replays exactly as before
    recovery: bool = True            # checkpoint-and-requeue affected jobs
    # (False = measure the no-recovery counterfactual: victims stay placed
    # on dead GPUs and their contended bandwidth grades as 0.0)
    requeue_backoff: float = 0.5     # base re-admission retry delay; doubles
    # per attempt (0.5, 1, 2, ...) up to max_requeue_retries, after which
    # the job is abandoned (RecoveryOutcome.gave_up) instead of wedging the
    # drain assertion forever on a permanently shrunk cluster
    max_requeue_retries: int = 5
    flap_migrate: bool = True        # nic_flap: price waiting out the flap
    # against migrating off the host (expected-downtime x bandwidth gain
    # vs the shared migration_cost charge)

    def __post_init__(self):
        if self.policy not in POLICIES:
            raise ValueError(
                f"unknown policy {self.policy!r}; expected one of {POLICIES}"
            )
        if self.batch_window < 0:
            raise ValueError("batch_window must be >= 0")
        if self.aging_limit < 1:
            raise ValueError("aging_limit must be >= 1")
        if self.concurrent_workers < 0:
            raise ValueError("concurrent_workers must be >= 0")
        if self.concurrent_workers > 0 and self.policy != "fifo":
            raise ValueError(
                "concurrent admission is only defined for the fifo policy "
                "(backfill/batched drain logic is inherently sequential)"
            )
        if self.requeue_backoff <= 0:
            raise ValueError("requeue_backoff must be > 0")
        if self.max_requeue_retries < 0:
            raise ValueError("max_requeue_retries must be >= 0")
        if self.defrag:
            # within one scheduler there is ONE migration price: redispatch
            # and defrag moves must never charge different costs per GPU
            # (replace, not mutate: the caller's DefragConfig may be shared)
            self.defrag_config = dataclasses.replace(
                self.defrag_config or DefragConfig(),
                migration_cost_per_gpu=self.migration_cost_per_gpu,
            )


@dataclasses.dataclass
class _QueueEntry:
    job: TraceJob
    overtaken: int = 0   # times a later arrival was admitted past this job
    batch: int = 0       # batched policy: co-arrival batch id


class AdmissionScheduler:
    """Owns the event loop (arrivals, departures, queue) for one dispatcher.

    One scheduler drives one ``DispatcherService`` (duck-typed: ``ledger``,
    ``admit``, ``release``, ``dispatch``, ``name``, ``needs_rng``) through a
    trace, grading every admission with contention-degraded GBE against the
    ledger-aware exact Oracle exactly like the legacy ``replay_trace``:
    the oracle runs pre-admit, and grading the job post-admit is equivalent
    because ``JobLedger.contends`` excludes GPU-overlapping entries.
    """

    def __init__(
        self,
        cluster: Cluster,
        sim: BandwidthSimulator,
        tables: IntraHostTables,
        dispatcher,
        config: Optional[SchedulerConfig] = None,
        rng: Optional[np.random.Generator] = None,
        harvester=None,
        grade: bool = True,
    ):
        self.cluster = cluster
        self.sim = sim
        self.tables = tables
        self.dispatcher = dispatcher
        self.config = config or SchedulerConfig()
        self.rng = rng
        # Fast-path grading memo: trial moves and defrag planning re-grade
        # the same (subset, occupancy) pairs; keys carry the ledger's
        # (uid, version) so every admit/release invalidates by construction.
        self.grading_cache = GradingCache(sim)
        # Optional telemetry sink (contended_dataset.TelemetryHarvester):
        # every graded admission is also recorded as a (subset, ledger,
        # contended-bw) observation for the online fine-tuning loop.
        self.harvester = harvester
        # grade=False skips the per-admission exact-Oracle baseline (gbe
        # becomes NaN) — evaluation apparatus, not dispatch work; the
        # throughput bench times replays without it so admissions/sec
        # measures the dispatch path, not the grader.
        self.grade = grade
        self.records: List[TenantRecord] = []
        self.migrations: List[MigrationEvent] = []
        self.rejected: List[TraceJob] = []     # dropped by tenant max_queued
        self._defrag_spent = 0                 # moves charged to the budget
        self._last_defrag = float("-inf")      # last background pass time
        self._rec_by_job: Dict[str, TenantRecord] = {}
        self._departures: List[Tuple[float, int, str]] = []  # (end, seq, id)
        self._waiting: deque = deque()  # _QueueEntry, arrival order
        self._durations: Dict[str, float] = {}
        self._seq = 0
        self._batch_id = -1
        self._batch_close = float("-inf")
        # Cross-search inference batcher: shared by every scratch search this
        # scheduler spawns (joint orders, defrag proposals) so concurrent
        # searches fuse their surrogate applies into one padded device call.
        self._batcher = InferenceBatcher() if self.config.batch_applies else None
        # Tenant QoS accounting (live-job counts per tenant, job -> tenant)
        self._tenant_live: Dict[str, int] = {}
        self._job_tenant: Dict[str, str] = {}
        # Failure domain: the fault heap merges with the
        # departure heap in _release_until; with no schedule it stays empty
        # and the loop degenerates to the pre-fault event loop exactly.
        self.recoveries: List[faults_mod.RecoveryOutcome] = []
        self.fault_log: List[Dict] = []  # one row per fault/recover event:
        # aggregate live contended bw just before vs after the post-event
        # drain (the bench's bandwidth-retention measurement)
        self._injector: Optional[faults_mod.FaultInjector] = None
        self._faults: List[Tuple[float, int, int, str, object]] = []
        self._fault_seq = 0
        # live departure bookkeeping: job -> (heap seq, end time); a fault
        # requeue drops the entry so the stale heap tuple is skipped lazily
        self._dep_live: Dict[str, Tuple[int, float]] = {}
        # job -> (t_fault, kind, re-admission attempts) while in the
        # recovery pipeline; popped by _grade when the job re-admits (MTTR)
        self._disrupted: Dict[str, Tuple[float, str, int]] = {}
        if self.config.fault_schedule is not None:
            self._injector = faults_mod.FaultInjector(dispatcher.ledger)
            for ev in self.config.fault_schedule:
                self._push_fault_event(ev.t, "fault", ev)
                if ev.t_recover is not None:
                    self._push_fault_event(ev.t_recover, "recover", ev)
        # Opt-in concurrent fifo admission: eligible queue prefixes are
        # admitted as a group through the control plane (staged searches
        # overlap, commits CAS on the ledger version).  journal_path alone
        # attaches a write-ahead journal to the serial path.
        self._cplane = None
        if self.config.concurrent_workers > 0:
            from repro_torch.core.controlplane import AdmissionControlPlane

            self._cplane = AdmissionControlPlane(
                dispatcher,
                n_workers=self.config.concurrent_workers,
                journal=self.config.journal_path,
                rng=rng,
            )
        elif self.config.journal_path is not None:
            from repro_torch.core.controlplane import LedgerJournal

            dispatcher.ledger.attach_journal(
                LedgerJournal(self.config.journal_path)
            )

    # -- public -------------------------------------------------------------

    def run(self, trace: Sequence[TraceJob]) -> List[TenantRecord]:
        """Stream a trace through the dispatcher under the configured policy.

        Event-driven: arrivals in time order; departures at or before an
        arrival release first; the ledger is fully drained at the end, so a
        run leaves the service empty.
        """
        ledger = self.dispatcher.ledger
        if len(ledger) != 0:
            raise ValueError("scheduler needs a fresh (empty) dispatcher")
        if self.records:
            raise ValueError(
                "scheduler already ran a trace; build a fresh one per replay"
            )
        if self.rng is None and self.dispatcher.needs_rng:
            raise ValueError(
                f"{self.dispatcher.name} needs an rng to replay a trace"
            )
        for j in trace:
            if j.k > self.cluster.n_gpus:
                raise ValueError(
                    f"{j.job_id}: k={j.k} can never fit the "
                    f"{self.cluster.n_gpus}-GPU cluster"
                )
        self._durations = {j.job_id: j.duration for j in trace}
        try:
            for job in sorted(trace, key=lambda j: j.arrival):
                self._release_until(job.arrival)
                self._on_arrival(job)
            self._release_until(float("inf"))
        finally:
            if self._cplane is not None:
                self._cplane.shutdown()
        if self._waiting or len(ledger) != 0:
            raise RuntimeError(
                f"replay did not drain: {len(self._waiting)} jobs still "
                f"waiting, {len(ledger)} still live"
            )
        return self.records

    def aggregate_live_bandwidth(self) -> float:
        """Sum of every live job's contention-degraded bandwidth under the
        current ledger (health included) — the quantity the failure bench
        tracks across a storm."""
        ledger = self.dispatcher.ledger
        return float(sum(
            self.grading_cache.true_bandwidth(a.gpus, ledger=ledger)
            for a in ledger.jobs()
        ))

    # -- event handling -----------------------------------------------------

    def _release_until(self, horizon: float) -> None:
        """Advance the clock to ``horizon``: departures and fault events
        interleave in time order (a departure wins a tie — the job finished
        at the instant the fault landed).  With no fault schedule the fault
        heap is empty and this is exactly the pre-fault departure loop."""
        while True:
            if not self._departures and not self._faults:
                return
            t_dep = self._departures[0][0] if self._departures else math.inf
            t_flt = self._faults[0][0] if self._faults else math.inf
            if min(t_dep, t_flt) > horizon:
                return
            if t_dep <= t_flt:
                self._pop_departure()
            else:
                self._pop_fault_event()

    def _pop_departure(self) -> None:
        t_end, seq, job_id = heapq.heappop(self._departures)
        live = self._dep_live.get(job_id)
        if live is None or live[0] != seq:
            return  # stale: a fault requeued this job before it finished
        del self._dep_live[job_id]
        if self._cplane is not None:
            self._cplane.release(job_id)  # keeps its tenant counts live
        else:
            self.dispatcher.release(job_id)
        tenant = self._job_tenant.pop(job_id, None)
        if tenant is not None:
            self._tenant_live[tenant] -= 1
        self._drain(t_end)
        if self.config.redispatch:
            self._maybe_redispatch(t_end)
        if self.config.defrag:
            self._maybe_background_defrag(t_end)

    # -- failure domain: injection + recovery pipeline ------------------------

    def _push_fault_event(self, t: float, op: str, payload) -> None:
        # rank: recoveries before faults before retries at the same instant
        # (capacity comes back before a co-timed fault takes more away)
        rank = {"recover": 0, "fault": 1, "retry": 2}[op]
        heapq.heappush(
            self._faults, (t, rank, self._fault_seq, op, payload)
        )
        self._fault_seq += 1

    def _pop_fault_event(self) -> None:
        t, _, _, op, payload = heapq.heappop(self._faults)
        if op == "fault":
            self._on_fault(t, payload)
        elif op == "recover":
            self._on_recover(t, payload)
        else:
            self._on_retry(t, payload)

    def _on_fault(self, t: float, ev) -> None:
        """Apply one fault (journaled, version-bumping) and run the
        recovery pipeline: victims are checkpoint-released and requeued at
        the head of the queue; nic_flaps trigger the wait-vs-migrate
        pricing; the post-event drain re-admits whatever fits (make-room
        defrag fires per admission through the existing hook)."""
        agg_before = self.aggregate_live_bandwidth()
        affected = self._injector.affected_jobs(ev)
        requeued: List[TraceJob] = []
        with telemetry.span(
            "sched.fault", kind=ev.kind, host=ev.host_id,
            affected=len(affected),
        ):
            self._injector.apply(ev)
            if self.config.recovery and affected:
                for job_id in sorted(affected):
                    job = self._release_disrupted(job_id, t, ev.kind)
                    if job is not None:
                        requeued.append(job)
                # priority re-admission: victims go to the FRONT of the
                # queue, preserving their relative (sorted) order
                for job in reversed(requeued):
                    self._enqueue_front(job)
            if ev.kind == "nic_flap" and self.config.flap_migrate:
                self._consider_flap_migration(t, ev)
        self._drain(t)
        for job in requeued:
            self._schedule_retry(job.job_id, t)
        self.fault_log.append({
            "t": t, "op": "fault", "kind": ev.kind, "host": ev.host_id,
            "affected": len(affected), "requeued": len(requeued),
            "agg_bw_before": agg_before,
            "agg_bw_after": self.aggregate_live_bandwidth(),
        })

    def _on_recover(self, t: float, ev) -> None:
        agg_before = self.aggregate_live_bandwidth()
        with telemetry.span("sched.recover", kind=ev.kind, host=ev.host_id):
            self._injector.recover(ev)
        self._drain(t)  # restored capacity may admit waiting victims
        if self.config.redispatch:
            self._maybe_redispatch(t)  # e.g. move back onto healed rails
        self.fault_log.append({
            "t": t, "op": "recover", "kind": ev.kind, "host": ev.host_id,
            "affected": 0, "requeued": 0,
            "agg_bw_before": agg_before,
            "agg_bw_after": self.aggregate_live_bandwidth(),
        })

    def _release_disrupted(
        self, job_id: str, t: float, kind: str
    ) -> Optional[TraceJob]:
        """Checkpoint-release one fault victim; returns the requeue stub
        (remaining duration, original tenant) or None when the job is not
        live anymore (already claimed by an overlapping fault)."""
        live = self._dep_live.pop(job_id, None)
        if live is None:
            return None
        _, t_end = live
        remaining = max(t_end - t, 1e-3)
        alloc = self.dispatcher.ledger.allocation(job_id)
        k = alloc.k
        if self._cplane is not None:
            self._cplane.release(job_id)
        else:
            self.dispatcher.release(job_id)
        tenant = self._job_tenant.pop(job_id, "")
        if tenant in self._tenant_live:
            self._tenant_live[tenant] -= 1
        self._disrupted[job_id] = (t, kind, 0)
        telemetry.event(
            "sched.requeue", job_id=job_id, kind=kind, k=k,
            remaining=remaining,
        )
        return TraceJob(job_id, t, remaining, k, tenant)

    def _enqueue_front(self, job: TraceJob) -> None:
        batch = 0
        if self.config.policy == "batched":
            # a singleton batch of its own at the head: the victim drains
            # first and a non-fitting victim blocks later batches (priority)
            self._batch_id += 1
            batch = self._batch_id
        self._waiting.appendleft(_QueueEntry(job, batch=batch))

    def _schedule_retry(self, job_id: str, t: float) -> None:
        info = self._disrupted.get(job_id)
        if info is None:
            return  # re-admitted during the fault drain: no retry needed
        attempts = info[2]
        if attempts >= self.config.max_requeue_retries:
            self._give_up(job_id, t)
            return
        delay = self.config.requeue_backoff * (2.0 ** attempts)
        self._push_fault_event(t + delay, "retry", job_id)

    def _on_retry(self, t: float, job_id: str) -> None:
        info = self._disrupted.get(job_id)
        if info is None:
            return  # re-admitted before this backoff fired
        t_fault, kind, attempts = info
        self._disrupted[job_id] = (t_fault, kind, attempts + 1)
        with telemetry.span(
            "sched.requeue_retry", job_id=job_id, attempt=attempts + 1,
        ):
            self._drain(t)
        self._schedule_retry(job_id, t)

    def _give_up(self, job_id: str, t: float) -> None:
        """Bounded backoff exhausted: abandon the requeue (the victim's
        checkpoint outlives this trace) instead of wedging the drain."""
        t_fault, kind, attempts = self._disrupted.pop(job_id)
        for entry in self._waiting:
            if entry.job.job_id == job_id:
                self._waiting.remove(entry)
                break
        self.recoveries.append(faults_mod.RecoveryOutcome(
            job_id, t_fault, t, attempts, kind, gave_up=True,
        ))
        telemetry.event("sched.requeue_gave_up", job_id=job_id, kind=kind)

    def _consider_flap_migration(self, t: float, ev) -> None:
        """nic_flap wait-out-vs-migrate: a live cross-host job riding the
        flapped host's rails migrates only when the bandwidth recovered
        over the flap's expected remaining downtime exceeds the shared
        migration-cost charge — otherwise waiting out the flap is cheaper.
        At most one move per flap (the first mover invalidates the shared
        pre-move baseline)."""
        ledger = self.dispatcher.ledger
        downtime = faults_mod.expected_downtime(ev, t)
        movers = sorted(
            (a for a in ledger.jobs()
             if a.cross_host and ev.host_id in a.host_ids),
            key=lambda a: a.job_id,
        )
        if not movers or downtime <= 0.0:
            return
        before = {
            a.job_id: self.grading_cache.true_bandwidth(a.gpus, ledger=ledger)
            for a in ledger.jobs()
        }
        frag_before = defrag_mod.fragmentation_metrics(self.cluster, ledger)
        for alloc in movers:
            tenant = self._job_tenant.get(alloc.job_id, "")
            with forensics.decision(
                alloc.job_id, tenant=tenant, k=alloc.k,
                policy=self.config.policy, path="recovery",
            ) as df:
                # no min_self_gain: under downtime pricing a move can pay
                # even when the instantaneous gain is below the cost
                mv = defrag_mod.evaluate_move(
                    self.grading_cache, ledger, alloc,
                    lambda led, avail, k: self.dispatcher.dispatch(
                        avail, k, rng=self.rng
                    ),
                    self.config.migration_cost_per_gpu,
                    before=before, frag_before=frag_before,
                )
                if mv is None or (mv.new_bw - mv.old_bw) * downtime <= mv.cost:
                    continue
                ledger.migrate(alloc.job_id, mv.new_gpus)
                if df is not None:
                    df.commit(mv.new_gpus, mv.new_bw,
                              committed_version=ledger.version)
            telemetry.event(
                "sched.flap_migrate", job_id=alloc.job_id,
                gain=mv.new_bw - mv.old_bw, cost=mv.cost, downtime=downtime,
            )
            self.migrations.append(MigrationEvent(
                t, alloc.job_id, mv.old_gpus, mv.new_gpus,
                mv.old_bw, mv.new_bw, mv.cost, kind="flap-migrate",
            ))
            rec = self._rec_by_job.get(alloc.job_id)
            if rec is not None:
                rec.migrations += 1
            return

    def _on_arrival(self, job: TraceJob) -> None:
        ledger = self.dispatcher.ledger
        fits = job.k <= ledger.n_free()
        if not self._waiting and fits and self._tenant_ok(job.tenant):
            # spare capacity, empty queue: no policy holds the job back
            if self._cplane is not None:
                # concurrent mode admits through the control plane; the
                # singleton group keeps one code path
                self._enqueue(job)
                self._drain(job.arrival)
            else:
                self._admit_via_dispatcher(job, job.arrival)
            return
        pol = self._policy_for(job.tenant)
        if pol is not None and pol.max_queued is not None:
            waiting = sum(
                1 for e in self._waiting if e.job.tenant == job.tenant
            )
            if waiting >= pol.max_queued:
                self.rejected.append(job)  # over the tenant's queue cap
                return
        self._enqueue(job)
        if self.config.policy != "fifo":
            # backfill/batched may admit at arrival time (fifo never does:
            # a non-empty queue means capacity has not changed since the
            # last release, and the head still blocks)
            self._drain(job.arrival)

    def _enqueue(self, job: TraceJob) -> None:
        batch = 0
        if self.config.policy == "batched":
            # window 0 never coalesces — not even identical arrival stamps —
            # so the documented fifo degeneration holds exactly
            if (self._waiting and self.config.batch_window > 0
                    and job.arrival <= self._batch_close):
                batch = self._batch_id
            else:
                self._batch_id += 1
                self._batch_close = job.arrival + self.config.batch_window
                batch = self._batch_id
        self._waiting.append(_QueueEntry(job, batch=batch))

    def _drain(self, t: float) -> None:
        if self.config.policy == "fifo":
            self._drain_fifo(t)
        elif self.config.policy == "backfill":
            self._drain_backfill(t)
        else:
            self._drain_batched(t)

    # -- tenant QoS ---------------------------------------------------------

    def _policy_for(self, tenant: str) -> Optional[TenantPolicy]:
        return (self.config.tenant_policies or {}).get(tenant)

    def _tenant_ok(self, tenant: str, staged: Optional[Dict] = None) -> bool:
        """May this tenant take one more live job right now?  ``staged``
        adds not-yet-committed same-drain admissions to the live count."""
        pol = self._policy_for(tenant)
        if pol is None or pol.max_concurrent is None:
            return True
        live = self._tenant_live.get(tenant, 0)
        if staged:
            live += staged.get(tenant, 0)
        return live < pol.max_concurrent

    def _boost(self, tenant: str) -> int:
        pol = self._policy_for(tenant)
        return pol.priority_boost if pol is not None else 0

    # -- policies -----------------------------------------------------------

    def _drain_fifo(self, t: float) -> None:
        if self._cplane is not None:
            self._drain_fifo_concurrent(t)
            return
        ledger = self.dispatcher.ledger
        while (self._waiting
               and self._waiting[0].job.k <= ledger.n_free()
               and self._tenant_ok(self._waiting[0].job.tenant)):
            self._admit_via_dispatcher(self._waiting.popleft().job, t)

    def _drain_fifo_concurrent(self, t: float) -> None:
        """Admit the maximal fitting+eligible queue prefix as one group
        through the control plane: every member's search is staged against
        a ledger snapshot concurrently, commits CAS on the version.

        Grading replicates the serial protocol exactly: members are graded
        in commit order against an incrementally rebuilt clone (pre-group
        state + members committed before it), with the exact-Oracle
        baseline computed against that same view pre-admit — so a group
        whose commits land in queue order with the serial placements grades
        byte-identically to the serial drain.  Opt-in — the serial fifo
        path is untouched with 0 workers.
        """
        ledger = self.dispatcher.ledger
        free = ledger.n_free()
        staged: Dict[str, int] = {}
        group: List[TraceJob] = []
        for entry in self._waiting:  # strictly the queue prefix (fifo)
            job = entry.job
            if job.k > free or not self._tenant_ok(job.tenant, staged):
                break
            group.append(job)
            free -= job.k
            staged[job.tenant] = staged.get(job.tenant, 0) + 1
        if not group:
            return
        outcomes = self._cplane.admit_many(
            [(j.job_id, j.k, j.tenant) for j in group]
        )
        by_id = {j.job_id: j for j in group}
        # Rewind to pre-group state and replay the commits one by one so
        # each member is graded in the context the serial drain would have
        # given it (earlier commits live, later ones absent).
        view = ledger.clone()
        for out in outcomes:
            view.release(out.job_id)
        for out in sorted(outcomes, key=lambda o: o.committed_version):
            job = by_id[out.job_id]
            with telemetry.span(
                "sched.admit", job_id=job.job_id, k=job.k,
                policy=self.config.policy, path="concurrent",
            ) as sp:
                if sp:  # the worker's cplane.commit span carries it too
                    sp["journal_seq"] = out.journal_seq
                if self.grade:
                    with telemetry.span("sched.oracle", k=job.k):
                        _, opt_bw = baselines.oracle_dispatch(
                            self.cluster, self.sim, self.tables,
                            view.available(), job.k, ledger=view,
                        )
                else:
                    opt_bw = float("nan")
                n_live = len(view)
                view.admit(out.job_id, out.alloc.gpus)
                self._grade(
                    job, t, out.alloc, opt_bw,
                    n_live=n_live, overtakes=0, batch_size=len(group),
                    ledger=view, predicted=out.predicted_bw,
                )
        for _ in group:
            self._waiting.popleft()

    def _shadow(self, head_k: int, t: float) -> Tuple[float, int]:
        """EASY-backfill reservation for a blocked head: the earliest time
        the head could start if no further jobs were admitted (walk the
        departure heap accumulating freed GPUs), and the spare capacity at
        that moment beyond the head's need."""
        ledger = self.dispatcher.ledger
        free = ledger.n_free()
        if head_k <= free:
            return t, free - head_k
        for t_end, seq, job_id in sorted(self._departures):
            live = self._dep_live.get(job_id)
            if live is None or live[0] != seq:
                continue  # stale heap entry: the job was fault-requeued
            free += ledger.allocation(job_id).k
            if free >= head_k:
                return t_end, free - head_k
        return float("inf"), 0  # unreachable: k <= n_gpus is pre-checked

    def _drain_backfill(self, t: float) -> None:
        """Admit the head while it fits; otherwise backfill EASY-style.

        The blocked head holds a *reservation* at its shadow time (earliest
        possible start given current departures): a later job may overtake
        only if it fits now AND either finishes before the shadow time or
        uses capacity the head will not need then — so a backfill never
        delays the head.  Belt-and-braces on top of the reservation, every
        overtake increments the skipped jobs' aging counters and a job
        whose counter reaches ``aging_limit`` becomes a hard fence that
        nothing behind it may pass."""
        ledger = self.dispatcher.ledger
        limit = self.config.aging_limit
        while self._waiting:
            free = ledger.n_free()
            head = self._waiting[0]
            if head.job.k <= free and self._tenant_ok(head.job.tenant):
                self._waiting.popleft()
                self._admit_via_dispatcher(head.job, t)
                continue
            if head.overtaken >= limit:
                return  # head aged out: queue is frozen until it admits
            # a tenant-capped head that fits capacity-wise reserves from
            # now (shadow_t = t): backfillers may only use spare capacity
            shadow_t, extra = self._shadow(head.job.k, t)
            # fence: only entries before the first aged-out one may pass;
            # priority boosts reorder candidates within that prefix (with
            # no boosts the order is untouched — first fit by index)
            fence = len(self._waiting)
            for i in range(1, len(self._waiting)):
                if self._waiting[i].overtaken >= limit:
                    fence = i
                    break
            candidates = list(range(1, fence))
            if any(self._boost(self._waiting[i].job.tenant)
                   for i in candidates):
                candidates.sort(key=lambda i: (
                    -self._boost(self._waiting[i].job.tenant), i
                ))
            pick = None
            for i in candidates:
                entry = self._waiting[i]
                fits_now = (entry.job.k <= free
                            and self._tenant_ok(entry.job.tenant))
                respects_reservation = (
                    t + entry.job.duration <= shadow_t + 1e-9
                    or entry.job.k <= extra
                )
                if fits_now and respects_reservation:
                    pick = i
                    break
            if pick is None:
                return
            entry = self._waiting[pick]
            for j in range(pick):  # every skipped job was overtaken once
                self._waiting[j].overtaken += 1
            del self._waiting[pick]
            self._admit_via_dispatcher(entry.job, t, overtakes=pick)

    def _drain_batched(self, t: float) -> None:
        """Drain whole co-arrival batches FIFO; place the head batch jointly.

        Within the head batch, members are *selected* in arrival order,
        first-fit (a non-fitting member is skipped, never admitted later
        than it would be under fifo), then the selected jobs are committed
        through one joint plan — ``joint_hybrid_search`` picks the
        *placement* order.  A batch with leftover members blocks later
        batches, so unfairness is bounded by the co-arrival window."""
        ledger = self.dispatcher.ledger
        while self._waiting:
            head_batch = self._waiting[0].batch
            members = [
                (i, e) for i, e in enumerate(self._waiting)
                if e.batch == head_batch
            ]
            free = ledger.n_free()
            # selection order: arrival, unless priority boosts are in play
            # (boost affects WHO is selected; placement order is the joint
            # plan's concern, and admission below stays index-sorted)
            sel_order = members
            if any(self._boost(e.job.tenant) for _, e in members):
                sel_order = sorted(members, key=lambda ie: (
                    -self._boost(ie[1].job.tenant), ie[0]
                ))
            staged: Dict[str, int] = {}
            selected: List[Tuple[int, _QueueEntry]] = []
            for i, e in sel_order:  # first-fit under capacity + tenant caps
                if (e.job.k <= free
                        and self._tenant_ok(e.job.tenant, staged)):
                    selected.append((i, e))
                    free -= e.job.k
                    staged[e.job.tenant] = staged.get(e.job.tenant, 0) + 1
            if not selected:
                return
            selected.sort(key=lambda ie: ie[0])
            sel_idx = {i for i, _ in selected}
            # overtakes: unselected earlier entries (head-batch mates — the
            # head batch is always a prefix of the arrival-ordered queue)
            overtakes = {
                i: sum(1 for j in range(i) if j not in sel_idx)
                for i, _ in selected
            }
            jobs = [e.job for _, e in selected]
            self._admit_batch(
                jobs, t,
                overtakes=[overtakes[i] for i, _ in selected],
            )
            for i in sorted(sel_idx, reverse=True):
                del self._waiting[i]
            if any(e.batch == head_batch for e in self._waiting):
                return  # leftover members block later batches (batch FIFO)

    # -- admission + grading ------------------------------------------------

    def _admit_batch(
        self, jobs: List[TraceJob], t: float, overtakes: List[int]
    ) -> None:
        """Place ``jobs`` as one joint batch (falls back to sequential
        admission for dispatchers without the hybrid-search machinery)."""
        n = len(jobs)
        joint_capable = (
            n > 1
            and hasattr(self.dispatcher, "tables")
            and hasattr(self.dispatcher, "base_predictor")
        )
        if joint_capable and self.config.defrag:
            # make room for the batch's largest member BEFORE planning:
            # defrag moves relocate live jobs into free GPUs, so they must
            # never run between a joint plan and its commit.  The sequential
            # fallback below triggers per-admission instead (in
            # _admit_via_dispatcher), never both.
            self._maybe_make_room(max(j.k for j in jobs), t)
        if not joint_capable:
            order = range(n)
            if self.config.batch_window > 0:
                order = sorted(order, key=lambda i: (-jobs[i].k, i))
            for i in order:
                self._admit_via_dispatcher(
                    jobs[i], t, overtakes=overtakes[i], batch_size=n
                )
            return
        orders = (
            search.JOINT_ORDERS if self.config.batch_window > 0
            else ("arrival",)
        )
        plan = search.joint_hybrid_search(
            self.cluster, self.dispatcher.tables,
            self.dispatcher.base_predictor, self.dispatcher.ledger,
            [(j.job_id, j.k) for j in jobs],
            orders=orders,
            contention_aware=getattr(self.dispatcher, "contention_aware", True),
            contention_mode=getattr(
                self.dispatcher, "contention_mode", "analytic"
            ),
            contended=getattr(self.dispatcher, "contended_predictor", None),
            frag_weight=getattr(self.dispatcher, "frag_weight", 0.0),
            **self._scratch_search_kwargs(),
        )
        by_id = {j.job_id: (j, ov) for j, ov in zip(jobs, overtakes)}
        for p in plan.placements:
            job, ov = by_id[p.job_id]
            self._admit_planned(
                job, t, p.subset, overtakes=ov, batch_size=n,
                predicted=p.predicted_bw,
            )

    def _admit_via_dispatcher(
        self, job: TraceJob, t: float, overtakes: int = 0, batch_size: int = 1
    ) -> None:
        with telemetry.span(
            "sched.admit", job_id=job.job_id, k=job.k,
            policy=self.config.policy, path="serial",
        ) as sp, forensics.decision(
            job.job_id, tenant=job.tenant, k=job.k,
            policy=self.config.policy, path="serial",
        ) as df:
            if self.config.defrag:
                self._maybe_make_room(job.k, t)
            ledger = self.dispatcher.ledger
            if self.grade:
                with telemetry.span("sched.oracle", k=job.k):
                    _, opt_bw = baselines.oracle_dispatch(
                        self.cluster, self.sim, self.tables,
                        ledger.available(), job.k, ledger=ledger,
                    )
            else:
                opt_bw = float("nan")
            n_live = len(ledger)
            alloc = self.dispatcher.admit(
                job.job_id, job.k, rng=self.rng, tenant=job.tenant
            )
            # serial path: the admit above was the last journal write
            seq = (
                ledger.last_journal_seq if ledger.journal is not None else -1
            )
            if sp:
                sp["journal_seq"] = seq
            last = getattr(self.dispatcher, "last_result", None)
            predicted = last.predicted_bw if last is not None else float("nan")
            if df is not None:
                df.commit(alloc.gpus, predicted, journal_seq=seq,
                          committed_version=ledger.version)
            self._grade(
                job, t, alloc, opt_bw, n_live, overtakes, batch_size,
                predicted=predicted,
            )

    def _admit_planned(
        self, job: TraceJob, t: float, subset: Subset,
        overtakes: int = 0, batch_size: int = 1,
        predicted: float = float("nan"),
    ) -> None:
        """Commit a jointly-planned placement, grading it like any other."""
        with telemetry.span(
            "sched.admit", job_id=job.job_id, k=job.k,
            policy=self.config.policy, path="planned",
        ) as sp, forensics.decision(
            job.job_id, tenant=job.tenant, k=job.k,
            policy=self.config.policy, path="planned",
        ) as df:
            ledger = self.dispatcher.ledger
            avail = ledger.available()
            if len(subset) != job.k or not set(subset) <= set(avail):
                raise InvalidPlacementError(  # planner bug: crash, never queue
                    f"joint plan produced an invalid allocation for "
                    f"{job.job_id!r}: {subset}"
                )
            if self.grade:
                with telemetry.span("sched.oracle", k=job.k):
                    _, opt_bw = baselines.oracle_dispatch(
                        self.cluster, self.sim, self.tables, avail, job.k,
                        ledger=ledger,
                    )
            else:
                opt_bw = float("nan")
            n_live = len(ledger)
            alloc = ledger.admit(job.job_id, subset, tenant=job.tenant)
            seq = (
                ledger.last_journal_seq if ledger.journal is not None else -1
            )
            if sp:
                sp["journal_seq"] = seq
            if df is not None:
                df.commit(alloc.gpus, predicted, journal_seq=seq,
                          committed_version=ledger.version)
            self._grade(
                job, t, alloc, opt_bw, n_live, overtakes, batch_size,
                predicted=predicted,
            )

    def _grade(
        self, job: TraceJob, t: float, alloc: Allocation, opt_bw: float,
        n_live: int, overtakes: int, batch_size: int, ledger=None,
        predicted: float = float("nan"),
    ) -> None:
        # ledger override: the concurrent fifo drain grades each group
        # member against a rebuilt "commits before me" view, not the live
        # (post-group) ledger — see _drain_fifo_concurrent.
        if ledger is None:
            ledger = self.dispatcher.ledger
        # post-admit grading sees the pre-admit contention: contends()
        # self-excludes the job's own (GPU-overlapping) ledger entry
        bw = self.grading_cache.true_bandwidth(alloc.gpus, ledger=ledger)
        iso = self.grading_cache.true_bandwidth(alloc.gpus)
        # back-fill realized/oracle bandwidth into the admission's dossier
        # and the per-tenant regret ledger (no-op when capture is off)
        forensics.note_grade(job.job_id, bw, oracle_bw=opt_bw,
                             tenant=job.tenant)
        if self.harvester is not None:
            drift = getattr(self.harvester, "drift", None)
            if drift is not None and not math.isnan(predicted):
                # stamp B-hat for the report_bandwidth pairing path too:
                # a later realized measurement resolves through this
                from repro_torch.core.telemetry import snapshot_digest

                drift.note_prediction(
                    job.job_id, alloc.gpus, predicted,
                    digest=snapshot_digest(ledger, alloc.gpus),
                    tenant=job.tenant,
                )
            self.harvester.observe(
                ledger, alloc.gpus, bw,
                job_id=job.job_id, predicted=predicted,
                tenant=job.tenant, t=t, source="grade",
            )
        shared = sum(
            1 for hid in alloc.host_ids
            if ledger.rail_contenders(hid, against=alloc.gpus) > 0
        ) if alloc.cross_host else 0
        frag = ledger.fragmentation()
        rec = TenantRecord(
            self.dispatcher.name, job.job_id, job.k, t, t - job.arrival,
            bw / opt_bw, bw, iso, opt_bw, n_live, shared,
            policy=self.config.policy, overtakes=overtakes,
            batch_size=batch_size,
            stranding=frag.stranding, clean_hosts=frag.clean_hosts,
            predicted_bw=predicted,
        )
        self.records.append(rec)
        self._rec_by_job[job.job_id] = rec
        self._tenant_live[job.tenant] = (
            self._tenant_live.get(job.tenant, 0) + 1
        )
        self._job_tenant[job.job_id] = job.tenant
        heapq.heappush(
            self._departures, (t + job.duration, self._seq, job.job_id)
        )
        self._dep_live[job.job_id] = (self._seq, t + job.duration)
        self._seq += 1
        # this admission closes a recovery: seal MTTR for the pipeline
        info = self._disrupted.pop(job.job_id, None)
        if info is not None:
            t_fault, kind, attempts = info
            self.recoveries.append(faults_mod.RecoveryOutcome(
                job.job_id, t_fault, t, attempts + 1, kind,
            ))
            telemetry.event(
                "sched.recovered", job_id=job.job_id, kind=kind,
                mttr=t - t_fault, attempts=attempts + 1,
            )

    # -- elastic re-dispatch on release --------------------------------------

    def _maybe_redispatch(self, t: float) -> None:
        """Re-place the live cross-host job whose contention-degraded
        bandwidth improves the most net of migration cost — and only if no
        other live job's degraded bandwidth drops."""
        ledger = self.dispatcher.ledger
        candidates = [a for a in ledger.jobs() if a.cross_host]
        if not candidates:
            return
        # every candidate trials against the same (exactly restored) ledger
        # state: grade the pre-move baseline once, not once per candidate
        before = {
            a.job_id: self.grading_cache.true_bandwidth(a.gpus, ledger=ledger)
            for a in ledger.jobs()
        }
        frag_before = defrag_mod.fragmentation_metrics(self.cluster, ledger)
        best: Optional[defrag_mod.MoveEval] = None
        for alloc in list(candidates):
            ev = self._trial_move(alloc, before, frag_before)
            if ev is None:
                continue
            if best is None or ev.self_gain > best.self_gain:
                best = ev
        if best is None:
            return
        # single atomic move: one journal event, version bumps by 2 —
        # identical ledger state to the release+admit pair this replaces
        ledger.migrate(best.job_id, best.new_gpus)
        telemetry.event(
            "sched.redispatch", job_id=best.job_id,
            gain=best.new_bw - best.old_bw, cost=best.cost,
        )
        self.migrations.append(MigrationEvent(
            t, best.job_id, best.old_gpus, best.new_gpus,
            best.old_bw, best.new_bw, best.cost,
        ))
        rec = self._rec_by_job.get(best.job_id)
        if rec is not None:
            rec.migrations += 1

    def _trial_move(
        self, alloc: Allocation, before=None, frag_before=None
    ) -> Optional["defrag_mod.MoveEval"]:
        """Evaluate re-placing one live job via the shared trial-move
        helper (:func:`repro.core.defrag.evaluate_move` — gain rule,
        no-harm check, exact ledger restore); the re-dispatch hook's
        objective is the moved job's own net gain.  Grading runs through
        the ledger-versioned :class:`~repro.core.predict_cache.GradingCache`
        and reuses the caller's once-per-release ``before`` baseline.

        Returns the :class:`~repro.core.defrag.MoveEval` or None when the
        move does not pay or would hurt a co-tenant."""
        return defrag_mod.evaluate_move(
            self.grading_cache, self.dispatcher.ledger, alloc,
            lambda led, avail, k: self.dispatcher.dispatch(
                avail, k, rng=self.rng
            ),
            self.config.migration_cost_per_gpu,
            min_self_gain=1e-9,  # cheap reject before co-tenant grading
            before=before, frag_before=frag_before,
        )

    # -- defragmentation triggers --------------------------------------------

    def _scratch_search_kwargs(self) -> Dict:
        """Fast-path settings for scratch searches (joint plans, defrag
        proposals): follow the dispatcher's own cache/vectorized settings
        so a fast-path-off dispatcher replays the slow path end to end
        (the throughput bench's before side), and sink the throwaway
        wrappers' stats into the dispatcher's contention wrapper so the
        per-phase breakdown keeps their time."""
        d = self.dispatcher
        wrapper = getattr(d, "contention_predictor", None)
        return dict(
            use_cache=(
                getattr(d, "prediction_cache", None) is not None
                or getattr(d, "iso_cache", None) is not None
            ),
            vectorized=getattr(wrapper, "vectorized", True),
            stats_sink=wrapper.stats if wrapper is not None else None,
            batcher=self._batcher,
        )

    def _defrag_proposer(self) -> defrag_mod.ProposalFan:
        """How the planner re-places movers: best-fit consolidation slots
        (with the dispatcher's own contention-aware hybrid machinery as the
        fallback) when available, else the dispatcher's plain ``dispatch``."""
        d = self.dispatcher
        cfg = self.config.defrag_config
        if hasattr(d, "tables") and hasattr(d, "base_predictor"):
            return defrag_mod.consolidation_proposer(
                self.cluster, d.tables, d.base_predictor,
                contention_aware=getattr(d, "contention_aware", True),
                contention_mode=getattr(d, "contention_mode", "analytic"),
                contended=getattr(d, "contended_predictor", None),
                frag_weight=cfg.frag_weight,
                **self._scratch_search_kwargs(),
            )
        return lambda led, avail, k: [d.dispatch(avail, k, rng=self.rng)]

    def _run_defrag_pass(
        self, t: float, kind: str, target_k: Optional[int] = None
    ) -> None:
        cfg = self.config.defrag_config
        remaining = cfg.max_total_moves - self._defrag_spent
        if remaining <= 0:
            return  # trace-level migration budget exhausted
        ledger = self.dispatcher.ledger
        with telemetry.span(
            "sched.defrag", kind=kind, target_k=target_k or 0,
        ) as sp:
            plan = defrag_mod.plan_defrag(
                self.cluster, self.grading_cache, ledger, cfg,
                self._defrag_proposer(),
                target_k=target_k,
                budget=min(cfg.max_moves_per_pass, remaining),
            )
            defrag_mod.apply_plan(ledger, plan)
            sp["moves"] = len(plan.moves)
        for mv in plan.moves:
            self.migrations.append(MigrationEvent(
                t, mv.job_id, mv.old_gpus, mv.new_gpus,
                mv.old_bw, mv.new_bw, mv.cost, kind=kind,
            ))
            rec = self._rec_by_job.get(mv.job_id)
            if rec is not None:
                rec.migrations += 1
            self._defrag_spent += 1

    def _maybe_background_defrag(self, t: float) -> None:
        """Rate-limited consolidation pass at release time (the event-driven
        equivalent of an idle/periodic background sweep)."""
        cfg = self.config.defrag_config
        if t - self._last_defrag < cfg.interval:
            return
        self._last_defrag = t
        self._run_defrag_pass(t, kind="defrag")

    def _maybe_make_room(self, k: int, t: float) -> None:
        """On-demand pass: consolidate just enough to open a k-GPU clean
        block when the admission would otherwise be forced cross-host into
        contended rails (see :func:`repro.core.defrag.forced_rail_contended`)."""
        cfg = self.config.defrag_config
        if not cfg.make_room:
            return
        if defrag_mod.forced_rail_contended(
            self.cluster, self.dispatcher.ledger, k,
            quality_only=cfg.make_room_quality,
        ):
            self._run_defrag_pass(t, kind="make-room", target_k=k)


# ---------------------------------------------------------------------------
# Policy comparison harness
# ---------------------------------------------------------------------------

def compare_policies(
    cluster: Cluster,
    sim: BandwidthSimulator,
    tables: IntraHostTables,
    dispatcher_factory,
    trace: Sequence[TraceJob],
    configs: Optional[Dict[str, SchedulerConfig]] = None,
    seed: int = 0,
) -> Dict[str, AdmissionScheduler]:
    """Replay one trace under several scheduler configs (fresh dispatcher and
    rng per replay: identical randomness).  -> {config name: scheduler}."""
    if configs is None:
        configs = {
            "fifo": SchedulerConfig(policy="fifo"),
            "backfill": SchedulerConfig(policy="backfill"),
            "batched": SchedulerConfig(policy="batched", batch_window=2.0),
        }
    out: Dict[str, AdmissionScheduler] = {}
    for name, cfg in configs.items():
        disp = dispatcher_factory()
        disp.name = f"{disp.name}[{name}]"
        sched = AdmissionScheduler(
            cluster, sim, tables, disp, cfg,
            rng=np.random.default_rng(seed),
        )
        sched.run(trace)
        out[name] = sched
    return out
