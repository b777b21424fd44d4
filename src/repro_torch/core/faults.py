"""Failure-domain subsystem: typed fault events, seeded schedules, and the
injector that threads them through the :class:`~repro.core.tenancy.JobLedger`.

The fault model is deliberately small — four event kinds cover the failure
patterns that dominate multi-tenant GPU clusters (the regime of
arXiv:2207.07817's ring-all-reduce co-scheduling study):

``gpu_down``
    One or more GPUs die.  Dead GPUs are unplaceable: the ledger's
    ``available()`` excludes them, ``admit``/``migrate`` refuse them, and
    the ground truth returns 0.0 for any subset that touches one.
``host_down``
    Every GPU on a host dies at once (PSU / kernel panic).  Semantically a
    ``gpu_down`` over the whole host; kept distinct so schedules, spans and
    dossiers carry the blast radius.
``nic_flap``
    Transient: the host's NIC rail degrades by ``factor`` until
    ``t_recover``.  Jobs on the host keep running (degraded); the recovery
    pipeline prices wait-out vs migrate against expected downtime.
``link_degrade``
    Persistent multiplicative ``factor`` on a host's rail/NIC bandwidth
    (until an explicit ``recover`` event, if the schedule emits one).

Health is a four-state lattice per GPU — ``healthy < degraded <
quarantined < dead`` — stored sparsely on the ledger (absent == healthy)
under the existing version counter, so every fault/recover bumps
``ledger.version`` and invalidates prediction caches, snapshots and CAS
commits exactly like an admission would.  ``fault``/``recover`` are
journaled event kinds in the same canonical-JSON + crc32 grammar as
admit/release/migrate, so :func:`~repro.core.controlplane.replay_journal`
rebuilds post-fault state bit-identically, torn tails included.

Everything here is value-neutral when unused: a ledger that has never seen
a fault reports ``health_active == False`` and every consumer (simulator,
features, analytic cap, scheduler) takes its pre-existing byte-identical
path.  See ``docs/faults.md``.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from .cluster import Cluster

# The health lattice, weakest to strongest.  Transitions only ever move a
# GPU *up* the lattice within one fault application; recovery pops states
# explicitly (see JobLedger.apply_recover) so the order is deterministic
# and journal replay reproduces it exactly.
HEALTH_STATES: Tuple[str, ...] = ("healthy", "degraded", "quarantined", "dead")

FAULT_KINDS: Tuple[str, ...] = ("gpu_down", "host_down", "nic_flap", "link_degrade")

#: kinds whose recovery the schedule generator emits automatically
_TRANSIENT: Tuple[str, ...] = ("nic_flap", "gpu_down", "host_down", "link_degrade")


@dataclass(frozen=True)
class FaultEvent:
    """One typed fault (or its recovery).  ``t_recover`` is the absolute
    time the matching ``recover`` event fires; ``None`` means permanent
    (no recovery is scheduled)."""

    t: float
    kind: str                       # one of FAULT_KINDS
    host_id: int
    gpus: Tuple[int, ...] = ()      # global GPU ids (gpu_down / host_down)
    factor: float = 1.0             # rail multiplier (nic_flap / link_degrade)
    t_recover: Optional[float] = None

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.kind in ("nic_flap", "link_degrade") and not (
            0.0 < self.factor <= 1.0
        ):
            raise ValueError("factor must be in (0, 1] for degrade events")
        if self.t_recover is not None and self.t_recover <= self.t:
            raise ValueError("t_recover must be strictly after t")

    @property
    def transient(self) -> bool:
        return self.t_recover is not None


@dataclass
class FaultSchedule:
    """A deterministic, seeded storm: a time-sorted list of
    :class:`FaultEvent`.  Two schedules built with the same (cluster,
    seed, knobs) are element-wise identical — the generator draws from a
    single ``np.random.default_rng(seed)`` stream in a fixed order."""

    events: List[FaultEvent] = field(default_factory=list)

    def __iter__(self):
        return iter(self.events)

    def __len__(self) -> int:
        return len(self.events)

    @staticmethod
    def generate(
        cluster: Cluster,
        *,
        seed: int,
        n_events: int = 3,
        t_start: float = 0.0,
        t_end: float = 100.0,
        kinds: Sequence[str] = FAULT_KINDS,
        mean_downtime: float = 20.0,
        degrade_range: Tuple[float, float] = (0.3, 0.8),
        recover: bool = True,
    ) -> "FaultSchedule":
        """Draw ``n_events`` faults uniformly over ``[t_start, t_end)``.

        With ``recover=True`` (default) every event carries a
        ``t_recover`` drawn from an exponential with mean
        ``mean_downtime`` — so a scheduler consuming the storm always
        drains.  ``recover=False`` leaves gpu_down/host_down/link_degrade
        permanent (nic_flap is transient by definition and always gets a
        recovery time).
        """
        for k in kinds:
            if k not in FAULT_KINDS:
                raise ValueError(f"unknown fault kind {k!r}")
        rng = np.random.default_rng(seed)
        events: List[FaultEvent] = []
        for _ in range(int(n_events)):
            t = float(rng.uniform(t_start, t_end))
            kind = str(kinds[int(rng.integers(len(kinds)))])
            hid = int(rng.integers(len(cluster.hosts)))
            host = cluster.hosts[hid]
            gpus: Tuple[int, ...] = ()
            factor = 1.0
            if kind == "gpu_down":
                n = int(rng.integers(1, max(2, host.n_gpus // 2 + 1)))
                picks = rng.choice(host.n_gpus, size=n, replace=False)
                gpus = tuple(sorted(int(host.gpu_ids[i]) for i in picks))
            elif kind == "host_down":
                gpus = tuple(int(g) for g in host.gpu_ids)
            else:
                factor = float(rng.uniform(*degrade_range))
            t_rec: Optional[float] = None
            if recover or kind == "nic_flap":
                t_rec = t + max(1e-6, float(rng.exponential(mean_downtime)))
            events.append(
                FaultEvent(
                    t=t, kind=kind, host_id=hid, gpus=gpus,
                    factor=factor, t_recover=t_rec,
                )
            )
        events.sort(key=lambda e: (e.t, e.host_id, e.kind))
        return FaultSchedule(events)


class FaultInjector:
    """Applies :class:`FaultEvent`\\ s to a ledger (journaled, versioned)
    and undoes them at recovery time.  Stateless beyond the ledger — the
    ledger's sparse health maps are the single source of truth, which is
    what makes journal replay rebuild post-fault state bit-identically.
    """

    def __init__(self, ledger):
        self.ledger = ledger
        self.n_applied = 0
        self.n_recovered = 0

    def apply(self, ev: FaultEvent) -> None:
        self.ledger.apply_fault(
            ev.kind, gpus=ev.gpus, host_id=ev.host_id, factor=ev.factor
        )
        self.n_applied += 1

    def recover(self, ev: FaultEvent) -> None:
        self.ledger.apply_recover(ev.kind, gpus=ev.gpus, host_id=ev.host_id)
        self.n_recovered += 1

    def affected_jobs(self, ev: FaultEvent) -> Dict[str, Tuple[int, ...]]:
        """Live jobs whose allocation touches a GPU this event killed or
        quarantined — the set the recovery pipeline must requeue.  Degrade
        events (nic_flap / link_degrade) leave jobs in place, so they
        return an empty dict; the wait-vs-migrate policy handles those."""
        if ev.kind not in ("gpu_down", "host_down"):
            return {}
        hit = set(ev.gpus)
        if ev.kind == "host_down" and not hit and ev.host_id is not None:
            # empty gpus means the whole host (mirrors apply_fault's
            # fallback) — the blast radius is every GPU the host carries
            hit = set(self.ledger.cluster.hosts[ev.host_id].gpu_ids)
        out: Dict[str, Tuple[int, ...]] = {}
        for alloc in list(self.ledger.jobs()):
            if hit.intersection(alloc.gpus):
                out[alloc.job_id] = alloc.gpus
        return out


@dataclass(frozen=True)
class RecoveryOutcome:
    """One requeued tenant's journey through the recovery pipeline —
    sealed into metrics (MTTR) and forensics dossiers."""

    job_id: str
    t_fault: float
    t_readmitted: float
    attempts: int
    kind: str
    gave_up: bool = False

    @property
    def mttr(self) -> float:
        return self.t_readmitted - self.t_fault


def expected_downtime(ev: FaultEvent, now: float, default: float = 20.0) -> float:
    """Remaining downtime of a transient event as seen at ``now`` — the
    price of *waiting out* a nic_flap instead of migrating off the host."""
    if ev.t_recover is None:
        return default
    return max(0.0, ev.t_recover - now)


def install_degraded_fallback(monitor, predictor) -> Callable:
    """Wire graceful degradation through the :class:`DriftMonitor`: when
    mispredictions on health-perturbed fabric trip a drift alert, force
    the contention-aware predictor onto its analytic cap (the learned
    surrogate never trained on degraded rails, so its errors there are
    structural, not noise).  Returns the installed hook.  Chains any
    pre-existing ``on_alert`` (e.g. ``finetune_on_drift``)."""
    prev = getattr(monitor, "on_alert", None)

    def _hook(alert):
        ledger = getattr(predictor, "ledger", None)
        if ledger is not None and getattr(ledger, "health_active", False):
            predictor.force_analytic = True
        if prev is not None:
            prev(alert)

    monitor.on_alert = _hook
    return _hook
