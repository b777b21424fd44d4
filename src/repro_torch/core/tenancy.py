"""Multi-tenant occupancy: live jobs, their allocations, derived availability.

The seed reproduction treated dispatching as a pure function over an ad-hoc
``avail`` list.  A real dispatcher is a *service*: jobs arrive, hold GPUs for
a while, and depart, and the set of live jobs — not a caller-supplied list —
is the source of truth for both availability and cross-job contention.  The
:class:`JobLedger` is that source of truth; everything contention-related
(:mod:`repro.core.contention`, the contended ground truth in
:mod:`repro.core.bandwidth_sim`) derives its view of the cluster from it.

Terminology used throughout the contention stack:

* an allocation is **cross-host** when it spans >1 host — only those jobs
  drive NIC-rail traffic and therefore contend with other collectives;
* a live job **contends with** a candidate subset S on host h when it is
  cross-host, occupies >=1 GPU of h, and is GPU-disjoint from S (a job is
  never its own contender, which makes re-grading an admitted job safe
  without bookkeeping about which ledger entry "is" S).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

from repro_torch.core.cluster import Cluster

_UID_LOCK = threading.Lock()  # guards the class-level uid counter

# Health lattice (see repro.core.faults): GPUs in either of these states
# are unplaceable — excluded from ``available()`` and refused by
# ``admit``/``migrate`` by construction.
_UNPLACEABLE = frozenset(("quarantined", "dead"))

# Fault kinds the ledger itself understands.  The first four mirror
# faults.FAULT_KINDS; ``quarantine`` is the operator/fencing action that
# removes a GPU from placement without declaring it dead.
_LEDGER_FAULT_KINDS = (
    "gpu_down", "host_down", "nic_flap", "link_degrade", "quarantine",
)


class CapacityError(ValueError):
    """An admission cannot be satisfied right now: not enough free GPUs.

    Expected under load — the control plane / scheduler queues the request
    and retries at the next release.  Subclasses :class:`ValueError` so
    legacy ``except ValueError`` call sites keep working.
    """


class InvalidPlacementError(ValueError):
    """A placement policy returned a subset that violates its request
    (wrong size, busy or out-of-range GPUs) — a programmer error, never an
    operational condition.  Callers must crash loudly, not queue."""


class VersionConflict(RuntimeError):
    """A compare-and-swap admission lost the race: the ledger version moved
    past the one the placement was staged against.  The worker re-searches
    against a fresh snapshot (see :mod:`repro.core.controlplane`)."""

    def __init__(self, staged: int, actual: int):
        super().__init__(
            f"ledger version moved: staged against v{staged}, now v{actual}"
        )
        self.staged = staged
        self.actual = actual


@dataclasses.dataclass(frozen=True)
class Allocation:
    """One live job's placement: the unit the ledger admits and releases.

    ``tenant`` is carried through the ledger (and the journal, when one is
    attached) so journal-reconstructed views can answer tenant-scoped
    questions — the forensics ``whatif(drop_tenant=...)`` counterfactual
    in particular.  Empty string means "no tenant" and is omitted from the
    journal encoding, keeping tenant-less streams byte-identical to the original encoding.
    """

    job_id: str
    gpus: Tuple[int, ...]
    host_ids: Tuple[int, ...]
    tenant: str = ""

    @property
    def k(self) -> int:
        return len(self.gpus)

    @property
    def cross_host(self) -> bool:
        return len(self.host_ids) > 1


@dataclasses.dataclass(frozen=True)
class ContentionSnapshot:
    """Frozen per-host rail-contender counts (and per-contender GPU demands),
    duck-typing the two methods of :class:`JobLedger` the bandwidth simulator
    consumes.

    Valid ONLY for candidate subsets GPU-disjoint from every live allocation
    (anything drawn from ``available()``): the disjointness check is
    pre-resolved, which is what makes hot loops — the exact Oracle's count-
    vector enumeration — skip the per-candidate set work.

    ``frag`` carries the ledger's fragmentation state at snapshot time (a
    :class:`repro.core.defrag.FragmentationMetrics`), so consumers grading
    or planning against the frozen view see the same stranding / clean-host
    picture the defrag subsystem acts on.
    """

    counts: Dict[int, int]
    demands: Dict[int, Tuple[int, ...]] = dataclasses.field(default_factory=dict)
    frag: Optional[object] = None  # defrag.FragmentationMetrics (lazy import)
    # host id -> rail degrade factor (absent == 1.0, healthy); mirrors the
    # source ledger's health view so grading against the frozen snapshot
    # sees the same degraded fabric the live ledger does.
    degrade: Dict[int, float] = dataclasses.field(default_factory=dict)

    def rail_contenders(self, host_id: int, against: Sequence[int] = ()) -> int:
        return self.counts.get(host_id, 0)

    def contender_demands(
        self, host_id: int, against: Sequence[int] = ()
    ) -> Tuple[int, ...]:
        return self.demands.get(host_id, ())

    @property
    def health_active(self) -> bool:
        return bool(self.degrade)

    def host_degrade(self, host_id: int) -> float:
        return self.degrade.get(host_id, 1.0)

    def gpu_health(self, gpu_id: int) -> str:
        # Snapshots only ever see candidates drawn from ``available()``,
        # which already excludes quarantined/dead GPUs.
        return "healthy"


class JobLedger:
    """Tracks live jobs and per-host occupancy for one :class:`Cluster`.

    Invariants (enforced on every mutation):
      * live allocations are pairwise GPU-disjoint;
      * ``available() == all_gpus - union(live allocations)``;
      * ``release(admit(j, S).job_id)`` restores the exact prior state
        (except the :attr:`version` counter, which only ever grows).

    ``version`` is a monotonic counter bumped by every successful admit and
    release — the cache-invalidation token of the dispatch fast path
    (:mod:`repro.core.predict_cache`): any memo keyed by ``(subset,
    version)`` is automatically stale the moment occupancy changes.  ``uid``
    distinguishes ledger *instances* (scratch copies start their own version
    space), so version-keyed entries from different ledgers never collide.

    With the control plane the version counter is also the **CAS token** of the
    concurrent-admission control plane: :meth:`admit_if` commits a staged
    placement only when the version still equals the one its search was
    pinned against (raising :class:`VersionConflict` otherwise), and every
    mutation runs under :attr:`lock` so overlapping workers serialize only
    their cheap commits, never their searches.  When a
    :class:`~repro.core.controlplane.LedgerJournal` is attached, every
    mutation is serialized to the journal *before* the in-memory change
    (write-ahead), so :func:`~repro.core.controlplane.replay_journal`
    rebuilds a bit-identical ledger — same allocations, same version
    counter — after a crash at any point.
    """

    _next_uid = 0

    def __init__(self, cluster: Cluster):
        self.cluster = cluster
        self._jobs: Dict[str, Allocation] = {}
        self._owner: Dict[int, str] = {}  # gpu id -> job id
        # host id -> job ids with >=1 GPU on that host (cross- or single-host)
        self._host_jobs: Dict[int, Set[str]] = {
            h.host_id: set() for h in cluster.hosts
        }
        self._version = 0
        # Sparse health state (absent == healthy / 1.0).  Mutated only by
        # apply_fault/apply_recover, under the same version counter and
        # write-ahead journal as occupancy — a fault IS an occupancy-
        # relevant event (caches keyed on version must go stale).
        self._gpu_health: Dict[int, str] = {}
        self._host_degrade: Dict[int, float] = {}
        # Reentrant: admit_if/migrate call admit/release while holding it,
        # and compound read-harvest sequences (report_bandwidth) nest too.
        self.lock = threading.RLock()
        self.journal = None  # controlplane.LedgerJournal (write-ahead sink)
        # seq of the last journal event this ledger wrote (-1 = none yet).
        # Read under ``lock`` right after a mutation to correlate the commit
        # with its journal line (admission spans / forensics dossiers).
        self.last_journal_seq = -1
        with _UID_LOCK:
            self.uid = JobLedger._next_uid
            JobLedger._next_uid += 1

    @property
    def version(self) -> int:
        """Monotonic occupancy version: bumped on every admit/release."""
        return self._version

    # -- lifecycle ----------------------------------------------------------

    def attach_journal(self, journal, recovered: bool = False) -> None:
        """Attach a write-ahead journal sink: every subsequent mutation is
        serialized to it before the in-memory change.  Requires a fresh
        (empty, version-0) ledger unless ``recovered=True`` — the recovery
        flow re-attaches a journal whose tail already describes the current
        state (see :func:`~repro.core.controlplane.replay_journal`)."""
        if not recovered and (self._jobs or self._version != 0):
            raise ValueError(
                "journal must be attached to a fresh ledger (or pass "
                "recovered=True after replay_journal)"
            )
        self.journal = journal

    def admit(
        self, job_id: str, gpus: Sequence[int], tenant: str = ""
    ) -> Allocation:
        """Record ``job_id`` as live on ``gpus``.  Returns the allocation."""
        with self.lock:
            if job_id in self._jobs:
                raise ValueError(f"job {job_id!r} is already live")
            subset = tuple(sorted(gpus))
            if len(subset) == 0:
                raise InvalidPlacementError("empty allocation")
            if len(set(subset)) != len(subset):
                raise InvalidPlacementError(
                    f"duplicate GPU ids in allocation: {gpus}"
                )
            for g in subset:
                if g < 0 or g >= self.cluster.n_gpus:
                    raise InvalidPlacementError(f"GPU id {g} outside cluster")
                if g in self._owner:
                    raise ValueError(
                        f"GPU {g} is busy (held by job {self._owner[g]!r})"
                    )
                state = self._gpu_health.get(g)
                if state in _UNPLACEABLE:
                    raise ValueError(f"GPU {g} is {state} (unplaceable)")
            if self.journal is not None:  # write-ahead: validated, not applied
                self.last_journal_seq = self.journal.record(
                    "admit", job_id=job_id, gpus=list(subset), tenant=tenant
                )
            host_ids = tuple(sorted(self.cluster.partition_by_host(subset)))
            alloc = Allocation(job_id, subset, host_ids, tenant=tenant)
            self._jobs[job_id] = alloc
            for g in subset:
                self._owner[g] = job_id
            for hid in host_ids:
                self._host_jobs[hid].add(job_id)
            self._version += 1
            return alloc

    def admit_if(
        self, job_id: str, gpus: Sequence[int], version: int, tenant: str = ""
    ) -> Allocation:
        """Compare-and-swap admission: admit ``job_id`` on ``gpus`` only if
        the ledger version still equals ``version`` (the version the
        placement's search was staged against), else raise
        :class:`VersionConflict` without mutating anything.  The concurrent
        control plane's commit primitive: searches overlap freely, commits
        serialize on :attr:`lock`, and a lost race is detected here."""
        with self.lock:
            if self._version != version:
                raise VersionConflict(version, self._version)
            return self.admit(job_id, gpus, tenant=tenant)

    def release(self, job_id: str) -> Allocation:
        """Remove a live job, returning its (now freed) allocation."""
        with self.lock:
            alloc = self._jobs.get(job_id)
            if alloc is None:
                raise KeyError(f"job {job_id!r} is not live")
            if self.journal is not None:
                self.last_journal_seq = self.journal.record(
                    "release", job_id=job_id
                )
            del self._jobs[job_id]
            for g in alloc.gpus:
                del self._owner[g]
            for hid in alloc.host_ids:
                self._host_jobs[hid].discard(job_id)
            self._version += 1
            return alloc

    def migrate(self, job_id: str, gpus: Sequence[int]) -> Allocation:
        """Re-place a live job onto ``gpus`` (which may overlap its current
        allocation) as one atomic release+admit — version bumps by exactly
        2, identical to the manual pair, but the journal records a single
        ``migrate`` event.  Fully validated before anything is journaled or
        mutated, so a failing move leaves ledger and journal untouched."""
        with self.lock:
            old = self._jobs.get(job_id)
            if old is None:
                raise KeyError(f"job {job_id!r} is not live")
            subset = tuple(sorted(gpus))
            if len(subset) == 0:
                raise InvalidPlacementError("empty migration target")
            if len(set(subset)) != len(subset):
                raise InvalidPlacementError(
                    f"duplicate GPU ids in migration target: {gpus}"
                )
            for g in subset:
                if g < 0 or g >= self.cluster.n_gpus:
                    raise InvalidPlacementError(f"GPU id {g} outside cluster")
                owner = self._owner.get(g)
                if owner is not None and owner != job_id:
                    raise ValueError(
                        f"GPU {g} is busy (held by job {owner!r})"
                    )
                state = self._gpu_health.get(g)
                if state in _UNPLACEABLE:
                    raise ValueError(f"GPU {g} is {state} (unplaceable)")
            if self.journal is not None:
                self.last_journal_seq = self.journal.record(
                    "migrate", job_id=job_id, gpus=list(subset),
                    tenant=old.tenant,
                )
            journal, self.journal = self.journal, None
            try:  # inner ops validated above: cannot fail, never journaled
                self.release(job_id)
                return self.admit(job_id, subset, tenant=old.tenant)
            finally:
                self.journal = journal

    def clone(self) -> "JobLedger":
        """Snapshot copy for staged (optimistic) searches: same occupancy,
        same ``version`` value — "searched at version v" is meaningful
        against the parent — but a fresh ``uid`` (its own cache-key space)
        and no journal.  O(live jobs); never aliases parent state."""
        with self.lock:
            other = JobLedger(self.cluster)
            other._jobs = dict(self._jobs)
            other._owner = dict(self._owner)
            other._host_jobs = {
                hid: set(ids) for hid, ids in self._host_jobs.items()
            }
            other._version = self._version
            other._gpu_health = dict(self._gpu_health)
            other._host_degrade = dict(self._host_degrade)
            return other

    # -- health / faults -----------------------------------------------------

    @property
    def health_active(self) -> bool:
        """True iff any GPU or host is currently non-healthy.  Every
        consumer gates its health-conditioned path on this, so a ledger
        that has never seen a fault stays byte-identical to pre-fault
        behavior."""
        return bool(self._gpu_health) or bool(self._host_degrade)

    def gpu_health(self, gpu_id: int) -> str:
        """Health-lattice state of one GPU (absent from the sparse map ==
        ``healthy``)."""
        return self._gpu_health.get(gpu_id, "healthy")

    def host_degrade(self, host_id: int) -> float:
        """Multiplicative rail/NIC degrade factor on one host (1.0 ==
        healthy fabric)."""
        return self._host_degrade.get(host_id, 1.0)

    def placeable(self, gpu_id: int) -> bool:
        """False for quarantined/dead GPUs — the admission refusal
        predicate."""
        return self._gpu_health.get(gpu_id) not in _UNPLACEABLE

    def health_state(self) -> Tuple[Tuple[Tuple[int, str], ...],
                                    Tuple[Tuple[int, float], ...]]:
        """Canonical, comparable snapshot of the full health view —
        ``(sorted gpu states, sorted host degrade factors)``.  Two ledgers
        with equal ``health_state()`` + equal allocations + equal version
        are bit-identical for every consumer in the stack (the journal-
        replay acceptance check)."""
        return (
            tuple(sorted(self._gpu_health.items())),
            tuple(sorted(self._host_degrade.items())),
        )

    def _mark_degraded(self, host_id: int) -> None:
        for g in self.cluster.hosts[host_id].gpu_ids:
            if g not in self._gpu_health:  # only lift healthy -> degraded
                self._gpu_health[g] = "degraded"

    def apply_fault(
        self,
        kind: str,
        gpus: Sequence[int] = (),
        host_id: Optional[int] = None,
        factor: float = 1.0,
    ) -> None:
        """Apply one typed fault (see :mod:`repro.core.faults`): journaled
        write-ahead as a ``fault`` event, version bumped by 1 — caches,
        snapshots and in-flight CAS commits staged against the pre-fault
        version all go stale, exactly as an admission would make them."""
        with self.lock:
            if kind not in _LEDGER_FAULT_KINDS:
                raise ValueError(f"unknown fault kind {kind!r}")
            subset = tuple(sorted(int(g) for g in gpus))
            for g in subset:
                if g < 0 or g >= self.cluster.n_gpus:
                    raise InvalidPlacementError(f"GPU id {g} outside cluster")
            if kind in ("nic_flap", "link_degrade", "host_down") and (
                host_id is None
            ):
                raise ValueError(f"{kind} requires host_id")
            if self.journal is not None:
                self.last_journal_seq = self.journal.record(
                    "fault", job_id="", kind=kind,
                    gpus=list(subset) if subset else None,
                    host=host_id, factor=factor if factor != 1.0 else None,
                )
            if kind in ("gpu_down", "host_down"):
                targets = subset or (
                    tuple(self.cluster.hosts[host_id].gpu_ids)
                    if kind == "host_down" else ()
                )
                for g in targets:
                    self._gpu_health[g] = "dead"
            elif kind == "quarantine":
                for g in subset:
                    if self._gpu_health.get(g) != "dead":
                        self._gpu_health[g] = "quarantined"
            else:  # nic_flap / link_degrade
                self._host_degrade[host_id] = float(factor)
                self._mark_degraded(host_id)
            self._version += 1

    def apply_recover(
        self,
        kind: str,
        gpus: Sequence[int] = (),
        host_id: Optional[int] = None,
    ) -> None:
        """Undo one fault (journaled ``recover`` event, version +1).

        Recovery is state-popping, not state-restoring: a GPU whose host
        is still degraded comes back ``degraded``, not ``healthy``, and a
        host recovery leaves dead/quarantined GPUs alone.  Deterministic
        given the event order, which is all journal replay needs."""
        with self.lock:
            if kind not in _LEDGER_FAULT_KINDS:
                raise ValueError(f"unknown fault kind {kind!r}")
            subset = tuple(sorted(int(g) for g in gpus))
            if self.journal is not None:
                self.last_journal_seq = self.journal.record(
                    "recover", job_id="", kind=kind,
                    gpus=list(subset) if subset else None, host=host_id,
                )
            if kind in ("gpu_down", "host_down", "quarantine"):
                for g in subset:
                    self._gpu_health.pop(g, None)
                    hid = self.cluster.gpu_host[g]
                    if self._host_degrade.get(hid, 1.0) != 1.0:
                        self._gpu_health[g] = "degraded"
            else:  # nic_flap / link_degrade
                self._host_degrade.pop(host_id, None)
                for g in self.cluster.hosts[host_id].gpu_ids:
                    if self._gpu_health.get(g) == "degraded":
                        del self._gpu_health[g]
            self._version += 1

    # -- queries ------------------------------------------------------------

    def __len__(self) -> int:
        return len(self._jobs)

    def __contains__(self, job_id: str) -> bool:
        return job_id in self._jobs

    def jobs(self) -> Iterator[Allocation]:
        return iter(self._jobs.values())

    def allocation(self, job_id: str) -> Allocation:
        return self._jobs[job_id]

    def get(self, job_id: str) -> Optional[Allocation]:
        """Atomic lookup: the job's allocation, or None if not live.  THE
        stale-report-safe entry point — one GIL-atomic read instead of the
        ``in`` + ``allocation()`` TOCTOU pair, which races with concurrent
        releases (the allocation can vanish between the two calls)."""
        return self._jobs.get(job_id)

    def busy(self) -> Set[int]:
        return set(self._owner)

    def available(self) -> List[int]:
        """Sorted global ids of all *placeable* GPUs not held by any live
        job.  Quarantined/dead GPUs are excluded — unplaceable by
        construction; the sparse-health fast path keeps the no-fault case
        byte-identical and allocation-free of extra checks."""
        if not self._gpu_health:
            return [
                g for g in range(self.cluster.n_gpus) if g not in self._owner
            ]
        return [
            g for g in range(self.cluster.n_gpus)
            if g not in self._owner
            and self._gpu_health.get(g) not in _UNPLACEABLE
        ]

    def n_free(self) -> int:
        """Number of free *placeable* GPUs — O(faulted GPUs), for scheduler
        capacity checks."""
        n = self.cluster.n_gpus - len(self._owner)
        for g, state in self._gpu_health.items():
            if state in _UNPLACEABLE and g not in self._owner:
                n -= 1
        return n

    def occupancy(self, host_id: int) -> int:
        """Number of busy GPUs on one host."""
        host = self.cluster.hosts[host_id]
        return sum(1 for g in host.gpu_ids if g in self._owner)

    def free_by_host(self) -> Dict[int, int]:
        """host id -> free GPU count, for every host (zeros included)."""
        return {
            h.host_id: h.n_gpus - self.occupancy(h.host_id)
            for h in self.cluster.hosts
        }

    def fragmentation(self):
        """Fragmentation state of the current occupancy — stranding score,
        clean-host count, largest placeable single-host block (a
        :class:`repro.core.defrag.FragmentationMetrics`)."""
        from repro_torch.core.defrag import fragmentation_metrics

        return fragmentation_metrics(self.cluster, self)

    @staticmethod
    def contends(alloc: Allocation, against: Set[int]) -> bool:
        """THE rail-contention predicate (see module docstring): a live job
        contends with a candidate iff it is cross-host and GPU-disjoint from
        it.  Shared by the contended ground truth and the virtual-merge
        estimator so the two can never drift apart."""
        return alloc.cross_host and against.isdisjoint(alloc.gpus)

    def cross_host_jobs_on(
        self, host_id: int, against: Sequence[int] = ()
    ) -> List[Allocation]:
        """Live cross-host jobs with >=1 GPU on ``host_id``, excluding any
        job that shares a GPU with ``against`` (i.e. ``against`` itself)."""
        excluded = set(against)
        return [
            self._jobs[job_id]
            for job_id in sorted(self._host_jobs[host_id])
            if self.contends(self._jobs[job_id], excluded)
        ]

    def cross_jobs_by_host(self) -> Dict[int, List[Allocation]]:
        """Snapshot: host id -> live *cross-host* allocations touching it.

        The contention estimator consumes this once per predict batch; hosts
        with no cross-host tenants are omitted.
        """
        out: Dict[int, List[Allocation]] = {}
        for hid, job_ids in self._host_jobs.items():
            cross = [
                self._jobs[j] for j in sorted(job_ids)
                if self._jobs[j].cross_host
            ]
            if cross:
                out[hid] = cross
        return out

    def rail_contenders(self, host_id: int, against: Sequence[int] = ()) -> int:
        """Number of live collectives competing for ``host_id``'s NIC rails
        against a candidate subset (see module docstring for the predicate)."""
        return len(self.cross_host_jobs_on(host_id, against=against))

    def contender_demands(
        self, host_id: int, against: Sequence[int] = ()
    ) -> Tuple[int, ...]:
        """Per-contender GPU counts on ``host_id`` (one entry per contending
        cross-host job, same predicate as :meth:`rail_contenders`) — the rail
        demands the *saturating* contention model weighs shares by."""
        return tuple(
            sum(1 for g in a.gpus if self.cluster.gpu_host[g] == host_id)
            for a in self.cross_host_jobs_on(host_id, against=against)
        )

    def snapshot(self) -> ContentionSnapshot:
        """Pre-resolved contender counts/demands for candidates drawn from
        ``available()`` (always GPU-disjoint from live jobs)."""
        cross = self.cross_jobs_by_host()
        return ContentionSnapshot(
            {hid: len(jobs) for hid, jobs in cross.items()},
            {
                hid: tuple(
                    sum(1 for g in a.gpus if self.cluster.gpu_host[g] == hid)
                    for a in jobs
                )
                for hid, jobs in cross.items()
            },
            frag=self.fragmentation(),
            degrade=dict(self._host_degrade),
        )

    def describe(self) -> str:
        live = ", ".join(
            f"{a.job_id}:k={a.k}@{list(a.host_ids)}" for a in self.jobs()
        )
        return (
            f"ledger[{self.cluster.name}]: {len(self)} live jobs, "
            f"{len(self._owner)}/{self.cluster.n_gpus} GPUs busy"
            + (f" ({live})" if live else "")
        )
