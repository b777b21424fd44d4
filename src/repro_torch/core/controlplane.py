"""Concurrent-admission control plane: CAS admissions, journal, tenant QoS.

The dispatcher stack below this module is synchronous: one
:class:`~repro.core.dispatcher.DispatcherService` owns one
:class:`~repro.core.tenancy.JobLedger` and admissions mutate it one at a
time.  A production dispatcher fields many simultaneous admission requests
against that single cluster state — and the expensive part of an admission
is the hybrid search, not the ledger mutation.  This module turns the
monotonic ``JobLedger.version`` counter (the cache-invalidation token of
the dispatch fast path) into a concurrency-control token, in three layers:

**Optimistic-concurrency admission** (:class:`AdmissionControlPlane`).  A
worker *stages* a placement: it clones the ledger under its lock (an
O(live jobs) snapshot pinned at ``version = v``), runs the full hybrid
search against the snapshot lock-free, then *commits* via
``JobLedger.admit_if(job_id, gpus, version=v)`` — a compare-and-swap that
succeeds only if no other admission/release landed in between.  On a
version conflict the worker first tries **read-set validation**: a staged
placement's score is a pure function of (its GPUs being free, the
cross-host contender allocations on each of its hosts), so if both facts
are unchanged between the snapshot and the live ledger, the placement is
exactly as good as it was scored and commits at the current version
without re-searching (a *validated* commit — it may no longer be the
global argmax against the moved state; ``strict=True`` disables this and
forces a re-search on any version move).  Only when the read-set itself
moved does the worker re-search against a fresh snapshot, bounded by
``max_retries`` re-searches; past the bound it runs the search while
holding the ledger lock (guaranteed progress).  A request that cannot fit
— or exceeds its tenant's concurrency cap — parks on a FIFO queue pumped
at every release.  Many admissions overlap their searches; only the cheap
commits serialize.

**Crash-safe append-only journal** (:class:`LedgerJournal` /
:func:`replay_journal`).  Every admit/release/migrate is serialized to an
append-only file *before* the in-memory mutation (write-ahead, hooked
inside ``JobLedger``): one line per event, ``<canonical json>#<crc32>``,
with a contiguous sequence number.  Recovery re-applies events in order
and rebuilds a **bit-identical** ledger — same allocations, same version
counter (admit/release bump 1, migrate bumps 2, exactly like the live
mutations), hence identical fragmentation metrics and identical
version-keyed cache behaviour.  A torn tail (truncation mid-record, a
corrupted crc, a sequence gap) ends the replay at the last durable prefix
— property-tested against random event streams with injected truncation
and corruption in ``tests/test_controlplane.py``.

**Per-tenant QoS policies** (:class:`TenantPolicy`).  A tenant carries a
plan tier, a live-job concurrency cap, a queue-depth cap and a priority
boost.  The control plane enforces the caps at admission (over-concurrent
requests park, over-queued requests are rejected); the admission
scheduler's queue policies consume ``priority_boost`` for their candidate
ordering (see ``SchedulerConfig(tenant_policies=...)`` in
:mod:`repro.core.scheduler`).

See ``docs/controlplane.md`` for the protocol walkthrough and the
staleness caveat on validated commits.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
import zlib
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core import telemetry
from repro_torch.core.tenancy import (
    Allocation,
    CapacityError,
    InvalidPlacementError,
    JobLedger,
    VersionConflict,
)

Subset = List[int]

__all__ = [
    "AdmissionControlPlane",
    "AdmissionOutcome",
    "CapacityError",
    "ControlPlaneStats",
    "InvalidPlacementError",
    "JournalEvent",
    "LedgerJournal",
    "TenantPolicy",
    "VersionConflict",
    "read_journal",
    "replay_journal",
]


# ---------------------------------------------------------------------------
# Crash-safe append-only journal
# ---------------------------------------------------------------------------

JOURNAL_OPS = ("admit", "release", "migrate", "fault", "recover")


@dataclasses.dataclass(frozen=True)
class JournalEvent:
    """One durable ledger mutation, in commit order."""

    seq: int
    op: str        # "admit" | "release" | "migrate" | "fault" | "recover"
    job_id: str
    gpus: Optional[Tuple[int, ...]] = None  # admit/migrate/fault targets
    tenant: str = ""                        # "" = no tenant (key omitted)
    kind: Optional[str] = None              # fault/recover: fault kind
    host: Optional[int] = None              # fault/recover: host id
    factor: Optional[float] = None          # fault: rail degrade factor


def _encode_event(seq: int, op: str, job_id: str, gpus=None,
                  tenant: str = "", kind=None, host=None,
                  factor=None) -> bytes:
    """``<canonical json>#<crc32 hex>\\n`` — compact, key-sorted json so a
    record's bytes are a pure function of the event.  The ``tenant`` key
    is emitted only when non-empty, and the fault keys (``kind``/``host``/
    ``factor``) only when set, so admit/release/migrate streams are
    byte-identical to the original journal grammar."""
    payload: Dict = {"seq": seq, "op": op, "job": job_id}
    if gpus is not None:
        payload["gpus"] = [int(g) for g in gpus]
    if tenant:
        payload["tenant"] = tenant
    if kind is not None:
        payload["kind"] = kind
    if host is not None:
        payload["host"] = int(host)
    if factor is not None:
        payload["factor"] = float(factor)
    line = json.dumps(payload, separators=(",", ":"), sort_keys=True)
    crc = zlib.crc32(line.encode("utf-8")) & 0xFFFFFFFF
    return f"{line}#{crc:08x}\n".encode("utf-8")


def _scan(raw: bytes) -> Tuple[List[JournalEvent], int]:
    """Parse the longest durable prefix of journal bytes.

    Returns ``(events, valid_end)`` where ``valid_end`` is the byte offset
    just past the last valid record.  Stops (without raising) at the first
    torn record: a chunk missing its trailing newline, a crc mismatch,
    unparseable json, an unknown op, or a sequence discontinuity.
    Everything before that point was written and flushed in full, so the
    prefix is exactly the recoverable state.
    """
    events: List[JournalEvent] = []
    pos = valid_end = 0
    expected = 0
    while True:
        nl = raw.find(b"\n", pos)
        if nl < 0:  # no newline: the tail (if any) is torn
            break
        chunk = raw[pos:nl]
        try:
            text = chunk.decode("utf-8")
            payload, sep, crc_hex = text.rpartition("#")
            if not sep or len(crc_hex) != 8:
                break
            if (zlib.crc32(payload.encode("utf-8")) & 0xFFFFFFFF) != int(
                crc_hex, 16
            ):
                break
            ev = json.loads(payload)
            if ev.get("op") not in JOURNAL_OPS or ev.get("seq") != expected:
                break
            gpus = ev.get("gpus")
            factor = ev.get("factor")
            events.append(JournalEvent(
                ev["seq"], ev["op"], ev["job"],
                tuple(int(g) for g in gpus) if gpus is not None else None,
                str(ev.get("tenant", "")),
                kind=ev.get("kind"),
                host=ev.get("host"),
                factor=float(factor) if factor is not None else None,
            ))
        except (ValueError, KeyError, TypeError, UnicodeDecodeError):
            break
        pos = valid_end = nl + 1
        expected += 1
    return events, valid_end


def read_journal(path) -> List[JournalEvent]:
    """The durable event prefix of a journal file (empty if absent)."""
    if not os.path.exists(path):
        return []
    with open(path, "rb") as fh:
        raw = fh.read()
    return _scan(raw)[0]


class LedgerJournal:
    """Append-only write-ahead journal for one :class:`JobLedger`.

    Records are written *before* the in-memory mutation they describe
    (inside the ledger lock, so journal order == commit order) and flushed
    per record; ``sync=True`` additionally fsyncs, trading admission
    latency for power-loss durability.

    Opening an existing journal truncates any torn tail left by a crash
    and resumes the sequence after the last valid record, so recovery
    (:func:`replay_journal` + ``attach_journal(..., recovered=True)``)
    continues the same file seamlessly.
    """

    def __init__(self, path, sync: bool = False):
        self.path = str(path)
        self.sync = sync
        self._lock = threading.Lock()
        self._seq = 0
        self.n_records = 0
        if os.path.exists(self.path):
            with open(self.path, "rb") as fh:
                raw = fh.read()
            events, valid_end = _scan(raw)
            self._seq = len(events)
            if valid_end < len(raw):  # drop the torn tail before appending
                with open(self.path, "r+b") as fh:
                    fh.truncate(valid_end)
        self._fh = open(self.path, "ab")

    def record(self, op: str, job_id: str, gpus=None,
               tenant: str = "", kind=None, host=None,
               factor=None) -> int:
        """Append one event durably (called by the ledger, write-ahead).
        Returns the event's sequence number, so the caller can correlate
        the in-memory commit with its journal line (admission spans and
        forensics dossiers carry it as ``journal_seq``)."""
        if op not in JOURNAL_OPS:
            raise ValueError(f"unknown journal op {op!r}")
        with self._lock:
            seq = self._seq
            data = _encode_event(seq, op, job_id, gpus, tenant=tenant,
                                 kind=kind, host=host, factor=factor)
            self._fh.write(data)
            self._fh.flush()
            if self.sync:
                os.fsync(self._fh.fileno())
            self._seq += 1
            self.n_records += 1
            return seq

    def close(self) -> None:
        self._fh.close()

    def __enter__(self) -> "LedgerJournal":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def replay_journal(path, cluster, upto_seq: Optional[int] = None) -> JobLedger:
    """Rebuild a ledger from a journal: apply the durable event prefix in
    order onto a fresh (journal-less) ledger.  Bit-identical recovery —
    identical allocations, identical ``version`` (admit/release bump 1,
    migrate bumps 2, exactly like the live mutations the journal shadows),
    hence identical fragmentation metrics.  Attach a fresh
    :class:`LedgerJournal` on the same path afterwards (``attach_journal(
    journal, recovered=True)``) to keep appending to the same file.

    ``upto_seq`` stops the replay *before* applying the event with that
    sequence number — the time-travel primitive behind
    :func:`repro.core.forensics.reconstruct`, which rebuilds the exact
    ledger view the admission at ``seq`` was decided against."""
    ledger = JobLedger(cluster)
    for ev in read_journal(path):
        if upto_seq is not None and ev.seq >= upto_seq:
            break
        if ev.op == "admit":
            ledger.admit(ev.job_id, ev.gpus, tenant=ev.tenant)
        elif ev.op == "release":
            ledger.release(ev.job_id)
        elif ev.op == "fault":
            ledger.apply_fault(
                ev.kind, gpus=ev.gpus or (), host_id=ev.host,
                factor=ev.factor if ev.factor is not None else 1.0,
            )
        elif ev.op == "recover":
            ledger.apply_recover(
                ev.kind, gpus=ev.gpus or (), host_id=ev.host
            )
        else:  # migrate
            ledger.migrate(ev.job_id, ev.gpus)
    return ledger


# ---------------------------------------------------------------------------
# Per-tenant QoS policies
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TenantPolicy:
    """Admission-time QoS knobs for one tenant (modelops-style plan rows).

    ``max_concurrent`` caps the tenant's simultaneously-live jobs: requests
    beyond it park until one of the tenant's jobs releases.  ``max_queued``
    caps its waiting depth: requests beyond it are *rejected* outright.
    ``priority_boost`` is consumed by the admission scheduler's queue
    policies (higher boost is considered first); the control plane itself
    treats parked requests FIFO.  ``None`` caps mean unlimited — the
    default policy is a no-op.
    """

    plan: str = "standard"
    max_concurrent: Optional[int] = None
    max_queued: Optional[int] = None
    priority_boost: int = 0

    def __post_init__(self):
        if self.max_concurrent is not None and self.max_concurrent < 1:
            raise ValueError("max_concurrent must be >= 1 (or None)")
        if self.max_queued is not None and self.max_queued < 0:
            raise ValueError("max_queued must be >= 0 (or None)")


# ---------------------------------------------------------------------------
# Optimistic-concurrency admission service
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class AdmissionOutcome:
    """What happened to one admission request."""

    job_id: str
    tenant: str
    status: str                    # "admitted" | "rejected"
    alloc: Optional[Allocation] = None
    predicted_bw: float = float("nan")
    staged_version: int = -1       # version the committed search ran against
    committed_version: int = -1    # ledger version right after the commit
    retries: int = 0               # re-searches forced by moved read-sets
    validated: bool = False        # committed via read-set validation
    serialized: bool = False       # retry bound hit: searched under the lock
    parked: bool = False           # waited on the capacity/QoS queue
    reason: str = ""               # rejection cause
    seconds: float = 0.0           # submit-to-resolution wall time
    journal_seq: int = -1          # seq of the commit's journal line (-1:
                                   # no journal attached)

    @property
    def admitted(self) -> bool:
        return self.status == "admitted"

    def to_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        d["alloc"] = list(self.alloc.gpus) if self.alloc is not None else None
        return d


@dataclasses.dataclass
class ControlPlaneStats:
    """Aggregate admission-path counters (reported by the bench).

    Commit kinds partition the admissions:
    ``n_cas_commits + n_validated + n_serialized == n_admitted`` — the
    invariant the metrics registry asserts at absorb time
    (:func:`repro.core.telemetry.absorb_controlplane_stats`).  Reset/merge
    semantics mirror :class:`~repro.core.predict_cache.PredictorStats`:
    one stats object per control plane, no nesting, so ``merged`` over
    *distinct* planes never double-counts.
    """

    n_admitted: int = 0
    n_cas_commits: int = 0       # committed at the staged version (clean CAS)
    n_validated: int = 0         # committed after read-set validation
    n_conflicts: int = 0         # re-searches forced by moved read-sets
    n_serialized: int = 0        # retry bound hit: search ran under the lock
    n_parked: int = 0            # park events (capacity / tenant caps)
    n_rejected: int = 0
    search_seconds: float = 0.0
    commit_seconds: float = 0.0

    def to_dict(self) -> Dict[str, float]:
        return dataclasses.asdict(self)

    # legacy name (benchmarks/tests predate the unified to_dict convention)
    def as_dict(self) -> Dict[str, float]:
        return self.to_dict()

    def reset(self) -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, f.default)

    @classmethod
    def merged(cls, *stats: "ControlPlaneStats") -> "ControlPlaneStats":
        """Field-wise sum over stats of *distinct* control planes."""
        out = cls()
        for s in stats:
            for f in dataclasses.fields(cls):
                setattr(out, f.name, getattr(out, f.name) + getattr(s, f.name))
        return out


@dataclasses.dataclass
class _Request:
    job_id: str
    k: int
    tenant: str
    future: Future
    t_submit: float
    retries: int = 0
    parked: bool = False


class AdmissionControlPlane:
    """Async admission service over one dispatcher: staged searches commit
    via ledger-version CAS, with write-ahead journaling and tenant QoS.

    ``dispatcher`` is any :class:`~repro.core.dispatcher.DispatcherService`
    — a BandPilot dispatcher's ``tables``/``base_predictor`` unlock the
    snapshot-pinned hybrid-search staging path; anything else stages
    through its plain ``dispatch`` against the snapshot's availability.
    :meth:`submit` returns a ``Future[AdmissionOutcome]``; parked requests
    (capacity or tenant caps) resolve when a later :meth:`release` admits
    them, or immediately with ``status="rejected"`` when a queue cap is
    hit.  ``batch_applies=True`` registers every staged search with a
    shared :class:`~repro.core.predict_cache.InferenceBatcher`, fusing
    overlapping workers' surrogate applies into shared device calls —
    fused applies amortize XLA dispatch overhead, and the applies
    themselves release the GIL so multi-core hosts overlap them with
    peer searches.  ``batch_wait`` bounds the fusion rendezvous; keep it
    well under one search's runtime or fusion degrades into convoy
    stalls (see ``benchmarks/bench_controlplane.py``).
    """

    def __init__(
        self,
        dispatcher,
        n_workers: int = 4,
        policies: Optional[Dict[str, TenantPolicy]] = None,
        journal=None,
        max_retries: int = 3,
        strict: bool = False,
        batch_applies: bool = True,
        batch_wait: float = 0.0005,
        rng=None,
    ):
        if n_workers < 1:
            raise ValueError("n_workers must be >= 1")
        if max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        self.dispatcher = dispatcher
        self.cluster = dispatcher.cluster
        self.ledger: JobLedger = dispatcher.ledger
        self.policies = dict(policies or {})
        self.max_retries = max_retries
        self.strict = strict
        self.n_workers = n_workers
        self.rng = rng
        self._rng_lock = threading.Lock()
        self.stats = ControlPlaneStats()
        self._stats_lock = threading.Lock()
        # tenant accounting + parked queue share one state lock; lock order
        # is serial -> ledger -> state -> stats (never the reverse)
        self._state_lock = threading.Lock()
        self._tenant_live: Dict[str, int] = {}
        self._tenant_waiting: Dict[str, int] = {}
        self._job_tenant: Dict[str, str] = {}
        self._parked: deque = deque()  # _Request, FIFO
        self._serial_lock = threading.Lock()  # one serialized search at once
        self._pool = ThreadPoolExecutor(
            max_workers=n_workers, thread_name_prefix="admission"
        )
        self._batcher = None
        if batch_applies and n_workers > 1:
            from repro_torch.core.predict_cache import InferenceBatcher

            # A short rendezvous beats the batcher's 5 ms default here:
            # an admission worker stalls every peer parked in apply() while
            # it grinds through GIL-bound Python between its own applies,
            # so long waits turn fusion into convoy stalls
            self._batcher = InferenceBatcher(wait_timeout=batch_wait)
        if journal is not None:
            if isinstance(journal, (str, os.PathLike)):
                journal = LedgerJournal(journal)
            self.ledger.attach_journal(
                journal,
                recovered=len(self.ledger) > 0 or self.ledger.version > 0,
            )
        self.journal = self.ledger.journal

    # -- public -------------------------------------------------------------

    def submit(self, job_id: str, k: int, tenant: str = "") -> Future:
        """Enqueue one admission; resolves at admission or rejection (a
        capacity/QoS wait resolves when a later release admits it)."""
        if k < 1 or k > self.cluster.n_gpus:
            raise CapacityError(
                f"k={k} can never fit the {self.cluster.n_gpus}-GPU cluster"
            )
        req = _Request(job_id, int(k), tenant, Future(), time.time())
        pol = self.policies.get(tenant)
        with self._state_lock:
            reject = (
                pol is not None and pol.max_queued is not None
                and self._tenant_waiting.get(tenant, 0) >= pol.max_queued
            )
            if not reject:
                self._tenant_waiting[tenant] = (
                    self._tenant_waiting.get(tenant, 0) + 1
                )
        if reject:
            self._finish_rejected(
                req, f"tenant {tenant!r} queue full "
                f"(max_queued={pol.max_queued})"
            )
        else:
            self._pool.submit(self._run_request, req)
        return req.future

    def admit_many(
        self, requests: Sequence[Tuple], timeout: Optional[float] = None
    ) -> List[AdmissionOutcome]:
        """Submit ``(job_id, k[, tenant])`` tuples and wait for them all."""
        futures = [self.submit(*r) for r in requests]
        return [f.result(timeout=timeout) for f in futures]

    def release(self, job_id: str) -> Allocation:
        """Release a live job (journaled via the ledger) and pump the
        parked queue — the admission side of the release path."""
        alloc = self.ledger.release(job_id)
        with self._state_lock:
            tenant = self._job_tenant.pop(job_id, None)
            if tenant is not None:
                self._tenant_live[tenant] -= 1
        self._pump()
        return alloc

    def pending(self) -> int:
        """Requests parked for capacity or tenant caps right now."""
        with self._state_lock:
            return len(self._parked)

    def shutdown(self, wait: bool = True) -> None:
        """Stop the worker pool.  Parked requests stay unresolved — drain
        them (via releases) before shutting down if their futures matter."""
        self._pool.shutdown(wait=wait)

    def __enter__(self) -> "AdmissionControlPlane":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()

    # -- request lifecycle --------------------------------------------------

    def _finish_rejected(self, req: _Request, reason: str) -> None:
        with self._stats_lock:
            self.stats.n_rejected += 1
        req.future.set_result(AdmissionOutcome(
            req.job_id, req.tenant, "rejected", reason=reason,
            parked=req.parked, seconds=time.time() - req.t_submit,
        ))

    def _park(self, req: _Request) -> None:
        """Capacity / tenant-cap wait: requeue FIFO, pumped at releases."""
        req.parked = True
        with self._state_lock:
            self._parked.append(req)
        with self._stats_lock:
            self.stats.n_parked += 1
        telemetry.event("cplane.park", job_id=req.job_id, k=req.k)

    def _pump(self) -> None:
        """Re-dispatch every parked request: a release may have opened any
        of their gates (re-parking the still-blocked ones is cheap)."""
        with self._state_lock:
            parked, self._parked = list(self._parked), deque()
        if parked:
            telemetry.event("cplane.pump", n_requeued=len(parked))
        for req in parked:
            self._pool.submit(self._run_request, req)

    def _run_request(self, req: _Request) -> None:
        try:
            outcome = self._admit_one(req)
        except BaseException as e:  # noqa: BLE001 — surface via the future
            self._done_waiting(req)
            req.future.set_exception(e)
            return
        if outcome is not None:  # None: parked, resolves at a later pump
            self._done_waiting(req)
            req.future.set_result(outcome)

    def _done_waiting(self, req: _Request) -> None:
        with self._state_lock:
            self._tenant_waiting[req.tenant] = max(
                self._tenant_waiting.get(req.tenant, 1) - 1, 0
            )

    def _admit_one(self, req: _Request) -> Optional[AdmissionOutcome]:
        """Stage/commit cycle for one request; None means parked.  Runs
        entirely on one pool worker thread, so the (thread-local) forensics
        decision draft opened here collects the staged search's provenance
        and seals into a dossier iff the request commits."""
        from repro_torch.core import forensics

        with forensics.decision(
            req.job_id, tenant=req.tenant, k=req.k, path="cplane",
        ) as draft:
            outcome = self._admit_one_inner(req)
            if draft is not None and outcome is not None and outcome.admitted:
                draft.commit(
                    subset=outcome.alloc.gpus,
                    predicted_bw=outcome.predicted_bw,
                    journal_seq=outcome.journal_seq,
                    staged_version=outcome.staged_version,
                    committed_version=outcome.committed_version,
                    validated=outcome.validated,
                    serialized=outcome.serialized,
                    retries=outcome.retries,
                )
            return outcome

    def _admit_one_inner(self, req: _Request) -> Optional[AdmissionOutcome]:
        pol = self.policies.get(req.tenant)
        if pol is not None and pol.max_concurrent is not None:
            with self._state_lock:
                over = (self._tenant_live.get(req.tenant, 0)
                        >= pol.max_concurrent)
            if over:
                self._park(req)
                return None
        ledger = self.ledger
        while True:
            snapshot = ledger.clone()  # clones under the ledger lock
            if req.k > snapshot.n_free():
                self._park(req)
                return None
            t0 = time.time()
            with telemetry.span(
                "cplane.stage", job_id=req.job_id, k=req.k,
                staged_version=snapshot.version, retry=req.retries,
            ):
                subset, predicted = self._search(snapshot, req.k)
            with self._stats_lock:
                self.stats.search_seconds += time.time() - t0
            self._check_placement(subset, snapshot, req)
            t1 = time.time()
            with telemetry.span(
                "cplane.commit", job_id=req.job_id,
                staged_version=snapshot.version,
            ) as sp:
                outcome = self._try_commit(req, subset, predicted, snapshot)
                if sp:
                    sp["result"] = (
                        "conflict" if outcome is None
                        else "validated" if outcome.validated else "cas"
                    )
                    if outcome is not None:
                        sp["journal_seq"] = outcome.journal_seq
            with self._stats_lock:
                self.stats.commit_seconds += time.time() - t1
            if outcome is not None:
                return outcome
            # read-set moved underneath the search: re-search (bounded)
            req.retries += 1
            with self._stats_lock:
                self.stats.n_conflicts += 1
            if req.retries > self.max_retries:
                return self._admit_serialized(req)

    def _try_commit(
        self, req: _Request, subset: Subset, predicted: float,
        snapshot: JobLedger,
    ) -> Optional[AdmissionOutcome]:
        """CAS first; on version movement, read-set validation; else None
        (the caller re-searches)."""
        ledger = self.ledger
        staged = snapshot.version
        with ledger.lock:
            if ledger.version == staged:
                alloc = ledger.admit_if(
                    req.job_id, subset, staged, tenant=req.tenant
                )
                validated = False
            elif not self.strict and self._placement_unaffected(
                subset, snapshot
            ):
                alloc = ledger.admit(req.job_id, subset, tenant=req.tenant)
                validated = True
            else:
                return None
            committed = ledger.version
            # under the lock, so this is *our* commit's journal line
            seq = ledger.last_journal_seq if ledger.journal is not None else -1
            self._note_admitted(req, validated)
        return AdmissionOutcome(
            req.job_id, req.tenant, "admitted", alloc=alloc,
            predicted_bw=predicted, staged_version=staged,
            committed_version=committed, retries=req.retries,
            validated=validated, parked=req.parked,
            seconds=time.time() - req.t_submit, journal_seq=seq,
        )

    def _admit_serialized(self, req: _Request) -> Optional[AdmissionOutcome]:
        """Retry bound exhausted: search while holding the ledger lock (no
        one can move the state mid-search, so the commit cannot conflict).
        Other workers' searches keep running; only their commits block."""
        ledger = self.ledger
        with self._serial_lock, ledger.lock, telemetry.span(
            "cplane.serialized", job_id=req.job_id, k=req.k,
            retries=req.retries,
        ) as sp:
            if req.k > ledger.n_free():
                parked = True
            else:
                parked = False
                v = ledger.version
                subset, predicted = self._search(ledger, req.k)
                self._check_placement(subset, ledger, req)
                alloc = ledger.admit_if(
                    req.job_id, subset, v, tenant=req.tenant
                )
                seq = (ledger.last_journal_seq
                       if ledger.journal is not None else -1)
                if sp:
                    sp["journal_seq"] = seq
                self._note_admitted(req, validated=False, serialized=True)
        if parked:
            self._park(req)
            return None
        return AdmissionOutcome(
            req.job_id, req.tenant, "admitted", alloc=alloc,
            predicted_bw=predicted, staged_version=v, committed_version=v + 1,
            retries=req.retries, serialized=True, parked=req.parked,
            seconds=time.time() - req.t_submit, journal_seq=seq,
        )

    def _note_admitted(
        self, req: _Request, validated: bool, serialized: bool = False
    ) -> None:
        with self._state_lock:
            self._tenant_live[req.tenant] = (
                self._tenant_live.get(req.tenant, 0) + 1
            )
            self._job_tenant[req.job_id] = req.tenant
        with self._stats_lock:
            self.stats.n_admitted += 1
            if serialized:
                self.stats.n_serialized += 1
            elif validated:
                self.stats.n_validated += 1
            else:
                self.stats.n_cas_commits += 1

    # -- staged search ------------------------------------------------------

    def _search(self, view: JobLedger, k: int) -> Tuple[Subset, float]:
        """Run the dispatcher's placement policy against a ledger view
        (snapshot clone, or the live ledger under lock for the serialized
        fallback).  BandPilot dispatchers get the full snapshot-pinned
        chain — contention wrapper over the *view*, fresh version-keyed
        prediction cache, the dispatcher's shared isolated memo inside
        ``base_predictor``, optional fragmentation tie-break; plain
        dispatchers stage through ``dispatch``."""
        d = self.dispatcher
        avail = view.available()
        if hasattr(d, "tables") and hasattr(d, "base_predictor"):
            from repro_torch.core import search as search_mod
            from repro_torch.core.predict_cache import cached_contention_predictor

            if d.contention_aware:
                pred = cached_contention_predictor(
                    self.cluster, d.base_predictor, view,
                    mode=d.contention_mode, contended=d.contended_predictor,
                    use_cache=d.prediction_cache is not None,
                )
            else:
                pred = d.base_predictor
            penalty = None
            if d.frag_weight > 0:
                from repro_torch.core.defrag import make_frag_penalty

                penalty = make_frag_penalty(self.cluster, view, d.frag_weight)

            def run():
                from repro_torch.core import forensics

                res = search_mod.hybrid_search(
                    self.cluster, d.tables, pred, avail, k,
                    frag_penalty=penalty,
                )
                df = forensics.draft()
                if df is not None:  # post-selection: cannot alter the choice
                    df.note_decomposition(forensics.bandwidth_decomposition(
                        self.cluster, d.tables, view, res.subset,
                        d.base_predictor,
                        predicted_bw=float(res.predicted_bw),
                        contention_mode=(d.contention_mode
                                         if d.contention_aware else "off"),
                    ))
                return list(res.subset), float(res.predicted_bw)

        else:
            def run():
                if getattr(d, "needs_rng", False):
                    with self._rng_lock:
                        return list(d.dispatch(avail, k, rng=self.rng)), \
                            float("nan")
                return list(d.dispatch(avail, k)), float("nan")

        if self._batcher is not None:
            with self._batcher.worker():
                return run()
        return run()

    def _check_placement(self, subset, view: JobLedger, req: _Request):
        if len(subset) != req.k or not set(subset) <= set(view.available()):
            raise InvalidPlacementError(
                f"policy returned an invalid allocation for "
                f"{req.job_id!r} (k={req.k}): {subset}"
            )

    def _placement_unaffected(
        self, subset: Subset, snapshot: JobLedger
    ) -> bool:
        """Read-set validation, called under the ledger lock: the staged
        placement's contention-degraded score is a pure function of (its
        GPUs being free, the cross-host contender allocations on each of
        its hosts).  Compare both facts between the live ledger and the
        snapshot the search actually saw — :class:`Allocation` records are
        frozen and compare by value, and ``cross_host_jobs_on`` sorts by
        job id, so list equality is exact.  A fragmentation tie-break
        makes the score depend on *global* occupancy, so any version move
        invalidates it outright."""
        ledger = self.ledger
        if not set(subset).isdisjoint(ledger.busy()):
            return False
        # Any active health perturbation invalidates the staged score
        # outright: the fault that bumped the version may have killed one
        # of these GPUs (free != placeable) or degraded a rail the score
        # depends on.  Faults are rare; re-searching is the cheap safe
        # answer, and admit() refuses unplaceable GPUs regardless.
        if ledger.health_active:
            return False
        if getattr(self.dispatcher, "frag_weight", 0.0) > 0:
            return False
        for hid in self.cluster.partition_by_host(subset):
            if (ledger.cross_host_jobs_on(hid, against=subset)
                    != snapshot.cross_host_jobs_on(hid, against=subset)):
                return False
        return True
