"""Dispatch forensics: decision attribution, journal time-travel, what-if.

With the observability layer the dispatch stack could say *that* a decision happened —
spans, metrics, drift alerts — but not *why* the search picked this subset
over that one, or what the choice cost the tenant.  This module closes
that gap with three layers, all read-only with respect to the dispatch
decision (capture ON commits byte-identical placements to capture OFF —
pinned by ``tests/test_forensics.py`` and the
``dispatch_forensics_overhead`` bench row):

**Attribution** (:class:`DecisionDossier` / :class:`DossierRecorder`).
Every committed admission produces a structured dossier: the journal
``seq`` and span ``trace_id`` it committed under, per-round search
provenance (candidates scored, PTS prune-and-why, per-round bottleneck
eliminations, the EHA-vs-PTS winner and its margin), the Stage-1
intra-host vs inter-host rail decomposition of the predicted bandwidth,
the analytic/learned contention-cap delta, and the fragmentation
tie-break state.  Capture rides the same falsy-null-guard pattern as the
tracer: hooks in ``search.py`` / ``dispatcher.py`` / ``scheduler.py`` /
``controlplane.py`` call :func:`draft`, which costs one module-global
read when no recorder is installed.  Drafts are thread-local (one
admission runs on one thread — pool workers included), so racing
control-plane workers never interleave provenance.

**Time-travel** (:func:`reconstruct` / :func:`replay_decision`).
``reconstruct(path, cluster, seq)`` rebuilds the exact ledger view the
admission at journal ``seq`` was decided against (via
``replay_journal(..., upto_seq=seq)``), and ``replay_decision`` re-runs
the dispatcher's search recipe against it — reproducing the journaled
placement byte-identically for every deterministic admission path
(serial, planned, serialized, and CAS commits; a *validated* concurrent
commit was staged against an older snapshot, so re-searching the
commit-time state legitimately may differ — see docs/observability.md).

**Counterfactual what-if** (:func:`whatif`).  Re-dispatch the same
request against the reconstructed ledger under perturbed config —
``drop_tenant=`` / ``drop_jobs=`` evict co-tenants, ``frag_weight=`` /
``contention_mode=`` / ``policy=`` override the search recipe — and
report the true-bandwidth delta.  Deltas feed the per-tenant
:class:`RegretLedger` (realized vs oracle vs best-counterfactual),
exported into a :class:`~repro.core.telemetry.MetricsRegistry` by
:func:`absorb_regret` and rendered by ``scripts/render_forensics.py``.

See ``docs/observability.md`` §5 for the dossier schema and regret
semantics.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import threading
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import telemetry
from repro_torch.core.controlplane import JournalEvent, read_journal, replay_journal
from repro_torch.core.tenancy import JobLedger

__all__ = [
    "DecisionDossier",
    "DossierRecorder",
    "RegretLedger",
    "ReplayResult",
    "WhatIfReport",
    "absorb_regret",
    "bandwidth_decomposition",
    "capture",
    "decision",
    "draft",
    "active_recorder",
    "install_forensics",
    "note_grade",
    "reconstruct",
    "replay_decision",
    "whatif",
]

_TLS = threading.local()                       # per-thread draft stack
_ACTIVE: Optional["DossierRecorder"] = None    # process-wide opt-in
_INSTALL_LOCK = threading.Lock()

_MAX_ROUNDS = 512  # provenance bound: drop round detail past this, not data


def _isfinite(x: float) -> bool:
    return isinstance(x, (int, float)) and math.isfinite(x)


# ---------------------------------------------------------------------------
# Drafts and dossiers (attribution)
# ---------------------------------------------------------------------------

class DecisionDraft:
    """Mutable per-admission scratchpad the hook sites write into.

    Opened by :func:`decision` on the admitting thread, filled by the
    search/dispatch/control-plane hooks (via :func:`draft`), sealed into a
    :class:`DecisionDossier` iff the admission commits.  A make-room defrag
    pass (or a control-plane re-search after a conflict) runs extra hybrid
    searches inside the same admission: each ``hybrid_search`` call resets
    the search provenance (:meth:`note_search_begin`), so the sealed
    dossier always describes the search whose subset actually committed.
    """

    __slots__ = (
        "job_id", "tenant", "k", "policy", "path", "trace_id",
        "subset", "predicted_bw", "journal_seq",
        "staged_version", "committed_version",
        "validated", "serialized", "retries", "committed",
        "n_avail", "frag_active", "n_searches",
        "winner", "winner_margin", "eha", "pts",
        "eha_score", "pts_score",
        "pts_prune", "pts_fused_steps", "pts_rounds",
        "decomposition",
    )

    def __init__(self, job_id: str, tenant: str, k: int,
                 policy: str, path: str):
        self.job_id = job_id
        self.tenant = tenant
        self.k = k
        self.policy = policy
        self.path = path
        self.trace_id = -1
        self.subset: Optional[Tuple[int, ...]] = None
        self.predicted_bw = float("nan")
        self.journal_seq = -1
        self.staged_version = -1
        self.committed_version = -1
        self.validated = False
        self.serialized = False
        self.retries = 0
        self.committed = False
        self.n_avail = 0
        self.frag_active = False
        self.n_searches = 0
        self.winner = ""
        self.winner_margin = float("nan")
        self.eha: Optional[Dict] = None
        self.pts: Optional[Dict] = None
        self.eha_score = float("nan")
        self.pts_score = float("nan")
        self.pts_prune: Optional[Dict] = None
        self.pts_fused_steps = 0
        self.pts_rounds: List[Dict] = []
        self.decomposition: Optional[Dict] = None

    # -- hook-site API (all O(1) per call) ----------------------------------

    def note_search_begin(self, k: int, n_avail: int,
                          frag_active: bool) -> None:
        """A hybrid search starts: reset per-search provenance (later
        searches within one admission overwrite earlier ones — the last
        search is the one whose result commits)."""
        self.n_avail = n_avail
        self.frag_active = frag_active
        self.n_searches += 1
        self.winner = ""
        self.winner_margin = float("nan")
        self.eha = self.pts = None
        self.eha_score = self.pts_score = float("nan")
        self.pts_prune = None
        self.pts_fused_steps = 0
        self.pts_rounds = []
        if self.trace_id < 0:
            self.trace_id = telemetry.current_trace_id()

    def note_hybrid(self, eha, pts, eha_score: float, pts_score: float,
                    winner: str) -> None:
        self.eha = _search_summary(eha)
        self.pts = _search_summary(pts)
        self.eha_score = float(eha_score)
        self.pts_score = float(pts_score)
        self.winner = winner
        self.winner_margin = abs(float(eha_score) - float(pts_score))

    def note_pts_prune(self, host_id: int, pruned: int) -> None:
        self.pts_prune = {"kind": "single_host", "host_id": int(host_id),
                          "pruned": int(pruned)}

    def note_pts_fused(self, steps: int) -> None:
        self.pts_fused_steps = int(steps)

    def note_pts_round(self, eliminated_gpu: int, score: float,
                       n_children: int) -> None:
        if len(self.pts_rounds) < _MAX_ROUNDS:
            self.pts_rounds.append({
                "eliminated": int(eliminated_gpu),
                "score": float(score),
                "n_children": int(n_children),
            })

    def note_decomposition(self, decomp: Dict) -> None:
        self.decomposition = decomp

    def commit(self, subset: Sequence[int], predicted_bw: float,
               journal_seq: int = -1, staged_version: int = -1,
               committed_version: int = -1, validated: bool = False,
               serialized: bool = False, retries: int = 0) -> None:
        """The admission committed: stamp the outcome; the enclosing
        :func:`decision` context seals the draft into a dossier."""
        self.subset = tuple(int(g) for g in subset)
        self.predicted_bw = float(predicted_bw)
        self.journal_seq = int(journal_seq)
        self.staged_version = int(staged_version)
        self.committed_version = int(committed_version)
        self.validated = bool(validated)
        self.serialized = bool(serialized)
        if self.committed:
            return
        self.retries = int(retries)
        self.committed = True
        if self.trace_id < 0:
            self.trace_id = telemetry.current_trace_id()
        # Seal NOW, not at context exit: the grading path runs inside the
        # decision context (right after commit), and its note_grade must
        # find the dossier already recorded to back-fill realized/oracle.
        rec = _ACTIVE
        if rec is not None:
            rec._record(_seal(self))


def _search_summary(res) -> Dict:
    """Compact provenance of one :class:`~repro.core.search.SearchResult`."""
    return {
        "subset": list(res.subset),
        "predicted_bw": float(res.predicted_bw),
        "seconds": float(res.seconds),
        "n_candidates": int(res.n_candidates),
        "single_host_shortcut": res.n_candidates == 1,
    }


@dataclasses.dataclass
class DecisionDossier:
    """One committed admission's full attribution record.

    ``realized_bw`` / ``oracle_bw`` / ``regret`` are back-filled when the
    grading path reports (:func:`note_grade`); NaN until then.  ``regret``
    is ``oracle_bw - realized_bw`` in GB/s — how much bandwidth the best
    ledger-aware placement would have bought this admission.
    """

    job_id: str
    tenant: str
    k: int
    policy: str
    path: str                    # serial | planned | concurrent | cplane
    subset: Tuple[int, ...]
    predicted_bw: float
    journal_seq: int             # -1: no journal attached
    trace_id: int                # -1: no tracer installed
    staged_version: int
    committed_version: int
    validated: bool
    serialized: bool
    retries: int
    winner: str                  # "EHA" | "PTS" | "" (no hybrid provenance)
    winner_margin: float         # |eha_score - pts_score| (penalized scores)
    eha: Optional[Dict]
    pts: Optional[Dict]
    eha_score: float
    pts_score: float
    pts_prune: Optional[Dict]
    pts_fused_steps: int
    pts_rounds: Tuple[Dict, ...]
    frag_active: bool
    n_searches: int              # >1: make-room / conflict re-searches ran
    n_avail: int
    decomposition: Optional[Dict]
    realized_bw: float = float("nan")
    oracle_bw: float = float("nan")
    regret: float = float("nan")

    def to_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        d["subset"] = list(self.subset)
        d["pts_rounds"] = list(self.pts_rounds)
        return d


def _seal(d: DecisionDraft) -> DecisionDossier:
    return DecisionDossier(
        job_id=d.job_id, tenant=d.tenant, k=d.k, policy=d.policy,
        path=d.path, subset=d.subset or (), predicted_bw=d.predicted_bw,
        journal_seq=d.journal_seq, trace_id=d.trace_id,
        staged_version=d.staged_version,
        committed_version=d.committed_version,
        validated=d.validated, serialized=d.serialized, retries=d.retries,
        winner=d.winner, winner_margin=d.winner_margin,
        eha=d.eha, pts=d.pts,
        eha_score=d.eha_score, pts_score=d.pts_score,
        pts_prune=d.pts_prune, pts_fused_steps=d.pts_fused_steps,
        pts_rounds=tuple(d.pts_rounds), frag_active=d.frag_active,
        n_searches=d.n_searches, n_avail=d.n_avail,
        decomposition=d.decomposition,
    )


class DossierRecorder:
    """Bounded ring of :class:`DecisionDossier` records plus the per-tenant
    :class:`RegretLedger` the grading path feeds.  Thread-safe: sealing
    takes the recorder lock; drafts themselves are thread-local."""

    def __init__(self, capacity: int = 4096):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = int(capacity)
        self._ring: deque = deque(maxlen=self.capacity)
        self._by_job: Dict[str, DecisionDossier] = {}  # latest per job id
        self._lock = threading.Lock()
        self.regret = RegretLedger()
        self.n_dossiers = 0

    def _record(self, dossier: DecisionDossier) -> None:
        with self._lock:
            self._ring.append(dossier)
            self._by_job[dossier.job_id] = dossier
            self.n_dossiers += 1

    def note_grade(self, job_id: str, realized_bw: float,
                   oracle_bw: float = float("nan"),
                   tenant: str = "") -> None:
        """Back-fill the realized/oracle bandwidths of ``job_id``'s latest
        dossier and feed the regret ledger (called by the scheduler's
        grading path via the module-level :func:`note_grade`)."""
        with self._lock:
            d = self._by_job.get(job_id)
        if d is not None:
            d.realized_bw = float(realized_bw)
            d.oracle_bw = float(oracle_bw)
            if _isfinite(realized_bw) and _isfinite(oracle_bw):
                d.regret = float(oracle_bw) - float(realized_bw)
            tenant = tenant or d.tenant
        self.regret.note(tenant, realized_bw, oracle=oracle_bw)

    # -- inspection ----------------------------------------------------------

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def dossiers(self, job_id: Optional[str] = None) -> List[DecisionDossier]:
        with self._lock:
            out = list(self._ring)
        if job_id is not None:
            out = [d for d in out if d.job_id == job_id]
        return out

    def by_seq(self, seq: int) -> Optional[DecisionDossier]:
        """The dossier whose commit wrote journal line ``seq``, if any."""
        with self._lock:
            for d in self._ring:
                if d.journal_seq == seq:
                    return d
        return None

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._by_job.clear()

    def write_jsonl(self, path) -> int:
        """One dossier per line (``scripts/render_forensics.py`` input)."""
        ds = self.dossiers()
        with open(path, "w", encoding="utf-8") as fh:
            for d in ds:
                fh.write(json.dumps(d.to_dict(), sort_keys=True) + "\n")
        return len(ds)


# -- install / capture machinery (mirrors telemetry's tracer) ----------------

def install_forensics(
    recorder: Optional[DossierRecorder],
) -> Optional[DossierRecorder]:
    """Install ``recorder`` process-wide (None disables); returns the
    previous one.  Process-wide for the same reason as the tracer: the
    control plane's pool workers must seal into the same recorder as the
    submitting thread."""
    global _ACTIVE
    with _INSTALL_LOCK:
        prev, _ACTIVE = _ACTIVE, recorder
    return prev


def active_recorder() -> Optional[DossierRecorder]:
    return _ACTIVE


@contextlib.contextmanager
def capture(recorder: DossierRecorder):
    """``with forensics.capture(DossierRecorder()) as rec:`` — install for
    the block, restore the previous recorder after."""
    prev = install_forensics(recorder)
    try:
        yield recorder
    finally:
        install_forensics(prev)


def _stack() -> List[DecisionDraft]:
    st = getattr(_TLS, "stack", None)
    if st is None:
        st = _TLS.stack = []
    return st


def draft() -> Optional[DecisionDraft]:
    """The innermost open draft on the calling thread, or None.  THE hook
    entry point: one module-global read when capture is disabled, so
    instrumented hot paths stay within the ≤5% overhead budget."""
    if _ACTIVE is None:
        return None
    st = getattr(_TLS, "stack", None)
    return st[-1] if st else None


@contextlib.contextmanager
def decision(job_id: str, tenant: str = "", k: int = 0,
             policy: str = "", path: str = ""):
    """Open a decision draft for one admission attempt.  Yields None when
    capture is disabled.  The draft seals into the active recorder iff
    :meth:`DecisionDraft.commit` ran (parked/rejected/failed admissions
    leave no dossier)."""
    rec = _ACTIVE
    if rec is None:
        yield None
        return
    d = DecisionDraft(job_id, tenant, int(k), policy, path)
    st = _stack()
    st.append(d)
    try:
        yield d
    finally:
        # sealing happened inside DecisionDraft.commit (so the grading
        # path, which runs before this context exits, sees the dossier)
        if st and st[-1] is d:
            st.pop()
        elif d in st:
            st.remove(d)


def note_grade(job_id: str, realized_bw: float,
               oracle_bw: float = float("nan"), tenant: str = "") -> None:
    """Report an admission's graded bandwidths to the active recorder
    (no-op when capture is disabled — one global read)."""
    rec = _ACTIVE
    if rec is not None:
        rec.note_grade(job_id, realized_bw, oracle_bw=oracle_bw,
                       tenant=tenant)


# ---------------------------------------------------------------------------
# Bandwidth decomposition (Stage-1 intra vs inter rail, cap delta)
# ---------------------------------------------------------------------------

def bandwidth_decomposition(
    cluster, tables, ledger: JobLedger, subset: Sequence[int],
    base_predictor=None, predicted_bw: float = float("nan"),
    contention_mode: str = "analytic",
) -> Dict:
    """Attribute a placement's predicted bandwidth to its layers.

    * ``intra_bw``: per-host Stage-1 table bandwidth of each host's local
      share (exact, from :class:`~repro.core.intra_host.IntraHostTables`;
      None for single-GPU shares, which have no intra-host collective).
    * ``inter_cap``: the analytic fair-share rail cap against the ledger's
      live cross-host tenants (``inf`` when single-host or uncontended).
    * ``cap_delta``: isolated B-hat minus the final (contention-degraded)
      estimate — the bandwidth the contention branch charged, whether the
      analytic cap or the learned contended head produced it.

    Called *after* subset selection; the only model touch is one isolated
    predict of the already-chosen subset, which hits the dispatcher's
    isolated memo (every hybrid winner was already scored), so capture
    cannot perturb placements or blow the overhead budget.
    """
    subset = sorted(int(g) for g in subset)
    by_host = cluster.partition_by_host(subset)
    intra: Dict[int, Optional[float]] = {}
    for hid, gpus in sorted(by_host.items()):
        if len(gpus) > 1:
            intra[hid] = float(tables.lookup_global(gpus))
        else:
            intra[hid] = None
    cap = float("inf")
    if len(by_host) > 1:
        from repro_torch.core.contention import contended_inter_cap

        cap = float(contended_inter_cap(cluster, ledger, subset))
    isolated = float("nan")
    if base_predictor is not None:
        isolated = float(np.asarray(base_predictor.predict([subset]))[0])
    cap_delta = float("nan")
    if _isfinite(isolated) and _isfinite(predicted_bw):
        cap_delta = isolated - float(predicted_bw)
    return {
        "intra_bw": intra,
        "n_hosts": len(by_host),
        "cross_host": len(by_host) > 1,
        "inter_cap": cap,
        "isolated_bw": isolated,
        "predicted_bw": float(predicted_bw),
        "cap_delta": cap_delta,
        "contention_mode": contention_mode,
    }


# ---------------------------------------------------------------------------
# Time-travel: reconstruct + deterministic re-search
# ---------------------------------------------------------------------------

def reconstruct(
    journal_path, cluster, seq: int
) -> Tuple[JobLedger, JournalEvent]:
    """The ledger state the event at journal ``seq`` was decided against
    (every durable event with a smaller seq applied, nothing else), plus
    the event itself.  Raises ValueError when ``seq`` is not in the
    journal's durable prefix — a truncated journal time-travels over its
    surviving prefix only."""
    events = read_journal(journal_path)
    target = None
    for ev in events:
        if ev.seq == seq:
            target = ev
            break
    if target is None:
        raise ValueError(
            f"no durable journal event with seq={seq} "
            f"(journal holds {len(events)} events)"
        )
    return replay_journal(journal_path, cluster, upto_seq=seq), target


_UNSET = object()


def _search_view(
    view: JobLedger, k: int, dispatcher, *,
    contention_mode: Optional[str] = None,
    frag_weight: Optional[float] = None,
    contended=_UNSET,
    policy: str = "hybrid",
) -> Tuple[List[int], float, str]:
    """Run the dispatcher's search recipe against an arbitrary ledger view
    — the same chain ``AdmissionControlPlane._search`` stages with
    (contention wrapper over the view, the dispatcher's shared isolated
    memo, optional fragmentation tie-break), with per-call overrides for
    the what-if knobs.  Returns ``(subset, predicted_bw, winner)``."""
    from repro_torch.core import search as search_mod
    from repro_torch.core.predict_cache import cached_contention_predictor

    d = dispatcher
    cluster = d.cluster
    mode = d.contention_mode if contention_mode is None else contention_mode
    cont = d.contended_predictor if contended is _UNSET else contended
    fw = d.frag_weight if frag_weight is None else float(frag_weight)
    if d.contention_aware and mode != "off":
        pred = cached_contention_predictor(
            cluster, d.base_predictor, view, mode=mode, contended=cont,
            use_cache=d.prediction_cache is not None,
        )
    else:
        pred = d.base_predictor
    penalty = None
    if fw > 0:
        from repro_torch.core.defrag import make_frag_penalty

        penalty = make_frag_penalty(cluster, view, fw)
    avail = view.available()
    if policy == "eha":
        res = search_mod.eha_search(cluster, d.tables, pred, avail, k,
                                    frag_penalty=penalty)
        return list(res.subset), float(res.predicted_bw), "EHA"
    if policy == "pts":
        res = search_mod.pts_search(cluster, d.tables, pred, avail, k,
                                    frag_penalty=penalty)
        return list(res.subset), float(res.predicted_bw), "PTS"
    if policy != "hybrid":
        raise ValueError(f"unknown search policy {policy!r}")
    res = search_mod.hybrid_search(cluster, d.tables, pred, avail, k,
                                   frag_penalty=penalty)
    return list(res.subset), float(res.predicted_bw), res.winner


@dataclasses.dataclass(frozen=True)
class ReplayResult:
    """One time-travelled decision: journaled vs re-searched placement."""

    seq: int
    job_id: str
    tenant: str
    journaled: Tuple[int, ...]
    replayed: Tuple[int, ...]
    predicted_bw: float
    winner: str
    identical: bool
    ledger_version: int  # version of the reconstructed decision-time view


def replay_decision(journal_path, seq: int, dispatcher) -> ReplayResult:
    """Reconstruct the ledger at ``seq`` and deterministically re-run the
    dispatcher's search for that admission.  For every deterministic
    admission path the replayed subset equals the journaled one
    byte-for-byte (the hypothesis suite in ``tests/test_forensics.py``
    pins this across policies, contention modes, and truncated-journal
    prefixes)."""
    view, ev = reconstruct(journal_path, dispatcher.cluster, seq)
    if ev.op != "admit":
        raise ValueError(
            f"journal seq={seq} is a {ev.op!r} event; only admits carry a "
            f"search decision to replay"
        )
    subset, predicted, winner = _search_view(view, len(ev.gpus), dispatcher)
    return ReplayResult(
        seq=seq, job_id=ev.job_id, tenant=ev.tenant,
        journaled=tuple(ev.gpus), replayed=tuple(subset),
        predicted_bw=predicted, winner=winner,
        identical=tuple(subset) == tuple(ev.gpus),
        ledger_version=view.version,
    )


# ---------------------------------------------------------------------------
# Counterfactual what-if
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class WhatIfReport:
    """Factual vs counterfactual outcome of one journaled admission.

    ``factual_bw`` and ``counter_bw`` are *true* (simulator) contended
    bandwidths against the decision-time view and the perturbed view
    respectively; ``delta_bw = counter_bw - factual_bw`` is the bandwidth
    the perturbation would have bought (negative: the perturbation
    hurts).  ``oracle_bw`` is the exact ledger-aware Oracle on the
    factual view when requested (NaN otherwise)."""

    seq: int
    job_id: str
    tenant: str
    k: int
    knobs: Dict
    dropped_jobs: Tuple[str, ...]
    factual_subset: Tuple[int, ...]
    factual_bw: float
    counter_subset: Tuple[int, ...]
    counter_predicted: float
    counter_bw: float
    counter_winner: str
    delta_bw: float
    oracle_bw: float = float("nan")

    def to_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        for key in ("factual_subset", "counter_subset", "dropped_jobs"):
            d[key] = list(d[key])
        return d


def whatif(
    journal_path, seq: int, dispatcher, sim, *,
    drop_tenant: Optional[str] = None,
    drop_jobs: Sequence[str] = (),
    frag_weight: Optional[float] = None,
    contention_mode: Optional[str] = None,
    policy: str = "hybrid",
    oracle: bool = False,
    regret_ledger: Optional["RegretLedger"] = None,
) -> WhatIfReport:
    """Counterfactually re-dispatch the admission at journal ``seq``.

    The ledger is reconstructed at decision time, perturbed
    (``drop_tenant``/``drop_jobs`` evict live co-tenants; the remaining
    knobs override the search recipe), and the dispatcher's search runs
    against the perturbed view.  Both placements are graded with the
    *true* contended simulator against their respective views, so the
    delta isolates the perturbation, not predictor error.  ``oracle=True``
    additionally runs the exact ledger-aware Oracle on the factual view
    (expensive: count-vector enumeration).  When a ``regret_ledger`` is
    given (or a recorder is installed), the counterfactual feeds its
    per-tenant best-counterfactual regret.
    """
    cluster = dispatcher.cluster
    view, ev = reconstruct(journal_path, cluster, seq)
    if ev.op != "admit":
        raise ValueError(
            f"journal seq={seq} is a {ev.op!r} event; what-if needs an admit"
        )
    k = len(ev.gpus)
    factual_bw = float(sim.true_bandwidth(list(ev.gpus), ledger=view))

    cview = view.clone()
    to_drop = set(drop_jobs)
    dropped: List[str] = []
    for a in list(cview.jobs()):
        if a.job_id in to_drop or (
            drop_tenant is not None and a.tenant == drop_tenant
        ):
            cview.release(a.job_id)
            dropped.append(a.job_id)
    subset, predicted, winner = _search_view(
        cview, k, dispatcher, contention_mode=contention_mode,
        frag_weight=frag_weight, policy=policy,
    )
    counter_bw = float(sim.true_bandwidth(subset, ledger=cview))

    oracle_bw = float("nan")
    if oracle:
        from repro_torch.core.baselines import oracle_dispatch

        _, oracle_bw = oracle_dispatch(
            cluster, sim, dispatcher.tables, view.available(), k,
            ledger=view,
        )
        oracle_bw = float(oracle_bw)

    report = WhatIfReport(
        seq=seq, job_id=ev.job_id, tenant=ev.tenant, k=k,
        knobs={
            "drop_tenant": drop_tenant,
            "drop_jobs": list(drop_jobs),
            "frag_weight": frag_weight,
            "contention_mode": contention_mode,
            "policy": policy,
        },
        dropped_jobs=tuple(dropped),
        factual_subset=tuple(ev.gpus), factual_bw=factual_bw,
        counter_subset=tuple(subset), counter_predicted=predicted,
        counter_bw=counter_bw, counter_winner=winner,
        delta_bw=counter_bw - factual_bw, oracle_bw=oracle_bw,
    )
    reg = regret_ledger
    if reg is None and _ACTIVE is not None:
        reg = _ACTIVE.regret
    if reg is not None:
        reg.note(ev.tenant, factual_bw, oracle=oracle_bw,
                 counterfactual=counter_bw)
    return report


# ---------------------------------------------------------------------------
# The per-tenant regret ledger
# ---------------------------------------------------------------------------

class RegretLedger:
    """Per-tenant accounting of realized vs oracle vs best-counterfactual
    bandwidth.  ``regret = reference - realized`` in GB/s: positive means
    the reference placement (the exact Oracle, or the best counterfactual
    tried) would have bought that much more bandwidth.  Raw regret samples
    are kept (bounded per tenant) so :func:`absorb_regret` can export full
    distributions, not just means."""

    def __init__(self, max_samples_per_tenant: int = 1024):
        self._lock = threading.Lock()
        self._tenants: Dict[str, Dict] = {}
        self.max_samples = int(max_samples_per_tenant)

    def _entry(self, tenant: str) -> Dict:
        e = self._tenants.get(tenant)
        if e is None:
            e = self._tenants[tenant] = {
                "n": 0, "realized_sum": 0.0,
                "n_oracle": 0, "oracle_regret_sum": 0.0,
                "n_counterfactual": 0, "counterfactual_regret_sum": 0.0,
                "oracle_samples": deque(maxlen=self.max_samples),
                "counterfactual_samples": deque(maxlen=self.max_samples),
            }
        return e

    def note(self, tenant: str, realized: float,
             oracle: float = float("nan"),
             counterfactual: float = float("nan")) -> None:
        if not _isfinite(realized):
            return
        with self._lock:
            e = self._entry(tenant)
            e["n"] += 1
            e["realized_sum"] += float(realized)
            if _isfinite(oracle):
                r = float(oracle) - float(realized)
                e["n_oracle"] += 1
                e["oracle_regret_sum"] += r
                e["oracle_samples"].append(r)
            if _isfinite(counterfactual):
                r = float(counterfactual) - float(realized)
                e["n_counterfactual"] += 1
                e["counterfactual_regret_sum"] += r
                e["counterfactual_samples"].append(r)

    def tenants(self) -> List[str]:
        with self._lock:
            return sorted(self._tenants)

    def samples(self, tenant: str, kind: str = "oracle") -> List[float]:
        with self._lock:
            e = self._tenants.get(tenant)
            if e is None:
                return []
            return list(e[f"{kind}_samples"])

    def summary(self) -> Dict[str, Dict[str, float]]:
        """tenant -> {n, mean_realized, mean/total oracle + counterfactual
        regret} (NaN where a reference was never observed)."""
        with self._lock:
            items = sorted(self._tenants.items())
        out: Dict[str, Dict[str, float]] = {}
        for tenant, e in items:
            out[tenant] = {
                "n": float(e["n"]),
                "mean_realized": e["realized_sum"] / e["n"],
                "n_oracle": float(e["n_oracle"]),
                "mean_oracle_regret": (
                    e["oracle_regret_sum"] / e["n_oracle"]
                    if e["n_oracle"] else float("nan")
                ),
                "total_oracle_regret": e["oracle_regret_sum"],
                "n_counterfactual": float(e["n_counterfactual"]),
                "mean_counterfactual_regret": (
                    e["counterfactual_regret_sum"] / e["n_counterfactual"]
                    if e["n_counterfactual"] else float("nan")
                ),
            }
        return out


# regret distributions are signed GB/s deltas, nothing like the default
# latency buckets — the configurable-bucket registry path exists for this
REGRET_BUCKETS = (
    -100.0, -50.0, -20.0, -10.0, -5.0, -1.0, 0.0,
    1.0, 5.0, 10.0, 20.0, 50.0, 100.0, 200.0,
)


def absorb_regret(reg, regret: RegretLedger, **labels) -> None:
    """Project a :class:`RegretLedger` into a
    :class:`~repro.core.telemetry.MetricsRegistry`.  Gauges and counters
    are set-idempotent; the regret *histograms* observe the ledger's
    (bounded) raw samples, so — like ``absorb_trace_summary`` — absorb a
    given ledger into a given registry once."""
    summ = regret.summary()
    names = tuple(sorted(labels)) + ("tenant",)
    count = reg.counter(
        "regret_admissions_total", "admissions graded into the regret ledger",
        names,
    )
    realized = reg.gauge(
        "regret_mean_realized_gbs", "mean realized bandwidth (GB/s)", names
    )
    mean_or = reg.gauge(
        "regret_mean_oracle_gbs",
        "mean oracle regret per admission (GB/s)", names,
    )
    mean_cf = reg.gauge(
        "regret_mean_counterfactual_gbs",
        "mean best-counterfactual regret per admission (GB/s)", names,
    )
    hist = reg.histogram(
        "regret_gbs", "per-admission regret vs reference (GB/s)",
        names + ("reference",), buckets=REGRET_BUCKETS,
    )
    for tenant, row in summ.items():
        count.set(row["n"], tenant=tenant, **labels)
        realized.set(row["mean_realized"], tenant=tenant, **labels)
        if row["n_oracle"]:
            mean_or.set(row["mean_oracle_regret"], tenant=tenant, **labels)
        if row["n_counterfactual"]:
            mean_cf.set(
                row["mean_counterfactual_regret"], tenant=tenant, **labels
            )
        for kind in ("oracle", "counterfactual"):
            for r in regret.samples(tenant, kind):
                hist.observe(r, tenant=tenant, reference=kind, **labels)
