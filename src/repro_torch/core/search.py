"""Fast hybrid search (Sec. 4.3): EHA + PTS, guided by the surrogate.

Both components consume a *predictor* object exposing
``predict(list_of_subsets) -> np.ndarray`` (the hierarchical surrogate, or
ground truth for the Ideal-BP upper bound) and return a (subset, predicted_bw)
pair.  ``hybrid_search`` runs both and keeps the argmax (Sec. 4.3.1).

Every search entry point accepts an optional ``frag_penalty(subset) ->
relative discount`` tie-break (built by :func:`repro.core.defrag.
make_frag_penalty`): candidate *selection* maximizes ``predicted_bw * (1 -
frag_penalty(S))``, steering otherwise-equal candidates away from breaking
up clean hosts, while the *reported* predicted bandwidth stays the raw
(undiscounted) estimate.  A relative discount is scale-free — the same
weight is a tie-break on a 500 GB/s H100 fabric and a 20 GB/s legacy one.
``frag_penalty=None`` (the default) is bit-identical to the historical
behaviour.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import forensics, telemetry
from repro_torch.core.cluster import Cluster
from repro_torch.core.intra_host import IntraHostTables
from repro_torch.core.tenancy import JobLedger

Subset = List[int]
FragPenalty = Optional[Callable[[Sequence[int]], float]]


def _penalized(preds: np.ndarray, candidates, frag_penalty: FragPenalty):
    """Selection scores: predictions discounted by the relative tie-break."""
    if frag_penalty is None:
        return preds
    return preds * (1.0 - np.asarray([frag_penalty(c) for c in candidates]))


@dataclasses.dataclass
class SearchResult:
    subset: Subset
    predicted_bw: float
    seconds: float
    n_candidates: int


def _available_by_host(
    cluster: Cluster, avail: Sequence[int]
) -> Dict[int, List[int]]:
    return cluster.partition_by_host(avail)


# ---------------------------------------------------------------------------
# Single-host prioritization (shared by EHA and PTS pruning)
# ---------------------------------------------------------------------------

def best_single_host(
    cluster: Cluster,
    tables: IntraHostTables,
    avail_by_host: Dict[int, List[int]],
    k: int,
    frag_penalty: FragPenalty = None,
) -> Optional[Tuple[float, int, Subset]]:
    """Best k-GPU allocation on any single host with >=k available GPUs,
    using exact Stage-1 lookups.  Returns (bw, host_id, global_subset) with
    the raw bw; with ``frag_penalty`` the *choice* among hosts maximizes
    the penalized score (prefer topping up a dirty host over cracking open
    a clean one)."""
    best = None
    best_score = None
    for hid, gpus in avail_by_host.items():
        if len(gpus) < k:
            continue
        locals_ = [cluster.gpu_local[g] for g in gpus]
        bw, sub = tables.best_subset(hid, k, locals_)
        subset = tables.to_globals(hid, sub)
        score = bw * (1.0 - frag_penalty(subset)) if frag_penalty else bw
        if best_score is None or score > best_score:
            best = (bw, hid, subset)
            best_score = score
    return best


# ---------------------------------------------------------------------------
# EHA — Equilibrium-driven Heuristic Algorithm (Algorithm 1)
# ---------------------------------------------------------------------------

def _distinct_permutations(items: Sequence[int]):
    """Lazily yield the distinct permutations of a multiset in ascending
    lexicographic order (Narayana next-permutation with duplicate skipping).

    Replaces ``sorted(set(itertools.permutations(items)))``, which eagerly
    materializes all m! permutations before deduplication — an O(m!)
    landmine for m beyond ~10 hosts (k=64 over 2-GPU hosts makes m=32, which
    would never return) even though the caller only ever consumes the first
    few distinct entries.
    """
    arr = sorted(items)
    m = len(arr)
    while True:
        yield tuple(arr)
        i = m - 2
        while i >= 0 and arr[i] >= arr[i + 1]:
            i -= 1
        if i < 0:
            return
        j = m - 1
        while arr[j] <= arr[i]:
            j -= 1
        arr[i], arr[j] = arr[j], arr[i]
        arr[i + 1:] = arr[:i:-1]


def balanced_count_assignments(
    capacities: Sequence[int], k: int, max_assignments: int = 16
) -> List[Tuple[int, ...]]:
    """Distinct near-even distributions of k over hosts with capacities.

    E.g. k=8 over 3 hosts -> permutations of (3,3,2) that respect capacity.
    Capacity overflow is re-waterfilled onto the remaining hosts.  The
    permutation stream is lazy (:func:`_distinct_permutations`), so the
    ``max_assignments`` cap bounds the work even for many hosts.
    """
    m = len(capacities)
    base, rem = divmod(k, m)
    shape = [base + 1] * rem + [base] * (m - rem)
    out: List[Tuple[int, ...]] = []
    seen = set()
    for perm in _distinct_permutations(shape):
        counts = list(perm)
        # re-waterfill overflow (a host's share may exceed its availability)
        overflow = 0
        for i in range(m):
            if counts[i] > capacities[i]:
                overflow += counts[i] - capacities[i]
                counts[i] = capacities[i]
        while overflow > 0:
            # give to the host with the most remaining headroom
            heads = [(capacities[i] - counts[i], i) for i in range(m)]
            heads.sort(reverse=True)
            if heads[0][0] <= 0:
                break  # infeasible
            counts[heads[0][1]] += 1
            overflow -= 1
        if overflow > 0:
            continue
        # zero counts are fine (k < m): the host simply goes unused
        t = tuple(counts)
        if t not in seen:
            seen.add(t)
            out.append(t)
        if len(out) >= max_assignments:
            break
    return out


def eha_search(
    cluster: Cluster,
    tables: IntraHostTables,
    predictor,
    avail: Sequence[int],
    k: int,
    max_host_combos: int = 64,
    frag_penalty: FragPenalty = None,
) -> SearchResult:
    """Algorithm 1.  Fast constructive search around the equilibrium insight."""
    with telemetry.span("search.eha", k=k, n_avail=len(avail)) as sp:
        res = _eha_search(
            cluster, tables, predictor, avail, k, max_host_combos,
            frag_penalty,
        )
        if sp:
            sp["n_candidates"] = res.n_candidates
            sp["predicted_bw"] = res.predicted_bw
            sp["single_host_shortcut"] = res.n_candidates == 1
        return res


def _eha_search(
    cluster: Cluster,
    tables: IntraHostTables,
    predictor,
    avail: Sequence[int],
    k: int,
    max_host_combos: int = 64,
    frag_penalty: FragPenalty = None,
) -> SearchResult:
    t0 = time.time()
    by_host = _available_by_host(cluster, avail)
    n_cands = 0

    # Phase 1: single-host prioritization (exact via Stage-1 tables).
    # With a frag_penalty the shortcut is NOT taken blindly: consolidation
    # deliberately opens clean single-host blocks, and on heterogeneous
    # clusters a freed point-to-point host's full-host ring can be far
    # slower than a balanced cross-host placement — so the single-host
    # winner is scored against the phase-2 candidates below instead.
    single = best_single_host(cluster, tables, by_host, k, frag_penalty)
    if single is not None and frag_penalty is None:
        bw, _, subset = single
        return SearchResult(subset, bw, time.time() - t0, 1)

    # Phase 2: balanced multi-host construction over the minimum host count
    # (plus one more host when the single-host shortcut is being
    # re-examined, so genuine multi-host alternatives exist to compare).
    hosts = sorted(by_host.items(), key=lambda kv: -len(kv[1]))
    sizes = [len(g) for _, g in hosts]
    m = 0
    total = 0
    for s in sizes:
        m += 1
        total += s
        if total >= k:
            break
    if total < k:
        raise ValueError(f"request k={k} exceeds available pool {sum(sizes)}")

    # Host combinations of size m with enough capacity (largest-first bias).
    candidates: List[Subset] = []
    host_ids = [hid for hid, _ in hosts]
    m_sizes = [m]
    if single is not None and m + 1 <= len(host_ids):
        m_sizes.append(m + 1)
    for m_cur in m_sizes:
        combos = 0
        for combo in itertools.combinations(range(len(host_ids)), m_cur):
            caps = [sizes[i] for i in combo]
            if sum(caps) < k:
                continue
            combos += 1
            if combos > max_host_combos:
                break
            chosen_hids = [host_ids[i] for i in combo]
            for counts in balanced_count_assignments(caps, k):
                subset: Subset = []
                for hid, n_h in zip(chosen_hids, counts):
                    if n_h == 0:
                        continue
                    locals_ = [cluster.gpu_local[g] for g in by_host[hid]]
                    _, sub = tables.best_subset(hid, n_h, locals_)
                    subset.extend(tables.to_globals(hid, sub))
                candidates.append(sorted(subset))
    if single is not None:
        candidates.append(sorted(single[2]))

    if not candidates:  # degenerate fallback: greedy fill
        pool = [g for _, gs in hosts for g in gs]
        candidates = [sorted(pool[:k])]
    preds = predictor.predict(candidates)
    n_cands = len(candidates)
    best_idx = int(np.argmax(_penalized(preds, candidates, frag_penalty)))
    return SearchResult(
        candidates[best_idx], float(preds[best_idx]), time.time() - t0, n_cands
    )


# ---------------------------------------------------------------------------
# PTS — Pruned Tree Search (Algorithm 2)
# ---------------------------------------------------------------------------

def pts_search(
    cluster: Cluster,
    tables: IntraHostTables,
    predictor,
    avail: Sequence[int],
    k: int,
    frag_penalty: FragPenalty = None,
) -> SearchResult:
    """Algorithm 2.  Top-down iterative elimination of the bottleneck GPU."""
    with telemetry.span("search.pts", k=k, n_avail=len(avail)) as sp:
        res = _pts_search(cluster, tables, predictor, avail, k, frag_penalty)
        if sp:
            sp["n_candidates"] = res.n_candidates
            sp["predicted_bw"] = res.predicted_bw
        return res


def _pts_search(
    cluster: Cluster,
    tables: IntraHostTables,
    predictor,
    avail: Sequence[int],
    k: int,
    frag_penalty: FragPenalty = None,
) -> SearchResult:
    t0 = time.time()
    by_host = _available_by_host(cluster, avail)
    s_curr: Subset = sorted(avail)
    n_cands = 0
    df = forensics.draft()  # one global read when capture is off

    # Search pruning: node-insertion heuristic for small requests.  With a
    # frag_penalty the *host choice* is penalty-aware, but the prune itself
    # stays (full-pool elimination would cost O(|avail|^2) predictor calls
    # per dispatch); the single-vs-multi-host comparison that frag mode
    # needs happens in EHA's phase 2, which hybrid_search always runs.
    if k <= 8:
        single = best_single_host(cluster, tables, by_host, k, frag_penalty)
        if single is not None:
            _, hid, _ = single
            pruned = len(s_curr)
            s_curr = sorted(by_host[hid])
            if df is not None:
                df.note_pts_prune(hid, pruned - len(s_curr))

    # Fused on-device descent: the whole elimination |S| -> k as ONE device
    # call (``SurrogatePredictor.eliminate_to``; the contention wrapper
    # threads the analytic cap through as a lattice table).  The frag
    # penalty is host-side per-round arithmetic, so penalized searches stay
    # on the host loop; any configuration the scan declines (learned
    # contention, oversized parents, non-surrogate predictors, ...) falls
    # through to the loop below unchanged.
    if (
        frag_penalty is None
        and len(s_curr) > k
        and hasattr(predictor, "eliminate_to")
    ):
        res = predictor.eliminate_to(s_curr, k)
        if res is not None:
            n0 = len(s_curr)
            s_curr = list(res.subset)
            # the descent scored every remove-one child of every round
            n_cands += (n0 * (n0 + 1) - k * (k + 1)) // 2
            telemetry.event("search.pts.fused_scan", steps=n0 - len(s_curr))
            if df is not None:
                df.note_pts_fused(n0 - len(s_curr))

    # Iterative elimination |S| -> k, one GPU at a time.  Each round is ONE
    # fused featurize+predict call when the predictor has an incremental
    # child path (predict_children: the child batch is the parent's token
    # matrix with a patched row per child, deduplicated against the
    # prediction cache); the plain batched predict is the fallback.
    fused = hasattr(predictor, "predict_children")
    rounds = 0
    while len(s_curr) > k:
        children = [s_curr[:i] + s_curr[i + 1:] for i in range(len(s_curr))]
        if fused:
            preds = predictor.predict_children(s_curr)
        else:
            preds = predictor.predict(children)
        n_cands += len(children)
        rounds += 1
        best_i = int(np.argmax(_penalized(preds, children, frag_penalty)))
        if df is not None:  # child i omits s_curr[i]: that GPU bottlenecked
            df.note_pts_round(
                s_curr[best_i], float(preds[best_i]), len(children)
            )
        s_curr = children[best_i]
    if rounds:
        telemetry.event(
            "search.pts.host_rounds", rounds=rounds, fused_children=fused
        )

    final_bw = float(predictor.predict([s_curr])[0])
    return SearchResult(s_curr, final_bw, time.time() - t0, n_cands + 1)


# ---------------------------------------------------------------------------
# Hybrid (Sec. 4.3.1)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class HybridResult:
    subset: Subset
    predicted_bw: float
    eha: SearchResult
    pts: SearchResult
    winner: str

    @property
    def total_seconds(self) -> float:
        return self.eha.seconds + self.pts.seconds


def hybrid_search(
    cluster: Cluster,
    tables: IntraHostTables,
    predictor,
    avail: Sequence[int],
    k: int,
    frag_penalty: FragPenalty = None,
) -> HybridResult:
    df = forensics.draft()
    if df is not None:
        # resets per-search provenance: a make-room defrag pass (or a
        # control-plane conflict re-search) runs extra hybrid searches
        # inside one admission, and the committed subset comes from the
        # LAST one — which is the provenance the dossier should describe.
        df.note_search_begin(k, len(avail), frag_penalty is not None)
    eha = eha_search(cluster, tables, predictor, avail, k,
                     frag_penalty=frag_penalty)
    pts = pts_search(cluster, tables, predictor, avail, k,
                     frag_penalty=frag_penalty)
    eha_score, pts_score = eha.predicted_bw, pts.predicted_bw
    if frag_penalty is not None:
        eha_score *= 1.0 - frag_penalty(eha.subset)
        pts_score *= 1.0 - frag_penalty(pts.subset)
    winner = "EHA" if eha_score >= pts_score else "PTS"
    if df is not None:
        df.note_hybrid(eha, pts, eha_score, pts_score, winner)
    if winner == "EHA":
        return HybridResult(eha.subset, eha.predicted_bw, eha, pts, "EHA")
    return HybridResult(pts.subset, pts.predicted_bw, eha, pts, "PTS")


# ---------------------------------------------------------------------------
# Joint batched placement (admission scheduler, `batched` policy)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class JointPlacement:
    """One job's slot in a joint batch plan, in placement order."""

    job_id: str
    k: int
    subset: Subset
    predicted_bw: float  # contention-degraded, against ledger + ALL mates


@dataclasses.dataclass
class JointResult:
    placements: List[JointPlacement]  # in placement (commit) order
    order: str                        # winning candidate order
    total_predicted_bw: float         # sum of final per-job degraded estimates
    seconds: float


JOINT_ORDERS = ("largest-first", "arrival")


def _ordered_requests(
    requests: Sequence[Tuple[str, int]], order: str
) -> List[Tuple[str, int]]:
    if order == "arrival":
        return list(requests)
    if order == "largest-first":
        return sorted(requests, key=lambda r: -r[1])  # stable: arrival ties
    raise ValueError(f"unknown joint order {order!r}")


def joint_hybrid_search(
    cluster: Cluster,
    tables: IntraHostTables,
    predictor,
    ledger: JobLedger,
    requests: Sequence[Tuple[str, int]],
    orders: Sequence[str] = JOINT_ORDERS,
    contention_aware: bool = True,
    contention_mode: str = "analytic",
    contended=None,
    frag_weight: float = 0.0,
    use_cache: bool = True,
    vectorized: bool = True,
    stats_sink=None,
    batcher=None,
) -> JointResult:
    """Place a batch of ``(job_id, k)`` requests *jointly* against a ledger.

    For each candidate placement order, the live ledger is copied into a
    scratch ledger and each job runs the ordinary :func:`hybrid_search`
    against it — admitting every placement into the scratch as it is chosen,
    so later jobs see their earlier batch-mates as live co-tenants (and,
    with ``contention_aware``, the predictor degrades candidates next to
    them via the virtual-merge fair-share cap).  The plan is scored by the
    sum of each job's contention-degraded estimate against the *final*
    scratch ledger (a job placed early can be degraded by a mate placed
    later; scoring at the end charges for that), and the best order wins.

    The returned placements are valid to commit sequentially against the
    real ledger: they are pairwise GPU-disjoint and drawn from its current
    availability.  ``contention_aware=False`` keeps batch-mates as
    availability constraints only (the contention-oblivious ablation).
    ``contention_mode``/``contended`` select the analytic fair-share cap or
    the learned ContendedSurrogate for the degradation estimates, exactly as
    in :class:`~repro.core.contention.ContentionAwarePredictor`.
    ``frag_weight > 0`` applies the fragmentation tie-break
    (:func:`repro.core.defrag.make_frag_penalty`) against the *scratch*
    ledger, so later batch-mates are steered away from cracking open hosts
    their earlier mates left clean.

    ``use_cache`` (the default) wraps each order's contention-aware
    predictor in a scratch-ledger-versioned prediction cache
    (:mod:`repro.core.predict_cache`), so the final whole-plan re-scoring
    and the overlap between per-job EHA/PTS candidate sets are free; pass a
    cached *base* ``predictor`` (the dispatcher's ledger-independent
    isolated memo) to additionally share the expensive isolated inference
    across candidate orders.

    ``batcher`` (an :class:`~repro.core.predict_cache.InferenceBatcher`)
    runs the candidate orders on concurrent worker threads whose surrogate
    applies are padded and fused into shared device calls.  Each order's
    search is a pure function of the (immutable) real ledger, so the orders
    are independent; the winner is still reduced in the original ``orders``
    sequence with the same strict ``>`` comparison, and fusion itself is
    value-neutral (pad/row-independence is regression-pinned), so the
    chosen plan is byte-identical to the sequential path.
    """
    from repro_torch.core.defrag import make_frag_penalty
    from repro_torch.core.predict_cache import (
        PredictorStats,
        cached_contention_predictor,
    )

    if not requests:
        raise ValueError("joint_hybrid_search needs >=1 request")
    if not orders:
        raise ValueError("joint_hybrid_search needs >=1 candidate order")
    ids = [r[0] for r in requests]
    if len(set(ids)) != len(ids):
        raise ValueError(f"duplicate job ids in batch: {ids}")
    t0 = time.time()
    if len(requests) == 1:
        orders = orders[:1]
    uniq: List[str] = []
    tried = set()
    for order in orders:
        key = tuple(r[0] for r in _ordered_requests(requests, order))
        if key in tried:
            continue  # two orders coincide (e.g. batch already size-sorted)
        tried.add(key)
        uniq.append(order)

    def _run_order(order: str, sink) -> JointResult:
        seq = _ordered_requests(requests, order)
        scratch = JobLedger(cluster)
        for a in ledger.jobs():
            scratch.admit(a.job_id, a.gpus)
        pred = (
            cached_contention_predictor(
                cluster, predictor, scratch,
                mode=contention_mode, contended=contended,
                use_cache=use_cache, vectorized=vectorized,
                stats_sink=sink,
            )
            if contention_aware else predictor
        )
        # the penalty reads the scratch live, so it stays current as each
        # batch-mate admits below
        penalty = (
            make_frag_penalty(cluster, scratch, frag_weight)
            if frag_weight > 0 else None
        )
        placements: List[JointPlacement] = []
        for job_id, k in seq:
            avail = scratch.available()
            if k > len(avail):
                raise ValueError(
                    f"joint batch does not fit: {job_id!r} needs k={k}, "
                    f"{len(avail)} GPUs free"
                )
            res = hybrid_search(cluster, tables, pred, avail, k,
                                frag_penalty=penalty)
            scratch.admit(job_id, res.subset)
            placements.append(
                JointPlacement(job_id, k, res.subset, res.predicted_bw)
            )
        # Final scoring: every subset re-estimated against the complete
        # scratch (its own entry self-excludes via the contends predicate).
        finals = np.asarray(
            pred.predict([p.subset for p in placements]), dtype=np.float64
        )
        for p, bw in zip(placements, finals):
            p.predicted_bw = float(bw)
        return JointResult(placements, order, float(finals.sum()), 0.0)

    def _traced_order(order: str, sink) -> JointResult:
        # one span per candidate order — on the batcher path these run on
        # worker threads, so each is a root span on its own thread
        with telemetry.span(
            "search.joint_order", order=order, n_jobs=len(requests),
        ) as sp:
            res = _run_order(order, sink)
            if sp:
                sp["total_predicted_bw"] = res.total_predicted_bw
            return res

    if batcher is not None and len(uniq) > 1:
        # one worker thread per order; per-thread stats sinks (merged after
        # the join) keep the shared counters race-free
        sinks = [PredictorStats() for _ in uniq]
        results: List[Optional[JointResult]] = [None] * len(uniq)
        errs: List[Optional[BaseException]] = [None] * len(uniq)

        def _worker(i: int, order: str) -> None:
            try:
                with batcher.worker():
                    results[i] = _traced_order(order, sinks[i])
            except BaseException as e:
                errs[i] = e

        threads = [
            threading.Thread(
                target=_worker, args=(i, o), name=f"joint-order-{o}"
            )
            for i, o in enumerate(uniq)
        ]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        for e in errs:
            if e is not None:
                raise e
        if stats_sink is not None:
            merged = PredictorStats.merged(stats_sink, *sinks)
            for f in dataclasses.fields(PredictorStats):
                setattr(stats_sink, f.name, getattr(merged, f.name))
        candidates = results
    else:
        candidates = [_traced_order(o, stats_sink) for o in uniq]

    best: Optional[JointResult] = None
    for cand in candidates:
        if best is None or cand.total_predicted_bw > best.total_predicted_bw:
            best = cand
    assert best is not None
    best.seconds = time.time() - t0
    return best
