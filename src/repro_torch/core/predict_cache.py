"""Ledger-versioned prediction memo + unified predictor instrumentation.

The dispatch fast path re-scores the same subsets many times within one
admission: EHA's phase-2 winner is re-scored by PTS and by the hybrid
arbiter, a PTS round's winner is re-predicted as the final subset, joint
batched placement re-scores every plan against the final scratch state, and
trial moves re-grade co-tenants.  All of those are pure functions of
``(subset, ledger occupancy)`` — so one memo keyed by ``(subset tuple,
ledger version, mode)`` makes every repeat free.

**Invalidation contract.**  :class:`~repro.core.tenancy.JobLedger` carries a
monotonic ``version`` counter bumped on every admit/release.  A versioned
cache entry is valid for exactly one version: any occupancy change makes
every outstanding key stale *by construction* (no explicit invalidation
hooks, nothing to forget to call).  Because the counter only grows, entries
from an exactly-restored ledger state are conservatively dropped too —
correctness never depends on state comparison.  Ledger-independent
predictors (the isolated surrogate: B̂(S) never changes while the params are
fixed) opt out with ``versioned=False`` and keep their entries for the
process lifetime (bounded by ``max_entries``).

:class:`PredictorStats` is the one instrumentation record every predictor
in the stack carries (``.stats``): model calls, cumulative predict time,
its featurize/inference split, contention-wrapper overhead, degradation and
cache-hit counters.  Legacy attribute names (``n_model_calls``,
``predict_seconds``, ``n_capped``) remain readable/writable properties on
the predictors themselves.  The fused on-device elimination path
(``SurrogatePredictor.eliminate_to``) cannot split featurize from inference
per round — the whole descent is one device call — so it reports a single
``scan_seconds`` bucket plus the device-step count, and bumps *neither*
``n_model_calls`` nor the featurize/infer split (no double-counting when
``collect_stats`` merges a chain).

This module is also home to :class:`InferenceBatcher`, the cross-search
apply fuser: threads running concurrent hybrid searches (joint batched
placement order-candidates, defrag trial moves) register with
``with batcher.worker():`` and their surrogate applies are padded and fused
into one shared jitted call — the same continuous-batching trick serving
engines use.  Fusion is value-neutral: the Transformer is row- and
pad-independent (regression-pinned in ``tests/test_ondevice_scan.py``), so
batched outputs are bit-identical to per-search applies.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class PredictorStats:
    """Shared instrumentation for every predictor in the dispatch stack."""

    n_model_calls: int = 0        # candidates sent through a Transformer
    predict_seconds: float = 0.0  # total wall time inside predict()
    featurize_seconds: float = 0.0  # ... spent building token batches
    infer_seconds: float = 0.0      # ... spent in jitted model applies
    scan_seconds: float = 0.0     # wall time inside fused on-device descents
    n_scan_steps: int = 0         # elimination rounds executed on-device
    wrapper_seconds: float = 0.0    # contention-wrap overhead (excl. base)
    n_capped: int = 0             # candidates whose estimate was degraded
    cache_hits: int = 0
    cache_misses: int = 0

    def reset(self) -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, f.default)

    def to_dict(self) -> Dict[str, float]:
        return dataclasses.asdict(self)

    # legacy name (pre-dates the unified to_dict convention across stats)
    def as_dict(self) -> Dict[str, float]:
        return self.to_dict()

    @property
    def hit_rate(self) -> float:
        total = self.cache_hits + self.cache_misses
        return self.cache_hits / total if total else 0.0

    @staticmethod
    def merged(*stats: "PredictorStats") -> "PredictorStats":
        out = PredictorStats()
        for s in stats:
            for f in dataclasses.fields(PredictorStats):
                setattr(out, f.name, getattr(out, f.name) + getattr(s, f.name))
        return out


def collect_stats(*predictors) -> PredictorStats:
    """Merge the ``.stats`` of every distinct predictor in a chain (wrappers
    expose their wrapped predictor as ``.base``; shared bases dedup by id)."""
    seen = {}
    for p in predictors:
        while p is not None:
            if id(p) in seen:
                break
            seen[id(p)] = p
            p = getattr(p, "base", None)
    return PredictorStats.merged(
        *(p.stats for p in seen.values() if hasattr(p, "stats"))
    )


_UNVERSIONED = -1


class LruDict(OrderedDict):
    """Bounded dict with least-recently-used eviction.

    Reads (``get`` / ``[]``) refresh recency; inserts past ``max_entries``
    evict the least-recently-used entry.  Eviction only forgets memoized
    values — every value is a pure function of its key — so capping a cache
    can never change what a lookup-or-recompute path returns, only how often
    it recomputes (property-tested in ``tests/test_ondevice_scan.py``).

    Every operation is a read-modify-write *pair* (lookup + move_to_end,
    insert + evict), so GIL atomicity of the individual C calls is not
    enough once admissions overlap: interleaved pairs can corrupt the
    recency order (move_to_end on a concurrently evicted key) or evict the
    entry another thread just promoted.  A reentrant lock makes each
    operation atomic — it is uncontended in the serial paths and the
    hammer test in ``tests/test_controlplane.py`` pins the concurrent
    behaviour.
    """

    def __init__(self, max_entries: int):
        super().__init__()
        self.max_entries = int(max_entries)
        self._lock = threading.RLock()  # get() re-enters via __getitem__

    def __getitem__(self, key):
        with self._lock:
            val = super().__getitem__(key)
            self.move_to_end(key)
            return val

    def get(self, key, default=None):
        with self._lock:
            try:
                return self[key]
            except KeyError:
                return default

    def __setitem__(self, key, value):
        with self._lock:
            super().__setitem__(key, value)
            self.move_to_end(key)
            # evict with del, not popitem(): OrderedDict.popitem re-enters
            # the subclass __getitem__ after unlinking the key, which would
            # trip the recency refresh on a half-removed entry
            while len(self) > self.max_entries:
                del self[next(iter(self))]


class PredictionCache:
    """Memo of predictor outputs keyed by ``(subset, ledger version, mode)``.

    One cache binds one ledger (or none).  Versioned entries live in a
    window store that is cleared whenever the observed ledger version moves,
    so stale keys never accumulate; unversioned (ledger-independent) entries
    persist up to ``max_entries`` with oldest-first eviction.
    ``wrap(predictor, mode)`` returns a :class:`CachedPredictor` view; any
    number of predictors may share one cache under distinct mode tags.
    """

    def __init__(self, ledger=None, max_entries: int = 1 << 18):
        self.ledger = ledger
        self.max_entries = max_entries
        self._static: Dict[Tuple, float] = LruDict(max_entries)
        self._window: Dict[Tuple, float] = {}
        self._window_version = _UNVERSIONED
        self.stats = PredictorStats()  # aggregate hit/miss across wrappers

    def version(self) -> int:
        return self.ledger.version if self.ledger is not None else _UNVERSIONED

    def wrap(self, predictor, mode: str, versioned: bool = True):
        return CachedPredictor(self, predictor, mode, versioned=versioned)

    def invalidate(self) -> None:
        self._static.clear()
        self._window.clear()

    def __len__(self) -> int:
        return len(self._static) + len(self._window)

    # -- store selection ----------------------------------------------------

    def store_for(self, versioned: bool) -> Dict[Tuple, float]:
        if not versioned:
            # the lifetime memo self-bounds: LruDict evicts on insert
            return self._static
        v = self.version()
        if v != self._window_version:
            # occupancy changed: clear for memory hygiene.  Correctness no
            # longer depends on this — entry keys carry the version (see
            # CachedPredictor._lookup), so a racing clear/insert can only
            # leave an unreachable entry behind, never serve a stale one.
            self._window.clear()
            self._window_version = v
        return self._window


class CachedPredictor:
    """Predictor-protocol view over a :class:`PredictionCache`.

    Exposes the same ``predict(list_of_subsets) -> np.ndarray`` protocol the
    hybrid search consumes (plus ``predict_children`` when the wrapped
    predictor has a fused elimination path), so it threads through
    ``search.hybrid_search`` unchanged.  Unknown attributes delegate to the
    wrapped predictor.
    """

    def __init__(self, cache: PredictionCache, base, mode: str,
                 versioned: bool = True):
        self.cache = cache
        self.base = base
        self.mode = mode
        self.versioned = versioned
        self.stats = PredictorStats()  # this wrapper's hit/miss counters

    def __getattr__(self, name):
        return getattr(self.base, name)

    def _lookup(self, subsets: Sequence[Sequence[int]]):
        store = self.cache.store_for(self.versioned)
        # the ledger version is part of the KEY, not just the window-clear
        # trigger: a worker that looked up at version v, computed through
        # the base predictor while another thread committed (bumping the
        # version and clearing the window), then stored its result, writes
        # an entry reachable only by v-keyed lookups — a cross-version hit
        # is impossible by construction, not just by clearing discipline
        v = self.cache.version() if self.versioned else _UNVERSIONED
        keys = [(tuple(s), self.mode, v) for s in subsets]
        out = np.empty((len(subsets),), np.float64)
        miss = []
        for i, key in enumerate(keys):
            val = store.get(key)
            if val is None:
                miss.append(i)
            else:
                out[i] = val
        return store, keys, out, miss

    def _account(self, n_hits: int, n_misses: int) -> None:
        for s in (self.stats, self.cache.stats):
            s.cache_hits += n_hits
            s.cache_misses += n_misses

    def predict(self, subsets: Sequence[Sequence[int]]) -> np.ndarray:
        store, keys, out, miss = self._lookup(subsets)
        if miss:
            preds = np.asarray(
                self.base.predict([subsets[i] for i in miss]), np.float64
            )
            for i, p in zip(miss, preds):
                out[i] = p
                store[keys[i]] = float(p)
        self._account(len(subsets) - len(miss), len(miss))
        return out

    def predict_children(self, parent: Sequence[int]) -> np.ndarray:
        """One elimination round, deduplicated against the cache: a full
        miss runs the wrapped predictor's fused featurize+predict path; any
        hit degrades only the missing children to the ordinary batch
        predict."""
        parent = list(parent)
        children = [parent[:i] + parent[i + 1:] for i in range(len(parent))]
        store, keys, out, miss = self._lookup(children)
        if miss:
            if len(miss) == len(children) and hasattr(
                self.base, "predict_children"
            ):
                preds = np.asarray(
                    self.base.predict_children(parent), np.float64
                )
            else:
                preds = np.empty((len(children),), np.float64)
                got = np.asarray(
                    self.base.predict([children[i] for i in miss]), np.float64
                )
                preds[miss] = got
            for i in miss:
                out[i] = preds[i]
                store[keys[i]] = float(out[i])
        self._account(len(children) - len(miss), len(miss))
        return out

    def predict_one(self, subset: Sequence[int]) -> float:
        return float(self.predict([subset])[0])


def cached_contention_predictor(
    cluster,
    base,
    ledger,
    mode: str = "analytic",
    contended=None,
    use_cache: bool = True,
    vectorized: bool = True,
    stats_sink: Optional[PredictorStats] = None,
):
    """The standard fast-path predictor chain for one ledger: a
    :class:`~repro.core.contention.ContentionAwarePredictor` over ``base``,
    wrapped in a ledger-versioned cache.  ``use_cache=False`` /
    ``vectorized=False`` reproduce the slow path (the before-side of the
    throughput bench).  ``stats_sink`` substitutes a caller-owned
    :class:`PredictorStats` for the chain's counters — scratch searches
    (joint orders, defrag proposals) pass their dispatcher's wrapper stats
    so per-phase breakdowns do not lose the throwaway wrappers' time."""
    from repro_torch.core.contention import ContentionAwarePredictor

    inner = ContentionAwarePredictor(
        cluster, base, ledger, mode=mode, contended=contended,
        vectorized=vectorized,
    )
    if stats_sink is not None:
        inner.stats = stats_sink
    if not use_cache:
        return inner
    cached = PredictionCache(ledger).wrap(inner, mode=mode, versioned=True)
    if stats_sink is not None:
        cached.stats = stats_sink
    return cached


class GradingCache:
    """Ledger-versioned memo over ``sim.true_bandwidth(S, ledger)`` — the
    grading-side twin of :class:`PredictionCache`, for the trial-move /
    defrag machinery that scores placements with the simulator rather than
    a predictor.  Duck-types the one method those paths consume; keys carry
    the ledger's ``(uid, version)`` so scratch copies never collide."""

    def __init__(self, sim, max_entries: int = 1 << 17):
        self.sim = sim
        self.max_entries = max_entries
        self._memo: Dict[Tuple, float] = LruDict(max_entries)
        self.stats = PredictorStats()

    def true_bandwidth(self, subset, ledger=None) -> float:
        if ledger is None:
            key = (tuple(sorted(subset)), _UNVERSIONED, _UNVERSIONED)
        else:
            key = (tuple(sorted(subset)), ledger.uid, ledger.version)
        val = self._memo.get(key)
        if val is None:
            self.stats.cache_misses += 1
            val = self.sim.true_bandwidth(subset, ledger=ledger)
            self._memo[key] = val
        else:
            self.stats.cache_hits += 1
        return val


# ---------------------------------------------------------------------------
# Cross-search inference batching
# ---------------------------------------------------------------------------

_TLS = threading.local()


def active_batcher() -> Optional["InferenceBatcher"]:
    """The :class:`InferenceBatcher` the calling thread registered with (via
    ``batcher.worker()``), or None.  Consulted by the surrogate apply paths
    so batching needs no plumbing through the predictor protocol."""
    return getattr(_TLS, "batcher", None)


class _PendingApply:
    __slots__ = ("key", "fn", "params", "feats", "mask", "out", "done")

    def __init__(self, fn, params, feats, mask):
        self.key = (id(fn), id(params))
        self.fn = fn
        self.params = params
        self.feats = feats
        self.mask = mask
        self.out = None
        self.done = False


def _round_up_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


class InferenceBatcher:
    """Fuses surrogate applies from concurrent searches into shared calls.

    Worker threads (one per joint-order candidate, or the single defrag
    proposal thread) register with ``with batcher.worker():``.  Inside the
    block every jitted apply routes through :meth:`apply`, which parks the
    request until each registered worker has one pending — or a short
    timeout fires, so a worker stuck featurizing never stalls the others —
    then pads all same-model requests into ONE fused apply and hands every
    caller its own rows back.

    Value-neutrality: requests are grouped by ``(model fn, params)``; token
    dims are zero-padded to the group maximum and the batch dim to a power
    of two with sentinel rows (``mask[:, 0] = 1``), exactly the padding the
    un-batched apply path performs.  The Transformer is row-independent and
    pad-independent (regression-pinned), so whichever requests happen to fuse,
    every caller receives bit-identical outputs to a solo apply.  Timing
    variation can change *grouping*, never *values*.
    """

    def __init__(self, wait_timeout: float = 0.005):
        self.wait_timeout = wait_timeout
        self._cv = threading.Condition()
        self._workers = 0
        self._pending: List[_PendingApply] = []
        self.n_requests = 0
        self.n_fused_applies = 0

    @contextlib.contextmanager
    def worker(self):
        prev = getattr(_TLS, "batcher", None)
        _TLS.batcher = self
        with self._cv:
            self._workers += 1
        try:
            yield self
        finally:
            _TLS.batcher = prev
            with self._cv:
                self._workers -= 1
                # a departing worker may be the one a barrier was waiting
                # on: wake parked requests so they flush without it
                self._cv.notify_all()

    def apply(self, fn, params, feats: np.ndarray, mask: np.ndarray):
        """Submit one ``fn(params, feats, mask)`` apply; blocks until the
        fused call containing it completes.  Returns exactly ``len(feats)``
        decoded rows."""
        entry = _PendingApply(fn, params, feats, mask)
        with self._cv:
            self._pending.append(entry)
            self.n_requests += 1
            while not entry.done:
                if len(self._pending) >= max(self._workers, 1):
                    self._flush_locked()
                else:
                    self._cv.wait(self.wait_timeout)
                    if not entry.done:
                        # timeout or a worker departed: flush what we have
                        self._flush_locked()
        return entry.out

    def _flush_locked(self) -> None:
        pending, self._pending = self._pending, []
        groups: Dict[Tuple[int, int], List[_PendingApply]] = {}
        for e in pending:
            groups.setdefault(e.key, []).append(e)
        for entries in groups.values():
            self._fuse(entries)
        self.n_fused_applies += len(groups)
        self._cv.notify_all()

    @staticmethod
    def _fuse(entries: List[_PendingApply]) -> None:
        import torch  # deferred, as the other numpy modules import no torch

        fn, params = entries[0].fn, entries[0].params
        device = next(params.parameters()).device  # the model's own device
        T = max(e.feats.shape[1] for e in entries)
        B = sum(e.feats.shape[0] for e in entries)
        Bp = _round_up_pow2(max(B, 1))
        F = entries[0].feats.shape[2]
        feats = np.zeros((Bp, T, F), entries[0].feats.dtype)
        mask = np.zeros((Bp, T), entries[0].mask.dtype)
        mask[B:, 0] = 1.0  # sentinel rows, same as the solo apply path
        off = 0
        for e in entries:
            b, t = e.feats.shape[:2]
            feats[off:off + b, :t] = e.feats
            mask[off:off + b, :t] = e.mask
            off += b
        out = fn(params, torch.from_numpy(feats).to(device),
                 torch.from_numpy(mask).to(device)).cpu().numpy()
        off = 0
        for e in entries:
            b = e.feats.shape[0]
            e.out = out[off:off + b]
            e.done = True
            off += b
