"""Dispatch observability: admission tracer, metrics registry, drift recorder.

BandPilot's pitch is that the dispatcher's *predicted* contention-degraded
bandwidth matches what tenants actually get — this module is how you watch
that claim live.  Three layers, each consumable on its own:

**Span-based admission tracer** (:class:`AdmissionTracer`).  Every
``submit -> search -> commit`` path emits nested spans: the admission root,
EHA construction, the PTS descent (host rounds or fused on-device scan
steps), the contention branch taken (analytic cap vs learned head), cache
hit/miss deltas, control-plane stage/validate/retry/serialize commits,
park/pump events, and defrag background / make-room passes.  Spans land in
a bounded ring buffer and nest through a *per-thread* stack, so spans from
racing control-plane workers interleave freely without corrupting either
structure (hammer-tested in ``tests/test_telemetry.py``).  Tracing is a
process-wide opt-in (:func:`trace` / :func:`install`): when no tracer is
installed every instrumented site is a single module-global ``None`` check
returning a shared no-op span, and the tracer only ever *records* — it
never touches an rng, a predictor, or a ledger — so placements are
byte-identical with tracing on or off (regression-pinned across fifo /
batched x analytic / learned x concurrent workers).

**Unified metrics registry** (:class:`MetricsRegistry`).  One
counters/gauges/histograms surface (with labels) that absorbs every stats
object of the dispatch stack — :class:`~repro.core.predict_cache.
PredictorStats`, :class:`~repro.core.controlplane.ControlPlaneStats`,
``summarize_trace`` summaries, :class:`~repro.core.defrag.
FragmentationMetrics`, drift state — behind ``MetricsRegistry.snapshot()``,
with Prometheus text exposition (:meth:`MetricsRegistry.to_prometheus`,
label escaping and histogram grammar validated in tests) and JSONL export
(:meth:`MetricsRegistry.write_jsonl` / :func:`read_metrics_jsonl`).

*Double-count rules* (the one contract every absorb follows):
``absorb_*`` helpers **set** the cumulative value of the source object —
re-absorbing the same source is idempotent, absorbing two *distinct*
sources into the same labelset is the caller's double-count bug.  Predictor
chains must be merged exactly once via ``collect_stats`` (which dedups
shared bases by id) *before* absorbing — pass
``dispatcher.predictor_stats()``, never the per-wrapper ``.stats`` objects,
whose times nest.  ``ControlPlaneStats`` commit kinds partition:
``n_cas_commits + n_validated + n_serialized == n_admitted`` (asserted at
absorb time), so the labelled commit counter sums to the admission total by
construction.

**Prediction-drift flight recorder** (:class:`DriftMonitor`).  For every
graded admission and every ``report_bandwidth`` callback the monitor pairs
predicted B-hat with the realized contended bandwidth (wired through the
existing :class:`~repro.core.contended_dataset.TelemetryHarvester` —
attach the monitor as ``TelemetryHarvester(cluster, drift=...)`` and the
scheduler/service observation path feeds it; there is no second
observation pipeline).  It keeps windowed MAPE and signed bias per tenant
and overall, a bounded ring of :class:`DecisionRecord` (candidate subset,
contention-snapshot digest, predicted/realized scores), and raises a
structured :class:`DriftAlert` — carrying the last-N decision records —
when the window degrades past the thresholds.  ``on_alert`` is the action
hook: :func:`finetune_on_drift` builds one that feeds the harvester's
triples to :func:`repro.core.training.online_finetune_contended`, closing
the paper's online-adaptation loop from a *measured* drift signal instead
of a wall clock.

See ``docs/observability.md`` for the span taxonomy, metric names, drift
semantics, and measured overhead.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import math
import threading
import time
import zlib
from collections import deque
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "AdmissionTracer",
    "Span",
    "trace",
    "install",
    "active_tracer",
    "span",
    "event",
    "current_trace_id",
    "MetricsRegistry",
    "read_metrics_jsonl",
    "absorb_predictor_stats",
    "absorb_controlplane_stats",
    "absorb_fragmentation",
    "absorb_trace_summary",
    "absorb_drift",
    "collect_scheduler_metrics",
    "DecisionRecord",
    "DriftAlert",
    "DriftMonitor",
    "snapshot_digest",
    "finetune_on_drift",
]


# ---------------------------------------------------------------------------
# Span-based admission tracer
# ---------------------------------------------------------------------------

_TLS = threading.local()          # per-thread span stack (nesting)
_ACTIVE: Optional["AdmissionTracer"] = None   # process-wide opt-in
_INSTALL_LOCK = threading.Lock()


class Span:
    """One timed, attributed region of an admission path.

    Mutable while open (``sp["key"] = value`` adds attributes; the null
    span swallows writes), frozen in practice once it lands in the ring.
    ``trace_id`` groups every span of one admission; ``parent_id`` / the
    per-thread stack give the nesting; ``thread`` disambiguates racing
    control-plane workers.
    """

    __slots__ = (
        "name", "trace_id", "span_id", "parent_id", "thread",
        "t0", "t1", "attrs",
    )

    def __init__(self, name, trace_id, span_id, parent_id, thread, t0, attrs):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.thread = thread
        self.t0 = t0
        self.t1 = float("nan")
        self.attrs = attrs

    @property
    def duration(self) -> float:
        return self.t1 - self.t0

    def __setitem__(self, key: str, value) -> None:
        self.attrs[key] = value

    def __getitem__(self, key: str):
        return self.attrs[key]

    def __bool__(self) -> bool:
        return True

    def to_dict(self) -> Dict:
        return {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "thread": self.thread,
            "t0": self.t0,
            "t1": self.t1,
            "attrs": dict(self.attrs),
        }

    def __repr__(self) -> str:
        return (
            f"Span({self.name!r}, trace={self.trace_id}, "
            f"dur={self.duration * 1e3:.3f}ms, attrs={self.attrs})"
        )


class _NullSpan:
    """Shared no-op span: attribute writes vanish, truthiness is False so
    call sites can gate optional (more expensive) annotation work."""

    __slots__ = ()

    def __setitem__(self, key, value) -> None:
        pass

    def __bool__(self) -> bool:
        return False

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NULL_SPAN = _NullSpan()


class _OpenSpan:
    """Context manager for one live span: pushes on the caller thread's
    stack at enter, stamps ``t1``, pops, and appends to the tracer's ring
    at exit.  Exceptions propagate (a crashed admission still records its
    spans, flagged with ``error``)."""

    __slots__ = ("tracer", "span")

    def __init__(self, tracer: "AdmissionTracer", sp: Span):
        self.tracer = tracer
        self.span = sp

    def __enter__(self) -> Span:
        _stack().append(self.span)
        return self.span

    def __exit__(self, exc_type, exc, tb) -> bool:
        sp = self.span
        sp.t1 = time.time()
        if exc_type is not None:
            sp.attrs["error"] = exc_type.__name__
        stack = _stack()
        # tolerate a corrupted stack rather than masking the real exception
        if stack and stack[-1] is sp:
            stack.pop()
        elif sp in stack:
            stack.remove(sp)
        self.tracer._record(sp)
        return False


def _stack() -> List[Span]:
    st = getattr(_TLS, "stack", None)
    if st is None:
        st = _TLS.stack = []
    return st


class AdmissionTracer:
    """Bounded ring buffer of completed :class:`Span` records.

    Thread-safe by construction: nesting state is per-thread (TLS), ring
    appends take the tracer lock, and a full ring drops the *oldest* span.
    ``capacity`` bounds memory no matter how long the service runs —
    tracing is a flight recorder, not an archive (export with
    :meth:`write_jsonl` if you need one).
    """

    def __init__(self, capacity: int = 4096):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = int(capacity)
        self._ring: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._trace_ids = itertools.count()
        self._span_ids = itertools.count()
        self.n_spans = 0          # lifetime count (before ring eviction)
        self.n_dropped = 0        # evicted by the capacity bound

    # -- emission (normally via the module-level span()/event()) ------------

    def span(self, name: str, **attrs) -> _OpenSpan:
        """Open a span.  The first span on a thread's empty stack starts a
        fresh trace (one trace == one admission path); nested spans inherit
        the enclosing trace id."""
        stack = _stack()
        if stack:
            parent = stack[-1]
            trace_id, parent_id = parent.trace_id, parent.span_id
        else:
            with self._lock:
                trace_id = next(self._trace_ids)
            parent_id = -1
        with self._lock:
            span_id = next(self._span_ids)
        sp = Span(
            name, trace_id, span_id, parent_id,
            threading.get_ident(), time.time(), attrs,
        )
        return _OpenSpan(self, sp)

    def event(self, name: str, **attrs) -> None:
        """Zero-duration span (park/pump notifications and the like)."""
        with self.span(name, **attrs):
            pass

    def _record(self, sp: Span) -> None:
        with self._lock:
            if len(self._ring) == self.capacity:
                self.n_dropped += 1
            self._ring.append(sp)
            self.n_spans += 1

    # -- inspection ----------------------------------------------------------

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def spans(
        self, name: Optional[str] = None, trace_id: Optional[int] = None
    ) -> List[Span]:
        """Completed spans, oldest first, optionally filtered."""
        with self._lock:
            out = list(self._ring)
        if name is not None:
            out = [s for s in out if s.name == name]
        if trace_id is not None:
            out = [s for s in out if s.trace_id == trace_id]
        return out

    def traces(self) -> Dict[int, List[Span]]:
        """trace id -> its spans (in completion order)."""
        out: Dict[int, List[Span]] = {}
        for s in self.spans():
            out.setdefault(s.trace_id, []).append(s)
        return out

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    def summary(self) -> Dict[str, Dict[str, float]]:
        """span name -> {count, total_seconds, mean_seconds} over the ring."""
        agg: Dict[str, List[float]] = {}
        for s in self.spans():
            if not math.isnan(s.t1):
                agg.setdefault(s.name, []).append(s.duration)
        return {
            name: {
                "count": float(len(ds)),
                "total_seconds": float(sum(ds)),
                "mean_seconds": float(sum(ds) / len(ds)),
            }
            for name, ds in sorted(agg.items())
        }

    def write_jsonl(self, path) -> int:
        """Dump the ring as one JSON object per line; returns the count."""
        spans = self.spans()
        with open(path, "w", encoding="utf-8") as fh:
            for s in spans:
                fh.write(json.dumps(s.to_dict(), sort_keys=True) + "\n")
        return len(spans)


def install(tracer: Optional[AdmissionTracer]) -> Optional[AdmissionTracer]:
    """Install ``tracer`` process-wide (None disables).  Returns the
    previous tracer.  Process-wide on purpose: control-plane pool threads
    and joint-order workers must see the same tracer as the submitting
    thread, which thread-local installation cannot provide."""
    global _ACTIVE
    with _INSTALL_LOCK:
        prev, _ACTIVE = _ACTIVE, tracer
    return prev


def active_tracer() -> Optional[AdmissionTracer]:
    return _ACTIVE


@contextlib.contextmanager
def trace(tracer: AdmissionTracer):
    """``with telemetry.trace(AdmissionTracer()) as tr:`` — install for the
    block, restore the previous tracer after."""
    prev = install(tracer)
    try:
        yield tracer
    finally:
        install(prev)


def span(name: str, **attrs):
    """THE instrumentation entry point: a context manager that is a live
    span under an installed tracer and a shared no-op otherwise.  The
    disabled cost is one global read per call site."""
    tr = _ACTIVE
    if tr is None:
        return _NULL_SPAN
    return tr.span(name, **attrs)


def event(name: str, **attrs) -> None:
    """Zero-duration notification (no-op when tracing is disabled)."""
    tr = _ACTIVE
    if tr is not None:
        tr.event(name, **attrs)


def current_trace_id() -> int:
    """Trace id of the innermost open span on the calling thread, or -1
    when no span is open (or no tracer installed).  The trace <-> journal
    linkage primitive: forensics dossiers stamp it next to the commit's
    ``journal_seq`` so one admission can be followed across the span ring,
    the journal, and the dossier store."""
    if _ACTIVE is None:
        return -1
    st = getattr(_TLS, "stack", None)
    return st[-1].trace_id if st else -1


# ---------------------------------------------------------------------------
# Unified metrics registry
# ---------------------------------------------------------------------------

def _escape_label_value(v: str) -> str:
    """Prometheus exposition escaping for label values: backslash, double
    quote, and newline (in that order — backslash first)."""
    return (
        str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    )


def _escape_help(v: str) -> str:
    """HELP lines escape backslash and newline (quotes stay bare)."""
    return str(v).replace("\\", "\\\\").replace("\n", "\\n")


def _format_value(v: float) -> str:
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    return repr(float(v))


_NAME_OK = set(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_:"
)
_LABEL_OK = set(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_"
)


def _check_name(name: str, charset, kind: str) -> str:
    if not name or name[0].isdigit() or not set(name) <= charset:
        raise ValueError(f"invalid {kind} name {name!r}")
    return name


class _Metric:
    """Shared machinery: one named metric, samples keyed by label values."""

    kind = "untyped"

    def __init__(self, name: str, help: str, labels: Sequence[str] = ()):
        self.name = _check_name(name, _NAME_OK, "metric")
        self.help = help
        self.label_names: Tuple[str, ...] = tuple(
            _check_name(ln, _LABEL_OK, "label") for ln in labels
        )
        self._samples: Dict[Tuple[str, ...], float] = {}
        self._lock = threading.Lock()

    def _key(self, labels: Dict[str, object]) -> Tuple[str, ...]:
        if set(labels) != set(self.label_names):
            raise ValueError(
                f"{self.name}: expected labels {self.label_names}, "
                f"got {tuple(sorted(labels))}"
            )
        return tuple(str(labels[ln]) for ln in self.label_names)

    def value(self, **labels) -> float:
        with self._lock:
            return self._samples[self._key(labels)]

    def samples(self) -> List[Tuple[Dict[str, str], float]]:
        with self._lock:
            items = list(self._samples.items())
        return [
            (dict(zip(self.label_names, key)), v) for key, v in sorted(items)
        ]

    def _label_str(self, key: Tuple[str, ...], extra: str = "") -> str:
        parts = [
            f'{ln}="{_escape_label_value(lv)}"'
            for ln, lv in zip(self.label_names, key)
        ]
        if extra:
            parts.append(extra)
        return "{" + ",".join(parts) + "}" if parts else ""

    def expose(self) -> List[str]:
        lines = [
            f"# HELP {self.name} {_escape_help(self.help)}",
            f"# TYPE {self.name} {self.kind}",
        ]
        with self._lock:
            items = sorted(self._samples.items())
        for key, v in items:
            lines.append(f"{self.name}{self._label_str(key)} {_format_value(v)}")
        return lines

    def snapshot(self) -> Dict:
        return {
            "type": self.kind,
            "help": self.help,
            "samples": [
                {"labels": labels, "value": v} for labels, v in self.samples()
            ],
        }


class Counter(_Metric):
    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError(f"{self.name}: counters only go up")
        key = self._key(labels)
        with self._lock:
            self._samples[key] = self._samples.get(key, 0.0) + float(amount)

    def set(self, value: float, **labels) -> None:
        """Set the cumulative value — the absorb-idempotency primitive (the
        source object owns the accumulation; re-absorbing must not double).
        Monotonicity is the source's contract, not re-checked here."""
        if value < 0:
            raise ValueError(f"{self.name}: counters are non-negative")
        with self._lock:
            self._samples[self._key(labels)] = float(value)


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._samples[self._key(labels)] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._samples[key] = self._samples.get(key, 0.0) + float(amount)


DEFAULT_BUCKETS = (
    0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 50.0, 100.0,
)


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help, labels=(), buckets=DEFAULT_BUCKETS):
        super().__init__(name, help, labels)
        bs = tuple(sorted(float(b) for b in buckets))
        if not bs or any(b1 <= b0 for b0, b1 in zip(bs, bs[1:])):
            raise ValueError("buckets must be non-empty and strictly increasing")
        self.buckets = bs
        # per labelset: cumulative bucket counts (+Inf implicit last), sum
        self._counts: Dict[Tuple[str, ...], List[int]] = {}
        self._sums: Dict[Tuple[str, ...], float] = {}

    def observe(self, value: float, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            counts = self._counts.get(key)
            if counts is None:
                counts = self._counts[key] = [0] * (len(self.buckets) + 1)
                self._sums[key] = 0.0
                self._samples[key] = 0.0   # observation count (for value())
            for i, b in enumerate(self.buckets):
                if value <= b:
                    counts[i] += 1
            counts[-1] += 1                # +Inf
            self._sums[key] += float(value)
            self._samples[key] += 1.0

    def expose(self) -> List[str]:
        lines = [
            f"# HELP {self.name} {_escape_help(self.help)}",
            f"# TYPE {self.name} {self.kind}",
        ]
        with self._lock:
            items = sorted(self._counts.items())
            sums = dict(self._sums)
        for key, counts in items:
            for b, c in zip(self.buckets, counts):
                le = f'le="{_format_value(b)}"'
                lines.append(
                    f"{self.name}_bucket{self._label_str(key, le)} {c}"
                )
            inf_label = 'le="+Inf"'
            lines.append(
                f"{self.name}_bucket{self._label_str(key, inf_label)} "
                f"{counts[-1]}"
            )
            lines.append(
                f"{self.name}_sum{self._label_str(key)} "
                f"{_format_value(sums[key])}"
            )
            lines.append(
                f"{self.name}_count{self._label_str(key)} {counts[-1]}"
            )
        return lines

    def snapshot(self) -> Dict:
        with self._lock:
            items = sorted(self._counts.items())
            sums = dict(self._sums)
        return {
            "type": self.kind,
            "help": self.help,
            "buckets": list(self.buckets),
            "samples": [
                {
                    "labels": dict(zip(self.label_names, key)),
                    "counts": list(counts),
                    "sum": sums[key],
                    "count": counts[-1],
                }
                for key, counts in items
            ],
        }


class MetricsRegistry:
    """One process-wide (or per-test) home for every dispatch metric.

    ``counter``/``gauge``/``histogram`` get-or-create (re-registration with
    a different type or labelset is an error — one name, one schema);
    ``snapshot()`` returns the whole registry as plain dicts,
    ``to_prometheus()`` the text exposition, ``write_jsonl``/
    :func:`read_metrics_jsonl` the file round-trip.
    """

    def __init__(self, namespace: str = "bandpilot"):
        self.namespace = namespace
        self._metrics: Dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def _full(self, name: str) -> str:
        return f"{self.namespace}_{name}" if self.namespace else name

    def _get_or_create(self, cls, name, help, labels, **kw) -> _Metric:
        full = self._full(name)
        with self._lock:
            m = self._metrics.get(full)
            if m is None:
                m = cls(full, help, labels, **kw)
                self._metrics[full] = m
                return m
        if not isinstance(m, cls) or m.label_names != tuple(labels):
            raise ValueError(
                f"metric {full!r} already registered as {m.kind} with "
                f"labels {m.label_names}"
            )
        want = kw.get("buckets")
        if want is not None and isinstance(m, Histogram):
            norm = tuple(sorted(float(b) for b in want))
            if norm != m.buckets:
                # one name, one schema: silently keeping the first buckets
                # would make the second caller's distribution unreadable
                raise ValueError(
                    f"metric {full!r} already registered with buckets "
                    f"{m.buckets}; re-registration asked for {norm}"
                )
        return m

    def counter(self, name, help="", labels=()) -> Counter:
        return self._get_or_create(Counter, name, help, labels)

    def gauge(self, name, help="", labels=()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labels)

    def histogram(
        self, name, help="", labels=(), buckets=DEFAULT_BUCKETS
    ) -> Histogram:
        return self._get_or_create(
            Histogram, name, help, labels, buckets=buckets
        )

    def get(self, name: str) -> Optional[_Metric]:
        """Look up by short name or the fully-namespaced exposition name."""
        m = self._metrics.get(self._full(name))
        return m if m is not None else self._metrics.get(name)

    def __len__(self) -> int:
        return len(self._metrics)

    def snapshot(self) -> Dict[str, Dict]:
        with self._lock:
            metrics = sorted(self._metrics.items())
        return {name: m.snapshot() for name, m in metrics}

    def to_prometheus(self) -> str:
        with self._lock:
            metrics = sorted(self._metrics.items())
        lines: List[str] = []
        for _, m in metrics:
            lines.extend(m.expose())
        return "\n".join(lines) + ("\n" if lines else "")

    def write_jsonl(self, path) -> int:
        """One ``{"name": ..., **snapshot}`` object per line."""
        snap = self.snapshot()
        with open(path, "w", encoding="utf-8") as fh:
            for name, m in snap.items():
                fh.write(
                    json.dumps({"name": name, **m}, sort_keys=True) + "\n"
                )
        return len(snap)


def read_metrics_jsonl(path) -> Dict[str, Dict]:
    """Load a :meth:`MetricsRegistry.write_jsonl` file back into the same
    ``snapshot()`` shape (the round-trip is pinned in tests)."""
    out: Dict[str, Dict] = {}
    with open(path, "r", encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            obj = json.loads(line)
            name = obj.pop("name")
            out[name] = obj
    return out


# -- absorption: the existing stats surfaces behind one snapshot ------------

def absorb_predictor_stats(reg: MetricsRegistry, stats, **labels) -> None:
    """Absorb one *merged* :class:`~repro.core.predict_cache.PredictorStats`
    (``dispatcher.predictor_stats()`` — already chain-deduped).  Set
    semantics: idempotent per (source, labelset)."""
    names = tuple(sorted(labels))
    for field, help in (
        ("n_model_calls", "candidates sent through a surrogate apply"),
        ("n_capped", "candidates degraded by a contention branch"),
        ("n_scan_steps", "fused on-device elimination rounds"),
        ("cache_hits", "prediction-cache hits"),
        ("cache_misses", "prediction-cache misses"),
    ):
        reg.counter(f"predictor_{field}_total", help, names).set(
            getattr(stats, field), **labels
        )
    for field, help in (
        ("predict_seconds", "wall seconds inside predict()"),
        ("featurize_seconds", "wall seconds building token batches"),
        ("infer_seconds", "wall seconds in jitted applies"),
        ("scan_seconds", "wall seconds in fused on-device descents"),
        ("wrapper_seconds", "contention-wrapper overhead seconds"),
    ):
        reg.counter(f"predictor_{field}_total", help, names).set(
            getattr(stats, field), **labels
        )
    reg.gauge(
        "predictor_cache_hit_rate", "hits / (hits + misses)", names
    ).set(stats.hit_rate, **labels)


def absorb_controlplane_stats(reg: MetricsRegistry, stats, **labels) -> None:
    """Absorb a :class:`~repro.core.controlplane.ControlPlaneStats`.

    The commit-kind partition is the documented invariant: cas + validated
    + serialized == admitted.  Exposed as ONE labelled counter (so the sum
    over the ``commit`` label is the admission total by construction) and
    asserted here — drift between the partition and the total is a stats
    bug, caught at absorb time rather than on a dashboard.
    """
    parts = {
        "cas": stats.n_cas_commits,
        "validated": stats.n_validated,
        "serialized": stats.n_serialized,
    }
    if sum(parts.values()) != stats.n_admitted:
        raise ValueError(
            f"commit kinds {parts} do not partition "
            f"n_admitted={stats.n_admitted}"
        )
    names = tuple(sorted(labels))
    commit = reg.counter(
        "cplane_commits_total",
        "admissions by commit kind (sums to admissions)",
        names + ("commit",),
    )
    for kind, v in parts.items():
        commit.set(v, commit=kind, **labels)
    for field, help in (
        ("n_admitted", "admissions committed"),
        ("n_conflicts", "re-searches forced by moved read-sets"),
        ("n_parked", "park events (capacity / tenant caps)"),
        ("n_rejected", "rejections (queue caps)"),
    ):
        reg.counter(f"cplane_{field[2:]}_total", help, names).set(
            getattr(stats, field), **labels
        )
    for field, help in (
        ("search_seconds", "wall seconds staging searches"),
        ("commit_seconds", "wall seconds in commit attempts"),
    ):
        reg.counter(f"cplane_{field}_total", help, names).set(
            getattr(stats, field), **labels
        )


def absorb_fragmentation(reg: MetricsRegistry, frag, **labels) -> None:
    """Absorb a :class:`~repro.core.defrag.FragmentationMetrics` (gauges:
    fragmentation is instantaneous state, not a cumulative count)."""
    names = tuple(sorted(labels))
    for field, help in (
        ("total_free", "free GPUs"),
        ("clean_hosts", "fully-free hosts"),
        ("fragmented_hosts", "partially-busy hosts"),
        ("largest_free_block", "largest single-host free capacity"),
        ("largest_quality_block", "largest switch-fabric free block"),
        ("premium_free", "free GPUs on switch-fabric hosts"),
        ("stranding", "stranded free GPUs / total free GPUs"),
    ):
        reg.gauge(f"frag_{field}", help, names).set(
            getattr(frag, field), **labels
        )


def absorb_trace_summary(reg: MetricsRegistry, records, **labels) -> None:
    """Absorb graded :class:`~repro.core.scheduler.TenantRecord` rows: the
    ``summarize_trace`` means as gauges plus wait/GBE histograms.  One
    labelset per dispatcher name found in the records (merged with
    ``labels``)."""
    from repro_torch.core.scheduler import summarize_trace

    summary = summarize_trace(records)
    names = tuple(sorted(labels)) + ("dispatcher",)
    waits = reg.histogram(
        "admission_wait_seconds", "queueing delay per admission", names,
        buckets=(0.5, 1.0, 2.0, 5.0, 10.0, 20.0, 50.0),
    )
    gbes = reg.histogram(
        "admission_gbe", "contention-degraded GBE per admission", names,
        buckets=(0.2, 0.4, 0.6, 0.8, 0.9, 0.95, 0.99, 1.0),
    )
    count = reg.counter(
        "admissions_total", "graded admissions", names + ("policy",)
    )
    for r in records:
        waits.observe(r.wait, dispatcher=r.dispatcher, **labels)
        if not math.isnan(r.gbe):
            gbes.observe(r.gbe, dispatcher=r.dispatcher, **labels)
        count.inc(1, dispatcher=r.dispatcher, policy=r.policy, **labels)
    for disp, row in summary.items():
        for field, value in row.items():
            if field == "n":
                continue
            reg.gauge(
                f"trace_{field}", f"summarize_trace {field}", names
            ).set(value, dispatcher=disp, **labels)


def absorb_drift(reg: MetricsRegistry, monitor: "DriftMonitor", **labels):
    """Absorb a :class:`DriftMonitor`'s windowed state."""
    names = tuple(sorted(labels))
    reg.gauge("drift_mape", "windowed MAPE of B-hat vs realized", names).set(
        monitor.mape(), **labels
    )
    reg.gauge("drift_bias", "windowed signed bias of B-hat", names).set(
        monitor.bias(), **labels
    )
    reg.counter("drift_samples_total", "paired observations", names).set(
        monitor.n_observed, **labels
    )
    reg.counter("drift_alerts_total", "drift alerts raised", names).set(
        len(monitor.alerts), **labels
    )
    per_tenant = reg.gauge(
        "drift_mape_tenant", "windowed MAPE per tenant", names + ("tenant",)
    )
    for tenant in monitor.tenants():
        per_tenant.set(monitor.mape(tenant=tenant), tenant=tenant, **labels)


def absorb_recovery(reg: MetricsRegistry, scheduler, **labels) -> None:
    """Absorb the failure-domain outcome of a scheduler run: injected
    fault counts per kind, MTTR over completed recoveries, abandoned
    requeues, and the bandwidth retained across the storm (aggregate live
    contended bw after the last fault's drain / before the first fault).
    No-op when the run carried no fault schedule."""
    fault_log = getattr(scheduler, "fault_log", None) or []
    recoveries = list(getattr(scheduler, "recoveries", ()) or [])
    if not fault_log and not recoveries:
        return
    names = tuple(sorted(labels))
    faults_rows = [r for r in fault_log if r["op"] == "fault"]
    cnt = reg.counter(
        "faults_injected_total", "fault events applied", names + ("kind",)
    )
    for kind in sorted({r["kind"] for r in faults_rows}):
        cnt.set(sum(1 for r in faults_rows if r["kind"] == kind),
                kind=kind, **labels)
    done = [r for r in recoveries if not r.gave_up]
    reg.counter("recoveries_total", "victims re-admitted", names).set(
        len(done), **labels
    )
    reg.counter(
        "recoveries_gave_up_total", "requeues abandoned after max retries",
        names,
    ).set(len(recoveries) - len(done), **labels)
    if done:
        reg.gauge(
            "recovery_mttr_mean", "mean fault-to-readmission time", names
        ).set(sum(r.mttr for r in done) / len(done), **labels)
        reg.gauge(
            "recovery_mttr_max", "worst fault-to-readmission time", names
        ).set(float(max(r.mttr for r in done)), **labels)
        reg.gauge(
            "recovery_attempts_mean", "mean re-admission attempts", names
        ).set(sum(r.attempts for r in done) / len(done), **labels)
    if faults_rows:
        pre = faults_rows[0]["agg_bw_before"]
        post = faults_rows[-1]["agg_bw_after"]
        if pre > 0:
            reg.gauge(
                "recovered_bandwidth_frac",
                "aggregate live contended bw retained across the storm",
                names,
            ).set(post / pre, **labels)


def collect_scheduler_metrics(
    scheduler, registry: Optional[MetricsRegistry] = None
) -> MetricsRegistry:
    """One-call snapshot of everything a finished (or live)
    :class:`~repro.core.scheduler.AdmissionScheduler` knows: trace
    summaries, merged predictor stats, grading-cache counters, current
    fragmentation, migration counts, control-plane stats (when concurrent),
    and drift state (when the harvester carries a monitor)."""
    reg = registry if registry is not None else MetricsRegistry()
    disp = scheduler.dispatcher
    name = getattr(disp, "name", "dispatcher")
    if scheduler.records:
        absorb_trace_summary(reg, scheduler.records)
    stats_fn = getattr(disp, "predictor_stats", None)
    if stats_fn is not None:
        absorb_predictor_stats(reg, stats_fn(), dispatcher=name)
    absorb_predictor_stats(
        reg, scheduler.grading_cache.stats, dispatcher=f"{name}/grading"
    )
    absorb_fragmentation(
        reg, disp.ledger.fragmentation(), dispatcher=name
    )
    reg.counter(
        "migrations_total", "committed live-job moves", ("dispatcher", "kind")
    )
    for kind in ("redispatch", "defrag", "make-room", "flap-migrate"):
        reg.get("migrations_total").set(
            sum(1 for m in scheduler.migrations if m.kind == kind),
            dispatcher=name, kind=kind,
        )
    absorb_recovery(reg, scheduler, dispatcher=name)
    cplane = getattr(scheduler, "_cplane", None)
    if cplane is not None:
        absorb_controlplane_stats(reg, cplane.stats, dispatcher=name)
    drift = getattr(scheduler.harvester, "drift", None)
    if drift is not None:
        absorb_drift(reg, drift, dispatcher=name)
    return reg


# ---------------------------------------------------------------------------
# Prediction-drift flight recorder
# ---------------------------------------------------------------------------

def snapshot_digest(ledger, subset: Sequence[int] = ()) -> str:
    """Stable 8-hex digest of the contention context a prediction was made
    against: the sorted GPU tuples of every live job disjoint from
    ``subset`` (the same co-tenant predicate the harvester and the
    contended ground truth use).  Cheap enough to stamp on every decision
    record; two records with equal digests saw byte-identical co-tenant
    sets."""
    sset = set(subset)
    cot = sorted(
        a.gpus for a in ledger.jobs() if sset.isdisjoint(a.gpus)
    )
    blob = ";".join(",".join(str(g) for g in gs) for gs in cot)
    return f"{zlib.crc32(blob.encode('utf-8')) & 0xFFFFFFFF:08x}"


@dataclasses.dataclass
class DecisionRecord:
    """One graded dispatch decision, as the flight recorder keeps it."""

    job_id: str
    tenant: str
    subset: Tuple[int, ...]
    predicted: float          # B-hat the search committed on
    realized: float           # contended bandwidth actually measured/graded
    ape: float                # |predicted - realized| / realized
    err: float                # signed (predicted - realized) / realized
    digest: str               # contention-snapshot digest at decision time
    t: float = 0.0            # trace clock of the observation
    source: str = "grade"     # "grade" | "report" (report_bandwidth)

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class DriftAlert:
    """Structured drift notification: the windowed stats that tripped the
    threshold plus the last-N decision records behind them."""

    t: float                   # observation clock when raised
    n_window: int              # paired observations in the window
    mape: float
    bias: float
    mape_threshold: float
    bias_threshold: float
    tenant: str                # "" = the global window tripped
    records: List[DecisionRecord] = dataclasses.field(default_factory=list)

    @property
    def kind(self) -> str:
        return "bias" if abs(self.bias) >= self.bias_threshold else "mape"

    def to_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        d["kind"] = self.kind
        return d


class DriftMonitor:
    """Windowed predicted-vs-realized drift tracking with structured alerts.

    Wire it through the existing telemetry path —
    ``TelemetryHarvester(cluster, drift=monitor)`` — and every graded
    admission / ``report_bandwidth`` callback that reaches the harvester
    also reaches the monitor; there is no second observation pipeline.

    * :meth:`note_prediction` stamps the B-hat an admission committed on
      (the scheduler and control plane call it with the search's predicted
      bandwidth, the subset, and the contention-snapshot digest).
    * :meth:`observe` pairs a realized bandwidth with the stamped
      prediction (grading passes ``predicted`` inline; a later
      ``report_bandwidth`` resolves through the pending map by job id).
    * windowed **MAPE** (mean |err|) and **bias** (mean signed err — a
      systematically optimistic predictor shows positive bias long before
      MAPE looks alarming) are kept overall and per tenant over the last
      ``window`` pairs.
    * when a window of at least ``min_samples`` exceeds a threshold, a
      :class:`DriftAlert` carrying the last ``dump_last`` decision records
      is appended to :attr:`alerts` and handed to ``on_alert`` — with at
      least ``min_samples`` fresh pairs between alerts, so a persistently
      bad predictor alerts periodically, not per admission.

    Thread-safe (the control plane grades from pool threads).  NaN or
    non-positive realized values are dropped (a stale report carries no
    drift signal).
    """

    def __init__(
        self,
        window: int = 64,
        min_samples: int = 16,
        mape_threshold: float = 0.25,
        bias_threshold: float = 0.20,
        dump_last: int = 32,
        max_records: int = 1024,
        on_alert: Optional[Callable[["DriftAlert"], None]] = None,
    ):
        if window < 1 or min_samples < 1:
            raise ValueError("window and min_samples must be >= 1")
        self.window = int(window)
        self.min_samples = int(min_samples)
        self.mape_threshold = float(mape_threshold)
        self.bias_threshold = float(bias_threshold)
        self.dump_last = int(dump_last)
        self.on_alert = on_alert
        self._lock = threading.Lock()
        self._pending: Dict[str, Tuple[float, Tuple[int, ...], str, str]] = {}
        self._errs: deque = deque(maxlen=self.window)   # signed rel. errors
        self._tenant_errs: Dict[str, deque] = {}
        self._records: deque = deque(maxlen=int(max_records))
        self._since_alert = 0
        self.alerts: List[DriftAlert] = []
        self.n_observed = 0    # paired observations (lifetime)
        self.n_unmatched = 0   # realized values with no stamped prediction

    # -- feeding -------------------------------------------------------------

    def note_prediction(
        self,
        job_id: str,
        subset: Sequence[int],
        predicted: float,
        digest: str = "",
        tenant: str = "",
    ) -> None:
        """Stamp the B-hat an admission committed on (pairs with a later
        ``report_bandwidth`` for the same job)."""
        if math.isnan(predicted):
            return  # baselines search without a predictor: nothing to grade
        with self._lock:
            self._pending[job_id] = (
                float(predicted), tuple(subset), digest, tenant
            )

    def observe(
        self,
        realized: float,
        job_id: str = "",
        subset: Sequence[int] = (),
        predicted: Optional[float] = None,
        digest: str = "",
        tenant: str = "",
        t: float = 0.0,
        source: str = "grade",
    ) -> Optional[DriftAlert]:
        """Pair one realized bandwidth with its prediction; returns the
        alert if this observation tripped one."""
        with self._lock:
            if predicted is None or math.isnan(predicted):
                pend = self._pending.get(job_id)
                if pend is None:
                    self.n_unmatched += 1
                    return None
                predicted, psubset, pdigest, ptenant = pend
                subset = subset or psubset
                digest = digest or pdigest
                tenant = tenant or ptenant
            if math.isnan(realized) or realized <= 0.0:
                return None
            err = (float(predicted) - float(realized)) / float(realized)
            rec = DecisionRecord(
                job_id, tenant, tuple(subset), float(predicted),
                float(realized), abs(err), err, digest, t=t, source=source,
            )
            self._records.append(rec)
            self._errs.append(err)
            self._tenant_errs.setdefault(
                tenant, deque(maxlen=self.window)
            ).append(err)
            self.n_observed += 1
            self._since_alert += 1
            return self._check_locked(t)

    def release(self, job_id: str) -> None:
        """Forget a departed job's stamped prediction (frees the pending
        map; an un-reported job simply never pairs)."""
        with self._lock:
            self._pending.pop(job_id, None)

    # -- windows -------------------------------------------------------------

    def _window_for(self, tenant: Optional[str]) -> Iterable[float]:
        if tenant is None:
            return self._errs
        return self._tenant_errs.get(tenant, ())

    def mape(self, tenant: Optional[str] = None) -> float:
        with self._lock:
            errs = list(self._window_for(tenant))
        if not errs:
            return float("nan")
        return float(sum(abs(e) for e in errs) / len(errs))

    def bias(self, tenant: Optional[str] = None) -> float:
        with self._lock:
            errs = list(self._window_for(tenant))
        if not errs:
            return float("nan")
        return float(sum(errs) / len(errs))

    def tenants(self) -> List[str]:
        with self._lock:
            return sorted(self._tenant_errs)

    def records(self, last: Optional[int] = None) -> List[DecisionRecord]:
        with self._lock:
            out = list(self._records)
        return out[-last:] if last is not None else out

    def dump(self, last: Optional[int] = None, path=None) -> List[Dict]:
        """The last-N decision records as dicts; optionally written to
        ``path`` as JSONL (the on-demand side of the flight recorder)."""
        rows = [r.to_dict() for r in self.records(last or self.dump_last)]
        if path is not None:
            with open(path, "w", encoding="utf-8") as fh:
                for row in rows:
                    fh.write(json.dumps(row, sort_keys=True) + "\n")
        return rows

    # -- alerting ------------------------------------------------------------

    def _check_locked(self, t: float) -> Optional[DriftAlert]:
        if self._since_alert < self.min_samples:
            return None
        errs = self._errs
        if len(errs) < self.min_samples:
            return None
        mape = sum(abs(e) for e in errs) / len(errs)
        bias = sum(errs) / len(errs)
        if mape < self.mape_threshold and abs(bias) < self.bias_threshold:
            return None
        alert = DriftAlert(
            t, len(errs), float(mape), float(bias),
            self.mape_threshold, self.bias_threshold, tenant="",
            records=list(self._records)[-self.dump_last:],
        )
        self.alerts.append(alert)
        self._since_alert = 0
        cb = self.on_alert
        if cb is not None:
            # outside the lock would be nicer, but the callback may touch
            # the monitor; RLock semantics via re-acquire are avoided by
            # keeping callbacks read-only on the monitor (documented)
            cb(alert)
        event("drift.alert", mape=alert.mape, bias=alert.bias,
              n=alert.n_window)
        return alert


def finetune_on_drift(
    harvester,
    predictor,
    tables=None,
    steps: int = 100,
    lr: float = 5e-4,
    min_contended: int = 8,
    trainer: Optional[Callable] = None,
) -> Callable[[DriftAlert], None]:
    """Build an ``on_alert`` hook that closes the online-adaptation loop:
    on drift, fine-tune the dispatcher's
    :class:`~repro.core.surrogate.ContendedSurrogatePredictor` on the
    harvester's accumulated (subset, ledger, bw) triples
    (:func:`repro.core.training.online_finetune_contended`) and swap the
    new params into ``predictor`` in place — the next admission searches
    with the adapted model.

    ``trainer`` substitutes the training call (tests inject a stub; the
    default resolves the real one lazily so the hook itself stays
    jax-free).  The hook is a no-op until the harvester holds at least
    ``min_contended`` contended samples — fine-tuning on an empty or
    isolated-only buffer would only destabilize the head.
    """

    def _alert(alert: DriftAlert) -> None:
        triples = harvester.triples()
        contended = [tr for tr in triples if tr[1] is not None]
        if len(contended) < min_contended:
            return
        fit = trainer
        if fit is None:
            from repro_torch.core.training import online_finetune_contended

            def fit(cluster, tbl, params, samples):  # noqa: F811
                return online_finetune_contended(
                    cluster, tbl, params, samples, steps=steps, lr=lr,
                )

        new_params = fit(
            harvester.cluster,
            tables if tables is not None else predictor.tables,
            predictor.params,
            triples,
        )
        predictor.params = new_params
        event("drift.finetune", n_samples=len(triples),
              n_contended=len(contended))

    return _alert
