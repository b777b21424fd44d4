"""Defragmentation: fragmentation metrics, consolidation planner, triggers.

Long Poisson traces leave the cluster *fragmented*: many half-busy hosts,
no host with a large clean block.  The ledger knows this
(:meth:`~repro.core.tenancy.JobLedger.occupancy`) but, before this module,
nothing acted on it — a large arrival was forced into a cross-host,
rail-contended placement even when a cheap consolidation of small
co-tenants could have freed a clean host.  That is exactly the regime
BandPilot's contention model exists to avoid.  Three layers close the gap:

1. **Metrics** — :func:`fragmentation_metrics` condenses a ledger into a
   :class:`FragmentationMetrics`: total free GPUs, clean-host count,
   the largest placeable k that does not cross hosts, and the *stranding
   score* (fraction of free GPUs stuck on partially-busy hosts).  Exposed
   on :meth:`JobLedger.fragmentation`, carried by
   :class:`~repro.core.tenancy.ContentionSnapshot`, and reported per
   admission by ``summarize_trace``.

2. **Planner** — :func:`plan_defrag` builds a greedy multi-move
   consolidation plan against a *scratch copy* of the ledger: candidate
   moves re-place small (single- or partial-host) jobs into best-fit
   slots (:func:`consolidation_proposer` — tightest fit first, premium
   hosts last, the ordinary hybrid search as fallback), each move must
   *consolidate* (:func:`is_consolidating`) and is scored by the change
   in a cluster potential

       ``sum over live tenants of contended bw
         + clean_host_bonus * clean hosts
         + premium_reserve * free switch-fabric GPUs
         [+ make_room_bonus * min(largest quality block, target k)]
         - migration cost``

   and committed only under a **no-harm-per-tenant** guarantee (no live
   job's contended bandwidth may drop).  Charging every move against the
   shared migration cost and requiring a strict potential increase bounds
   the plan and rules out oscillation.

3. **Triggers** — the admission scheduler (``SchedulerConfig(defrag=
   True)``) runs a *background pass* at release time (rate-limited by
   ``DefragConfig.interval``) plus an on-demand **make-room pass** when an
   arrival would otherwise be forced into a cross-host rail-contended
   placement (:func:`forced_rail_contended`) that consolidation could
   avoid.  Fragmentation-awareness also enters placement itself:
   :func:`make_frag_penalty` is the configurable tie-break
   (``frag_weight``) threaded through ``search.hybrid_search`` /
   ``joint_hybrid_search`` that steers otherwise-equal candidates away
   from breaking up clean hosts.

This module is also the shared home of the migration economics used by
the scheduler's release-time re-dispatch, the fault-tolerance rebalance
(:mod:`repro.ft.elastic`), and the planner itself: :func:`migration_cost`,
:func:`net_migration_gain`, and :func:`evaluate_move` (the trial
relocation with the no-harm check, restoring the ledger exactly).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core import search
from repro_torch.core.cluster import Cluster
from repro_torch.core.tenancy import Allocation, JobLedger

Subset = List[int]

# propose(ledger, avail, k) -> subset: how a trial relocation picks the new
# placement (the ledger is the scratch state with the moving job released).
Proposer = Callable[[JobLedger, Sequence[int], int], Subset]
# proposals(ledger, avail, k) -> ranked candidate subsets for one mover
# (the planner evaluates them in order and keeps the first that qualifies).
ProposalFan = Callable[[JobLedger, Sequence[int], int], List[Subset]]

_EPS = 1e-9


# ---------------------------------------------------------------------------
# Layer 1: fragmentation metrics
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FragmentationMetrics:
    """How chopped-up a ledger's free capacity is.

    ``largest_free_block`` is the largest k placeable without crossing
    hosts; ``stranding`` is the fraction of free GPUs sitting on
    partially-busy hosts (0.0 on an empty *or* perfectly-packed cluster —
    it measures *mixing*, not load).
    """

    total_free: int
    clean_hosts: int         # hosts with zero busy GPUs
    fragmented_hosts: int    # hosts that are partially busy
    largest_free_block: int  # largest single-host free capacity
    largest_quality_block: int  # ... restricted to switch-fabric hosts
    premium_free: int        # total free GPUs on switch-fabric hosts
    stranding: float         # stranded free GPUs / total free GPUs

    def describe(self) -> str:
        return (
            f"free={self.total_free} clean_hosts={self.clean_hosts} "
            f"largest_block={self.largest_free_block} "
            f"stranding={self.stranding:.2f}"
        )

    def to_dict(self) -> Dict[str, float]:
        return dataclasses.asdict(self)


def fragmentation_metrics(
    cluster: Cluster, ledger: JobLedger
) -> FragmentationMetrics:
    """Condense per-host occupancy into a :class:`FragmentationMetrics`.

    ``largest_quality_block`` counts only switch-fabric (NVSwitch / ICI)
    hosts: a large free block on a point-to-point host is usually *not*
    room worth making — its full-host ring bottleneck tends to be weaker
    than even a contended cross-host placement, so funnelling a big
    arrival into it would hurt.  On all-switch clusters the two block
    metrics coincide.
    """
    free = ledger.free_by_host()
    clean = fragmented = largest = largest_q = premium = stranded = total = 0
    for host in cluster.hosts:
        f = free[host.host_id]
        total += f
        largest = max(largest, f)
        if host.host_type.nvswitch:
            largest_q = max(largest_q, f)
            premium += f
        if f == host.n_gpus:
            clean += 1
        elif f > 0:  # partially busy; fully-busy hosts are neither
            fragmented += 1
            stranded += f
    return FragmentationMetrics(
        total, clean, fragmented, largest, largest_q, premium,
        stranded / total if total else 0.0,
    )


def room_makeable(cluster: Cluster, k: int, quality_only: bool = True) -> bool:
    """Could any (switch-fabric, when ``quality_only``) host ever offer a
    clean k-block?  Gates the make-room trigger so clusters without a
    suitable host never burn planner passes on an unreachable target."""
    return any(
        h.n_gpus >= k
        for h in cluster.hosts
        if h.host_type.nvswitch or not quality_only
    )


def forced_rail_contended(
    cluster: Cluster, ledger: JobLedger, k: int, quality_only: bool = False
) -> bool:
    """True iff a k-GPU arrival *must* cross hosts (no single-host block
    fits it, though one host is large enough in principle) AND at least one
    host offering free GPUs already carries live cross-host rail traffic —
    i.e. the admission would land rail-contended, and consolidation could
    in principle avoid it.  The make-room trigger predicate.

    With ``quality_only`` (the scheduler passes ``make_room_quality``) only
    a switch-fabric block counts as "already fits" — the same block metric
    the make-room pass targets, so trigger and target never disagree: a
    big free block on a weak point-to-point host does not suppress the
    pass that would open a usable one.
    """
    if k > ledger.n_free():
        return False  # cannot admit at all; queueing, not fragmentation
    if not room_makeable(cluster, k, quality_only=quality_only):
        return False  # cross-host is inherent to the request, not forced
    frag = fragmentation_metrics(cluster, ledger)
    block = frag.largest_quality_block if quality_only \
        else frag.largest_free_block
    if block >= k:
        return False  # a clean block already fits it
    cross = ledger.cross_jobs_by_host()
    return any(
        free > 0 and hid in cross
        for hid, free in ledger.free_by_host().items()
    )


# ---------------------------------------------------------------------------
# Shared migration economics (re-exported by repro.core.scheduler)
# ---------------------------------------------------------------------------

def migration_cost(
    old_gpus: Sequence[int], new_gpus: Sequence[int], cost_per_gpu: float
) -> float:
    """Bandwidth-equivalent charge for moving a live job.

    Each GPU the job vacates means checkpoint/restore traffic and a stall
    for the whole collective, so the charge is proportional to how much of
    the placement actually moves: ``cost_per_gpu * |old \\ new|``.  A
    re-placement equal to the current one is free (and a no-op).
    """
    return cost_per_gpu * len(set(old_gpus) - set(new_gpus))


def net_migration_gain(
    old_gpus: Sequence[int],
    new_gpus: Sequence[int],
    old_bw: float,
    new_bw: float,
    cost_per_gpu: float,
) -> float:
    """THE migrate-or-stay gain rule, shared by the scheduler's release-time
    re-dispatch, ``repro.ft.elastic``'s voluntary rebalance, and the defrag
    planner: the bandwidth delta net of the migration-cost charge."""
    return new_bw - old_bw - migration_cost(old_gpus, new_gpus, cost_per_gpu)


@dataclasses.dataclass(frozen=True)
class MoveEval:
    """One fully-evaluated candidate relocation of a live job.

    ``self_gain`` is the moved job's own contended-bandwidth delta net of
    cost (the release-time re-dispatch objective); ``total_gain`` sums the
    delta across *all* live tenants net of cost (the defrag planner
    objective — moving one job can decongest a neighbour's rails).
    """

    job_id: str
    old_gpus: Tuple[int, ...]
    new_gpus: Tuple[int, ...]
    old_bw: float           # moved job's contended bw before the move
    new_bw: float           # ... after the move
    cost: float             # migration_cost charged against the gain
    self_gain: float        # new_bw - old_bw - cost
    total_gain: float       # sum-over-tenants contended-bw delta - cost
    frag_before: FragmentationMetrics
    frag_after: FragmentationMetrics

    @property
    def clean_hosts_delta(self) -> int:
        return self.frag_after.clean_hosts - self.frag_before.clean_hosts

    @property
    def largest_block_delta(self) -> int:
        return (self.frag_after.largest_free_block
                - self.frag_before.largest_free_block)


def is_consolidating(cluster: Cluster, ev: MoveEval) -> bool:
    """THE defrag-move gate: a planner move must free a clean host, grow
    the largest placeable block, or shrink the mover's own host span (fewer
    spanned hosts = one less rail demand on every host it vacates).

    Without this gate the no-harm/gain framework happily accepts pure
    bandwidth-chasing relocations — e.g. parking a small job on a premium
    host the moment space opens, stranding the cluster's best block.  Those
    moves are the *release-time re-dispatch* hook's job (where the moved
    job's own gain is the objective); defragmentation only makes moves that
    measurably un-fragment the cluster.  Growing the largest
    *switch-fabric* block also qualifies (that is the block make-room
    builds), even when a point-to-point host's larger-but-weak block
    shrinks to pay for it.
    """
    span = (
        len(cluster.partition_by_host(ev.new_gpus))
        - len(cluster.partition_by_host(ev.old_gpus))
    )
    dq = (ev.frag_after.largest_quality_block
          - ev.frag_before.largest_quality_block)
    return (ev.clean_hosts_delta > 0 or ev.largest_block_delta > 0
            or dq > 0 or span < 0)


def evaluate_placement(
    sim,
    ledger: JobLedger,
    alloc: Allocation,
    new_subset: Sequence[int],
    cost_per_gpu: float,
    require_no_harm: bool = True,
    min_self_gain: Optional[float] = None,
    before: Optional[dict] = None,
    frag_before: Optional[FragmentationMetrics] = None,
) -> Optional[MoveEval]:
    """Trial-apply moving ``alloc`` to a *fixed* ``new_subset``; restores
    ``ledger`` exactly on every path.

    Measures every live tenant's contended bandwidth before/after
    (``sim.true_bandwidth(S, ledger=...)`` — the scheduler's grading
    apparatus).  Returns ``None`` when the subset is the current placement,
    or (with ``require_no_harm``) when *any* tenant's contended bandwidth
    would drop — including the moved job itself.  Thresholding the gains is
    otherwise the caller's job: the re-dispatch hook passes
    ``min_self_gain`` so a trial whose mover does not pay for itself is
    rejected cheaply, *before* the per-co-tenant grading (its common case);
    the planner omits it (it scores ``total_gain`` plus fragmentation
    credits and needs the full evaluation anyway).

    ``before``/``frag_before`` let a caller evaluating many candidates
    against the same ledger state (the planner's round loop) grade the
    pre-move state once instead of per candidate; the caller guarantees the
    ledger is unchanged since they were computed — evaluate_placement's own
    exact restore preserves that across successive trials.
    """
    cluster = ledger.cluster
    new_gpus = tuple(sorted(new_subset))
    if new_gpus == alloc.gpus:
        return None
    if before is None:
        before = {
            a.job_id: sim.true_bandwidth(a.gpus, ledger=ledger)
            for a in ledger.jobs()
        }
    if frag_before is None:
        frag_before = fragmentation_metrics(cluster, ledger)
    cost = migration_cost(alloc.gpus, new_gpus, cost_per_gpu)
    ledger.release(alloc.job_id)
    try:
        ledger.admit(alloc.job_id, new_gpus)
        try:
            # post-admit grading sees the right contention: contends()
            # self-excludes each job's own GPU-overlapping ledger entry
            new_bw = sim.true_bandwidth(new_gpus, ledger=ledger)
            self_gain = new_bw - before[alloc.job_id] - cost
            if min_self_gain is not None and self_gain <= min_self_gain:
                return None  # mover does not pay: skip co-tenant grading
            after = {
                a.job_id: (
                    new_bw if a.job_id == alloc.job_id
                    else sim.true_bandwidth(a.gpus, ledger=ledger)
                )
                for a in ledger.jobs()
            }
            if require_no_harm and any(
                after[jid] < before[jid] - _EPS for jid in before
            ):
                return None
            frag_after = fragmentation_metrics(cluster, ledger)
            return MoveEval(
                alloc.job_id, alloc.gpus, new_gpus,
                before[alloc.job_id], new_bw, cost,
                self_gain=self_gain,
                total_gain=sum(after.values()) - sum(before.values()) - cost,
                frag_before=frag_before, frag_after=frag_after,
            )
        finally:
            ledger.release(alloc.job_id)
    finally:
        if alloc.job_id not in ledger:
            ledger.admit(alloc.job_id, alloc.gpus)


def evaluate_move(
    sim,
    ledger: JobLedger,
    alloc: Allocation,
    propose: Proposer,
    cost_per_gpu: float,
    require_no_harm: bool = True,
    min_self_gain: Optional[float] = None,
    before: Optional[dict] = None,
    frag_before: Optional[FragmentationMetrics] = None,
) -> Optional[MoveEval]:
    """Trial-relocate one live job: release it, ask ``propose`` for a new
    subset over the freed availability, then grade the move with
    :func:`evaluate_placement`.  The ledger is restored exactly on every
    path.  This is the shared trial the scheduler's release-time re-dispatch
    runs (``propose`` = the dispatcher's own ``dispatch``).

    ``sim`` may be any object exposing ``true_bandwidth(S, ledger=...)`` —
    the simulator itself or the fast path's
    :class:`~repro.core.predict_cache.GradingCache` memo over it.
    ``before``/``frag_before`` forward to :func:`evaluate_placement`: a
    caller trialling many movers against one unchanged ledger state (the
    re-dispatch hook's candidate loop) grades the pre-move state once."""
    ledger.release(alloc.job_id)
    try:
        subset = propose(ledger, ledger.available(), alloc.k)
    finally:
        ledger.admit(alloc.job_id, alloc.gpus)
    return evaluate_placement(
        sim, ledger, alloc, subset, cost_per_gpu,
        require_no_harm=require_no_harm, min_self_gain=min_self_gain,
        before=before, frag_before=frag_before,
    )


# ---------------------------------------------------------------------------
# Fragmentation-aware placement tie-break
# ---------------------------------------------------------------------------

def make_frag_penalty(
    cluster: Cluster, ledger: JobLedger, weight: float
) -> Callable[[Sequence[int]], float]:
    """Build the placement tie-break term for ``search.hybrid_search``.

    The returned ``penalty(subset)`` is a *relative discount*: ``weight``
    (a fraction, e.g. 0.02) per clean host the subset would leave partially
    occupied — dirtying a fully-free host strands its remaining GPUs, while
    topping up an already-busy host is consolidation and costs nothing.
    Candidate selection maximizes ``predicted_bw * (1 - penalty(S))``, so
    the same weight is a tie-break on a 500 GB/s H100 fabric and a 20 GB/s
    legacy one.  The ledger is read live, so one penalty stays correct as a
    scratch ledger admits batch-mates; the reported predicted bandwidth
    stays undiscounted.
    """
    def penalty(subset: Sequence[int]) -> float:
        p = 0.0
        for hid, gpus in cluster.partition_by_host(subset).items():
            host_n = cluster.hosts[hid].n_gpus
            if ledger.occupancy(hid) == 0 and len(gpus) < host_n:
                p += weight
        return min(p, 1.0)

    return penalty


def hybrid_proposer(
    cluster: Cluster,
    tables,
    base_predictor,
    contention_aware: bool = True,
    contention_mode: str = "analytic",
    contended=None,
    frag_weight: float = 0.0,
    use_cache: bool = True,
    vectorized: bool = True,
    stats_sink=None,
    batcher=None,
) -> Proposer:
    """A :data:`Proposer` that re-places jobs exactly the way BandPilot
    admits them: hybrid search under the contention-aware predictor bound
    to the (scratch) ledger, with the fragmentation tie-break applied.
    The per-proposal predictor is wrapped in a ledger-versioned prediction
    cache (pass the dispatcher's cached ``base_predictor`` to also share
    the isolated memo across trials).  ``batcher`` (an
    :class:`~repro.core.predict_cache.InferenceBatcher`) registers the
    proposal search as a batch worker so its surrogate applies can fuse
    with concurrent searches; value-neutral — single-worker batches pass
    straight through."""
    from repro_torch.core.predict_cache import cached_contention_predictor

    def propose(ledger: JobLedger, avail: Sequence[int], k: int) -> Subset:
        pred = (
            cached_contention_predictor(
                cluster, base_predictor, ledger,
                mode=contention_mode, contended=contended,
                use_cache=use_cache, vectorized=vectorized,
                stats_sink=stats_sink,
            )
            if contention_aware else base_predictor
        )
        penalty = (
            make_frag_penalty(cluster, ledger, frag_weight)
            if frag_weight > 0 else None
        )
        ctx = batcher.worker() if batcher is not None else contextlib.nullcontext()
        with ctx:
            return search.hybrid_search(
                cluster, tables, pred, avail, k, frag_penalty=penalty
            ).subset

    return propose


def consolidation_proposer(
    cluster: Cluster,
    tables,
    base_predictor=None,
    contention_aware: bool = True,
    contention_mode: str = "analytic",
    contended=None,
    frag_weight: float = 0.02,
    use_cache: bool = True,
    vectorized: bool = True,
    stats_sink=None,
    batcher=None,
) -> ProposalFan:
    """Best-fit candidate slots for a defrag mover, cheapest real estate
    first.

    For placement, bandwidth is the objective; for a *defrag move* it is
    only a constraint (no-harm) — the objective is un-fragmenting the
    cluster without consuming capacity future arrivals will want.  So the
    fan ranks every single-host slot that fits the mover by (fewest free
    GPUs first — tightest fit preserves big blocks; slowest host first —
    premium hosts are kept for jobs that need them), with the bw-greedy
    :func:`hybrid_proposer` placement appended last as the
    nothing-else-fits fallback (it is also the only cross-host candidate,
    covering span-reduction moves).  The no-harm check downstream rejects
    any slot actually too slow for the mover.
    """
    hybrid = (
        hybrid_proposer(
            cluster, tables, base_predictor,
            contention_aware=contention_aware,
            contention_mode=contention_mode, contended=contended,
            frag_weight=frag_weight, use_cache=use_cache,
            vectorized=vectorized, stats_sink=stats_sink,
            batcher=batcher,
        )
        if base_predictor is not None else None
    )

    def proposals(ledger: JobLedger, avail: Sequence[int], k: int) -> List[Subset]:
        fits = []
        for hid, gpus in cluster.partition_by_host(avail).items():
            if len(gpus) < k:
                continue
            locals_ = [cluster.gpu_local[g] for g in gpus]
            bw, sub = tables.best_subset(hid, k, locals_)
            fits.append((len(gpus), bw, hid, tables.to_globals(hid, sub)))
        fits.sort(key=lambda f: (f[0], f[1], f[2]))
        out = [f[3] for f in fits]
        if hybrid is not None:
            out.append(hybrid(ledger, avail, k))
        return out

    return proposals


# ---------------------------------------------------------------------------
# Layer 2: the consolidation planner
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DefragConfig:
    """Knobs for the planner and its scheduler triggers."""

    max_moves_per_pass: int = 2      # moves one planner invocation may emit
    max_total_moves: int = 8         # per-trace migration budget (triggers)
    migration_cost_per_gpu: float = 2.0  # shared with SchedulerConfig
    min_gain: float = 1e-6           # strict potential increase per move
    clean_host_bonus: float = 4.0    # GB/s-equiv credit per clean host freed
    make_room_bonus: float = 8.0     # GB/s-equiv per GPU of block progress
    premium_reserve: float = 25.0    # GB/s-equiv per switch-fabric GPU kept
    #   free: the opportunity value of premium-fabric capacity.  A mover
    #   consuming A800/H100 space pays this per GPU, one vacating it earns
    #   it — so consolidation never squats on the hosts large arrivals
    #   need.  Exactly zero on homogeneous clusters (moves conserve it).
    small_job_max_k: Optional[int] = None  # candidate cap; None = host size
    interval: float = 5.0            # min sim-time between background passes
    make_room: bool = True           # on-demand pass before forced admits
    make_room_quality: bool = True   # only switch-fabric blocks count as room
    frag_weight: float = 0.02        # relative tie-break for planner proposals

    def __post_init__(self):
        if self.max_moves_per_pass < 1:
            raise ValueError("max_moves_per_pass must be >= 1")
        if self.max_total_moves < 0:
            raise ValueError("max_total_moves must be >= 0")
        if self.interval < 0:
            raise ValueError("interval must be >= 0")


@dataclasses.dataclass
class DefragPlan:
    """A committed-order list of consolidation moves plus its metric delta.

    ``moves`` apply sequentially (each was evaluated against the scratch
    state left by its predecessors); :func:`apply_plan` replays them onto
    the real ledger.
    """

    moves: List[MoveEval]
    before: FragmentationMetrics
    after: FragmentationMetrics
    target_k: Optional[int] = None

    @property
    def n_moves(self) -> int:
        return len(self.moves)

    @property
    def total_gain(self) -> float:
        return sum(m.total_gain for m in self.moves)


def _target_block(frag: FragmentationMetrics, config: DefragConfig) -> int:
    return (
        frag.largest_quality_block if config.make_room_quality
        else frag.largest_free_block
    )


def _move_score(
    ev: MoveEval, config: DefragConfig, target_k: Optional[int]
) -> float:
    """Potential delta of one move: tenant bandwidth + fragmentation credits,
    net of migration cost.  Every accepted move strictly increases a bounded
    potential, so greedy planning terminates and cannot oscillate."""
    score = ev.total_gain + config.clean_host_bonus * ev.clean_hosts_delta
    score += config.premium_reserve * (
        ev.frag_after.premium_free - ev.frag_before.premium_free
    )
    if target_k is not None:
        score += config.make_room_bonus * (
            min(_target_block(ev.frag_after, config), target_k)
            - min(_target_block(ev.frag_before, config), target_k)
        )
    return score


def plan_defrag(
    cluster: Cluster,
    sim,
    ledger: JobLedger,
    config: DefragConfig,
    proposals: ProposalFan,
    target_k: Optional[int] = None,
    budget: Optional[int] = None,
) -> DefragPlan:
    """Greedily build a consolidation plan against a scratch copy of
    ``ledger`` (the live ledger is never touched).

    Each round considers every candidate mover (live jobs no larger than
    ``small_job_max_k`` — by default one host; bigger jobs are what defrag
    makes room *for*, not what it moves).  Per mover, the ``proposals`` fan
    (usually :func:`consolidation_proposer`) is evaluated best-fit-first
    and the FIRST slot that survives the no-harm check, qualifies as
    *consolidating* (:func:`is_consolidating` — bandwidth-chasing
    relocations belong to the re-dispatch hook) and clears ``min_gain`` is
    that mover's move; the best-scoring mover's move commits to the
    scratch.  With ``target_k`` (the make-room pass) planning additionally
    credits progress toward a ``target_k``-sized block (on switch-fabric
    hosts when ``make_room_quality``) and stops as soon as one exists.
    """
    scratch = JobLedger(cluster)
    for a in ledger.jobs():
        scratch.admit(a.job_id, a.gpus)
    before = fragmentation_metrics(cluster, scratch)
    max_k = config.small_job_max_k
    if max_k is None:
        max_k = max(h.n_gpus for h in cluster.hosts)
    n_moves = config.max_moves_per_pass if budget is None else budget
    moves: List[MoveEval] = []
    while len(moves) < n_moves:
        frag = fragmentation_metrics(cluster, scratch)
        if target_k is not None and _target_block(frag, config) >= target_k:
            break  # room made: the arrival now fits a clean block
        # the pre-move state is identical for every candidate this round
        # (evaluate_placement restores the scratch exactly): grade it once
        round_before = {
            a.job_id: sim.true_bandwidth(a.gpus, ledger=scratch)
            for a in scratch.jobs()
        }
        best: Optional[Tuple[float, MoveEval]] = None
        for alloc in sorted(scratch.jobs(), key=lambda a: a.job_id):
            if alloc.k > max_k:
                continue
            scratch.release(alloc.job_id)
            try:
                cands = proposals(scratch, scratch.available(), alloc.k)
            finally:
                scratch.admit(alloc.job_id, alloc.gpus)
            for subset in cands:
                ev = evaluate_placement(
                    sim, scratch, alloc, subset,
                    config.migration_cost_per_gpu,
                    before=round_before, frag_before=frag,
                )
                if ev is None or not is_consolidating(cluster, ev):
                    continue
                score = _move_score(ev, config, target_k)
                if score > config.min_gain:
                    # best-fit discipline: the first qualifying slot is
                    # this mover's move; cheaper slots never lose to a
                    # higher-bandwidth one
                    if best is None or score > best[0]:
                        best = (score, ev)
                    break
        if best is None:
            break  # no move clears the bar: the ledger is defragmented
        mv = best[1]
        scratch.release(mv.job_id)
        scratch.admit(mv.job_id, mv.new_gpus)
        moves.append(mv)
    return DefragPlan(
        moves, before, fragmentation_metrics(cluster, scratch), target_k
    )


def apply_plan(ledger: JobLedger, plan: DefragPlan) -> None:
    """Replay a plan's moves onto the live ledger, in plan order.

    The ledger must be in the state the plan was built from (the scheduler
    plans and applies atomically); each move's re-admit validates
    disjointness, so a stale plan raises rather than corrupts.
    """
    for mv in plan.moves:
        # one atomic journal event per move (version bumps by 2, identical
        # to the release+admit pair this replaces)
        ledger.migrate(mv.job_id, mv.new_gpus)
