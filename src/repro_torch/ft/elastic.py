"""Fault tolerance: failure handling, elastic re-dispatch, stragglers.

The contract at 1000+ node scale:

1. **Checkpoint/restart** — training state (params + optimizer + data step)
   is periodically checkpointed (repro_torch/checkpoint); any crash restarts from
   the latest atomic checkpoint and the deterministic data pipeline replays
   the exact stream.
2. **Node failure -> elastic rescale** — when hosts drop out, the surviving
   pool is *re-dispatched through BandPilot* (the paper's search runs on the
   new availability set), a fresh mesh is built over the chosen devices, and
   parameters are restored into the new sharding.  This is the framework
   integration of the paper: dispatch quality directly sets the post-failure
   collective bandwidth.
3. **Straggler mitigation** — a step-time watchdog flags devices/hosts whose
   step times exceed a robust threshold; persistent stragglers are treated
   as soft failures and trigger the same re-dispatch path (their GPUs are
   marked unavailable), which BandPilot then routes around.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.cluster import Cluster
from repro_torch.core.defrag import net_migration_gain
from repro_torch.core.dispatcher import BandPilotDispatcher


@dataclasses.dataclass
class FailureEvent:
    step: int
    failed_gpus: List[int]
    kind: str = "host_failure"  # or "straggler"


class StragglerMonitor:
    """Flags ranks whose step times are persistently above the fleet median.

    Decision rule: a rank is a straggler if its step time exceeds
    ``threshold x median`` for ``patience`` consecutive observations.
    """

    def __init__(self, threshold: float = 1.8, patience: int = 3):
        self.threshold = threshold
        self.patience = patience
        self._strikes: Dict[int, int] = {}

    def observe(self, step_times: Dict[int, float]) -> List[int]:
        """step_times: rank -> seconds.  Returns ranks flagged this round."""
        # prune strikes for ranks no longer reporting (failed, descheduled,
        # or replaced): a stale strike count must not carry over to a rank
        # id that later rejoins with a fresh device
        for rank in list(self._strikes):
            if rank not in step_times:
                del self._strikes[rank]
        med = float(np.median(list(step_times.values())))
        flagged = []
        for rank, t in step_times.items():
            if t > self.threshold * med:
                self._strikes[rank] = self._strikes.get(rank, 0) + 1
                if self._strikes[rank] >= self.patience:
                    flagged.append(rank)
            else:
                self._strikes[rank] = 0
        return flagged


@dataclasses.dataclass
class ElasticDecision:
    new_allocation: List[int]
    predicted_bw: float
    reason: str


class ElasticCoordinator:
    """Owns the availability state and re-dispatches through BandPilot.

    ``migration_cost_per_gpu`` prices voluntary moves: failure handling is
    mandatory (the old placement is gone), but :meth:`consider_rebalance`
    only migrates when the predicted gain beats the migration-cost charge —
    the same :func:`repro_torch.core.defrag.net_migration_gain` rule the admission
    scheduler's release hook and the defrag planner apply.
    """

    def __init__(
        self,
        cluster: Cluster,
        dispatcher: BandPilotDispatcher,
        request_size: int,
        migration_cost_per_gpu: float = 2.0,
    ):
        self.cluster = cluster
        self.dispatcher = dispatcher
        self.request_size = request_size
        self.migration_cost_per_gpu = migration_cost_per_gpu
        self.unavailable: set = set()
        self.current: List[int] = []

    def initial_dispatch(self) -> ElasticDecision:
        avail = [g for g in self.cluster.all_gpus() if g not in self.unavailable]
        sub = self.dispatcher.dispatch(avail, self.request_size)
        self.current = sub
        bw = self.dispatcher.last_result.predicted_bw
        return ElasticDecision(sub, bw, "initial")

    def handle_failure(self, event: FailureEvent) -> ElasticDecision:
        """Mark GPUs dead, shrink the request if needed, re-dispatch."""
        self.unavailable.update(event.failed_gpus)
        avail = [g for g in self.cluster.all_gpus() if g not in self.unavailable]
        # elastic scale-down: keep request a multiple of the host size when
        # possible so mesh factorizations stay clean
        k = min(self.request_size, len(avail))
        # round to the SURVIVING pool's dominant host size, not hosts[0]'s:
        # on a heterogeneous cluster (or when host 0 itself died) the old
        # ``hosts[0].n_gpus`` rounding produced request sizes no surviving
        # host shape can factorize cleanly
        by_size: Dict[int, int] = {}
        for g in avail:
            n = self.cluster.hosts[self.cluster.gpu_host[g]].n_gpus
            by_size[n] = by_size.get(n, 0) + 1
        host_n = max(by_size, key=lambda n: (by_size[n], n))
        if k > host_n:
            k -= k % host_n
        if k == 0:
            raise RuntimeError("no survivors to dispatch")
        sub = self.dispatcher.dispatch(avail, k)
        self.current = sub
        bw = self.dispatcher.last_result.predicted_bw
        return ElasticDecision(sub, bw, event.kind)

    def consider_rebalance(self) -> Optional[ElasticDecision]:
        """Opportunistic elastic re-dispatch (no failure forcing it).

        After recovery events — co-tenants departing, stragglers returning
        to the pool — the current placement may have become stale.  Re-run
        the search over the surviving pool and migrate only when the
        predicted bandwidth gain exceeds the migration-cost charge for the
        GPUs that would move.  Returns the decision, or None to stay put.
        """
        if not self.current:
            raise RuntimeError("no current allocation; dispatch first")
        avail = [g for g in self.cluster.all_gpus() if g not in self.unavailable]
        # grade the incumbent with the same lens the search scores the
        # challenger: the dispatcher's ledger-aware contended predictor when
        # one is attached (the old isolated-predictor baseline overstated
        # cur_bw under co-tenancy, vetoing moves whose real gain paid)
        wrapper = getattr(self.dispatcher, "contention_predictor", None)
        scorer = wrapper if wrapper is not None else self.dispatcher.predictor
        cur_bw = float(np.asarray(scorer.predict([self.current]))[0])
        sub = self.dispatcher.dispatch(avail, len(self.current))
        new_bw = self.dispatcher.last_result.predicted_bw
        gain = net_migration_gain(
            self.current, sub, cur_bw, new_bw, self.migration_cost_per_gpu
        )
        if sorted(sub) == sorted(self.current) or gain <= 0:
            return None
        self.current = sub
        return ElasticDecision(sub, new_bw, "rebalance")


def run_elastic_training(
    coordinator: ElasticCoordinator,
    build_and_train: Callable[[List[int], int], Tuple[int, float]],
    failures: Sequence[FailureEvent],
    total_steps: int,
) -> List[Dict]:
    """Drive train -> fail -> re-dispatch -> restore -> train to completion.

    ``build_and_train(allocation, start_step)`` trains until the next
    failure (or the end) and returns (reached_step, last_loss).  Checkpoint
    save/restore is the callee's job (see repro_torch/launch/elastic.py).
    """
    log: List[Dict] = []
    decision = coordinator.initial_dispatch()
    log.append({"event": "dispatch", "alloc": decision.new_allocation,
                "bw": decision.predicted_bw})
    step = 0
    pending = sorted(failures, key=lambda f: f.step)
    for event in pending + [None]:
        until = event.step if event else total_steps
        if until > step:
            step, loss = build_and_train(coordinator.current, step)
            log.append({"event": "train", "until": step, "loss": loss})
        if event is None or step >= total_steps:
            break
        decision = coordinator.handle_failure(event)
        log.append({
            "event": "redispatch", "kind": event.kind,
            "failed": event.failed_gpus,
            "alloc": decision.new_allocation, "bw": decision.predicted_bw,
        })
    return log
