"""BandPilot core: the paper's contribution as a composable library.

Public surface:
  Cluster / bandwidth simulation:
    cluster.Cluster, cluster.PAPER_CLUSTERS, bandwidth_sim.BandwidthSimulator
  Hierarchical surrogate (Sec. 4.2):
    intra_host.IntraHostTables, surrogate.SurrogatePredictor,
    training.train_surrogate / online_finetune / evaluate_surrogate
  Hybrid search (Sec. 4.3):
    search.eha_search / pts_search / hybrid_search
  Dispatchers + evaluation (Sec. 5):
    dispatcher.BandPilotDispatcher / BaselineDispatcher / evaluate_dispatchers,
    baselines.oracle_dispatch
  Multi-tenant contention (Sec. 4.4):
    tenancy.JobLedger / Allocation, contention.ContentionAwarePredictor /
    virtual_merge, dispatcher.replay_trace / poisson_trace /
    compare_contention_awareness (admit/release service lifecycle)
  Admission scheduling (queue policies, joint batching, re-dispatch):
    scheduler.AdmissionScheduler / SchedulerConfig / compare_policies /
    migration_cost, search.joint_hybrid_search
  Learned contention (trained contended surrogate + telemetry pipeline):
    contended_dataset.build_contended_dataset / make_contended_split /
    TelemetryHarvester / harvest_trace, surrogate.ContendedSurrogatePredictor,
    training.train_contended_surrogate / online_finetune_contended /
    evaluate_contended_predictor, ContentionAwarePredictor(mode="learned")
  Defragmentation (metrics, consolidation planner, scheduler triggers):
    defrag.fragmentation_metrics / FragmentationMetrics, plan_defrag /
    apply_plan / DefragConfig, evaluate_move / net_migration_gain (shared
    migration economics), make_frag_penalty (placement tie-break),
    SchedulerConfig(defrag=True)
  Dispatch fast path (vectorized featurization + ledger-versioned memos):
    predict_cache.PredictionCache / CachedPredictor / GradingCache /
    PredictorStats / cached_contention_predictor, features.featurize_batch
    (vectorized) / featurize_children (incremental PTS rounds),
    BandPilotDispatcher(cache=True), JobLedger.version
  Concurrent-admission control plane (CAS admissions, journal, QoS):
    controlplane.AdmissionControlPlane / AdmissionOutcome / TenantPolicy,
    LedgerJournal / read_journal / replay_journal, JobLedger.admit_if /
    migrate / get, CapacityError / InvalidPlacementError / VersionConflict,
    SchedulerConfig(tenant_policies=..., concurrent_workers=...,
    journal_path=...)
  Observability (admission tracer, metrics registry, drift recorder):
    telemetry.AdmissionTracer / trace / span, MetricsRegistry /
    collect_scheduler_metrics / read_metrics_jsonl, DriftMonitor /
    DriftAlert / DecisionRecord / finetune_on_drift,
    TelemetryHarvester(drift=...) (see docs/observability.md)
  Dispatch forensics (attribution, time-travel, counterfactual replay):
    forensics.DossierRecorder / capture / DecisionDossier,
    reconstruct / replay_decision / whatif, RegretLedger / absorb_regret,
    bandwidth_decomposition (see docs/observability.md §Forensics)
"""

from repro_torch.core.bandwidth_sim import BW_SCALE, BandwidthSimulator
from repro_torch.core.contended_dataset import (
    ContendedSample,
    TelemetryHarvester,
    build_contended_dataset,
    harvest_trace,
    make_contended_split,
    materialize_ledger,
    sample_cotenant_ledger,
    to_triples,
)
from repro_torch.core.contention import (
    ContentionAwarePredictor,
    MergeView,
    contended_inter_cap,
    virtual_merge,
)
from repro_torch.core.defrag import (
    DefragConfig,
    DefragPlan,
    FragmentationMetrics,
    MoveEval,
    apply_plan,
    consolidation_proposer,
    evaluate_move,
    evaluate_placement,
    forced_rail_contended,
    fragmentation_metrics,
    hybrid_proposer,
    is_consolidating,
    make_frag_penalty,
    net_migration_gain,
    plan_defrag,
    room_makeable,
)
from repro_torch.core.cluster import (
    Cluster,
    PAPER_CLUSTERS,
    h100_cluster,
    het_4mix_cluster,
    het_ra_cluster,
    het_va_cluster,
    tpu_pod_cluster,
)
from repro_torch.core.dispatcher import (
    BandPilotDispatcher,
    BaselineDispatcher,
    DispatcherService,
    GroundTruthPredictor,
    bw_loss_by_k,
    compare_contention_awareness,
    evaluate_dispatchers,
    gbe_by_k,
    replay_trace,
    summarize,
)
from repro_torch.core.controlplane import (
    AdmissionControlPlane,
    AdmissionOutcome,
    ControlPlaneStats,
    JournalEvent,
    LedgerJournal,
    TenantPolicy,
    read_journal,
    replay_journal,
)
from repro_torch.core.forensics import (
    DecisionDossier,
    DossierRecorder,
    RegretLedger,
    ReplayResult,
    WhatIfReport,
    absorb_regret,
    bandwidth_decomposition,
    reconstruct,
    replay_decision,
    whatif,
)
from repro_torch.core.intra_host import IntraHostTables
from repro_torch.core.predict_cache import (
    CachedPredictor,
    GradingCache,
    PredictionCache,
    PredictorStats,
    cached_contention_predictor,
    collect_stats,
)
from repro_torch.core.scheduler import (
    AdmissionScheduler,
    MigrationEvent,
    SchedulerConfig,
    TenantRecord,
    TraceJob,
    compare_policies,
    migration_cost,
    poisson_trace,
    summarize_trace,
)
from repro_torch.core.telemetry import (
    AdmissionTracer,
    DecisionRecord,
    DriftAlert,
    DriftMonitor,
    MetricsRegistry,
    collect_scheduler_metrics,
    finetune_on_drift,
    read_metrics_jsonl,
    snapshot_digest,
)
from repro_torch.core.tenancy import (
    Allocation,
    CapacityError,
    InvalidPlacementError,
    JobLedger,
    VersionConflict,
)
from repro_torch.core.search import (
    eha_search,
    hybrid_search,
    joint_hybrid_search,
    pts_search,
)
from repro_torch.core.surrogate import (
    ContendedSurrogatePredictor,
    SurrogatePredictor,
    init_contended_params,
)
from repro_torch.core.training import (
    TrainConfig,
    evaluate_analytic_cap,
    evaluate_contended_predictor,
    evaluate_surrogate,
    make_train_test_split,
    online_finetune,
    online_finetune_contended,
    train_contended_surrogate,
    train_surrogate,
)

__all__ = [
    "BW_SCALE",
    "BandwidthSimulator",
    "Cluster",
    "PAPER_CLUSTERS",
    "h100_cluster",
    "het_4mix_cluster",
    "het_ra_cluster",
    "het_va_cluster",
    "tpu_pod_cluster",
    "BandPilotDispatcher",
    "BaselineDispatcher",
    "DispatcherService",
    "GroundTruthPredictor",
    "bw_loss_by_k",
    "evaluate_dispatchers",
    "gbe_by_k",
    "summarize",
    "Allocation",
    "JobLedger",
    "CapacityError",
    "InvalidPlacementError",
    "VersionConflict",
    "AdmissionControlPlane",
    "AdmissionOutcome",
    "ControlPlaneStats",
    "JournalEvent",
    "LedgerJournal",
    "TenantPolicy",
    "read_journal",
    "replay_journal",
    "ContentionAwarePredictor",
    "MergeView",
    "contended_inter_cap",
    "virtual_merge",
    "TenantRecord",
    "TraceJob",
    "compare_contention_awareness",
    "poisson_trace",
    "replay_trace",
    "summarize_trace",
    "AdmissionScheduler",
    "MigrationEvent",
    "SchedulerConfig",
    "compare_policies",
    "migration_cost",
    "DefragConfig",
    "DefragPlan",
    "FragmentationMetrics",
    "MoveEval",
    "apply_plan",
    "consolidation_proposer",
    "evaluate_move",
    "evaluate_placement",
    "forced_rail_contended",
    "fragmentation_metrics",
    "hybrid_proposer",
    "is_consolidating",
    "make_frag_penalty",
    "room_makeable",
    "net_migration_gain",
    "plan_defrag",
    "IntraHostTables",
    "CachedPredictor",
    "GradingCache",
    "PredictionCache",
    "PredictorStats",
    "cached_contention_predictor",
    "collect_stats",
    "eha_search",
    "hybrid_search",
    "joint_hybrid_search",
    "pts_search",
    "SurrogatePredictor",
    "ContendedSurrogatePredictor",
    "init_contended_params",
    "AdmissionTracer",
    "DecisionRecord",
    "DriftAlert",
    "DriftMonitor",
    "MetricsRegistry",
    "collect_scheduler_metrics",
    "finetune_on_drift",
    "read_metrics_jsonl",
    "snapshot_digest",
    "DecisionDossier",
    "DossierRecorder",
    "RegretLedger",
    "ReplayResult",
    "WhatIfReport",
    "absorb_regret",
    "bandwidth_decomposition",
    "reconstruct",
    "replay_decision",
    "whatif",
    "ContendedSample",
    "TelemetryHarvester",
    "build_contended_dataset",
    "harvest_trace",
    "make_contended_split",
    "materialize_ledger",
    "sample_cotenant_ledger",
    "to_triples",
    "TrainConfig",
    "evaluate_surrogate",
    "evaluate_analytic_cap",
    "evaluate_contended_predictor",
    "make_train_test_split",
    "online_finetune",
    "online_finetune_contended",
    "train_contended_surrogate",
    "train_surrogate",
]
