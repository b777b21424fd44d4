"""BandPilot end to end on a simulated 32-GPU cluster: the port's
``examples/quickstart.py`` and ``examples/multi_tenant.py``.

  1. build the cluster and its bandwidth simulator;
  2. measure the Stage-1 intra-host tables;
  3. train the hierarchical surrogate on 250 sparse inter-host samples
     (on the device), and grade it (R², MAPE) on five times as many;
  4. dispatch the Fig. 1 scenario (k=8 over two hosts with 6 idle GPUs
     each) with BandPilot and Topo, then the randomized-availability
     protocol (Sec. 5.3) against Topo / Default / Random;
  5. admit a cross-host tenant, watch a candidate degrade under the
     fair-share rail model, release it and watch it restore exactly;
  6. replay a Poisson job trace through ``AdmissionScheduler``: contention-
     aware BandPilot (analytic cap, fused on-device descent) against the
     oblivious variant and the baselines.

The surrogate scores on the device; the descent is one CUDA graph replay a
search on the card.

  python -m repro_torch.launch.dispatch                          # on the card
  python -m repro_torch.launch.dispatch --quick --device cpu     # smoke-sized, CPU
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np

import repro_torch.core as core
from repro_torch.device import resolve_device


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cluster", default="H100", choices=sorted(core.PAPER_CLUSTERS))
    ap.add_argument("--steps", type=int, default=2000, help="surrogate training steps")
    ap.add_argument("--samples", type=int, default=250, help="inter-host training samples")
    ap.add_argument("--scenarios", type=int, default=10)
    ap.add_argument("--trace-jobs", type=int, default=40)
    ap.add_argument("--quick", action="store_true",
                    help="100 steps, 2 scenarios, a 10-job trace")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if args.quick:
        args.steps, args.scenarios, args.trace_jobs = 100, 2, 10

    # 1. the cluster + its (black-box) bandwidth landscape
    cluster = core.PAPER_CLUSTERS[args.cluster]()
    sim = core.BandwidthSimulator(cluster)
    print(cluster.describe())

    # 2. Stage-1: exhaustive intra-host measurement (one-time, offline)
    tables = core.IntraHostTables(cluster, sim)
    print(f"intra-host tables: {tables.n_measurements} measurements, "
          f"{tables.storage_bytes() / 1024:.0f} KB")

    # 3. Stage-2: train the surrogate on sparse inter-host samples
    train_set, test_set = core.make_train_test_split(sim, args.samples, seed=0)
    params, info = core.train_surrogate(
        cluster, tables, train_set, core.TrainConfig(steps=args.steps), device=device,
    )
    predictor = core.SurrogatePredictor(cluster, tables, params)
    acc = core.evaluate_surrogate(predictor, test_set)
    print(f"surrogate on {device}: R2={acc['r2']:.4f} MAPE={acc['mape']:.2f}% "
          f"({info['param_bytes'] / 1024:.0f} KB model, {args.steps} steps in "
          f"{info['train_seconds']:.1f} s, final loss {info['final_loss']:.5f})")

    # 4. the Fig. 1 scenario: two hosts with 6 idle GPUs each, k=8
    avail = list(range(0, 6)) + list(range(8, 14))
    bp = core.BandPilotDispatcher(cluster, tables, predictor)
    topo = core.BaselineDispatcher(cluster, "topo")
    s_bp = bp.dispatch(avail, 8)
    s_topo = topo.dispatch(avail, 8)
    print("\nFig.1 scenario (k=8, 6+6 idle):")
    print(f"  Topo      -> {s_topo}  B={sim.true_bandwidth(s_topo):.1f} GB/s")
    print(f"  BandPilot -> {s_bp}  B={sim.true_bandwidth(s_bp):.1f} GB/s")

    ds = [bp, topo, core.BaselineDispatcher(cluster, "default"),
          core.BaselineDispatcher(cluster, "random")]
    recs = core.evaluate_dispatchers(
        cluster, sim, tables, ds, request_sizes=[4, 8, 12, 16, 20],
        n_scenarios=args.scenarios, seed=1,
    )
    gbe = {name: s["mean_gbe"] for name, s in core.summarize(recs).items()}
    print("\nmean GBE over randomized scenarios:")
    for name, s in sorted(core.summarize(recs).items(), key=lambda kv: -kv[1]["mean_gbe"]):
        print(f"  {name:10s} {100 * s['mean_gbe']:5.1f}%  "
              f"(bw loss {s['mean_bw_loss']:.1f} GB/s)")

    # 5. lifecycle: degrade under contention, restore on release
    svc = core.BandPilotDispatcher(cluster, tables, predictor)
    hosts = cluster.hosts
    candidate = list(hosts[0].gpu_ids[:4]) + list(hosts[1].gpu_ids[:4])
    iso = sim.true_bandwidth(candidate)
    tenant = svc.ledger.admit("tenant-a", list(hosts[0].gpu_ids[4:]) + list(hosts[1].gpu_ids[4:]))
    deg = sim.true_bandwidth(candidate, ledger=svc.ledger)
    s_aware = svc.dispatch(svc.ledger.available(), 8)
    print(f"\ncandidate 4+4 on hosts (0,1): isolated {iso:.1f} GB/s; with "
          f"{tenant.job_id} (k={tenant.k}) admitted {deg:.1f} GB/s "
          f"({100 * (1 - deg / iso):.0f}% degradation); aware dispatch(k=8) lands on "
          f"hosts {sorted(cluster.partition_by_host(s_aware))}: "
          f"{sim.true_bandwidth(s_aware, ledger=svc.ledger):.1f} GB/s")
    svc.release("tenant-a")
    restored = sim.true_bandwidth(candidate, ledger=svc.ledger)
    if restored != iso:
        raise RuntimeError(f"release did not restore the isolated bandwidth: {restored} != {iso}")

    # 6. trace replay: aware vs oblivious vs baselines
    trace = core.poisson_trace(
        cluster, args.trace_jobs, np.random.default_rng(3),
        mean_interarrival=1.0, mean_duration=8.0,
        k_choices=range(4, cluster.n_gpus // 2 + 1),
    )
    t0 = time.time()
    results = core.compare_contention_awareness(
        cluster, sim, tables,
        lambda: core.SurrogatePredictor(cluster, tables, params), trace, seed=3,
    )
    trace_seconds = time.time() - t0
    summaries = {name: core.summarize_trace(r)[name] for name, r in results.items()}
    print(f"\nreplayed {len(trace)} Poisson jobs in {trace_seconds:.1f} s")
    print(f"{'dispatcher':<22} {'mean GBE':>9} {'degraded':>9} "
          f"{'contended':>10} {'mean wait':>10}")
    for name, s in sorted(summaries.items(), key=lambda kv: -kv[1]["mean_gbe"]):
        print(f"{name:<22} {100 * s['mean_gbe']:>8.2f}% "
              f"{100 * s['mean_degradation']:>8.1f}% "
              f"{100 * s['frac_contended']:>9.0f}% {s['mean_wait']:>10.2f}")
    return {"device": str(device), "cluster": cluster.name, "train": info, "accuracy": acc,
            "fig1": {"bandpilot": s_bp, "topo": s_topo,
                     "bandpilot_bw": sim.true_bandwidth(s_bp),
                     "topo_bw": sim.true_bandwidth(s_topo)},
            "mean_gbe": gbe, "trace": summaries, "trace_seconds": trace_seconds}


if __name__ == "__main__":
    main()
