"""Dry run: trace every (arch x shape) step on the production mesh of fake
ranks, print each rank's memory, FLOPs, bytes and collectives and the H100
roofline row.

Counterpart of ``repro/launch/dryrun.py``. The reference lowers and
compiles each cell on 512 placeholder XLA devices; here the step
(``launch/steps.py``) is built on the ``meta`` device -- shapes, no storage
-- inside a ``torch.distributed`` "fake" process group of 256 ranks (512
with ``--multi-pod on``) whose collectives move nothing, and one call of it
runs under ``op_analysis.OpCounter`` as rank 0. The kernels' launches are
operators whose meta kernels give their outputs' shapes (each
``kernels/*/ops.py``), so the trace follows the card's route without a
card, and allocates nothing.

Depth is counted in full: the reference extrapolates from unrolled one- and
two-group compiles because XLA's cost analysis counts a while loop's body
once; an eager trace runs every layer.

Meta tensors rather than fake CUDA tensors: autograd aborts the process on a
CUDA tensor, fake or not, when PyTorch is built without CUDA (its graph
records the tensor's CUDA stream).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch internvl2-76b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod both \\
      --out results/dryrun
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback
from typing import Dict, Iterator, Optional

import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.launch import roofline, shapes as shp, steps
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.op_analysis import OpCounter


@contextlib.contextmanager
def fake_world(world: int) -> Iterator[None]:
    """A "fake" default process group of ``world`` ranks, this process rank 0:
    meshes build, collectives return at once and move nothing."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def count(step: steps.Step) -> OpCounter:
    """One call of ``step`` under an OpCounter: this rank's ops."""
    counter = OpCounter()
    for category, tensors in step.state.items():
        counter.track(tensors, category)
    with counter:
        step()
    return counter


def trace(step: steps.Step) -> Dict:
    """One call of ``step`` under an OpCounter: this rank's counts."""
    return count(step).summary()


def run_cell(
    arch: str,
    shape: str,
    multi_pod: bool,
    strategy: str = "fsdp_tp",
    remat_policy: str = "nothing",
    verbose: bool = True,
    rules_override=None,
):
    """Build and trace one cell. Returns (roofline_report, record_dict)."""
    cfg = get_config(arch)
    cell = shp.SHAPES[shape]
    skip = shp.cell_skip_reason(arch, shape)
    if skip:
        return None, {"arch": arch, "shape": shape, "status": "skipped",
                      "reason": skip}
    n_chips = 512 if multi_pod else 256
    mesh_name = "2x16x16" if multi_pod else "16x16"
    if cell.kind == "decode" and strategy == "fsdp_tp":
        strategy = "serve_2d"  # weight-stationary decode default
    with fake_world(n_chips):
        mesh = make_production_mesh(multi_pod=multi_pod)
        t0 = time.time()
        step = steps.build_step(cfg, cell, mesh, strategy=strategy,
                                remat_policy=remat_policy, rules_override=rules_override)
        t_build = time.time() - t0
        t0 = time.time()
        costs = trace(step)
        t_trace = time.time() - t0
    rep = roofline.analyze_from_costs(
        arch, cfg, shape, cell.kind, mesh_name, n_chips, costs,
        costs["peak_bytes"], cell.global_batch, cell.seq_len,
    )
    record = {
        "arch": arch, "shape": shape, "mesh": mesh_name,
        "strategy": strategy, "remat": remat_policy, "status": "ok",
        "build_s": round(t_build, 1), "trace_s": round(t_trace, 1),
        "n_ops": costs["n_ops"],
        "memory_per_rank_gb": {k: v / 2**30 for k, v in costs["peak_by_category"].items()},
        "peak_memory_gb": costs["peak_bytes"] / 2**30,
        "cost": {"flops": rep.op_flops, "bytes": rep.op_bytes},
        "collectives": {
            "nvlink_bytes": rep.nvlink_bytes, "nic_bytes": rep.nic_bytes,
            "n_collectives": costs["n_collectives"], "by_kind": rep.by_kind,
        },
        "roofline": rep.row(),
    }
    if verbose:
        mem = record["memory_per_rank_gb"]
        print(f"[{arch} x {shape} x {mesh_name}] {strategy} build={t_build:.1f}s "
              f"trace={t_trace:.1f}s ops={costs['n_ops']}")
        print(f"  memory/rank: peak {record['peak_memory_gb']:.2f}G = "
              + " + ".join(f"{k} {v:.2f}G" for k, v in mem.items()))
        print(f"  cost: {rep.op_flops/1e12:.2f} TFLOP, "
              f"{rep.op_bytes/2**30:.2f} GiB touched; collectives: "
              f"NVLink {rep.nvlink_bytes/2**20:.1f} MiB, NIC {rep.nic_bytes/2**20:.1f} MiB")
        print(f"  roofline: compute={1e3*rep.compute_s:.1f}ms "
              f"memory={1e3*rep.memory_s:.1f}ms "
              f"collective={1e3*rep.collective_s:.1f}ms "
              f"-> {rep.bottleneck}-bound, useful={rep.useful_ratio:.2f}, "
              f"roofline={100*rep.roofline_fraction:.1f}%", flush=True)
    return rep, record


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", choices=["off", "on", "both"], default="off")
    ap.add_argument("--strategy", default="fsdp_tp")
    ap.add_argument("--remat", default="nothing")
    ap.add_argument("--out", default=None, help="JSONL output path prefix")
    args = ap.parse_args(argv)

    cells = (
        shp.all_cells() if args.all
        else [(args.arch or "gemma-7b", args.shape or "train_4k")]
    )
    pods = {"off": [False], "on": [True], "both": [False, True]}[args.multi_pod]

    out_path = None
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        out_path = args.out + ".jsonl"
        open(out_path, "w").close()  # truncate

    reports, records = [], []
    failures = []
    for arch, shape in cells:
        for mp in pods:
            try:
                rep, rec = run_cell(arch, shape, mp, args.strategy, args.remat)
            except Exception as e:  # a failure here is a bug in the system
                traceback.print_exc()
                rec = {"arch": arch, "shape": shape,
                       "mesh": "2x16x16" if mp else "16x16",
                       "status": "FAILED", "error": f"{type(e).__name__}: {e}"}
                rep = None
                failures.append(rec)
            records.append(rec)
            if rep:
                reports.append(rep)
            if out_path:  # incremental flush: sweep progress survives crashes
                with open(out_path, "a") as f:
                    f.write(json.dumps(rec) + "\n")
            if rec["status"] == "skipped":
                print(f"[{arch} x {shape}] SKIPPED: {rec['reason']}")
                break  # skip applies to both meshes

    if reports:
        print("\n" + roofline.format_table(reports))
    if out_path:
        print(f"\nwrote {len(records)} records to {out_path}")
    if failures:
        print(f"\n{len(failures)} FAILURES")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
