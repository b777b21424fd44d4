"""Perf iteration over the dry run: hypothesis -> knob -> re-trace -> compare.

Counterpart of ``repro/launch/perf.py``. Each named experiment is a set of
knobs over the same cell; ``run_experiment`` builds and traces it with the
port's dry run (``launch/dryrun.py``: a fake world of 256 ranks, 512 with
``--multi-pod``, meta tensors, ``OpCounter`` as rank 0) where the reference
lowers and compiles; the CLI prints the three roofline terms side by side
and appends a JSONL record an experiment.

A record keeps the reference's keys where their meaning carries over
(``experiment``, ``arch``, ``shape``, ``wall_s``: build plus trace,
``compute_ms``, ``memory_ms``, ``collective_ms``, ``bottleneck``,
``useful_ratio``, ``roofline_frac``) and the port's own names where it
differs: ``peak_gb`` (the counter's peak, in place of XLA's ``temp_gb``),
``nvlink_gb`` and ``nic_gb`` (the H100 cluster's fabrics, in place of
``ici_gb`` and ``dcn_gb``); ``by_kind`` holds the bytes of each collective
kind and ``by_axis`` the same split by the mesh axes each group spans.

An experiment whose knob has no counterpart in the port raises
``NotImplementedError`` with the reason (:func:`refusal`); it is never
measured under another meaning.

  PYTHONPATH=src python -m repro_torch.launch.perf --cell gemma-7b:train_4k \\
      --exp baseline cast_barrier rs_grads --out results/perf_gemma
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
import traceback
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from repro_torch.configs import get_config
from repro_torch.launch import dryrun, roofline, shapes as shp, steps
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.op_analysis import CollectiveOp
from repro_torch.parallel import sharding as shd

# ---------------------------------------------------------------------------
# Experiment registry: name -> dict of knobs, the reference's letter for letter.
#   env: environment variables set while the step is built and traced
#   strategy / rules_patch / remat / constrain_grads / grad_accum: step-building knobs
# ---------------------------------------------------------------------------

EXPERIMENTS = {
    "baseline": {},
    # REPRO_ATTN_BF16_WIRE: ``kernels/flash_attention/ref.py`` ``mha_reference``
    # takes the reference's bf16-in, fp32-accumulate numerics. The reference's
    # hypothesis (fp32 on the wire of GSPMD's gathers) is GSPMD's: the port
    # gathers the stream in the compute dtype and q, k, v enter no collective.
    "bf16_wire": {"env": {"REPRO_ATTN_BF16_WIRE": "1"}},
    # constrain_grads: not passed on. Every gradient already comes back at its
    # parameter's placement, reduce-scattered where the weight lies on the batch
    # axes (``parallel/fsdp.py`` ``_Gather.backward``): the port's only reduction.
    "rs_grads": {"constrain_grads": True},
    "bf16_wire+rs_grads": {"env": {"REPRO_ATTN_BF16_WIRE": "1"},
                           "constrain_grads": True},
    # strategy fsdp_tp_noseq: ``parallel/sharding.py``, no sequence split of the stream
    "no_seq_shard": {"strategy": "fsdp_tp_noseq"},
    # rules_patch experts: model, ff: data: refused (``refusal``) until each
    # expert's ff block stays on data in training.
    "moe_ep2d": {"rules_patch": {"experts": "model", "ff": "data",
                                 "embed": None}},
    "moe_ep2d+bf16_wire": {
        "rules_patch": {"experts": "model", "ff": "data", "embed": None},
        "env": {"REPRO_ATTN_BF16_WIRE": "1"},
    },
    "moe_ep2d+bf16_wire+rs_grads": {
        "rules_patch": {"experts": "model", "ff": "data", "embed": None},
        "env": {"REPRO_ATTN_BF16_WIRE": "1"},
        "constrain_grads": True,
    },
    # remat dots_with_no_batch_dims: ``models/transformer.py`` ``_SAVED_OPS``
    "remat_dots": {"remat": "dots_with_no_batch_dims"},
    # REPRO_ATTN_CHUNK_THRESHOLD: ``ref.chunk_threshold``, the plain path's
    # query chunks. The card's route (and the dry run's) is the flash operator
    # forward and an unchunked ``mha_reference`` recompute backward, as the
    # reference's Pallas VJP: no traced step takes the chunks.
    "chunked_attn": {"env": {"REPRO_ATTN_CHUNK_THRESHOLD": "2097152"}},
    "chunked+bf16_wire": {
        "env": {"REPRO_ATTN_CHUNK_THRESHOLD": "2097152",
                "REPRO_ATTN_BF16_WIRE": "1"},
    },
    "chunked+bf16_wire+rs_grads": {
        "env": {"REPRO_ATTN_CHUNK_THRESHOLD": "2097152",
                "REPRO_ATTN_BF16_WIRE": "1"},
        "constrain_grads": True,
    },
    # REPRO_CAST_BARRIER: ``models/transformer.py`` ``lm_loss`` has each weight's
    # block cast before ``materialize`` gathers it: the FSDP gathers move bf16
    "cast_barrier": {"env": {"REPRO_CAST_BARRIER": "1"}},
    # REPRO_GRAD_SYNC_BF16: ``train/train_loop.py``, a bf16 round trip of each
    # reduced gradient before AdamW
    "grad_bf16": {"env": {"REPRO_GRAD_SYNC_BF16": "1"}},
    "kitchen_sink": {
        "env": {"REPRO_ATTN_CHUNK_THRESHOLD": "2097152",
                "REPRO_ATTN_BF16_WIRE": "1",
                "REPRO_CAST_BARRIER": "1",
                "REPRO_GRAD_SYNC_BF16": "1"},
        "constrain_grads": True,
    },
    "moe_kitchen_sink": {
        "rules_patch": {"experts": "model", "ff": "data", "embed": None},
        "env": {"REPRO_ATTN_CHUNK_THRESHOLD": "2097152",
                "REPRO_ATTN_BF16_WIRE": "1",
                "REPRO_CAST_BARRIER": "1",
                "REPRO_GRAD_SYNC_BF16": "1"},
        "constrain_grads": True,
    },
    # REPRO_SP_GATHER=0: refused (``refusal``); the port always gathers, the knob's "1"
    "sp_gather_off": {"env": {"REPRO_SP_GATHER": "0"}},
    # grad_accum: ``train/train_loop.py`` ``TrainRunConfig.grad_accum``
    "accum8": {"grad_accum": 8},
    "chunked+accum8": {
        "env": {"REPRO_ATTN_CHUNK_THRESHOLD": "2097152"},
        "grad_accum": 8,
    },
    "optimized": {
        "env": {"REPRO_ATTN_CHUNK_THRESHOLD": "2097152",
                "REPRO_ATTN_BF16_WIRE": "1"},
    },
    "optimized_moe": {
        "rules_patch": {"experts": "model", "ff": "data", "embed": None},
        "env": {"REPRO_ATTN_CHUNK_THRESHOLD": "2097152",
                "REPRO_ATTN_BF16_WIRE": "1"},
    },
}

SP_GATHER_OFF = (
    "REPRO_SP_GATHER=0 is GSPMD's own resolution of the sequence split, which has no "
    "counterpart without GSPMD; the port always gathers the stream explicitly, the "
    "knob's '1' (parallel/fsdp.py)")
EXPERT_FF_ON_DATA = (
    "rules_patch ff: data keeps each expert's ff block on data in the reference (expert "
    "weights never gathered); the port's training still gathers it over data as FSDP "
    "(ROADMAP.md A.1, moe_ep2d)")


def refusal(knobs: Dict) -> Optional[str]:
    """Why the port cannot run ``knobs``, or None."""
    if knobs.get("env", {}).get("REPRO_SP_GATHER") == "0":
        return SP_GATHER_OFF
    if knobs.get("rules_patch", {}).get("ff") == "data":
        return EXPERT_FF_ON_DATA
    return None


def stray_knobs() -> List[str]:
    """The knobs set in the environment that change the plain reference's
    numerics (``REPRO_ATTN_*``, ``REPRO_CAST_BARRIER``). A check against that
    reference refuses to run under them; :func:`environment` sets them for
    one experiment only."""
    return sorted(k for k in os.environ
                  if k.startswith("REPRO_ATTN_") or k == "REPRO_CAST_BARRIER")


@contextlib.contextmanager
def environment(env: Dict[str, str]) -> Iterator[None]:
    """``env`` set inside; every variable restored on the way out."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def by_axis(ops: Sequence[CollectiveOp], mesh) -> Dict[str, Dict[str, int]]:
    """Collective bytes by kind and by the mesh axes each group spans
    ("data", "model", "data+model", ...)."""
    names = mesh.mesh_dim_names
    where = {int(r): idx for idx, r in np.ndenumerate(mesh.mesh.numpy())}  # rank -> coords
    spans: Dict = {}
    out: Dict[str, Dict[str, int]] = {}
    for op in ops:
        axes = spans.get(op.ranks)
        if axes is None:
            axes = spans[op.ranks] = "+".join(
                n for i, n in enumerate(names) if len({where[r][i] for r in op.ranks}) > 1)
        kind = out.setdefault(op.kind, {})
        kind[axes] = kind.get(axes, 0) + op.bytes
    return out


def run_experiment(arch: str, shape: str, exp_name: str, multi_pod: bool = False) -> Dict:
    knobs = EXPERIMENTS[exp_name]
    reason = refusal(knobs)
    if reason is not None:
        raise NotImplementedError(f"{exp_name}: {reason}")
    skip = shp.cell_skip_reason(arch, shape)
    if skip:
        raise ValueError(f"{arch} x {shape} is not a cell: {skip}")
    cfg = get_config(arch)
    cell = shp.SHAPES[shape]
    strategy = knobs.get("strategy", "serve_2d" if cell.kind == "decode" else "fsdp_tp")
    rules = shd.STRATEGIES[strategy]()
    rules.update(knobs.get("rules_patch", {}))
    n_chips, mesh_name = (512, "2x16x16") if multi_pod else (256, "16x16")
    with environment(knobs.get("env", {})), dryrun.fake_world(n_chips):
        mesh = make_production_mesh(multi_pod=multi_pod)
        t0 = time.time()
        step = steps.build_step(cfg, cell, mesh, strategy=strategy,
                                remat_policy=knobs.get("remat", "nothing"),
                                rules_override=rules, grad_accum=knobs.get("grad_accum", 1))
        counter = dryrun.count(step)
        wall = time.time() - t0
        costs = counter.summary()
        axes = by_axis(counter.collectives, mesh)
    rep = roofline.analyze_from_costs(arch, cfg, shape, cell.kind, mesh_name, n_chips, costs,
                                      costs["peak_bytes"], cell.global_batch, cell.seq_len)
    return {
        "experiment": exp_name, "arch": arch, "shape": shape,
        "wall_s": round(wall, 1),
        "compute_ms": 1e3 * rep.compute_s,
        "memory_ms": 1e3 * rep.memory_s,
        "collective_ms": 1e3 * rep.collective_s,
        "bottleneck": rep.bottleneck,
        "useful_ratio": rep.useful_ratio,
        "roofline_frac": rep.roofline_fraction,
        "peak_gb": costs["peak_bytes"] / 2**30,
        "nvlink_gb": rep.nvlink_bytes / 2**30,
        "nic_gb": rep.nic_bytes / 2**30,
        "by_kind": rep.by_kind,
        "by_axis": axes,
    }


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True, help="arch:shape")
    ap.add_argument("--exp", nargs="+", default=["baseline"], choices=list(EXPERIMENTS))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default=None, help="JSONL output path prefix")
    args = ap.parse_args(argv)
    arch, shape = args.cell.split(":")

    failed = 0
    for exp in args.exp:
        try:
            r = run_experiment(arch, shape, exp, args.multi_pod)
        except Exception as e:
            if not isinstance(e, NotImplementedError):
                traceback.print_exc()
            r = {"experiment": exp, "arch": arch, "shape": shape,
                 "error": f"{type(e).__name__}: {e}"}
        if "error" in r:
            failed += 1
            print(f"[{exp:<28}] {r['error']}", flush=True)
        else:
            print(f"[{exp:<28}] compute={r['compute_ms']:8.1f}ms "
                  f"memory={r['memory_ms']:8.1f}ms "
                  f"collective={r['collective_ms']:8.1f}ms "
                  f"({r['bottleneck']}-bound) useful={r['useful_ratio']:.2f} "
                  f"roofline={100 * r['roofline_frac']:.1f}% "
                  f"peak={r['peak_gb']:.1f}G", flush=True)
        if args.out:
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out + ".jsonl", "a") as f:
                f.write(json.dumps(r) + "\n")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
