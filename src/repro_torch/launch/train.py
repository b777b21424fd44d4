"""Training launcher with BandPilot dispatch as a first-class feature.

Counterpart of ``repro/launch/train.py``:

  python -m repro_torch.launch.train --arch gemma-7b --reduced --steps 100 \\
      --dispatcher bandpilot --devices 8 --mesh 4x2 --device cpu

Flow: (1) model the device pool as a cluster (hosts of 8), (2) dispatch k
devices through the requested policy (BandPilot = surrogate + hybrid
search), (3) build the mesh over the *chosen, ordered* devices, (4) train
with the parameters and AdamW moments laid out by the FSDP x TP rules
(``parallel/fsdp.py``), with checkpointing and the deterministic data
pipeline.

A device is a ``torch.distributed`` rank. ``--devices N`` (the reference's
forced XLA device count) spawns N gloo ranks on the CPU and needs
``--device cpu``. On the card the world is one rank a card (NCCL), all the
cards unless ``--devices`` asks for fewer; more than there are raises. A
world of one runs in this process. Ranks the dispatch leaves out build the
mesh with the others (a collective) and sit the training out. Rank 0 prints
the pool and the dispatch; the mesh's first rank prints the steps.

``main`` takes a config as an argument too (``cfg``), which stands for
``--arch``/``--reduced``: the card's smoke run cuts the depth that way.
"""

import argparse
import contextlib
import os
import shutil
import sys
import tempfile
import time
from typing import List, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import core
from repro_torch.checkpoint.ckpt import Checkpointer
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import bandpilot_mesh, process_group
from repro_torch.models.model_zoo import build_model
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.fsdp import ShardedModel
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_loop import TrainRunConfig, train_loop


def _parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-7b")
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-test-sized config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--dispatcher", default="bandpilot",
                    choices=["bandpilot", "topo", "default", "random", "none"])
    ap.add_argument("--devices", type=int, default=0,
                    help="N ranks: gloo processes on the CPU, or at most the cards")
    ap.add_argument("--request", type=int, default=0,
                    help="device count to dispatch (default: all)")
    ap.add_argument("--mesh", default="",
                    help="mesh shape for the dispatched devices, e.g. 4x2")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def _world(args) -> int:
    if args.device == "cpu":
        return args.devices or 1
    resolve_device("cuda")
    cards = torch.cuda.device_count()
    if args.devices > cards:
        raise ValueError(f"--devices {args.devices}: this machine has {cards} cards "
                         "(pass --device cpu for gloo ranks on the CPU)")
    return args.devices or cards


def _dispatcher(name: str, n_dev: int):
    hosts = max(1, n_dev // 8)
    cluster = core.tpu_pod_cluster(hosts) if n_dev >= 8 else core.Cluster(
        [("TPU_V5E", 1)], name="local")
    sim = core.BandwidthSimulator(cluster)
    tables = core.IntraHostTables(cluster, sim)
    if name == "bandpilot":
        return core.BandPilotDispatcher(cluster, tables, core.GroundTruthPredictor(sim))
    return core.BaselineDispatcher(cluster, name)


def _rank_main(rank: int, world: int, store: Optional[str], args,
               cfg: Optional[ModelConfig]) -> Optional[dict]:
    with process_group(args.device, rank, world, store):
        return _train(rank, world, args, cfg)


def _train(rank: int, world: int, args, cfg: Optional[ModelConfig]) -> Optional[dict]:
    say = print if rank == 0 else (lambda *a, **kw: None)
    n_dev = world
    k = args.request or n_dev
    say(f"pool: {n_dev} devices; request k={k}; dispatcher={args.dispatcher}")

    # -- dispatch ---------------------------------------------------------
    dispatcher = None
    if args.dispatcher != "none" and n_dev > 1:
        dispatcher = _dispatcher(args.dispatcher, n_dev)
    shape = tuple(int(x) for x in args.mesh.split("x")) if args.mesh else (k, 1)
    axes = ("data", "model")[: len(shape)]
    if len(shape) == 1:
        axes = ("data",)
    mesh, chosen = bandpilot_mesh(dispatcher, list(range(n_dev)), k, shape, axes,
                                  device_type=args.device)
    say(f"dispatched devices: {chosen}; mesh {dict(zip(axes, shape))}", flush=True)
    if mesh.get_coordinate() is None:
        return None  # left out by the dispatch

    # -- model + data -------------------------------------------------------
    if cfg is None:
        cfg = get_config(args.arch)
        if args.reduced:
            cfg = cfg.reduced()
    model = ShardedModel(build_model(cfg, device=args.device), mesh,
                         shd.STRATEGIES["fsdp_tp"]())
    params = model.init(args.seed)
    data = SyntheticLM(DataConfig(cfg.vocab_size, args.seq_len, args.global_batch,
                                  seed=args.seed))
    run = TrainRunConfig(
        optimizer=AdamWConfig(lr=args.lr, weight_decay=0.01),
        total_steps=args.steps, warmup_steps=min(20, args.steps // 5),
        compute_dtype=torch.float32 if args.reduced else torch.bfloat16,
    )
    ck = Checkpointer(args.ckpt_dir, keep=2, async_save=True) if args.ckpt_dir else None
    lead = rank == int(mesh.mesh.flatten()[0])
    t0 = time.time()
    with open(os.devnull, "w") as sink, contextlib.redirect_stdout(
            sys.stdout if lead else sink):
        params, opt_state, history = train_loop(
            model, params, data.batches(args.steps), run, log_every=args.log_every,
            checkpointer=ck, checkpoint_every=args.ckpt_every)
        if ck:
            ck.wait()
        print("training complete", flush=True)
    return {"cfg": cfg, "chosen": chosen, "mesh": dict(zip(axes, shape)),
            "history": history, "opt_step": opt_state.step, "seconds": time.time() - t0,
            "n_params": sum(p.numel() for p in params.parameters())}


def main(argv: Optional[List[str]] = None, cfg: Optional[ModelConfig] = None
         ) -> Optional[dict]:
    """Train; returns the mesh's first rank's summary when the world is one
    process, None when ranks were spawned (they print)."""
    args = _parse_args(argv)
    world = _world(args)
    if world == 1:
        return _rank_main(0, 1, None, args, cfg)
    tmp = tempfile.mkdtemp(prefix="repro_torch_train_")
    try:
        mp.start_processes(_spawned, args=(world, os.path.join(tmp, "store"), args, cfg),
                           nprocs=world, start_method="spawn")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return None


def _spawned(rank: int, world: int, store: str, args, cfg: Optional[ModelConfig]) -> None:
    torch.set_num_threads(1)  # the ranks are the parallelism
    _rank_main(rank, world, store, args, cfg)


if __name__ == "__main__":
    main()
