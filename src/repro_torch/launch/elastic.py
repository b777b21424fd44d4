"""Fault tolerance: host failure -> BandPilot re-dispatch -> new mesh ->
restore -> resume. The port of ``examples/elastic_recovery.py``.

  python -m repro_torch.launch.elastic --quick --device cpu   # the example's flow
  python -m repro_torch.launch.elastic                        # on the card

A GroundTruthPredictor-guided BandPilot (deterministic) dispatches 16 GPUs
of the paper's 32-GPU H100 testbed; at the failure the GPUs of host 1
(8-15) die. The coordinator marks them unavailable and re-dispatches the
surviving pool; training resumes on a fresh mesh, restored from the latest
checkpoint into the new mesh's placements, with the deterministic data
stream continuing where it left off.

The cluster is simulated: each allocation trains on a fresh ``DeviceMesh``
over this process group's ranks (one, the card or a CPU process), which
stands for the allocated GPUs. Training is the sharded step
(``parallel/fsdp.py``).

``--quick``: the example's run -- reduced gemma-7b, 80 steps, the failure at
40, a checkpoint every 10, batch 8 x 48 tokens, fp32. Without it, the card's
run: recurrentgemma-9b at full width cut to one pattern group of 3 layers
(the depth whose fp32 masters and moments fit the card), bf16 compute over
fp32 masters, batch 1 x 2048, 5 steps, a checkpoint and the failure at step
3 (the one save of the run), one checkpoint kept.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import shutil
import tempfile
import time
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch import core
from repro_torch.checkpoint.ckpt import Checkpointer
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.ft.elastic import ElasticCoordinator, FailureEvent, run_elastic_training
from repro_torch.launch.mesh import make_mesh_from_devices, process_group
from repro_torch.models.model_zoo import build_model
from repro_torch.models.transformer import LM
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.fsdp import ShardedModel
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_loop import TrainRunConfig, make_train_step, train_loop


@dataclasses.dataclass(frozen=True)
class Flow:
    """One elastic run's settings."""

    cfg: ModelConfig
    steps: int
    fail_at: int
    ckpt_every: int
    batch: int
    seq: int
    compute_dtype: torch.dtype
    log_every: int
    keep: int
    lr: float = 2e-3
    request: int = 16
    failed_gpus: Tuple[int, ...] = tuple(range(8, 16))

    def run_config(self) -> TrainRunConfig:
        return TrainRunConfig(optimizer=AdamWConfig(lr=self.lr), total_steps=self.steps,
                              compute_dtype=self.compute_dtype)

    def data(self) -> SyntheticLM:
        return SyntheticLM(DataConfig(self.cfg.vocab_size, self.seq, self.batch, seed=0))


def quick_flow() -> Flow:
    """``examples/elastic_recovery.py``'s settings."""
    return Flow(get_config("gemma-7b").reduced(), steps=80, fail_at=40, ckpt_every=10,
                batch=8, seq=48, compute_dtype=torch.float32, log_every=20, keep=2)


def card_flow() -> Flow:
    cfg = dataclasses.replace(get_config("recurrentgemma-9b"), n_layers=3)
    return Flow(cfg, steps=5, fail_at=3, ckpt_every=3, batch=1, seq=2048,
                compute_dtype=torch.bfloat16, log_every=1, keep=1)


class _TimedCoordinator(ElasticCoordinator):
    """Records when each failure is handled and how long the re-dispatch took."""

    def handle_failure(self, event):
        self.failed_at = time.perf_counter()
        decision = super().handle_failure(event)
        self.redispatch_s = time.perf_counter() - self.failed_at
        return decision


class _TimedCheckpointer(Checkpointer):
    """Records each save's seconds and the bytes it wrote."""

    def __init__(self, directory: str, keep: int):
        super().__init__(directory, keep=keep)
        self.saves: List[dict] = []

    def save(self, step, tree, metadata=None):
        t0 = time.perf_counter()
        super().save(step, tree, metadata)
        path = os.path.join(self.directory, f"step_{step:010d}", "arrays.npz")
        self.saves.append({"step": step, "s": time.perf_counter() - t0,
                           "bytes": os.path.getsize(path) if os.path.exists(path) else None})


def checkpoint_bytes(cfg: ModelConfig) -> int:
    """fp32 parameters and AdamW's two moments, on the ``meta`` device."""
    n = sum(p.numel() for p in LM(cfg, torch.device("meta"), torch.float32).parameters())
    return 3 * 4 * n


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def run(flow: Flow, device: torch.device, ckpt_dir: str, params: Optional[LM] = None,
        seed: int = 0) -> dict:
    """Train -> fail -> re-dispatch -> restore -> train to ``flow.steps``.

    Runs inside a process group (every rank calls it). ``params`` (an LM on
    ``device``, sharded in place) replaces the seeded init. Returns the
    event log, the loss of every logged step, each step's milliseconds (CUDA
    events on the card; a step that saved a checkpoint includes the save),
    the checkpoint saves, and the recovery's split in seconds: re-dispatch,
    mesh build, restore, first resumed step."""
    need = (flow.keep + 1) * checkpoint_bytes(flow.cfg)  # a new one lands before the gc
    os.makedirs(ckpt_dir, exist_ok=True)
    free = shutil.disk_usage(ckpt_dir).free
    if free < need:
        raise RuntimeError(f"{ckpt_dir}: {free} bytes free, the checkpoints need {need}")
    cluster = core.h100_cluster()
    sim = core.BandwidthSimulator(cluster)
    tables = core.IntraHostTables(cluster, sim)
    bp = core.BandPilotDispatcher(cluster, tables, core.GroundTruthPredictor(sim))
    coord = _TimedCoordinator(cluster, bp, request_size=flow.request)
    model = build_model(flow.cfg, device=device)
    data = flow.data()
    ck = _TimedCheckpointer(ckpt_dir, keep=flow.keep)
    run_cfg = flow.run_config()
    rules = shd.STRATEGIES["fsdp_tp"]()
    world = dist.get_world_size()
    failures = [FailureEvent(step=flow.fail_at, failed_gpus=list(flow.failed_gpus))]
    state = {"lm": params, "opt": None}
    out = {"history": [], "step_ms": {}, "allocations": [], "recover": None}

    def timed(batches, start):
        """Yield the batches, marking the clock (and a CUDA event) as each is
        taken and once after the last: each mark brackets a step."""
        marks = []
        for b in batches:
            marks.append((time.perf_counter(), _event(device)))
            yield b
        _sync(device)
        marks.append((time.perf_counter(), _event(device)))
        _sync(device)
        for i, (a, b) in enumerate(zip(marks, marks[1:])):
            out["step_ms"][start + i + 1] = (a[1].elapsed_time(b[1]) if a[1] is not None
                                             else (b[0] - a[0]) * 1e3)
        if start > 0:  # the first resumed step ended at the second mark
            rec = out["recover"]
            rec["first_step_s"] = marks[1][0] - marks[0][0]
            rec["total_s"] = marks[1][0] - coord.failed_at

    def build_and_train(allocation, start_step):
        out["allocations"].append(list(allocation))
        t0 = time.perf_counter()
        mesh = make_mesh_from_devices(range(world), (world, 1), ("data", "model"),
                                      device.type)
        sharded = ShardedModel(model, mesh, rules)
        mesh_s = time.perf_counter() - t0
        if start_step > 0 and ck.all_steps():
            # the old mesh's state went with its hosts: restore into the new one
            state.update(lm=None, opt=None)
            t0 = time.perf_counter()
            lm = sharded.shard(LM(flow.cfg, device, torch.float32))  # allocated, not drawn
            tpl = {"params": lm, "opt": make_train_step(sharded, run_cfg)[1](lm)}
            ck_step, restored = ck.restore(tpl)
            _sync(device)
            state.update(lm=restored["params"], opt=restored["opt"])
            out["recover"] = {"redispatch_s": coord.redispatch_s, "mesh_s": mesh_s,
                              "restore_s": time.perf_counter() - t0}
            start_step = ck_step
            print(f"  restored checkpoint @ step {ck_step}")
        else:
            lm = state["lm"] if state["lm"] is not None else model.init(seed)
            state["lm"] = sharded.shard(lm)
        until = min((f.step for f in failures if f.step > start_step), default=flow.steps)
        batches = timed(data.batches(until - start_step, start=start_step), start_step)
        lm, opt, hist = train_loop(sharded, state["lm"], batches, run_cfg,
                                   log_every=flow.log_every, checkpointer=ck,
                                   checkpoint_every=flow.ckpt_every, start_step=start_step,
                                   opt_state=state["opt"])
        state.update(lm=lm, opt=opt)
        out["history"] += hist
        return until, hist[-1]["loss"] if hist else float("nan")

    log = run_elastic_training(coord, build_and_train, failures, flow.steps)
    print("\nevent log:")
    for e in log:
        if e["event"] == "dispatch":
            print(f"  dispatch: {len(e['alloc'])} GPUs, predicted B={e['bw']:.0f} GB/s")
        elif e["event"] == "redispatch":
            print(f"  {e['kind']}: lost {e['failed']}; re-dispatched "
                  f"{len(e['alloc'])} GPUs (B={e['bw']:.0f} GB/s), "
                  f"none on the dead host: {not set(e['alloc']) & set(e['failed'])}")
        else:
            print(f"  trained to step {e['until']} (loss {e['loss']:.3f})")
    if state["opt"].step != flow.steps:
        raise RuntimeError(f"stopped at step {state['opt'].step}, not {flow.steps}")
    print("\nrecovered and completed all steps.")
    out.update(log=log, saves=ck.saves, opt_step=state["opt"].step,
               checkpoint_bytes=checkpoint_bytes(flow.cfg))
    return out


def _event(device: torch.device):
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    flow = quick_flow() if args.quick else card_flow()
    ckpt_dir = tempfile.mkdtemp(prefix="elastic_")
    try:
        with process_group(args.device):
            return run(flow, torch.device(args.device), ckpt_dir)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)


if __name__ == "__main__":
    main()
