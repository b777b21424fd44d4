"""The sharded training step's cost over ``train_loop``'s on one card.

    python3 scripts/profile_torch_sharded.py

``launch/elastic.py``'s card configuration (recurrentgemma-9b at full width,
one (rglru, rglru, attn_local) group, bf16 compute over fp32 masters, B 1 x
S 2048): the plain step (``make_train_step`` over the model) and the sharded
step (over ``parallel.fsdp.ShardedModel`` on a 1-rank NCCL mesh, so every
gather and reduction is a copy), in turns: plain, sharded, plain. For each,
after two warm-up steps: 5 steps under CUDA events; the pieces of 3 more --
forward and loss, backward, AdamW with its clip -- under CUDA events and the
host clock (the host's enqueue time: where it exceeds the events, the host
sets the pace); one step under ``torch.profiler`` (host wall, device busy,
idle share, the top device kernels, and the host operators with the most
self time). Writes ``chiprun_out/profile_sharded.json``.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "scripts"))

from profile_torch_serve import _phase, _smi  # noqa: E402
from repro_torch.kernels import KERNELS, cuda_build  # noqa: E402
from repro_torch.launch.elastic import card_flow  # noqa: E402
from repro_torch.launch.mesh import make_mesh_from_devices, process_group  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402
from repro_torch.parallel import sharding as shd  # noqa: E402
from repro_torch.parallel.fsdp import ShardedModel  # noqa: E402
from repro_torch.train.optimizer import adamw, cosine_schedule  # noqa: E402
from repro_torch.train.train_loop import make_train_step  # noqa: E402

SEED = 0


def _host_ops(fn, n=15):
    """The host operators with the most self CPU time over one call."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total, reverse=True)
    return [{"op": e.key[:100], "self_cpu_ms": e.self_cpu_time_total / 1e3, "calls": e.count}
            for e in rows[:n]]


def block(name, model, lm, flow, batches):
    run = flow.run_config()
    step, opt_init = make_train_step(model, run)
    holder = {"lm": lm, "state": opt_init(lm)}

    def one(batch):
        holder["lm"], holder["state"], _ = step(holder["lm"], holder["state"], batch)

    for batch in batches[:2]:
        one(batch)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
    ev[0].record()
    for i, batch in enumerate(batches[2:7]):
        one(batch)
        ev[i + 1].record()
    torch.cuda.synchronize()
    step_ms = [a.elapsed_time(b) for a, b in zip(ev, ev[1:])]

    _, update = adamw(run.optimizer, cosine_schedule(run.total_steps, run.warmup_steps))
    params = dict(holder["lm"].named_parameters())
    pieces = {k: [] for k in ("forward_and_loss", "backward", "adamw")}
    host = {k: [] for k in pieces}
    for batch in batches[7:10]:
        b = {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        t = [time.perf_counter()]
        ev[0].record()
        loss, _ = model.loss(holder["lm"], b, remat_policy=run.remat_policy,
                             compute_dtype=run.compute_dtype)
        ev[1].record()
        t.append(time.perf_counter())
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        ev[2].record()
        t.append(time.perf_counter())
        _, holder["state"], _ = update(grads, holder["state"], params)
        ev[3].record()
        t.append(time.perf_counter())
        torch.cuda.synchronize()
        for k, a, c, ta, tc in zip(pieces, ev, ev[1:], t, t[1:]):
            pieces[k].append(a.elapsed_time(c))
            host[k].append((tc - ta) * 1e3)
        del grads, loss
    rec = {"step": name, "step_ms": step_ms, "step_ms_median": float(np.median(step_ms)),
           "pieces_ms_median": {k: float(np.median(v)) for k, v in pieces.items()},
           "pieces_host_ms_median": {k: float(np.median(v)) for k, v in host.items()},
           "profile": _phase(name, lambda: one(batches[10])),
           "host_ops": _host_ops(lambda: one(batches[11]))}
    print(name, json.dumps({k: rec[k] for k in ("step_ms_median", "pieces_ms_median",
                                                "pieces_host_ms_median")}), flush=True)
    for row in rec["host_ops"]:
        print(f"  host {row['self_cpu_ms']:9.3f} ms  {row['calls']:6d}  {row['op']}")
    return rec


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA card")
    print(_smi())
    cuda_build.build(KERNELS)
    flow = card_flow()
    data = flow.data()
    batches = [data.batch(i) for i in range(12)]
    model = build_model(flow.cfg)
    out = {"arch": flow.cfg.name, "layers": flow.cfg.n_layers, "batch": flow.batch,
           "seq": flow.seq, "gpu": _smi(), "blocks": []}
    with process_group("cuda"):
        for name in ("plain", "sharded", "plain"):
            lm = model.init(SEED, torch.float32)
            if name == "sharded":
                mesh = make_mesh_from_devices([0], (1, 1), ("data", "model"), "cuda")
                sharded = ShardedModel(model, mesh, shd.STRATEGIES["fsdp_tp"]())
                out["blocks"].append(block(name, sharded, sharded.shard(lm), flow, batches))
            else:
                out["blocks"].append(block(name, model, lm, flow, batches))
            del lm
            torch.cuda.empty_cache()
    plain = [b["step_ms_median"] for b in out["blocks"] if b["step"] == "plain"]
    out["sharded_overhead_ms"] = out["blocks"][1]["step_ms_median"] - float(np.mean(plain))
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "profile_sharded.json").write_text(json.dumps(out, indent=1) + "\n")
    print("sharded overhead ms", out["sharded_overhead_ms"])
    print(out["gpu"])
    return out


if __name__ == "__main__":
    main()
