"""Tensor-parallel serving's decode step against the unsplit one, on one card.

    python3 scripts/profile_torch_tp_serve.py [--layers 8]

internvl2-76b at full width, depth cut to ``--layers``, bf16, B 4: a prefill
of 256 prefix rows and 2304 tokens into a 4096-slot cache, then decode
steps through the model API (unsplit) and through
``parallel.fsdp.ShardedModel`` on a 1-rank NCCL mesh (the tensor-parallel
path with every split whole), in turns: unsplit, sharded, unsplit,
sharded. For each: 10 steps under CUDA events and the host clock, then 4
steps under ``torch.profiler`` (host wall, device busy, idle share, the top
device kernels) and the host operators with the most self time. Writes
``chiprun_out/profile_tp_serve.json``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "scripts"))

from profile_torch_serve import _phase, _smi  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import KERNELS, cuda_build  # noqa: E402
from repro_torch.launch.mesh import make_mesh_from_devices, process_group  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402
from repro_torch.parallel import sharding as shd  # noqa: E402
from repro_torch.parallel.fsdp import ShardedModel  # noqa: E402

SEED, B, P, S, MAX_LEN = 0, 4, 256, 2304, 4096


def _host_ops(fn, n=12):
    """The host operators with the most self CPU time over one call."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total, reverse=True)
    return [{"op": e.key[:100], "self_cpu_ms": e.self_cpu_time_total / 1e3, "calls": e.count}
            for e in rows[:n]]


def _timed(name, step, n=10):
    """ms a step under CUDA events and the host clock, then a profile of 4."""
    step()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    start.record()
    for _ in range(n):
        step()
    end.record()
    torch.cuda.synchronize()
    rec = {"ms_per_step_events": start.elapsed_time(end) / n,
           "ms_per_step_host": (time.perf_counter() - t0) * 1e3 / n}

    def four():
        for _ in range(4):
            step()
    rec["profile_4_steps"] = _phase(name, four)
    rec["host_ops"] = _host_ops(step)
    print(name, json.dumps({k: rec[k] for k in ("ms_per_step_events", "ms_per_step_host")}),
          flush=True)
    return rec


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=8)
    args = ap.parse_args()
    smi = _smi()
    print(smi, flush=True)
    cuda_build.build(KERNELS)
    cfg = dataclasses.replace(get_config("internvl2-76b"), n_layers=args.layers)
    model = build_model(cfg)
    lm = model.init(SEED, torch.bfloat16)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=g, device="cuda"),
             "prefix_embeds": torch.randn(B, P, cfg.d_model, generator=g,
                                          device="cuda").bfloat16()}
    out = {"gpu": smi, "arch": cfg.name, "layers": cfg.n_layers, "batch": B,
           "positions": P + S, "max_len": MAX_LEN, "runs": []}
    with torch.no_grad():
        cache = model.init_cache(B, MAX_LEN, torch.bfloat16)
        logits, cache = model.prefill(lm, batch, cache)
        tok = logits.argmax(-1)

        def plain():
            model.decode_step(lm, cache, tok)
            cache["pos"] -= 1  # the same position every step

        with process_group("cuda"):
            mesh = make_mesh_from_devices([0], (1, 1), ("data", "model"), "cuda")
            sharded = ShardedModel(build_model(cfg), mesh, shd.STRATEGIES["fsdp_tp"]())
            # a second copy of the weights, sharded: the unsplit path keeps its own
            slm = sharded.shard(build_model(cfg).init(SEED, torch.bfloat16))
            scache = sharded.init_cache(B, MAX_LEN, torch.bfloat16)
            slogits, scache = sharded.prefill(slm, batch, scache)
            stok = slogits.full_tensor().argmax(-1)
            if not torch.equal(stok, tok):
                raise RuntimeError("the sharded prefill's greedy token differs")

            def tp():
                sharded.decode_step(slm, scache, stok)
                scache["pos"] -= 1

            for name, step in (("unsplit", plain), ("sharded", tp),
                               ("unsplit", plain), ("sharded", tp)):
                out["runs"].append({"path": name, **_timed(name, step)})
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "profile_tp_serve.json").write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
