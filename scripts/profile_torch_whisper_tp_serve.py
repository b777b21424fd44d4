#!/usr/bin/env python3
"""Sharded whisper-medium serving against the unsplit model, on one card.

    python3 scripts/profile_torch_whisper_tp_serve.py

whisper-medium at full width (24 + 24 layers, seeded bf16 weights), B 4 x
1500 frames, through the model API (unsplit) and through
``parallel.fsdp.ShardedModel`` on a 1-rank NCCL mesh under ``fsdp_tp``
(every split whole), in turns: unsplit, sharded, unsplit, sharded. For
each: a warm encode under ``torch.profiler``, then decode steps at one
position (the cache's ``pos`` put back after each): 10 under CUDA events
and the host clock, 4 under ``torch.profiler`` (host wall, device busy,
idle share, the top device kernels), and the host operators with the most
self time over one step. Writes ``chiprun_out/profile_whisper_tp_serve.json``.
Fails if the profiler sees no device time.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "scripts"))

from profile_torch_serve import _phase, _smi  # noqa: E402
from profile_torch_tp_serve import _host_ops  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import KERNELS, cuda_build  # noqa: E402
from repro_torch.launch.mesh import make_mesh_from_devices, process_group  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402
from repro_torch.parallel import sharding as shd  # noqa: E402
from repro_torch.parallel.fsdp import ShardedModel  # noqa: E402

SEED, B, T, S = 0, 4, 1500, 448
START = 50258  # <|startoftranscript|>


def _timed(name, step, n=10):
    """ms a decode step under CUDA events and the host clock, a profile of
    4 steps, the host operators of one."""
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
    rec["profile_4_steps"] = _phase(f"{name} decode", four)
    rec["host_ops"] = _host_ops(step)
    print(name, json.dumps({k: rec[k] for k in ("ms_per_step_events", "ms_per_step_host")}),
          flush=True)
    return rec


def _side(name, model, params, frames, full):
    """One side's encode and decode step: (encode, decode step) closures."""
    state = {}

    def encode():
        state["memory"], state["cache"] = model.prefill(
            params, {"frames": frames}, model.init_cache(B, S, torch.bfloat16))

    encode()
    first = torch.full((B, 1), START, device="cuda")
    logits, state["cache"] = model.decode_step(params, state["cache"], first, state["memory"])
    tok = full(logits).argmax(-1)

    def decode():
        model.decode_step(params, state["cache"], tok, state["memory"])
        state["cache"]["pos"] -= 1  # the same position every step

    return encode, decode


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA card")
    smi = _smi()
    print(smi, flush=True)
    cuda_build.build(KERNELS)
    cfg = get_config("whisper-medium")
    g = torch.Generator(device="cuda").manual_seed(SEED)
    frames = torch.randn(B, T, cfg.d_model, generator=g, device="cuda").bfloat16()
    out = {"gpu": smi, "arch": cfg.name, "layers": [cfg.n_encoder_layers, cfg.n_layers],
           "batch": B, "frames": T, "cache_len": S, "runs": []}
    with torch.no_grad(), process_group("cuda"):
        model = build_model(cfg)
        plain = _side("unsplit", model, model.init(SEED, torch.bfloat16), frames, lambda t: t)
        mesh = make_mesh_from_devices([0], (1, 1), ("data", "model"), "cuda")
        sharded_model = ShardedModel(build_model(cfg), mesh, shd.STRATEGIES["fsdp_tp"]())
        # a second copy of the weights, sharded: the unsplit side keeps its own
        params = sharded_model.shard(build_model(cfg).init(SEED, torch.bfloat16))
        sharded = _side("sharded", sharded_model, params, frames, lambda t: t.full_tensor())
        for name, (encode, decode) in (("unsplit", plain), ("sharded", sharded),
                                       ("unsplit", plain), ("sharded", sharded)):
            out["runs"].append({"path": name, "encode": _phase(f"{name} encode", encode),
                                **_timed(name, decode)})
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "profile_whisper_tp_serve.json").write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
