#!/usr/bin/env python3
"""Where the time goes in whisper-medium on the port, on the card.

    python3 scripts/profile_torch_whisper.py

``chip_smoke.py``'s whisper configurations at full width (24 + 24 layers,
seeded weights and inputs): a warm encode of 4 x 1500 bf16 frames, 8 greedy
decode steps against its memory, and a training step (B 4 x 1500 frames x
448 tokens, bf16 compute over fp32 masters, remat "nothing", AdamW, TF32
off as in ``chip_smoke.py``). The step's pieces -- forward and loss,
backward, AdamW with its clip -- are timed with CUDA events over three
steps after two warm-up steps; each phase is profiled once with
``torch.profiler`` (host wall, device busy, idle share, the kernels that
take the most device time, the port's kernels' time and launches). Writes
``chiprun_out/profile_whisper.json``. Fails if the profiler sees no device
time.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "scripts"))

from profile_torch_serve import _phase, _smi  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import KERNELS, cuda_build  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402
from repro_torch.train.optimizer import AdamWConfig, adamw, cosine_schedule  # noqa: E402
from repro_torch.train.train_loop import TrainRunConfig, make_train_step  # noqa: E402

B, T, S, SEED = 4, 1500, 448, 0
START = 50258  # <|startoftranscript|>


def serve_phases(cfg, model):
    params = model.init(SEED, torch.bfloat16)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    frames = torch.randn(B, T, cfg.d_model, generator=g, device="cuda").bfloat16()
    state = {}

    def encode():
        state["memory"], state["cache"] = model.prefill(
            params, {"frames": frames}, model.init_cache(B, cfg.max_seq_len, torch.bfloat16))

    def decode():
        tok = torch.full((B, 1), START, device="cuda")
        for _ in range(8):
            logits, state["cache"] = model.decode_step(params, state["cache"], tok,
                                                       state["memory"])
            tok = logits.argmax(-1)
        return tok.cpu()

    with torch.inference_mode():
        encode()  # warm-up: cuBLAS handles, kernels loaded
        decode()
        return [_phase("encode", encode), _phase("decode 8 steps", decode)]


def train_phases(cfg, model):
    lm = model.init(SEED, torch.float32)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    batch = {"frames": torch.randn(B, T, cfg.d_model, generator=g, device="cuda").bfloat16(),
             "tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=g, device="cuda"),
             "labels": torch.randint(0, cfg.vocab_size, (B, S), generator=g, device="cuda")}
    run = TrainRunConfig(optimizer=AdamWConfig(lr=3e-4, weight_decay=0.1), total_steps=10,
                         warmup_steps=1, remat_policy="nothing",
                         compute_dtype=torch.bfloat16)
    step, opt_init = make_train_step(model, run)
    state = opt_init(lm)
    for _ in range(2):
        lm, state, _ = step(lm, state, batch)
    _, update = adamw(run.optimizer, cosine_schedule(run.total_steps, run.warmup_steps))
    params = dict(lm.named_parameters())
    pieces = {"forward_and_loss_ms": [], "backward_ms": [], "adamw_ms": []}
    for _ in range(3):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        loss, _ = model.loss(lm, batch, remat_policy=run.remat_policy,
                             compute_dtype=run.compute_dtype)
        ev[1].record()
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        ev[2].record()
        _, state, _ = update(grads, state, params)
        ev[3].record()
        torch.cuda.synchronize()
        for (name, times), a, b in zip(pieces.items(), ev, ev[1:]):
            times.append(a.elapsed_time(b))
        del grads, loss
    medians = {k: float(np.median(v)) for k, v in pieces.items()}
    print("train pieces (median of 3 steps, ms):", json.dumps(medians), flush=True)
    holder = {"lm": lm, "state": state}

    def one_step():
        holder["lm"], holder["state"], _ = step(holder["lm"], holder["state"], batch)

    return pieces, medians, [_phase("train step", one_step)]


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = _smi()
    print(gpu, flush=True)
    cuda_build.build(KERNELS)
    cfg = get_config("whisper-medium")
    model = build_model(cfg)
    phases = serve_phases(cfg, model)
    torch.cuda.empty_cache()
    pieces, medians, train = train_phases(cfg, model)
    out = {"arch": cfg.name, "layers": [cfg.n_encoder_layers, cfg.n_layers], "batch": B,
           "frames": T, "tokens": S, "gpu": gpu, "train_pieces_ms": pieces,
           "train_pieces_median_ms": medians, "phases": phases + train}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "profile_whisper.json").write_text(json.dumps(out, indent=1) + "\n")
    return out


if __name__ == "__main__":
    main()
