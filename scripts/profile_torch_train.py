"""Where the time goes in the PyTorch port's training step, on the card.

    python3 scripts/profile_torch_train.py

``chip_smoke.py``'s ``train`` configuration: recurrentgemma-9b at full
width, depth cut to one (rglru, rglru, attn_local) group, bf16 compute over
fp32 masters, remat "nothing", B 2 x S 2560 from ``SyntheticLM``, AdamW.
After two warm-up steps it times the pieces of three more steps with CUDA
events -- the forward and loss, the backward (``torch.autograd.grad``),
the AdamW update with its clip -- and profiles one whole step with
``torch.profiler`` (host wall, device busy, idle share, the kernels that
take the most device time, the port's kernels' time and launches). Writes
``chiprun_out/profile_train.json``. Fails if the profiler sees no device
time.
"""

from __future__ import annotations

import dataclasses
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
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.kernels import KERNELS, cuda_build  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402
from repro_torch.train.optimizer import AdamWConfig, adamw, cosine_schedule  # noqa: E402
from repro_torch.train.train_loop import TrainRunConfig, make_train_step  # noqa: E402

B, S, SEED = 2, 2560, 0


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(_smi())
    cuda_build.build(KERNELS)
    cfg = dataclasses.replace(get_config("recurrentgemma-9b"), n_layers=3)
    model = build_model(cfg)
    lm = model.init(SEED, torch.float32)
    data = SyntheticLM(DataConfig(cfg.vocab_size, S, B, seed=SEED))
    batches = [{k: torch.as_tensor(v, device="cuda") for k, v in data.batch(i).items()}
               for i in range(6)]
    run = TrainRunConfig(optimizer=AdamWConfig(lr=3e-4, weight_decay=0.1), total_steps=10,
                         warmup_steps=1, remat_policy="nothing",
                         compute_dtype=torch.bfloat16)
    step, opt_init = make_train_step(model, run)
    state = opt_init(lm)
    for batch in batches[:2]:  # warm-up: cuBLAS handles, kernels loaded, memory cached
        lm, state, _ = step(lm, state, batch)

    # the step's pieces, as make_train_step runs them, each between two events
    _, update = adamw(run.optimizer, cosine_schedule(run.total_steps, run.warmup_steps))
    params = dict(lm.named_parameters())
    pieces = {"forward_and_loss_ms": [], "backward_ms": [], "adamw_ms": []}
    for batch in batches[2:5]:
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
    print("pieces (median of 3 steps, ms):", json.dumps(medians))

    holder = {"lm": lm, "state": state}

    def one_step():
        holder["lm"], holder["state"], _ = step(holder["lm"], holder["state"], batches[5])

    out = {"arch": cfg.name, "layers": cfg.n_layers, "batch": B, "seq": S,
           "compute_dtype": "bfloat16", "remat_policy": run.remat_policy, "gpu": _smi(),
           "pieces_ms": pieces, "pieces_median_ms": medians,
           "phases": [_phase("train step", one_step)]}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "profile_train.json").write_text(json.dumps(out, indent=1) + "\n")
    print(out["gpu"])
    return out


if __name__ == "__main__":
    main()
