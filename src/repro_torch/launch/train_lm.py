"""Train a ~100M-parameter LM for a few hundred steps: the port's
``examples/train_lm.py``.

The mistral-nemo block architecture scaled to ~100M parameters, the
deterministic synthetic pipeline, AdamW with a cosine schedule, fp32
compute, async checkpointing. Loss drops well below ln(V) within a few
hundred steps.

  python -m repro_torch.launch.train_lm                   # ~100M, 300 steps, on the card
  python -m repro_torch.launch.train_lm --quick --device cpu   # smoke-sized, CPU

The reference's flags, plus ``--device`` (the card unless told otherwise).
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import tempfile
import time
from typing import List, Optional

import torch

from repro_torch.checkpoint.ckpt import Checkpointer
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models.model_zoo import build_model
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_loop import TrainRunConfig, train_loop


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--steps", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train_lm_ckpt"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    base = get_config("mistral-nemo-12b")
    if args.quick:
        cfg = base.reduced()
        steps = args.steps or 60
        batch, seq = 8, 64
    else:
        # ~100M-param dense LM with the mistral-nemo block layout
        cfg = dataclasses.replace(
            base, name="nemo-100m", n_layers=8, d_model=512, n_heads=8,
            n_kv_heads=4, head_dim=64, d_ff=2048, vocab_size=32768,
            max_seq_len=512,
        )
        steps = args.steps or 300
        batch, seq = 16, 256

    model = build_model(cfg, device=args.device)
    params = model.init(0)
    n_params = sum(p.numel() for p in params.parameters())
    print(f"{cfg.name}: {n_params / 1e6:.1f}M params, {steps} steps, "
          f"batch {batch} x seq {seq}")

    data = SyntheticLM(DataConfig(cfg.vocab_size, seq, batch, seed=0))
    run = TrainRunConfig(
        optimizer=AdamWConfig(lr=3e-3, weight_decay=0.01),
        total_steps=steps, warmup_steps=max(10, steps // 10),
        compute_dtype=torch.float32,
    )
    ck = Checkpointer(args.ckpt_dir, keep=2, async_save=True)
    t0 = time.time()
    params, opt_state, hist = train_loop(
        model, params, data.batches(steps), run, log_every=max(10, steps // 15),
        checkpointer=ck, checkpoint_every=max(50, steps // 4),
    )
    ck.wait()
    seconds = time.time() - t0
    lnv = math.log(cfg.vocab_size)
    final = hist[-1]["loss"] if hist else float("nan")
    print(f"\ndone in {seconds:.0f}s; final loss {final:.3f} "
          f"vs ln(V)={lnv:.2f} ({'LEARNED' if final < 0.75 * lnv else 'check'})")
    print(f"checkpoints: {ck.all_steps()} in {args.ckpt_dir}")
    return {"cfg": cfg, "n_params": n_params, "steps": steps, "history": hist,
            "seconds": seconds, "opt_step": opt_state.step, "checkpoints": ck.all_steps()}


if __name__ == "__main__":
    main()
