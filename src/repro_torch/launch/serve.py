"""Serving launcher: batched generation on the card with random weights.

  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch recurrentgemma-9b --batch 4 --min-prompt-len 2304 \\
      --prompt-len 2560 --max-len 4096 --max-new 16

Counterpart of ``repro/launch/serve.py``, with the same flags except
``--devices`` (an XLA host-device flag with no counterpart here), plus
``--device`` (default ``cuda``), ``--dtype`` (weights and KV cache; default
bfloat16 on the card, float32 on the CPU) and ``--min-prompt-len`` (prompt
lengths are drawn from [min-prompt-len, prompt-len]; 4 as in the reference).
``--dispatcher`` is accepted and unused, as in the reference.
"""

from __future__ import annotations

import argparse
import time
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models.model_zoo import build_model
from repro_torch.serve.engine import ServeConfig, ServeEngine

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-9b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--min-prompt-len", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--dispatcher", default="bandpilot")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", choices=sorted(DTYPES), default=None)
    args = ap.parse_args(argv)
    if not 1 <= args.min_prompt_len <= args.prompt_len:
        ap.error("need 1 <= --min-prompt-len <= --prompt-len")
    return args


def main(argv=None) -> Dict[str, Any]:
    """Serve one batch; print it and return the outputs and timings."""
    args = _parse_args(argv)
    device = resolve_device(args.device)
    dtype = DTYPES[args.dtype or ("bfloat16" if device.type == "cuda" else "float32")]

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg, device)
    params = model.init(args.seed, dtype)

    rng = np.random.default_rng(args.seed)
    prompts = [
        rng.integers(0, cfg.vocab_size,
                     rng.integers(args.min_prompt_len, args.prompt_len + 1))
        .tolist()
        for _ in range(args.batch)
    ]
    eng = ServeEngine(model, params, ServeConfig(
        max_len=args.max_len, max_new_tokens=args.max_new, cache_dtype=dtype,
    ), device)
    t0 = time.perf_counter()
    outs = eng.generate(prompts, rng_seed=args.seed)
    dt = time.perf_counter() - t0
    n_tok = sum(len(o) for o in outs)
    for i, o in enumerate(outs):
        print(f"req{i}: prompt={prompts[i][:6]}... -> {o}")
    timing = eng.last_timing
    print(f"generated {n_tok} tokens in {dt:.2f}s ({n_tok / dt:.1f} tok/s batched); "
          f"prefill {timing['prefill_s'] * 1e3:.1f} ms over "
          f"{timing['prefill_len']} positions")
    return {"outputs": outs, "prompts": prompts, "seconds": dt, "tokens": n_tok,
            "timing": timing, "dtype": str(dtype).replace("torch.", ""),
            "n_params": sum(p.numel() for p in params.parameters()),
            "cfg": cfg}


if __name__ == "__main__":
    main()
