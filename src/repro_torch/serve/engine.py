"""Batched serving engine: prefill + greedy/temperature decode.

Counterpart of ``repro/serve/engine.py``: requests share fixed batch slots,
prompts are left-padded with token 0 to a common prefill length (no pad
mask, as in the reference), and decode runs lock-step with per-slot stop
tracking. Temperature sampling draws from a numpy generator seeded per call.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.model_zoo import Model
from repro_torch.models.transformer import LM


@dataclasses.dataclass
class ServeConfig:
    max_len: int = 512
    max_new_tokens: int = 64
    cache_dtype: torch.dtype = torch.float32
    temperature: float = 0.0  # 0 = greedy
    eos_id: Optional[int] = None


class ServeEngine:
    def __init__(self, model: Model, params: LM, cfg: ServeConfig,
                 device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model is on {model.device}, engine on {self.device}")
        self.model = model
        self.params = params
        self.cfg = cfg
        # host-clock seconds of the last generate(): prefill (to the first
        # sampled token on the host) and each decode step (likewise)
        self.last_timing: Dict[str, object] = {}

    @torch.inference_mode()
    def generate(self, prompts: Sequence[Sequence[int]],
                 rng_seed: int = 0) -> List[List[int]]:
        """prompts: batch of token-id lists -> generated continuations."""
        cfg = self.cfg
        B = len(prompts)
        plen = max(len(p) for p in prompts)
        toks = np.zeros((B, plen), np.int64)
        for i, p in enumerate(prompts):
            toks[i, plen - len(p):] = p  # left-pad
        cache = self.model.init_cache(B, cfg.max_len, cfg.cache_dtype)
        rng = np.random.default_rng(rng_seed)
        t0 = time.perf_counter()
        logits, cache = self.model.prefill(
            self.params, {"tokens": torch.from_numpy(toks).to(self.device)}, cache)
        cur = self._sample(logits, rng)
        prefill_s = time.perf_counter() - t0
        decode_s: List[float] = []
        out: List[List[int]] = [[] for _ in range(B)]
        done = np.zeros(B, bool)
        for _ in range(cfg.max_new_tokens):
            for i in range(B):
                if not done[i]:
                    t = int(cur[i, 0])
                    out[i].append(t)
                    if cfg.eos_id is not None and t == cfg.eos_id:
                        done[i] = True
            if done.all():
                break
            t0 = time.perf_counter()
            logits, cache = self.model.decode_step(
                self.params, cache, torch.from_numpy(cur).to(self.device))
            cur = self._sample(logits, rng)
            decode_s.append(time.perf_counter() - t0)
        self.last_timing = {"prefill_s": prefill_s, "decode_s": decode_s,
                            "prefill_len": plen}
        return out

    def _sample(self, logits: torch.Tensor, rng: np.random.Generator) -> np.ndarray:
        """[B, 1] int64 next tokens (on the host) from logits [B, S, V]."""
        lg = logits[:, -1, :].float()
        if self.cfg.temperature <= 0:
            return lg.argmax(-1)[:, None].cpu().numpy()
        p = torch.softmax(lg / self.cfg.temperature, dim=-1).cpu().numpy()
        choice = [rng.choice(p.shape[-1], p=row / row.sum()) for row in p]
        return np.asarray(choice, np.int64)[:, None]
