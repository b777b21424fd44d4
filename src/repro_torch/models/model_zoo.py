"""Uniform model API (``repro/models/model_zoo.py``), decoder-only LMs.

``build_model(cfg, device)`` returns a :class:`Model` with
  init(seed, dtype)                      -> params (an ``LM`` module)
  loss(params, batch, **kw)              -> (loss, metrics)  [train step]
  init_cache(batch, max_len, dtype)      -> cache
  prefill(params, batch, cache)          -> (last-token logits, cache)
  decode_step(params, cache, tokens)     -> (logits, cache)

The encoder-decoder family, and a batch carrying ``prefix_embeds`` (the
vision and audio frontends' prefix), raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch import weights
from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer
from repro_torch.models.transformer import LM


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    device: torch.device

    def init(self, seed: int = 0, dtype: torch.dtype = torch.float32) -> LM:
        return weights.init_params(self.cfg, seed, self.device, dtype)

    def loss(self, params: LM, batch: Dict[str, Any], **kw
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """``transformer.lm_loss``: kw are ``remat_policy``, ``compute_dtype``."""
        return transformer.lm_loss(params, batch, **kw)

    def init_cache(self, batch: int, max_len: int,
                   dtype: torch.dtype = torch.bfloat16) -> transformer.Cache:
        return transformer.init_decode_cache(self.cfg, batch, max_len, dtype,
                                             self.device)

    def prefill(self, params: LM, batch: Dict[str, Any],
                cache: transformer.Cache) -> Tuple[torch.Tensor, transformer.Cache]:
        if batch.get("prefix_embeds") is not None:
            raise NotImplementedError(
                f"{self.cfg.name}: prefix_embeds (the frontends' prefix) are not "
                "ported yet (ROADMAP.md queue A2)")
        return params.prefill(batch["tokens"], cache), cache

    def decode_step(self, params: LM, cache: transformer.Cache,
                    tokens: torch.Tensor) -> Tuple[torch.Tensor, transformer.Cache]:
        return params.decode_step(tokens, cache), cache


def build_model(cfg: ModelConfig, device: DeviceLike = "cuda") -> Model:
    transformer.check_supported(cfg)
    return Model(cfg, resolve_device(device))
