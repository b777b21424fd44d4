"""Uniform model API (``repro/models/model_zoo.py``) over decoder-only LMs
and the encoder-decoder family.

``build_model(cfg, device)`` returns a :class:`Model` with
  init(seed, dtype)                      -> params (an ``LM`` or ``EncDec`` module)
  loss(params, batch, **kw)              -> (loss, metrics)  [train step]
  init_cache(batch, max_len, dtype)      -> cache
  prefill(params, batch, cache)          -> (last-token logits, cache); for
                                            the encoder-decoder the encoder
                                            pass: (memory, cache)
  decode_step(params, cache, tokens, memory=None) -> (logits, cache)

A batch may carry ``prefix_embeds`` [B, P, d] (the vision frontend's prefix,
internvl2): ``loss`` and ``prefill`` put it before the tokens.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import weights
from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import encdec, transformer
from repro_torch.weights import Params


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    device: torch.device

    def init(self, seed: int = 0, dtype: torch.dtype = torch.float32) -> Params:
        return weights.init_params(self.cfg, seed, self.device, dtype)

    def loss(self, params: Params, batch: Dict[str, Any], **kw
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """``transformer.lm_loss`` or ``encdec.encdec_loss``: kw are
        ``remat_policy``, ``compute_dtype``, and the sharded trainer's hooks
        ``materialize`` and ``model_axis`` (``parallel/fsdp.py``)."""
        if self.cfg.is_encoder_decoder:
            return encdec.encdec_loss(params, batch, **kw)
        return transformer.lm_loss(params, batch, **kw)

    def init_cache(self, batch: int, max_len: int,
                   dtype: torch.dtype = torch.bfloat16) -> Dict[str, Any]:
        if self.cfg.is_encoder_decoder:
            return encdec.init_encdec_cache(self.cfg, batch, max_len, dtype, self.device)
        return transformer.init_decode_cache(self.cfg, batch, max_len, dtype,
                                             self.device)

    def prefill(self, params: Params, batch: Dict[str, Any],
                cache: Dict[str, Any]) -> Tuple[torch.Tensor, Dict[str, Any]]:
        if self.cfg.is_encoder_decoder:  # the encoder pass is the prefill
            return params.encode(batch["frames"]), cache
        return params.prefill(batch["tokens"], cache, batch.get("prefix_embeds")), cache

    def decode_step(self, params: Params, cache: Dict[str, Any], tokens: torch.Tensor,
                    memory: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        if self.cfg.is_encoder_decoder:
            return params.decode_step(tokens, cache, memory), cache
        return params.decode_step(tokens, cache), cache


def build_model(cfg: ModelConfig, device: DeviceLike = "cuda") -> Model:
    return Model(cfg, resolve_device(device))
