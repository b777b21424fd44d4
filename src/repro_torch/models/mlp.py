"""Feed-forward blocks: SwiGLU / GeGLU / GELU (``repro/models/mlp.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common


class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        d, ff = cfg.d_model, cfg.d_ff
        self.mlp_type = cfg.mlp_type
        if cfg.mlp_type in ("swiglu", "geglu"):
            self.w_gate = common.param((d, ff), device, dtype)
        self.w_up = common.param((d, ff), device, dtype)
        self.w_down = common.param((ff, d), device, dtype)

    def reset_parameters(self, gen: torch.Generator) -> None:
        for p in self.parameters():
            common.dense_init_(p, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.mlp_type == "swiglu":
            h = F.silu(x @ self.w_gate) * (x @ self.w_up)
        elif self.mlp_type == "geglu":
            h = F.gelu(x @ self.w_gate, approximate="tanh") * (x @ self.w_up)
        else:
            h = F.gelu(x @ self.w_up, approximate="tanh")
        return h @ self.w_down
