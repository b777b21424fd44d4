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

    def forward(self, x: torch.Tensor, axis=None) -> torch.Tensor:
        """``axis``: the layer's ``tensor_parallel.LayerAxis`` where sharded.
        Its ``column`` takes the input products: in serving, where the
        weights keep their ``embed`` block, the rank's columns of x times it,
        summed over the block's axes. The output is then the rank's block
        of the stream's columns (``LayerAxis.out`` gathers it)."""
        def up(name: str) -> torch.Tensor:
            w = getattr(self, name)
            return x @ w if axis is None else axis.column(x, w, name)

        if self.mlp_type == "swiglu":
            h = F.silu(up("w_gate")) * up("w_up")
        elif self.mlp_type == "geglu":
            h = F.gelu(up("w_gate"), approximate="tanh") * up("w_up")
        else:
            h = F.gelu(up("w_up"), approximate="tanh")
        return h @ self.w_down
