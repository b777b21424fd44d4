"""Griffin / RecurrentGemma recurrent block (RG-LRU + temporal conv).

Counterpart of ``repro/models/rglru.py``:

    x -> [linear -> GeLU]                         (gate branch)
      -> [linear -> causal conv1d(W) -> RG-LRU]   (recurrent branch)
    merge: recurrent * gate -> linear -> out

The gates are block-diagonal linears (n_blocks = n_heads). In the
cache-free forward (training) and in prefill the diagonal recurrence runs
through the CUDA scan; decode is one plain step.

Every op after the two input products acts on each channel alone, or on
one gate block's channels, so the layer splits along its channels: on one
rank's contiguous block ``[lo, hi)`` of them (``parallel/tensor_parallel.py``
splits it over ``model`` where the axis divides the gate blocks), the
module's weights are that block's -- the columns of ``w_in_rec`` and
``w_in_gate``, the conv's taps and bias, ``lam``, the gates' blocks, the
rows of ``w_out`` -- its state is the block's, the scan runs on
[B, S, hi - lo], and the output is the rank's term of the sum over
``model``. The code is the same: each weight's shape says the width.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.rglru import ops as lru_ops
from repro_torch.models import common

RGLRU_C = 8.0  # Griffin's fixed recurrence-sharpness constant

State = Dict[str, torch.Tensor]


def init_rglru_state(cfg: ModelConfig, batch: int, dtype, device) -> State:
    w = cfg.rnn_width or cfg.d_model
    return {"h": torch.zeros((batch, w), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, w), dtype=dtype,
                                device=device)}


class RGLRU(nn.Module):
    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        d = cfg.d_model
        w = cfg.rnn_width or d
        nb = cfg.n_heads
        bw = w // nb
        self.width, self.conv_width = w, cfg.conv_width
        self.w_in_rec = common.param((d, w), device, dtype)
        self.w_in_gate = common.param((d, w), device, dtype)
        self.conv_w = common.param((cfg.conv_width, w), device, dtype)
        self.conv_b = common.param((w,), device, dtype)
        self.gate_a = common.param((nb, bw, bw), device, dtype)
        self.gate_a_b = common.param((nb, bw), device, dtype)
        self.gate_x = common.param((nb, bw, bw), device, dtype)
        self.gate_x_b = common.param((nb, bw), device, dtype)
        self.lam = common.param((w,), device, dtype)
        self.w_out = common.param((w, d), device, dtype)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        common.dense_init_(self.w_in_rec, gen)
        common.dense_init_(self.w_in_gate, gen)
        common.dense_init_(self.conv_w, gen, in_axis=0)
        self.conv_b.zero_()
        common.dense_init_(self.gate_a, gen, in_axis=1)
        self.gate_a_b.zero_()
        common.dense_init_(self.gate_x, gen, in_axis=1)
        self.gate_x_b.zero_()
        # a = exp(-c * softplus(lam) * r) starts near 0.9 .. 0.999
        self.lam.copy_(torch.linspace(-2.0, 1.0, self.width))
        common.dense_init_(self.w_out, gen)

    @staticmethod
    def _block_diag(w: torch.Tensor, bias: torch.Tensor,
                    u: torch.Tensor) -> torch.Tensor:
        """u [..., width] through the block-diagonal linear w [nb, bw, bw]."""
        nb, bw, _ = w.shape
        ub = u.reshape(*u.shape[:-1], nb, bw)
        return (torch.einsum("...nb,nbc->...nc", ub, w) + bias).reshape(u.shape)

    def _gates(self, u: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (a, gated input) of the recurrence, in u's dtype."""
        r = torch.sigmoid(self._block_diag(self.gate_a, self.gate_a_b, u))
        i = torch.sigmoid(self._block_diag(self.gate_x, self.gate_x_b, u))
        a = torch.exp(-RGLRU_C * F.softplus(self.lam.float()) * r.float())
        # sqrt(1 - a^2) input normalization keeps the state scale-invariant
        b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-9)) * (i.float() * u.float())
        return a.to(u.dtype), b.to(u.dtype)

    def _conv(self, u: torch.Tensor, conv_state: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Depthwise causal conv. u [B,S,w]; conv_state [B, W-1, w] (decode)."""
        W = self.conv_width
        if conv_state is not None:
            u_pad = torch.cat([conv_state.to(u.dtype), u], dim=1)
        else:
            u_pad = F.pad(u, (0, 0, W - 1, 0))
        S = u.shape[1]
        out = u_pad[:, 0:S] * self.conv_w[W - 1]
        for i in range(1, W):
            out = out + u_pad[:, i:i + S] * self.conv_w[W - 1 - i]
        return out + self.conv_b, u_pad[:, -(W - 1):]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Full-sequence block from zero state, no cache (``rglru_block``)."""
        gate = F.gelu(x @ self.w_in_gate, approximate="tanh")
        u, _ = self._conv(x @ self.w_in_rec)
        a, b = self._gates(u)
        hs, _ = lru_ops.linear_scan(a, b)
        return (hs * gate) @ self.w_out

    def prefill(self, x: torch.Tensor, state: State) -> torch.Tensor:
        """Full-sequence block; leaves the final recurrent and conv state."""
        gate = F.gelu(x @ self.w_in_gate, approximate="tanh")
        u, conv_state = self._conv(x @ self.w_in_rec)
        a, b = self._gates(u)
        hs, h_final = lru_ops.linear_scan(a, b)
        state["h"].copy_(h_final.float())
        state["conv"].copy_(conv_state)
        return (hs * gate) @ self.w_out

    def decode(self, x: torch.Tensor, state: State) -> torch.Tensor:
        """One token (x [B,1,d]); updates ``state`` in place."""
        gate = F.gelu(x @ self.w_in_gate, approximate="tanh")
        u, conv_state = self._conv(x @ self.w_in_rec, state["conv"])
        a, b = self._gates(u)
        h = a[:, 0].float() * state["h"] + b[:, 0].float()
        state["h"].copy_(h)
        state["conv"].copy_(conv_state)
        return (h[:, None].to(x.dtype) * gate) @ self.w_out
