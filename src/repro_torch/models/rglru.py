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

Under ``serve_2d`` (``rnn`` over ``("data", "model")``) the layer serves on
its layout at rest: no weight and no state entry moves, only activations.
``conv_w``, ``conv_b``, ``lam``, ``w_out``'s rows and the state lie on the
rank's chunk ``c = d M + m`` of the ``D M`` chunks of the channels, and
``w_in_rec`` and ``w_in_gate`` on their (``embed`` block x ``model`` block).
``prefill`` and ``decode`` then take the layer's hook (``axis``,
``tensor_parallel._RnnAxis``): the two input products on the rank's columns
of x, summed over ``data`` (the ``model`` block), taken to the chunk by one
all-to-all over ``model``; the conv and the recurrence on the chunk (the
scan on [B, S, w/DM]); the gates' columns of the chunk, their input the
chunk's gate block gathered over the ranks that hold it (nothing moves where
a chunk spans whole blocks); and ``w_out``'s rows give a term the layer sums
over ``data`` and ``model``. Where that layout does not apply (``D M`` does
not divide the width, ``model`` the gate blocks, a chunk straddles a block's
edge, or the rows lie on ``data``, as under ``fsdp_tp``), the weights and
the state are gathered to the ``model`` block above.
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
        """u [..., nb bw] through the block-diagonal linear w [nb, bw, c]
        (c = bw, or a chunk's columns of one block) -> [..., nb c]."""
        nb, bw, _ = w.shape
        ub = u.reshape(*u.shape[:-1], nb, bw)
        return (torch.einsum("...nb,nbc->...nc", ub, w) + bias).reshape(*u.shape[:-1], -1)

    def _inputs(self, x: torch.Tensor, axis=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """(GeLU gate branch, recurrent input) of the two input products;
        with ``axis``, on the rank's chunk: the rank's columns of x times its
        blocks of ``w_in_gate`` and ``w_in_rec``, stacked, summed over the
        ``embed`` block's axes and taken to the chunk (``_RnnAxis.own``)."""
        if axis is None:
            return F.gelu(x @ self.w_in_gate, approximate="tanh"), x @ self.w_in_rec
        xc = axis.columns(x, "w_in_rec")
        both = axis.own(axis.summed(torch.stack([xc @ self.w_in_gate, xc @ self.w_in_rec]),
                                    "w_in_rec"))
        return F.gelu(both[0], approximate="tanh"), both[1]

    def _gates(self, u: torch.Tensor, axis=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (a, gated input) of the recurrence, in u's dtype; with ``axis``,
        from the gates' columns of the rank's chunk (``_RnnAxis.gates``)."""
        ub, (ga, gab, gx, gxb) = u, (self.gate_a, self.gate_a_b, self.gate_x, self.gate_x_b)
        if axis is not None:
            ub, (ga, gab, gx, gxb) = axis.gates(u, (ga, gab, gx, gxb))
        r = torch.sigmoid(self._block_diag(ga, gab, ub))
        i = torch.sigmoid(self._block_diag(gx, gxb, ub))
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
        gate, u = self._inputs(x)
        u, _ = self._conv(u)
        a, b = self._gates(u)
        hs, _ = lru_ops.linear_scan(a, b)
        return (hs * gate) @ self.w_out

    def prefill(self, x: torch.Tensor, state: State, axis=None) -> torch.Tensor:
        """Full-sequence block; leaves the final recurrent and conv state.
        ``axis``: the layer's hook where it serves on its chunk of the
        channels (module docstring); the output is then the rank's term."""
        gate, u = self._inputs(x, axis)
        u, conv_state = self._conv(u)
        a, b = self._gates(u, axis)
        hs, h_final = lru_ops.linear_scan(a, b)
        state["h"].copy_(h_final.float())
        state["conv"].copy_(conv_state)
        return (hs * gate) @ self.w_out

    def decode(self, x: torch.Tensor, state: State, axis=None) -> torch.Tensor:
        """One token (x [B,1,d]); updates ``state`` in place. ``axis`` as in
        :meth:`prefill`."""
        gate, u = self._inputs(x, axis)
        u, conv_state = self._conv(u, state["conv"])
        a, b = self._gates(u, axis)
        h = a[:, 0].float() * state["h"] + b[:, 0].float()
        state["h"].copy_(h)
        state["conv"].copy_(conv_state)
        return (h[:, None].to(x.dtype) * gate) @ self.w_out
