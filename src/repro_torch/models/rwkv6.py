"""RWKV-6 (Finch) block: time-mix (WKV recurrence) + channel-mix.

Counterpart of ``repro/models/rwkv6.py`` (arXiv:2404.05892): static
token-shift interpolation weights for r/k/v/g, and the data-dependent decay
w from a low-rank projection. The WKV recurrence runs through the CUDA
kernel on the card, in prefill and in every decode step (T = 1 with the
carried state). Called with no states, ``TimeMix`` and ``ChannelMix`` are
the reference's cache-free ``time_mix`` and ``channel_mix`` (training);
there the WKV op differentiates its chunked twin, as the reference does.
Decode state per layer: two shift vectors in the cache dtype and the
per-head K x V state in fp32.

The casts are the reference's, including its one to watch: the decay is
computed in fp32 and cast to the activation dtype before the recurrence.

Both mixers split along the ``model`` axis in sharded serving and
training (``parallel/tensor_parallel.py``); the code is the same, each
weight's shape says the width. The time mix on a rank's contiguous block of heads
holds that block's columns of ``w_r``/``w_k``/``w_v``/``w_g`` and of
``decay_b``, its entries of ``decay_base`` and ``out_norm``, its rows of
``bonus`` and of ``w_o``; WKV and the per-head group norm run on those
heads (in serving against the state's block), and the output is the rank's term of a
sum over ``model``. The channel mix on a rank's ``d_ff`` block holds
``w_k``'s columns and ``w_v``'s rows of it, and its block of ``w_r``'s
columns: :meth:`ChannelMix.parts` gives the rank's value term (a partial
sum over ``model``) and its block of the receptance. In training the
gradients come back the same way: each block's gradient is the rank's own
(gathered over ``model`` into a weight that lies whole at rest), and the
``mu_*`` and ``decay_a`` gradients, from the whole input on every rank,
are partial terms summed over ``model``; the WKV op trains through its
chunked twin on the rank's heads, the reference's training path.

Weight-stationary serving (the reference's ``serve_2d``): where the
mixers' weights keep their ``embed`` block on ``data``, ``TimeMix.forward``
and ``ChannelMix.parts`` take the hook ``LayerAxis.hook`` gives
(``column`` and ``row``, by leaf name). Each column product (the time
mix's ``w_r``, ``w_k``, ``w_g`` and ``decay_a``, the channel mix's ``w_k``
and ``w_r``) is the rank's ``embed`` block of the mixed stream's columns
times its (embed block x model block), summed over ``data``; each ``w_v``
(its rows the rank's ``model`` block, its columns its ``embed`` block)
gives the rank's ``model`` block of the output's columns, summed over
``model`` and then over ``data`` (``ModelAxis.row``). So r, k, v, g and
the decay reach WKV on the rank's heads as before, and the channel mix's
value and receptance cover the same block of columns. ``decay_b``, whose
``embed`` dim is also the heads' dim, is the one RWKV-6 weight still
gathered over ``data``. Without the hook every product is the whole one.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.rwkv6 import ops as wkv_ops
from repro_torch.models import common

DECAY_LORA = 64

State = Dict[str, torch.Tensor]


def init_rwkv_state(cfg: ModelConfig, batch: int, dtype, device) -> State:
    d = cfg.d_model
    K = cfg.rwkv_head_dim
    H = d // K
    return {"tm_shift": torch.zeros((batch, d), dtype=dtype, device=device),
            "wkv": torch.zeros((batch, H, K, K), dtype=torch.float32, device=device),
            "cm_shift": torch.zeros((batch, d), dtype=dtype, device=device)}


def _shift(x: torch.Tensor, prev: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token shift: x_{t-1} (zeros / carried state at t=0). x [B,S,d]."""
    if x.shape[1] == 1 and prev is not None:
        return prev[:, None, :]
    shifted = F.pad(x, (0, 0, 1, 0))[:, :-1]
    if prev is not None:
        shifted[:, 0] = prev
    return shifted


def _mix(x, x_prev, mu):
    return x + (x_prev - x) * mu


def _column(x: torch.Tensor, w: torch.Tensor, axis, leaf: str) -> torch.Tensor:
    """The column product ``x @ w``; with the weight-stationary hook
    ``axis``, its ``column`` (the rank's ``embed`` block of x's columns
    times w, summed over the block's axes)."""
    return x @ w if axis is None else axis.column(x, w, leaf)


def _row(x: torch.Tensor, w: torch.Tensor, axis, leaf: str) -> torch.Tensor:
    """The product ``x @ w`` with a ``w_v``; with the hook, its ``row`` (the
    rank's ``model`` block of the output's columns, summed)."""
    return x @ w if axis is None else axis.row(x, w, leaf)


def _group_norm(scale: torch.Tensor, y: torch.Tensor, H: int) -> torch.Tensor:
    """Per-head normalization of the WKV output. y [B,S,d]."""
    B, S, d = y.shape
    yh = y.reshape(B, S, H, d // H).float()
    mu = yh.mean(dim=-1, keepdim=True)
    var = yh.var(dim=-1, keepdim=True, unbiased=False)
    yh = (yh - mu) * torch.rsqrt(var + 1e-5)
    return (yh.reshape(B, S, d) * (1.0 + scale.float())).to(y.dtype)


class TimeMix(nn.Module):
    """Parameters as ``init_rwkv_time_mix``; ``forward`` is ``time_mix``."""

    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        d = cfg.d_model
        K = cfg.rwkv_head_dim
        self.d, self.H, self.K = d, d // K, K
        lora = min(DECAY_LORA, d // 2)
        for name in ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g", "decay_base", "out_norm"):
            setattr(self, name, common.param((d,), device, dtype))
        for name in ("w_r", "w_k", "w_v", "w_g", "w_o"):
            setattr(self, name, common.param((d, d), device, dtype))
        self.decay_a = common.param((d, lora), device, dtype)
        self.decay_b = common.param((lora, d), device, dtype)
        self.bonus = common.param((self.H, K), device, dtype)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        for name in ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g"):
            getattr(self, name).fill_(0.5)
        for name in ("w_r", "w_k", "w_v", "w_g", "w_o"):
            common.dense_init_(getattr(self, name), gen)
        self.decay_base.copy_(torch.linspace(-6.0, -0.5, self.d))
        common.dense_init_(self.decay_a, gen)
        common.dense_init_(self.decay_b, gen)
        self.decay_b.mul_(0.1)
        common.dense_init_(self.bonus, gen)
        self.out_norm.zero_()

    def _decay(self, xw: torch.Tensor, axis=None) -> torch.Tensor:
        """w_t = exp(-exp(clip(w0 + tanh(x W_a) W_b))), in fp32, in (0, 1)."""
        lo = torch.tanh(_column(xw, self.decay_a, axis, "decay_a")) @ self.decay_b
        log_w = -torch.exp(torch.clamp(self.decay_base.float() + lo.float(), -10.0, 2.0))
        return torch.exp(log_w)

    def forward(self, x: torch.Tensor, shift_state: Optional[torch.Tensor] = None,
                wkv_state: Optional[torch.Tensor] = None,
                wkv_out: Optional[torch.Tensor] = None, axis=None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """x [B,S,d] -> (out, new shift state [B,d], new WKV state [B,H,K,K]).
        The new WKV state is written into ``wkv_out`` when given (it may be
        ``wkv_state`` itself). H is ``bonus``'s: a rank's heads where the
        weights are its blocks. ``axis``: where they keep their ``embed``
        block too, the hook that takes the products with it (see the
        module's docstring)."""
        B, S, _ = x.shape
        H, K = self.bonus.shape[0], self.K
        x_prev = _shift(x, shift_state)
        r = _column(_mix(x, x_prev, self.mu_r), self.w_r, axis, "w_r")
        k = _column(_mix(x, x_prev, self.mu_k), self.w_k, axis, "w_k")
        v = _row(_mix(x, x_prev, self.mu_v), self.w_v, axis, "w_v")
        g = F.silu(_column(_mix(x, x_prev, self.mu_g), self.w_g, axis, "w_g"))
        w = self._decay(_mix(x, x_prev, self.mu_w), axis).to(x.dtype)
        y, new_state = wkv_ops.wkv(r.reshape(B, S, H, K), k.reshape(B, S, H, K),
                                   v.reshape(B, S, H, K), w.reshape(B, S, H, K),
                                   self.bonus, wkv_state, out=wkv_out)
        y = _group_norm(self.out_norm, y.reshape(B, S, H * K), H)
        return (y * g) @ self.w_o, x[:, -1, :], new_state


class ChannelMix(nn.Module):
    """Parameters as ``init_rwkv_channel_mix``; ``forward`` is ``channel_mix``."""

    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        d, ff = cfg.d_model, cfg.d_ff
        self.mu_k = common.param((d,), device, dtype)
        self.mu_r = common.param((d,), device, dtype)
        self.w_k = common.param((d, ff), device, dtype)
        self.w_v = common.param((ff, d), device, dtype)
        self.w_r = common.param((d, d), device, dtype)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        self.mu_k.fill_(0.5)
        self.mu_r.fill_(0.5)
        for p in (self.w_k, self.w_v, self.w_r):
            common.dense_init_(p, gen)

    def parts(self, x: torch.Tensor, shift_state: Optional[torch.Tensor] = None, axis=None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """x [B,S,d] -> (the value term [B,S,d], the receptance
        ``sigmoid(x_r @ w_r)``, new shift state [B,d]); the output is their
        product. On a rank's ``d_ff`` block the value term is its term of a
        sum over ``model`` and the receptance its block of columns. With the
        weight-stationary hook ``axis`` both are the rank's ``model`` block
        of the columns, the value summed (see the module's docstring)."""
        x_prev = _shift(x, shift_state)
        k = _column(_mix(x, x_prev, self.mu_k), self.w_k, axis, "w_k")
        v = _row(torch.square(F.relu(k)), self.w_v, axis, "w_v")
        r = torch.sigmoid(_column(_mix(x, x_prev, self.mu_r), self.w_r, axis, "w_r"))
        return v, r, x[:, -1, :]

    def forward(self, x: torch.Tensor, shift_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [B,S,d] -> (out, new shift state [B,d])."""
        v, r, shift = self.parts(x, shift_state)
        return r * v, shift
