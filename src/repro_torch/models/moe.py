"""Mixture-of-Experts layer with capacity-based routing (``repro/models/moe.py``).

The reference routes through dense one-hots: a [G, g, k, E, C] transient,
a [G, g, E, C] dispatch/combine pair and einsums over them, a form GSPMD
shards over the expert axis. Here the same function is computed from
indices:

  * queue positions: a cumsum over a group's (token, slot) choices in
    k-major order, [G, k*g, E], read back at each choice's expert;
  * dispatch: a gather of each kept choice's token row into the expert
    buffer [E, G*C, d] (an empty slot reads a zero row);
  * the expert products: batched matmuls over the E experts;
  * combine: a gather of each choice's expert output row, weighted by its
    gate and summed over the k choices (a dropped choice has gate 0).

The reference's dispatch einsum sums exactly one nonzero term per slot, so
the gather equals it; its combine differs from this one in summation order
only.

Every routing rule of the reference is kept, since each one changes which
tokens an expert gets:
  * tokens are grouped in flattened [B, S] order, ``g = min(256, B*S)``
    lowered until it divides B*S (left padding routes like any token);
  * ``C = max(ceil(g*k/E * capacity_factor), 1)`` slots per expert and group
    (in decode, B*S = B, so C is small: qwen3-moe at B 4 has C = 1);
  * an fp32 softmax over the router logits, the top k (ties to the lower
    expert index, as ``jax.lax.top_k``), the k values renormalized;
  * k-major queues: every token's first choice queues before any second
    choice; a choice at queue position >= C is dropped;
  * the gates pass through bf16 before they scale the expert outputs, also
    when x is fp32;
  * the Switch aux loss ``E * mean_G sum_e f_e P_e``, f_e from the primary
    expert's one-hot before any drop, P_e the mean router probability.

``forward`` runs the four stages as the methods ``_route``, ``_dispatch``,
``_experts`` and ``_combine``, which a profiler can time one by one.

Expert parallelism (``parallel/tensor_parallel.py``, ``LayerAxis.moe``):
where the ``model`` axis divides E, a rank holds the block of experts
``[lo, hi)`` and ``forward(..., experts=(lo, hi))`` routes every token over
all E as one process does (the same choices, queue positions and drops),
keeps the choices of its own experts (``_local``: the block's rows of the
slot grid, [(hi-lo), G*C, d]; every other choice gets gate 0 and reads no
row) and returns the block's term of the output. Where the axis splits
``d_ff`` instead, every slot is dispatched and the rank's ff columns and
``w_down`` rows give its term; each gate's gradient is then a partial term
too, which the caller's ``gates`` sums over ``model`` before the bf16
rounding, as one process rounds the whole (rounding each rank's term apart
parts from it by about 2e-3 of the router's largest gradient). Either way
the terms are summed over ``model``: one all-reduce of [B, S, d] a layer,
or in training, where the residual stream's sequence splits over
``model``, a reduce-scatter of it after the rows were all-gathered along
the sequence (``LayerAxis.moe``): the module sees whole rows either way.
An all-to-all pair of the dispatch buffer in place of that gather and
reduce-scatter would move about k * capacity_factor times their bytes
(10x at qwen3-moe's top-8 and 1.25).

Weight-stationary serving (the reference's ``serve_2d``): where each
weight keeps its ``embed`` block on ``data``, ``forward(..., axis=hook)``
takes the hook ``LayerAxis.moe`` gives (its ``column``, ``columns`` and
``summed``, by leaf name). The router's logits are the rank's columns of
the tokens times its router block, summed over the block's axes, so
every rank routes every token as one process does; the dispatch gathers
only the rank's ``d/D`` columns of each slot's token row, [E_b, G*C, d/D];
``w_gate`` and ``w_up`` on their [E_b, d/D, ff] blocks give partial
pre-activations, summed (stacked: one sum) before the activation; and
``w_down`` on its [E_b, ff, d/D] block gives the rank's ``d/D`` columns
of the output, which the caller gathers. Without a hook every product is
the whole one.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common

DEFAULT_GROUP_SIZE = 256


class Route(NamedTuple):
    """Where each token's k choices go: top_vals, keep and slot are [T, k]."""
    top_vals: torch.Tensor  # renormalized fp32 gates
    keep: torch.Tensor      # False where capacity dropped the choice (or, after
                            # ``_local``, its expert lies outside the block)
    slot: torch.Tensor      # row of the slot grid (0 where not kept)
    n_slots: int            # the grid's rows: E * G * C (a block's: its E_b * G * C)
    aux: torch.Tensor       # the Switch load-balancing loss, fp32


def group_size_for(tokens: int, group_size: int = DEFAULT_GROUP_SIZE) -> int:
    """The routing group: at most ``group_size`` tokens, a divisor of ``tokens``."""
    g = min(group_size, tokens)
    while tokens % g:
        g -= 1
    return g


def bf16_gates(top_vals: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The gates passed through bf16 (the reference's bf16 combine), in
    ``dtype``; their gradient is rounded to bf16 on the way back."""
    return top_vals.to(torch.bfloat16).to(dtype)


def capacity(group: int, k: int, n_experts: int, factor: float) -> int:
    """Slots per expert and group."""
    return max(int(math.ceil(group * k / n_experts * factor)), 1)


class MoE(nn.Module):
    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
        self.n_experts, self.k = E, cfg.experts_per_token
        self.capacity_factor = cfg.moe_capacity_factor
        self.mlp_type = cfg.mlp_type
        self.router = common.param((d, E), device, dtype)
        self.w_up = common.param((E, d, ff), device, dtype)
        self.w_down = common.param((E, ff, d), device, dtype)
        if cfg.mlp_type in ("swiglu", "geglu"):
            self.w_gate = common.param((E, d, ff), device, dtype)

    def reset_parameters(self, gen: torch.Generator) -> None:
        common.dense_init_(self.router, gen)
        for name in ("w_up", "w_down", "w_gate"):
            if hasattr(self, name):
                common.dense_init_(getattr(self, name), gen, in_axis=1)

    def _logits(self, xt: torch.Tensor, axis=None) -> torch.Tensor:
        """The router's logits [T, E] in fp32 (the product in xt's dtype);
        ``axis``: the hook (``forward``) that takes the product."""
        w = self.router.to(xt.dtype)
        return (xt @ w if axis is None else axis.column(xt, w, "router")).float()

    def _route(self, xt: torch.Tensor, group_size: int, axis=None) -> Route:
        """Choices, queue positions and drops of the tokens xt [T, d];
        ``axis`` as in ``_logits``."""
        T, E, k = xt.shape[0], self.n_experts, self.k
        g = group_size_for(T, group_size)
        G = T // g
        C = capacity(g, k, E, self.capacity_factor)
        dev = xt.device
        probs = torch.softmax(self._logits(xt, axis), dim=-1)  # [T, E]
        # a stable descending sort keeps tied experts in index order
        top_vals, top_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
        top_vals, top_idx = top_vals[:, :k], top_idx[:, :k]
        top_vals = top_vals / top_vals.sum(-1, keepdim=True)
        # queue position of each choice: its group's choices counted k-major
        choice = top_idx.view(G, g, k).transpose(1, 2).reshape(G, k * g, 1)
        queued = torch.zeros(G, k * g, E, dtype=torch.int32, device=dev)
        queued.scatter_(2, choice, 1)
        pos = queued.cumsum(1, dtype=torch.int32).gather(2, choice) - 1
        pos = pos.view(G, k, g).transpose(1, 2).reshape(T, k)
        keep = pos < C
        group = torch.arange(T, device=dev) // g
        # each kept choice's row of the [E, G, C] slot grid; dropped: row 0
        slot = torch.where(keep, top_idx * (G * C) + group[:, None] * C + pos, 0)
        density = F.one_hot(top_idx[:, 0], E).float().view(G, g, E).mean(1)
        aux = E * (density * probs.view(G, g, E).mean(1)).sum(-1).mean()
        return Route(top_vals, keep, slot, E * G * C, aux)

    def _local(self, r: Route, lo: int, hi: int) -> Route:
        """The choices whose expert lies in ``[lo, hi)``, on that block's rows
        of the slot grid; every other choice is not kept (gate 0, row 0)."""
        per_expert = r.n_slots // self.n_experts  # G * C
        first = lo * per_expert
        mine = r.keep & (r.slot >= first) & (r.slot < hi * per_expert)
        return r._replace(keep=mine, slot=torch.where(mine, r.slot - first, 0),
                          n_slots=(hi - lo) * per_expert)

    def _dispatch(self, xt: torch.Tensor, r: Route) -> torch.Tensor:
        """Each slot's token row, [E, G*C, d] (the experts whose weights the
        module holds); an empty slot reads the zero row appended to xt.
        Choices not kept all write the discarded last entry of the
        slot-to-token map."""
        T, d = xt.shape
        token = torch.arange(T, device=xt.device).repeat_interleave(self.k)
        src = torch.full((r.n_slots + 1,), T, dtype=torch.long, device=xt.device)
        src.scatter_(0, torch.where(r.keep, r.slot, r.n_slots).reshape(-1), token)
        return F.pad(xt, (0, 0, 0, 1))[src[:r.n_slots]].view(len(self.w_up), -1, d)

    def _experts(self, xe: torch.Tensor, axis=None) -> torch.Tensor:
        """Each expert's MLP over its slots: [E, n, d] -> [E*n, d]; with the
        hook ``axis``, the pre-activations summed over the ``embed`` block's
        axes first (gate and up stacked: one sum)."""
        up = torch.bmm(xe, self.w_up)
        if self.mlp_type in ("swiglu", "geglu"):
            gate = torch.bmm(xe, self.w_gate)
            if axis is not None:
                gate, up = axis.summed(torch.stack([gate, up]), "w_up").unbind(0)
        elif axis is not None:
            up = axis.summed(up, "w_up")
        if self.mlp_type == "swiglu":
            h = F.silu(gate) * up
        elif self.mlp_type == "geglu":
            h = F.gelu(gate, approximate="tanh") * up
        else:
            h = F.gelu(up, approximate="tanh")
        return torch.bmm(h, self.w_down).flatten(0, 1)

    def _combine(self, expert_out: torch.Tensor, r: Route,
                 gates: Callable = bf16_gates) -> torch.Tensor:
        """Each token's k expert rows weighted by their bf16-rounded gates
        (0 where dropped) and summed: [T, d]."""
        gate = gates(r.top_vals, expert_out.dtype) * r.keep
        return torch.bmm(gate.unsqueeze(1), expert_out[r.slot]).squeeze(1)

    def forward(self, x: torch.Tensor, group_size: int = DEFAULT_GROUP_SIZE,
                experts: Optional[Tuple[int, int]] = None, gates: Callable = bf16_gates,
                axis=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [B, S, d] -> (out [B, S, d], aux loss, an fp32 scalar).
        ``experts`` (lo, hi): the module holds experts ``[lo, hi)`` only (its
        expert weights are their block); out is then their term of the
        output, the aux loss still the whole one. ``gates(top_vals, dtype)``:
        the gates' bf16 rounding (:func:`bf16_gates`). ``axis``: where the
        weights keep their ``embed`` block, the hook that takes the products
        with it (see the module's docstring); out is then the rank's block
        of columns [B, S, d/D]."""
        xt = x.reshape(-1, x.shape[-1])
        r = self._route(xt, group_size, axis)
        if experts is not None:
            r = self._local(r, *experts)
        if axis is not None:
            xt = axis.columns(xt, "w_up")
        out = self._combine(self._experts(self._dispatch(xt, r), axis), r, gates)
        return out.view(*x.shape[:-1], out.shape[-1]), r.aux
