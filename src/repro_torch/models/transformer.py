"""Decoder-only LM: embedding, mixed-mixer blocks, tied or separate head.

Counterpart of ``repro/models/transformer.py``. Three entry points share the
block code, as in the reference:
  * ``lm_loss`` / ``LM.forward`` -- training forward (cache-free, each
    pattern group of layers optionally rematerialized) and softmax xent;
  * ``LM.prefill`` -- forward that also fills the decode caches;
  * ``LM.decode_step`` -- one token against the caches.

The reference stacks each pattern position's parameters along a group axis
and runs ``lax.scan``; here every layer is its own module, in model order:
layer ``g * len(pattern) + i`` is group ``g``'s pattern position ``i``, and
the tail follows the last group.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts, noop_context_fn)

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, common, rglru, rwkv6
from repro_torch.models.attention import Attention
from repro_torch.models.mlp import MLP
from repro_torch.models.rglru import RGLRU
from repro_torch.models.rwkv6 import ChannelMix, TimeMix

Cache = Dict[str, Any]  # {"layers": [per-layer dict], "pos": int}
Materialize = Callable[[str, torch.Tensor], torch.Tensor]  # (state-dict name, tensor)


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for the families the port does not serve yet."""
    if cfg.is_encoder_decoder:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder models are not ported yet "
            "(ROADMAP.md queue A, models/encdec)")
    if cfg.is_moe:
        raise NotImplementedError(
            f"{cfg.name}: MoE models are not ported yet (ROADMAP.md queue A, models/moe)")
    if cfg.qk_norm or not cfg.use_rope:
        raise NotImplementedError(
            f"{cfg.name}: QK-norm and learned positions come with the families "
            "that use them (ROADMAP.md queue A)")


def init_decode_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                      device) -> Cache:
    """Zeroed caches for every layer, in model order, and position 0."""
    pattern = cfg.mixer_pattern
    layers: List[Dict[str, torch.Tensor]] = []
    for i in range(cfg.n_layers):
        mixer = pattern[i % len(pattern)]
        if mixer == "rglru":
            layers.append(rglru.init_rglru_state(cfg, batch, dtype, device))
        elif mixer == "rwkv":
            layers.append(rwkv6.init_rwkv_state(cfg, batch, dtype, device))
        else:
            layers.append(attention.init_kv_cache(
                cfg, batch, max_len, dtype, device, local=(mixer == "attn_local")))
    return {"layers": layers, "pos": 0}


class Block(nn.Module):
    """Pre-norm residual block: mixer (attention, RG-LRU or RWKV time mix),
    then MLP (the RWKV channel mix for ``rwkv``)."""

    def __init__(self, cfg: ModelConfig, mixer: str, device, dtype):
        super().__init__()
        d = cfg.d_model
        self.mixer = mixer
        self.norm1 = common.norm_init(cfg.norm_type, d, device, dtype)
        if mixer in ("attn", "attn_local"):
            self.attn = Attention(cfg, device, dtype, local=(mixer == "attn_local"))
        elif mixer == "rglru":
            self.rglru = RGLRU(cfg, device, dtype)
        elif mixer == "rwkv":
            self.tm = TimeMix(cfg, device, dtype)
        else:
            raise ValueError(f"unsupported mixer {mixer!r}")
        self.norm2 = common.norm_init(cfg.norm_type, d, device, dtype)
        if mixer == "rwkv":
            self.cm = ChannelMix(cfg, device, dtype)
        else:
            self.mlp = MLP(cfg, device, dtype)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        common.reset_norm_(self.norm1)
        if self.mixer == "rglru":
            self.rglru.reset_parameters(gen)
        elif self.mixer == "rwkv":
            self.tm.reset_parameters(gen)
        else:
            self.attn.reset_parameters(gen)
        common.reset_norm_(self.norm2)
        (self.cm if self.mixer == "rwkv" else self.mlp).reset_parameters(gen)

    def _time_mix(self, h, cache, carried: bool) -> torch.Tensor:
        """The rwkv mixer. Prefill starts from zero states, as the reference
        does whatever the cache holds; decode carries them. The WKV kernel
        writes the new state straight into the cache."""
        h, tm_shift, _ = self.tm(h, cache["tm_shift"] if carried else None,
                                 cache["wkv"] if carried else None, wkv_out=cache["wkv"])
        cache["tm_shift"].copy_(tm_shift)
        return h

    def _ffn(self, h, cache, carried: bool) -> torch.Tensor:
        if self.mixer != "rwkv":
            return self.mlp(h)
        h, cm_shift = self.cm(h, cache["cm_shift"] if carried else None)
        cache["cm_shift"].copy_(cm_shift)
        return h

    def forward(self, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        """Full sequence, no cache (``apply_block``; the MoE aux term is 0
        until MoE is ported)."""
        h = common.apply_norm(self.norm1, x)
        if self.mixer == "rglru":
            h = self.rglru(h)
        elif self.mixer == "rwkv":
            h, _, _ = self.tm(h)
        else:
            h = self.attn(h, positions)
        x = x + h
        h = common.apply_norm(self.norm2, x)
        h = self.cm(h)[0] if self.mixer == "rwkv" else self.mlp(h)
        return x + h

    def prefill(self, x, positions, cache) -> torch.Tensor:
        """Full sequence; fills ``cache``."""
        h = common.apply_norm(self.norm1, x)
        if self.mixer == "rglru":
            h = self.rglru.prefill(h, cache)
        elif self.mixer == "rwkv":
            h = self._time_mix(h, cache, carried=False)
        else:
            h = self.attn.prefill(h, positions, cache)
        x = x + h
        return x + self._ffn(common.apply_norm(self.norm2, x), cache, carried=False)

    def decode(self, x, pos: int, cache) -> torch.Tensor:
        h = common.apply_norm(self.norm1, x)
        if self.mixer == "rglru":
            h = self.rglru.decode(h, cache)
        elif self.mixer == "rwkv":
            h = self._time_mix(h, cache, carried=True)
        else:
            h = self.attn.decode(h, pos, cache)
        x = x + h
        return x + self._ffn(common.apply_norm(self.norm2, x), cache, carried=True)


class LM(nn.Module):
    """The whole decoder-only model; its parameters are the served weights."""

    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.embed = common.param((cfg.vocab_size, cfg.d_model), device, dtype)
        self.final_norm = common.norm_init(cfg.norm_type, cfg.d_model, device, dtype)
        if not cfg.tie_embeddings:
            self.unembed = common.param((cfg.d_model, cfg.vocab_size), device, dtype)
        pattern = cfg.mixer_pattern
        self.layers = nn.ModuleList(
            Block(cfg, pattern[i % len(pattern)], device, dtype)
            for i in range(cfg.n_layers)
        )

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        common.embed_init_(self.embed, gen)
        common.reset_norm_(self.final_norm)
        if not self.cfg.tie_embeddings:
            common.dense_init_(self.unembed, gen)
        for layer in self.layers:
            layer.reset_parameters(gen)

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self.embed[tokens]
        if self.cfg.embed_scale:
            x = x * torch.tensor(math.sqrt(self.cfg.d_model), dtype=x.dtype)
        return x

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        x = common.apply_norm(self.final_norm, x)
        if self.cfg.tie_embeddings:
            logits = x @ self.embed.T
        else:
            logits = x @ self.unembed
        c = self.cfg.final_softcap
        if c is not None:
            logits = c * torch.tanh(logits / c)
        return logits

    def forward(self, tokens: torch.Tensor, remat_policy: Optional[str] = "nothing",
                materialize: Optional[Materialize] = None) -> torch.Tensor:
        """Training / scoring forward (``lm_forward``): logits [B, S, V].

        With grad on, each pattern group of layers runs under ``remat_policy``
        (see ``_remat_context``); the tail layers never do, as in the
        reference. ``materialize(name, tensor)``, where given, replaces each
        layer parameter just before its layer runs (inside a rematerialized
        group, so again in the recompute); the sharded trainer gathers the
        group's weights there."""
        x = self._embed(tokens)
        positions = torch.arange(x.shape[1], device=x.device)
        p = len(self.cfg.mixer_pattern)
        n_groups, _ = self.cfg.n_groups_and_tail()
        remat = remat_policy not in (None, "none") and torch.is_grad_enabled()
        for g in range(n_groups):
            group = range(g * p, (g + 1) * p)
            if remat:
                x = _remat_group(self.layers, group, x, positions, remat_policy, materialize)
            else:
                for i in group:
                    x = _run_layer(self.layers, i, x, positions, materialize)
        for i in range(n_groups * p, len(self.layers)):
            x = _run_layer(self.layers, i, x, positions, materialize)
        return self._logits(x)

    def prefill(self, tokens: torch.Tensor, cache: Cache) -> torch.Tensor:
        """Process the prompt [B, S], fill ``cache``; last-token logits [B,1,V]."""
        x = self._embed(tokens)
        S = x.shape[1]
        positions = torch.arange(S, device=x.device)
        for layer, c in zip(self.layers, cache["layers"]):
            x = layer.prefill(x, positions, c)
        cache["pos"] = S
        return self._logits(x[:, -1:])

    def decode_step(self, tokens: torch.Tensor, cache: Cache) -> torch.Tensor:
        """One token per row (tokens [B, 1]); logits [B, 1, V]."""
        pos = cache["pos"]
        x = self._embed(tokens)
        for layer, c in zip(self.layers, cache["layers"]):
            x = layer.decode(x, pos, c)
        cache["pos"] = pos + 1
        return self._logits(x)


# ---------------------------------------------------------------------------
# Training: rematerialized groups and the loss
# ---------------------------------------------------------------------------

# ``_maybe_remat``'s policies: which results a rematerialized group keeps for
# the backward. "nothing" keeps none; the "dots" policies keep the matrix
# products -- all of them (mm, bmm), or those without batch dimensions (mm:
# every x @ W; the attention scores and block-diagonal gates are bmm).
_SAVED_OPS = {
    "dots": (torch.ops.aten.mm.default, torch.ops.aten.bmm.default),
    "dots_with_no_batch_dims": (torch.ops.aten.mm.default,),
}


def _save_ops_policy(ops, ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in ops else CheckpointPolicy.PREFER_RECOMPUTE


def _remat_context(policy: str):
    """The ``context_fn`` of ``torch.utils.checkpoint`` for ``policy``."""
    if policy == "nothing":
        return noop_context_fn
    if policy not in _SAVED_OPS:
        raise ValueError(f"unknown remat policy {policy!r}")
    return functools.partial(create_selective_checkpoint_contexts,
                             functools.partial(_save_ops_policy, _SAVED_OPS[policy]))


def _call_layer(layer: Block, index: int, params: Dict[str, torch.Tensor], x: torch.Tensor,
                positions: torch.Tensor, materialize: Optional[Materialize]) -> torch.Tensor:
    if materialize is not None:
        params = {n: materialize(f"layers.{index}.{n}", t) for n, t in params.items()}
    return functional_call(layer, params, (x, positions))


def _run_layer(layers: nn.ModuleList, index: int, x: torch.Tensor, positions: torch.Tensor,
               materialize: Optional[Materialize]) -> torch.Tensor:
    layer = layers[index]
    if materialize is None:
        return layer(x, positions)
    return _call_layer(layer, index, dict(layer.named_parameters()), x, positions, materialize)


def _remat_group(layers: nn.ModuleList, group: Sequence[int], x: torch.Tensor,
                 positions: torch.Tensor, policy: str,
                 materialize: Optional[Materialize] = None) -> torch.Tensor:
    """The layers ``group`` (indices into ``layers``) over x under
    ``torch.utils.checkpoint``.

    The layers' parameters go in as explicit inputs: the backward's recompute
    then sees the same tensors as the forward, also when ``lm_loss`` swapped
    in cast copies that are gone by then. ``materialize`` runs inside, so the
    recompute materializes the weights again."""
    names = [[n for n, _ in layers[i].named_parameters()] for i in group]
    flat = [t for i in group for _, t in layers[i].named_parameters()]

    def run(x, *tensors):
        k = 0
        for i, ns in zip(group, names):
            params = dict(zip(ns, tensors[k:k + len(ns)]))
            x = _call_layer(layers[i], i, params, x, positions, materialize)
            k += len(ns)
        return x

    return checkpoint(run, x, *flat, use_reentrant=False, context_fn=_remat_context(policy))


MOE_AUX_WEIGHT = 0.01


def lm_loss(lm: LM, batch: Dict[str, Any], *, remat_policy: Optional[str] = "nothing",
            compute_dtype: Optional[torch.dtype] = None,
            materialize: Optional[Materialize] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """batch: tokens [B,S], labels [B,S], optional mask -> (loss, metrics).

    ``compute_dtype`` casts the fp32/bf16 parameters inside the differentiated
    function (``functional_call`` on cast copies), so the gradients reach the
    master parameters through the cast. ``materialize(name, tensor)``
    replaces each parameter before that cast: the embedding, final norm and
    head at the start, a layer's just before it runs (``LM.forward``)."""
    if batch.get("prefix_embeds") is not None:
        raise NotImplementedError(
            f"{lm.cfg.name}: prefix_embeds (the frontends' prefix) are not "
            "ported yet (ROADMAP.md queue A2)")
    tokens = batch["tokens"]

    def prepare(name: str, p: torch.Tensor) -> torch.Tensor:
        if materialize is not None:
            p = materialize(name, p)
        if compute_dtype is not None and p.dtype in (torch.float32, torch.bfloat16):
            p = p.to(compute_dtype)
        return p

    if materialize is not None:
        outer = {n: prepare(n, p) for n, p in lm.named_parameters()
                 if not n.startswith("layers.")}
        logits = functional_call(lm, outer, (tokens,),
                                 {"remat_policy": remat_policy, "materialize": prepare})
    elif compute_dtype is None:
        logits = lm(tokens, remat_policy=remat_policy)
    else:
        params = {n: prepare(n, p) for n, p in lm.named_parameters()}
        logits = functional_call(lm, params, (tokens,), {"remat_policy": remat_policy})
    xent = common.softmax_xent(logits, batch["labels"], batch.get("mask"))
    aux = torch.zeros((), dtype=torch.float32, device=logits.device)  # no MoE yet
    loss = xent + MOE_AUX_WEIGHT * aux
    return loss, {"xent": xent, "moe_aux": aux}
