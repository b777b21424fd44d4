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

A frontend's ``prefix_embeds`` [B, P, d] (internvl2's image tile) go before
the token embeddings, cast to their dtype, as the reference's
``_embed_tokens`` does: positions run 0..P+S-1, a prefill leaves ``pos`` at
P+S, and ``lm_loss`` drops the prefix's logits before the cross-entropy.
"""

from __future__ import annotations

import contextlib
import functools
import math
import os
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.func import functional_call
from torch.nn.utils.stateless import _reparametrize_module
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts, noop_context_fn)

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, common, rglru, rwkv6
from repro_torch.models.attention import Attention
from repro_torch.models.mlp import MLP
from repro_torch.models.moe import MoE
from repro_torch.models.rglru import RGLRU
from repro_torch.models.rwkv6 import ChannelMix, TimeMix

Cache = Dict[str, Any]  # {"layers": [per-layer dict], "pos": int}
# (state-dict name, tensor) -> the tensor to compute with; a sharded step's hook
# also takes ``dtype=``: cast the block before it moves (REPRO_CAST_BARRIER)
Materialize = Callable[..., torch.Tensor]
# (layer index, the layer's cache) -> a context giving the dict the layer
# reads and writes (the sharded path's rows, written back on exit)
LayerCache = Callable[[int, Dict[str, torch.Tensor]], Any]
ModelAxis = Any  # parallel.tensor_parallel.ModelAxis: the sharded model split


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
    then MLP (the RWKV channel mix for ``rwkv``, the experts for MoE configs)."""

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
        elif cfg.is_moe:
            self.moe = MoE(cfg, device, dtype)
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
        for name in ("cm", "moe", "mlp"):
            if hasattr(self, name):
                getattr(self, name).reset_parameters(gen)

    def _time_mix(self, h, cache, carried: bool, axis=None) -> torch.Tensor:
        """The rwkv mixer. Prefill starts from zero states, as the reference
        does whatever the cache holds; decode carries them. The WKV kernel
        writes the new state straight into the cache. On a rank's heads
        (sharded serving: ``cache["wkv"]`` is the state's block on them)
        the output is the rank's term of a sum over ``model``; where the
        time mix's weights keep their ``embed`` block, the layer's
        ``axis`` gives the hook that takes its products with it
        (``LayerAxis.hook``)."""
        h, tm_shift, _ = self.tm(h, cache["tm_shift"] if carried else None,
                                 cache["wkv"] if carried else None, wkv_out=cache["wkv"],
                                 axis=None if axis is None else axis.hook("tm"))
        cache["tm_shift"].copy_(tm_shift)
        return h

    def _ffn(self, h, cache, carried: bool, axis=None) -> torch.Tensor:
        """The block's second half; serving drops the MoE aux term. Sharded
        serving (``axis``) routes the MoE's tokens in the global batch's
        groups and computes the rank's experts, their term summed over
        ``model`` (``LayerAxis.moe``), and the channel mix on the rank's
        ``d_ff`` block where it splits (``LayerAxis.channel_mix``, also on
        its ``embed`` block where that stays)."""
        if hasattr(self, "moe"):
            return self.moe(h)[0] if axis is None else axis.moe(self.moe, h)
        if self.mixer != "rwkv":
            return self.mlp(h, axis)
        shift = cache["cm_shift"] if carried else None
        if axis is not None and axis.cm_sum:
            h, cm_shift = axis.channel_mix(self.cm, h, shift)
        else:
            h, cm_shift = self.cm(h, shift)
        cache["cm_shift"].copy_(cm_shift)
        return h

    def forward(self, x: torch.Tensor, positions: torch.Tensor, axis=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full sequence, no cache (``apply_block``): (x, MoE aux term), the
        aux term an fp32 scalar, 0 without experts. ``axis``: the layer's
        ``tensor_parallel.LayerAxis`` in sharded training, which splits the
        attention, the dense MLP, the RG-LRU's channels and the MoE's
        experts along ``model`` and routes the MoE's tokens in the global
        batch's groups (``LayerAxis.moe``), and the RWKV-6 time mix's heads
        and channel mix's ``d_ff``, as serving splits them. Where it splits
        the stream's sequence, x is the rank's block of positions [B, S'/M, d]
        (``positions`` the whole stream's): the norms and residual adds run
        on it, and each sub-block's normed input is gathered along the
        sequence, its output reduce-scattered (a split product), moved to
        the rank's positions by one all-to-all (the RWKV-6 channel mix's
        column blocks) or sliced to the rank's block (a layer the axis does
        not divide)."""
        x = x + self.mix(common.apply_norm(self.norm1, x), positions, axis)
        h, aux = self.feed_forward(common.apply_norm(self.norm2, x), axis)
        return x + h, aux

    def mix(self, h: torch.Tensor, positions: torch.Tensor, axis=None) -> torch.Tensor:
        """``forward``'s first half on the ``norm1``-normed stream: the mixer's
        output, the rank's block of it where the sequence splits."""
        if self.mixer == "rglru":
            return _summed(self.rglru(_split_in(h, axis, "rglru_sum")), axis, "rglru_sum")
        if self.mixer == "rwkv":
            return _summed(self.tm(_split_in(h, axis, "tm_sum"))[0], axis, "tm_sum")
        h = _split_in(h, axis, "attn_sum")
        return _summed(self.attn(h, positions, axis=axis), axis, "attn_sum")

    def feed_forward(self, h: torch.Tensor, axis=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """``forward``'s second half on the ``norm2``-normed stream: (output,
        MoE aux term). The RWKV-6 channel mix on the rank's ``d_ff`` block
        ends in its own collectives (``LayerAxis.channel_mix``): its output
        is the rank's block of positions where the sequence splits."""
        aux = h.new_zeros((), dtype=torch.float32)
        if self.mixer == "rwkv":
            if axis is not None and axis.cm_sum:
                return axis.channel_mix(self.cm, _split_in(h, axis, "cm_sum"))[0], aux
            return _summed(self.cm(_split_in(h, axis))[0], axis), aux
        if hasattr(self, "moe"):
            return self.moe(h) if axis is None else axis.moe(self.moe, h, with_aux=True)
        return _summed(self.mlp(_split_in(h, axis, "mlp_sum"), axis), axis, "mlp_sum"), aux

    def prefill(self, x, positions, cache, axis=None) -> torch.Tensor:
        """Full sequence; fills ``cache``. ``axis``: the layer's
        ``tensor_parallel.LayerAxis`` in sharded serving, which splits the
        attention, the dense MLP, the RG-LRU's channels (``cache`` then holds
        the rank's block of the state; under ``serve_2d`` its ``(data,
        model)`` chunk, with the layer's hook, ``LayerAxis.hook``), the
        RWKV-6 time mix's heads (the WKV state's block on them) and channel
        mix's ``d_ff``, and the MoE's experts along ``model``."""
        h = common.apply_norm(self.norm1, x)
        if self.mixer == "rglru":
            h = _summed(self.rglru.prefill(_split_in(h, axis, "rglru_sum"), cache,
                                           None if axis is None else axis.hook("rglru")),
                        axis, "rglru_sum")
        elif self.mixer == "rwkv":
            h = _summed(self._time_mix(_split_in(h, axis, "tm_sum"), cache, carried=False,
                                       axis=axis), axis, "tm_sum")
        else:
            h = _summed(self.attn.prefill(h, positions, cache, axis), axis, "attn_sum")
        x = x + h
        h = self._ffn(common.apply_norm(self.norm2, x), cache, carried=False, axis=axis)
        return x + _summed(h, axis, "mlp_sum")

    def decode(self, x, pos: int, cache, axis=None) -> torch.Tensor:
        h = common.apply_norm(self.norm1, x)
        if self.mixer == "rglru":
            h = _summed(self.rglru.decode(_split_in(h, axis, "rglru_sum"), cache,
                                          None if axis is None else axis.hook("rglru")),
                        axis, "rglru_sum")
        elif self.mixer == "rwkv":
            h = _summed(self._time_mix(_split_in(h, axis, "tm_sum"), cache, carried=True,
                                       axis=axis), axis, "tm_sum")
        else:
            h = _summed(self.attn.decode(h, pos, cache, axis), axis, "attn_sum")
        x = x + h
        h = self._ffn(common.apply_norm(self.norm2, x), cache, carried=True, axis=axis)
        return x + _summed(h, axis, "mlp_sum")


def _summed(h: torch.Tensor, axis, which: Optional[str] = None) -> torch.Tensor:
    """A sub-block's output: a row-parallel product's summed over ``model``
    where the layer's contracted dim was split (``LayerAxis.attn_sum`` /
    ``mlp_sum`` / ``rglru_sum`` / ``tm_sum``: ``ModelAxis.from_split``),
    else, computed whole, the rank's positions where the stream's sequence
    splits (``ModelAxis.own``); in serving, where the row weight keeps its
    ``embed`` block, the rank's block of columns then gathered to the whole
    stream (``LayerAxis.out``)."""
    return h if axis is None else axis.out(h, which)


def _split_in(h: torch.Tensor, axis, which: Optional[str] = None) -> torch.Tensor:
    """A sub-block's input: a column-parallel product's where the layer
    splits, its gradient summed over ``model`` (``ModelAxis.to_split``),
    else the whole stream where its sequence splits (``ModelAxis.gather``);
    both all-gather the rank's block where the sequence splits."""
    if axis is None:
        return h
    return axis.axis.to_split(h) if which and getattr(axis, which) else axis.axis.gather(h)


class LM(nn.Module):
    """The whole decoder-only model; its parameters are the served weights."""

    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
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

    def _embed(self, tokens: torch.Tensor,
               prefix_embeds: Optional[torch.Tensor] = None,
               model_axis: Optional[ModelAxis] = None) -> torch.Tensor:
        """Token embeddings (scaled where the config says), after the prefix.
        Where ``model_axis`` splits the vocabulary, ``embed`` holds this rank's
        rows: it looks up the tokens in its range, zeros for the others, and
        the rows are summed over ``model`` (each term scaled first: all but
        one are 0, so the sum is the same). Where it splits the stream's
        sequence, the result is the rank's block of positions: the sum
        reduce-scattered, the prefix going in before it in rank 0's term
        (the sum adds it once); an unsplit lookup is sliced
        (``ModelAxis.own``). In serving, where ``embed`` keeps its ``embed``
        block (``ModelAxis.stationary``), the rank's rows give its block of
        the columns, summed over ``model`` and all-gathered over the block's
        axes (the scale applied once, on each block)."""
        split = None if model_axis is None else model_axis.split("embed")
        x = lookup(self.embed, tokens, split)
        if self.cfg.embed_scale:
            x = x * torch.tensor(math.sqrt(self.cfg.d_model), dtype=x.dtype)
        seq = model_axis is not None and model_axis.seq is not None
        if split is not None and not seq:
            x = model_axis.from_split(x)
        if model_axis is not None:  # serving: the rank's embed block gathered where it stays
            x = model_axis.whole(x, "embed")
        if prefix_embeds is not None:
            prefix = prefix_embeds.to(x.dtype)
            if split is not None and seq and model_axis.coord["model"] != 0:
                prefix = torch.zeros_like(prefix)
            x = torch.cat([prefix, x], dim=1)
        if seq:
            x = model_axis.own(x) if split is None else model_axis.from_split(x)
        return x

    def _logits(self, x: torch.Tensor, model_axis: Optional[ModelAxis] = None
                ) -> torch.Tensor:
        """The head; where ``model_axis`` splits the vocabulary, the head's
        weight is this rank's vocab block and so are the logits, over the
        whole stream (the final-normed blocks gathered where its sequence
        splits); an unsplit head there reads the rank's positions only. In
        serving, where the head's weight keeps its ``embed`` block, the
        logits are the rank's partial product summed over the block's axes
        (``ModelAxis.column``), before the final softcap."""
        x = common.apply_norm(self.final_norm, x)
        if model_axis is not None and model_axis.head is not None:
            x = model_axis.to_split(x)
        name = "embed" if self.cfg.tie_embeddings else "unembed"
        w = self.embed.T if self.cfg.tie_embeddings else self.unembed
        logits = x @ w if model_axis is None else model_axis.column(x, w, name)
        c = self.cfg.final_softcap
        if c is not None:
            logits = c * torch.tanh(logits / c)
        return logits

    def forward(self, tokens: torch.Tensor, remat_policy: Optional[str] = "nothing",
                materialize: Optional[Materialize] = None,
                prefix_embeds: Optional[torch.Tensor] = None,
                model_axis: Optional[ModelAxis] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Training / scoring forward (``lm_forward``): (logits [B, P+S, V],
        the MoE aux term summed over the groups, then the tail).

        With grad on, each pattern group of layers runs under ``remat_policy``
        (see ``_remat_context``); the tail layers never do, as in the
        reference. ``materialize(name, tensor)``, where given, replaces each
        layer parameter just before its layer runs (inside a rematerialized
        group, so again in the recompute); the sharded trainer gathers the
        group's weights there. ``model_axis`` as in ``prefill``: the logits
        are then this rank's vocab block where the head splits. Where it
        splits the stream's sequence, the stream between the layers, and so
        each group's input that remat keeps, is the rank's block
        [B, (P+S)/M, d] (``Block.forward``)."""
        x = self._embed(tokens, prefix_embeds, model_axis)
        n_prefix = 0 if prefix_embeds is None else prefix_embeds.shape[1]
        positions = torch.arange(n_prefix + tokens.shape[1], device=x.device)
        p = len(self.cfg.mixer_pattern)
        n_groups, _ = self.cfg.n_groups_and_tail()
        remat = remat_policy not in (None, "none") and torch.is_grad_enabled()
        aux = x.new_zeros((), dtype=torch.float32)
        for g in range(n_groups):
            group = range(g * p, (g + 1) * p)
            if remat:
                x, a = _remat_group(self.layers, group, x, positions, remat_policy,
                                    materialize, model_axis)
            else:
                x, a = _run_group(self.layers, group, x, positions, materialize, model_axis)
            aux = aux + a
        for i in range(n_groups * p, len(self.layers)):
            x, a = _run_layer(self.layers, i, x, positions, materialize, model_axis)
            aux = aux + a
        return self._logits(x, model_axis), aux

    def prefill(self, tokens: torch.Tensor, cache: Cache,
                prefix_embeds: Optional[torch.Tensor] = None,
                materialize: Optional[Materialize] = None,
                layer_cache: Optional[LayerCache] = None,
                model_axis: Optional[ModelAxis] = None) -> torch.Tensor:
        """Process the prompt [B, S] after ``prefix_embeds`` [B, P, d], fill
        ``cache``; last-token logits [B,1,V]. ``materialize`` as in
        ``forward``; ``layer_cache(i, c)``, where given, is entered around
        layer i with its cache ``c`` and gives the dict the layer fills;
        ``model_axis`` (``parallel/tensor_parallel.py``), where given, splits
        the embedding, attention, the dense MLP and the head along ``model``
        (the weights ``materialize`` gives are this rank's blocks of them, and
        the logits are its vocab block). The prefix is whole on every rank."""
        x = self._embed(tokens, prefix_embeds, model_axis)
        S = x.shape[1]
        positions = torch.arange(S, device=x.device)
        for i, c in enumerate(cache["layers"]):
            with _cache_for(layer_cache, i, c) as c:
                x = _run_method(self.layers, i, "prefill", materialize, x, positions, c,
                                _layer_axis(model_axis, i))
        cache["pos"] = S
        return self._logits(x[:, -1:], model_axis)

    def decode_step(self, tokens: torch.Tensor, cache: Cache,
                    materialize: Optional[Materialize] = None,
                    layer_cache: Optional[LayerCache] = None,
                    model_axis: Optional[ModelAxis] = None) -> torch.Tensor:
        """One token per row (tokens [B, 1]); logits [B, 1, V]. The hooks as
        in ``prefill``."""
        pos = cache["pos"]
        x = self._embed(tokens, model_axis=model_axis)
        for i, c in enumerate(cache["layers"]):
            with _cache_for(layer_cache, i, c) as c:
                x = _run_method(self.layers, i, "decode", materialize, x, pos, c,
                                _layer_axis(model_axis, i))
        cache["pos"] = pos + 1
        return self._logits(x, model_axis)


def lookup(embed: torch.Tensor, tokens: torch.Tensor, split=None) -> torch.Tensor:
    """``embed[tokens]``; where ``split`` (``sharding.Split``) says that
    ``embed`` holds the rank's vocab rows ``[lo, hi)``, the rows of the tokens
    in that range and zeros for the others: the rank's term of the
    vocab-parallel lookup, to be summed over ``model``."""
    if split is None:
        return embed[tokens]
    inside = (tokens >= split.lo) & (tokens < split.hi)
    rows = embed[torch.where(inside, tokens - split.lo, 0)]
    return torch.where(inside[..., None], rows, 0)


def _layer_axis(model_axis: Optional[ModelAxis], index: int):
    return None if model_axis is None else model_axis.layer(index)


def _cache_for(layer_cache: Optional[LayerCache], index: int, cache: Dict[str, torch.Tensor]):
    return contextlib.nullcontext(cache) if layer_cache is None else layer_cache(index, cache)


def _run_method(layers: nn.ModuleList, index: int, method: str,
                materialize: Optional[Materialize], *args, stack: str = "layers"):
    """``layers[index].<method>(*args)``, on materialized weights where given
    (``stack``: the list's state-dict name)."""
    layer = layers[index]
    if materialize is None:
        return getattr(layer, method)(*args)
    params = {n: materialize(f"{stack}.{index}.{n}", t) for n, t in layer.named_parameters()}
    with _reparametrize_module(layer, params):
        return getattr(layer, method)(*args)


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
                positions: torch.Tensor, materialize: Optional[Materialize],
                model_axis: Optional[ModelAxis] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    if materialize is not None:
        params = {n: materialize(f"layers.{index}.{n}", t) for n, t in params.items()}
    return functional_call(layer, params, (x, positions, _layer_axis(model_axis, index)))


def _run_layer(layers: nn.ModuleList, index: int, x: torch.Tensor, positions: torch.Tensor,
               materialize: Optional[Materialize], model_axis: Optional[ModelAxis] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    layer = layers[index]
    if materialize is None:
        return layer(x, positions, _layer_axis(model_axis, index))
    return _call_layer(layer, index, dict(layer.named_parameters()), x, positions, materialize,
                       model_axis)


def _run_group(layers: nn.ModuleList, group: Sequence[int], x: torch.Tensor,
               positions: torch.Tensor, materialize: Optional[Materialize],
               model_axis: Optional[ModelAxis] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The layers ``group`` over x: (x, the group's aux terms summed in order)."""
    aux = x.new_zeros((), dtype=torch.float32)
    for i in group:
        x, a = _run_layer(layers, i, x, positions, materialize, model_axis)
        aux = aux + a
    return x, aux


def _remat_group(layers: nn.ModuleList, group: Sequence[int], x: torch.Tensor,
                 positions: torch.Tensor, policy: str,
                 materialize: Optional[Materialize] = None,
                 model_axis: Optional[ModelAxis] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_run_group`` under ``torch.utils.checkpoint``: (x, aux) both come
    out of the checkpoint, so every policy trains the router.

    The layers' parameters go in as explicit inputs: the backward's recompute
    then sees the same tensors as the forward, also when ``lm_loss`` swapped
    in cast copies that are gone by then. ``materialize`` runs inside, so the
    recompute materializes the weights again; under ``model_axis`` it also
    issues the forward's sums over ``model`` again, in the same order on
    every rank. Where the stream's sequence splits, the input kept for the
    backward is the rank's block [B, S'/M, d], and the recompute gathers it
    again inside."""
    names = [[n for n, _ in layers[i].named_parameters()] for i in group]
    flat = [t for i in group for _, t in layers[i].named_parameters()]

    def run(x, *tensors):
        k = 0
        aux = x.new_zeros((), dtype=torch.float32)
        for i, ns in zip(group, names):
            params = dict(zip(ns, tensors[k:k + len(ns)]))
            x, a = _call_layer(layers[i], i, params, x, positions, materialize, model_axis)
            aux = aux + a
            k += len(ns)
        return x, aux

    return checkpoint(run, x, *flat, use_reentrant=False, context_fn=_remat_context(policy))


MOE_AUX_WEIGHT = 0.01


def lm_loss(lm: LM, batch: Dict[str, Any], *, remat_policy: Optional[str] = "nothing",
            compute_dtype: Optional[torch.dtype] = None,
            materialize: Optional[Materialize] = None,
            model_axis: Optional[ModelAxis] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """batch: tokens [B,S], labels [B,S], optional mask and prefix_embeds
    [B,P,d] -> (loss, metrics); the loss is over the token positions only.

    ``compute_dtype`` casts the fp32/bf16 parameters inside the differentiated
    function (``functional_call`` on cast copies), so the gradients reach the
    master parameters through the cast. ``materialize(name, tensor)``
    replaces each parameter before that cast: the embedding, final norm and
    head at the start, a layer's just before it runs (``LM.forward``).
    ``model_axis`` (``parallel/tensor_parallel.py``), where given, splits the
    embedding, attention, the dense MLP and the head along ``model``, as in
    ``LM.prefill``; where the head splits, the cross-entropy is the
    vocab-parallel one (``ModelAxis.xent``) on this rank's logits block, the
    prefix's logits dropped after the head's gather. Where the stream's
    sequence splits and the head does not, the logits are the rank's
    positions' (``ModelAxis.seq_xent``).

    ``REPRO_CAST_BARRIER=1`` (read at each call, as the reference reads it
    when tracing) hands ``materialize`` the compute dtype instead
    (``materialize(name, tensor, dtype=...)``), which casts each weight's
    block before it moves: the sharded step gathers its weights in bf16.
    The gradient is widened before its reduction, which stays in the
    master's dtype: the values and gradients are the knob-off run's, as the
    reference's barrier (an ``optimization_barrier``) changes no value
    either. Without ``materialize`` the knob changes nothing."""
    tokens, prefix = batch["tokens"], batch.get("prefix_embeds")
    kw = {"remat_policy": remat_policy, "prefix_embeds": prefix}
    if model_axis is not None:
        kw["model_axis"] = model_axis
    cast_first = os.environ.get("REPRO_CAST_BARRIER", "0") == "1"

    def prepare(name: str, p: torch.Tensor) -> torch.Tensor:
        cast = compute_dtype is not None and p.dtype in (torch.float32, torch.bfloat16)
        if materialize is not None:
            if cast and cast_first:
                return materialize(name, p, dtype=compute_dtype)
            p = materialize(name, p)
        if cast:
            p = p.to(compute_dtype)
        return p

    if materialize is not None:
        outer = {n: prepare(n, p) for n, p in lm.named_parameters()
                 if not n.startswith("layers.")}
        logits, aux = functional_call(lm, outer, (tokens,), {**kw, "materialize": prepare})
    elif compute_dtype is None:
        logits, aux = lm(tokens, **kw)
    else:
        params = {n: prepare(n, p) for n, p in lm.named_parameters()}
        logits, aux = functional_call(lm, params, (tokens,), kw)
    n_prefix = 0 if prefix is None else prefix.shape[1]  # the loss is over the tokens only
    labels, mask = batch["labels"], batch.get("mask")
    if model_axis is not None and model_axis.head is not None:
        xent = model_axis.xent(logits[:, n_prefix:], labels, mask)
    elif model_axis is not None and model_axis.seq is not None:
        xent = model_axis.seq_xent(logits, labels, mask, n_prefix)
    else:
        xent = common.softmax_xent(logits[:, n_prefix:], labels, mask)
    loss = xent + MOE_AUX_WEIGHT * aux
    return loss, {"xent": xent, "moe_aux": aux}
