"""Whisper-style encoder-decoder backbone (``repro/models/encdec.py``).

The audio frontend (mel and conv downsampling) is a stub, as in the
reference: the batch carries frame embeddings [B, T_f, d]. The encoder adds
learned positions and runs non-causal self-attention blocks; the decoder runs
causal self-attention, cross-attention over the encoder's memory and the
MLP, with the head tied to the embedding. Pre-norm LayerNorm, GELU MLP.

The reference stacks each stack's blocks on a leading axis (``jax.vmap`` at
init, ``lax.scan`` at run time); here each block is its own module,
``enc_blocks.{i}`` and ``dec_blocks.{i}``, so a state-dict name is the
reference's path with the layer index after the stack's name.

Every attention of training and of the encode (the encoder's self-attention,
the decoder's self-attention and cross-attention) goes through
``fa_ops.attention``: on the card the flash kernels, in bf16 at whisper's
head_dim 64 the tensor-core one. Decode takes the plain path, as the
reference does, and projects the cross-attention's K and V from the memory
again at every step.

The frames must come in the weights' dtype (bf16 frames for bf16 weights, as
the reference's input specs give them): the reference would promote a bf16
model with fp32 frames to fp32 throughout, which the port does not do, so it
raises instead.

Sharded training (``parallel/fsdp.py``) takes the hooks ``LM.forward`` takes:
``materialize(name, tensor)`` replaces each block's parameters inside the
block (inside remat's checkpoint, so again in its recompute), and
``model_axis`` (``parallel/tensor_parallel.py``) splits each block's
self-attention, cross-attention and MLP along ``model`` by query heads and
``d_ff`` (each block's ``LayerAxis``), and the lookup, the tied head and the
cross-entropy by vocabulary where the axis divides it. Where the rules put
the streams' ``seq`` on ``model`` and the axis divides a stream's length,
that stream holds the rank's block of positions between blocks (the
encoder's [B, T_f/M, d], the decoder's [B, S/M, d], each split on its own
length; ``ModelAxis.on`` gives the encoder's view): each block's normed
input is gathered along the sequence and each sum over ``model`` is a
reduce-scatter, the positions are added to the rank's positions, an
unsplit lookup or head reads them alone (``ModelAxis.seq_xent``), and the
memory comes out of the encoder as the rank's block. The cross-attention
projects K and V from the whole memory onto the rank's heads, so a rank's
gradient of the memory may be a partial term: the memory enters the
decoder once (``ModelAxis.memory_in``: gathered along its sequence where
the encoder's stream splits, its backward a reduce-scatter; else its
backward an all-reduce), and every block's cross-attention takes it whole,
with no collective of its own.

Sharded serving takes the same hooks: ``encode`` under ``no_grad`` is the
sharded prefill, every encoder block split by heads and ``d_ff`` (flash on
the rank's heads over the gathered stream) and, where the axis splits the
encoder's stream, on the rank's block of positions as in training, the
memory out as that block; ``decode_step`` takes ``LM.decode_step``'s hooks
(``materialize``, ``layer_cache``, ``model_axis``): the lookup and the tied
head by vocabulary where the axis divides it, the memory gathered along its
frames once before the first block where it comes split
(``ModelAxis.memory_in``), each decoder block's weights materialized inside
the block, its self-attention over the rank's block of its self cache where
it lies (``LayerAxis.decode_attention``: partial softmaxes merged over the
cache's sequence axes), its cross-attention on the rank's heads with K and V
projected from the rank's rows of the whole memory, and its MLP on the
rank's ``d_ff`` block, each summed over ``model``. Under ``serve_2d`` each
block's weights and the tied embedding keep their ``embed`` block on
``data``, in the encode and in every decode step, as the reference lays
them out (``ModelAxis.stationary``): each column product (``wq``, ``wk``,
``wv``, ``w_up``, the cross-attention's ``wq``, the tied head) takes the
rank's columns of the whole stream and sums its partial product over
``data``; each row product (``wo``, ``w_down``, the cross-attention's
``wo``) and the lookup give the rank's block of the stream's columns,
gathered over ``data`` after the sum over ``model``. The cross-attention's
``wk`` and ``wv``, which read the memory, are gathered over ``data``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, common, transformer
from repro_torch.models.attention import Attention
from repro_torch.models.mlp import MLP
from repro_torch.models.transformer import (LayerCache, Materialize, ModelAxis, _split_in,
                                            _summed)

Cache = Dict[str, Any]  # {"self": [per-decoder-layer KV cache], "pos": int}


def init_encdec_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                      device) -> Cache:
    """A zeroed self-attention cache for every decoder layer, position 0."""
    layers: List[Dict[str, torch.Tensor]] = [
        attention.init_kv_cache(cfg, batch, max_len, dtype, device)
        for _ in range(cfg.n_layers)]
    return {"self": layers, "pos": 0}


class EncBlock(nn.Module):
    """Pre-norm block: non-causal self-attention, then the MLP."""

    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        d = cfg.d_model
        self.norm1 = common.norm_init(cfg.norm_type, d, device, dtype)
        self.attn = Attention(cfg, device, dtype)
        self.norm2 = common.norm_init(cfg.norm_type, d, device, dtype)
        self.mlp = MLP(cfg, device, dtype)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        common.reset_norm_(self.norm1)
        self.attn.reset_parameters(gen)
        common.reset_norm_(self.norm2)
        self.mlp.reset_parameters(gen)

    def forward(self, x: torch.Tensor, positions: torch.Tensor, axis=None) -> torch.Tensor:
        """``axis``: the block's ``tensor_parallel.LayerAxis`` in sharded
        training, which splits the attention by query heads and the MLP by
        ``d_ff`` (each a sum over ``model`` after it, as ``Block.forward``)."""
        x = x + self.mix(common.apply_norm(self.norm1, x), positions, axis)
        return x + self.feed_forward(common.apply_norm(self.norm2, x), axis)

    def mix(self, h: torch.Tensor, positions: torch.Tensor, axis=None) -> torch.Tensor:
        """The non-causal self-attention on the ``norm1``-normed stream."""
        h = _split_in(h, axis, "attn_sum")
        return _summed(self.attn(h, positions, causal=False, axis=axis), axis, "attn_sum")

    def feed_forward(self, h: torch.Tensor, axis=None) -> torch.Tensor:
        """The MLP on the ``norm2``-normed stream."""
        return _summed(self.mlp(_split_in(h, axis, "mlp_sum"), axis), axis, "mlp_sum")


class DecBlock(nn.Module):
    """Pre-norm block: causal self-attention, cross-attention over the
    memory, then the MLP."""

    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        d = cfg.d_model
        self.norm1 = common.norm_init(cfg.norm_type, d, device, dtype)
        self.attn = Attention(cfg, device, dtype)
        self.norm_x = common.norm_init(cfg.norm_type, d, device, dtype)
        self.xattn = Attention(cfg, device, dtype, cross=True)
        self.norm2 = common.norm_init(cfg.norm_type, d, device, dtype)
        self.mlp = MLP(cfg, device, dtype)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        for norm in (self.norm1, self.norm_x, self.norm2):
            common.reset_norm_(norm)
        self.attn.reset_parameters(gen)
        self.xattn.reset_parameters(gen)
        self.mlp.reset_parameters(gen)

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                memory: torch.Tensor, axis=None) -> torch.Tensor:
        """``axis`` as in ``EncBlock.forward``; the cross-attention splits by
        its query heads too (``LayerAxis.cross``)."""
        x = x + self.mix(common.apply_norm(self.norm1, x), positions, axis)
        x = x + self.cross(common.apply_norm(self.norm_x, x), memory, axis)
        return x + self.feed_forward(common.apply_norm(self.norm2, x), axis)

    def mix(self, h: torch.Tensor, positions: torch.Tensor, axis=None) -> torch.Tensor:
        """The causal self-attention on the ``norm1``-normed stream."""
        h = _split_in(h, axis, "attn_sum")
        return _summed(self.attn(h, positions, axis=axis), axis, "attn_sum")

    def cross(self, h: torch.Tensor, memory: torch.Tensor, axis=None,
              decode: bool = False) -> torch.Tensor:
        """The cross-attention on the ``norm_x``-normed stream (``decode``:
        one decode step's token, ``Attention.decode_cross``). Where it
        splits, the rank projects K and V from the whole memory onto its own
        heads. The memory comes in whole, with no collective of its own: its
        gradient's terms are summed over ``model`` once for every block
        (``ModelAxis.memory_in``, in ``EncDec.decode_train``)."""
        h = _split_in(h, axis, "xattn_sum")
        cross = None if axis is None else axis.cross
        if decode:
            out = self.xattn.decode_cross(h, memory, cross)
        else:
            out = self.xattn(h, None, memory=memory, axis=cross)
        return _summed(out, axis, "xattn_sum")

    def feed_forward(self, h: torch.Tensor, axis=None) -> torch.Tensor:
        """The MLP on the ``norm2``-normed stream."""
        return _summed(self.mlp(_split_in(h, axis, "mlp_sum"), axis), axis, "mlp_sum")

    def decode(self, x: torch.Tensor, pos: int, cache: Dict[str, torch.Tensor],
               memory: torch.Tensor, axis=None) -> torch.Tensor:
        """One token a row at position ``pos`` against the block's self cache
        (updated in place) and the memory. ``axis`` as in ``forward``, in
        sharded serving: the self-attention over the rank's block of the
        cache where it lies (``LayerAxis.decode_attention``), the
        cross-attention on the rank's heads, the MLP on its ``d_ff`` block,
        each summed over ``model``."""
        x = x + self.mix_step(common.apply_norm(self.norm1, x), pos, cache, axis)
        x = x + self.cross(common.apply_norm(self.norm_x, x), memory, axis, decode=True)
        return x + self.feed_forward(common.apply_norm(self.norm2, x), axis)

    def mix_step(self, h: torch.Tensor, pos: int, cache: Dict[str, torch.Tensor],
                 axis=None) -> torch.Tensor:
        """One decode step's causal self-attention on the ``norm1``-normed
        token, over the self cache."""
        h = _split_in(h, axis, "attn_sum")
        return _summed(self.attn.decode(h, pos, cache, axis), axis, "attn_sum")


def _own(axis: Optional[ModelAxis], positions: torch.Tensor) -> torch.Tensor:
    """The rank's positions where ``axis`` splits its stream's sequence,
    else all of them."""
    return positions if axis is None or axis.seq is None else positions[axis.seq.lo:axis.seq.hi]


def _run_block(stack: nn.ModuleList, name: str, index: int, remat_policy: Optional[str],
               materialize: Optional[Materialize], model_axis: Optional[ModelAxis],
               *args) -> torch.Tensor:
    """Block ``index`` of ``stack`` (state-dict prefix ``name``) on ``args``,
    under ``torch.utils.checkpoint`` with grad on and a remat policy (the
    reference's ``_maybe_remat`` around each block). The block's parameters
    go in as explicit inputs, as in ``transformer._remat_group``: the
    recompute then sees the tensors the forward saw, also the cast copies
    ``encdec_loss`` swaps in. ``materialize`` runs inside, so the recompute
    gathers the block's weights again and no block holds them between its
    forward and its backward; ``model_axis`` gives the block its
    ``LayerAxis``."""
    block = stack[index]
    axis = None if model_axis is None else model_axis.layer(index, name)
    names, params = zip(*block.named_parameters())
    n = len(names)

    def run(*tensors):
        weights = dict(zip(names, tensors[:n]))
        if materialize is not None:
            weights = {k: materialize(f"{name}.{index}.{k}", t) for k, t in weights.items()}
        return functional_call(block, weights, tensors[n:] + (axis,))

    if remat_policy in (None, "none") or not torch.is_grad_enabled():
        return run(*params, *args)
    return checkpoint(run, *params, *args, use_reentrant=False,
                      context_fn=transformer._remat_context(remat_policy))


class EncDec(nn.Module):
    """The whole encoder-decoder; its parameters are the served weights."""

    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        d = cfg.d_model
        self.cfg = cfg
        self.embed = common.param((cfg.vocab_size, d), device, dtype)
        self.enc_pos = common.param((cfg.frontend_seq_len or 1500, d), device, dtype)
        self.dec_pos = common.param((cfg.max_seq_len, d), device, dtype)
        self.enc_blocks = nn.ModuleList(EncBlock(cfg, device, dtype)
                                        for _ in range(cfg.n_encoder_layers))
        self.enc_norm = common.norm_init(cfg.norm_type, d, device, dtype)
        self.dec_blocks = nn.ModuleList(DecBlock(cfg, device, dtype)
                                        for _ in range(cfg.n_layers))
        self.dec_norm = common.norm_init(cfg.norm_type, d, device, dtype)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        for table in (self.embed, self.enc_pos, self.dec_pos):
            common.embed_init_(table, gen)
        for block in list(self.enc_blocks) + list(self.dec_blocks):
            block.reset_parameters(gen)
        common.reset_norm_(self.enc_norm)
        common.reset_norm_(self.dec_norm)

    def encode(self, frames: torch.Tensor, remat_policy: Optional[str] = None,
               materialize: Optional[Materialize] = None,
               model_axis: Optional[ModelAxis] = None) -> torch.Tensor:
        """frames [B, T_f, d] (the stub frontend's output) -> memory [B, T_f, d].
        Positions past the table's length tile it, as in the reference. The
        hooks as in ``forward``; where ``model_axis`` splits the encoder's
        stream, the stream and the memory are the rank's block of positions
        [B, T_f/M, d], the positions added to the rank's frames alone."""
        if frames.dtype != self.enc_pos.dtype:
            raise ValueError(f"frames are {frames.dtype}, the weights "
                             f"{self.enc_pos.dtype}: give the frames in the weights' dtype")
        T = frames.shape[1]
        positions = torch.arange(T, device=frames.device)
        axis = None if model_axis is None else model_axis.on("enc_blocks")
        x = frames if axis is None else axis.own(frames)
        x = x + self.enc_pos[_own(axis, positions) % self.enc_pos.shape[0]][None]
        for i in range(len(self.enc_blocks)):
            x = _run_block(self.enc_blocks, "enc_blocks", i, remat_policy, materialize,
                           model_axis, x, positions)
        return common.apply_norm(self.enc_norm, x)

    def _embed(self, tokens: torch.Tensor, model_axis: Optional[ModelAxis] = None
               ) -> torch.Tensor:
        """The token embeddings (no positions). Where ``model_axis`` splits
        the vocabulary, ``embed`` holds this rank's rows, and the rank's
        lookup term is summed over ``model`` (``LM._embed``): reduce-scattered
        to the rank's positions where the decoder's stream splits, where an
        unsplit lookup is sliced to them (``ModelAxis.own``). In serving,
        where ``embed`` keeps its ``embed`` block, the rank's rows give its
        block of the columns, gathered over the block's axes
        (``ModelAxis.whole``) after the sum over ``model``."""
        split = None if model_axis is None else model_axis.split("embed")
        x = transformer.lookup(self.embed, tokens, split)
        if model_axis is None:
            return x
        x = model_axis.own(x) if split is None else model_axis.from_split(x)
        return model_axis.whole(x, "embed")

    def _logits(self, x: torch.Tensor, model_axis: Optional[ModelAxis] = None
                ) -> torch.Tensor:
        """The tied head; where ``model_axis`` splits the vocabulary, the
        rank's vocab block of the logits over the whole stream (the
        final-normed blocks gathered where the decoder's stream splits);
        an unsplit head there reads the rank's positions (``LM._logits``).
        In serving, where ``embed`` keeps its ``embed`` block, the rank's
        partial product summed over the block's axes
        (``ModelAxis.column``)."""
        x = common.apply_norm(self.dec_norm, x)
        if model_axis is None:
            return x @ self.embed.T
        if model_axis.head is not None:
            x = model_axis.to_split(x)
        return model_axis.column(x, self.embed.T, "embed")

    def decode_train(self, tokens: torch.Tensor, memory: torch.Tensor,
                     remat_policy: Optional[str] = None,
                     materialize: Optional[Materialize] = None,
                     model_axis: Optional[ModelAxis] = None) -> torch.Tensor:
        """Teacher-forced decoder forward: tokens [B, S] -> logits [B, S, V]
        (the rank's vocab block where ``model_axis`` splits the head, its
        positions [B, S/M, V] where the decoder's stream splits and the head
        does not). The hooks as in ``forward``; the memory enters the
        decoder once (``ModelAxis.memory_in``: whole, its gradient's terms
        summed over ``model`` by one collective)."""
        S = tokens.shape[1]
        positions = torch.arange(S, device=tokens.device)
        x = self._embed(tokens, model_axis) + self.dec_pos[
            _own(model_axis, positions) % self.dec_pos.shape[0]][None]
        if model_axis is not None:
            memory = model_axis.memory_in(memory)
        for i in range(len(self.dec_blocks)):
            x = _run_block(self.dec_blocks, "dec_blocks", i, remat_policy, materialize,
                           model_axis, x, positions, memory)
        return self._logits(x, model_axis)

    def forward(self, frames: torch.Tensor, tokens: torch.Tensor,
                remat_policy: Optional[str] = None,
                materialize: Optional[Materialize] = None,
                model_axis: Optional[ModelAxis] = None) -> torch.Tensor:
        """Training forward: encode, then ``decode_train``; logits [B, S, V].
        ``materialize(name, tensor)``, where given, replaces each block
        parameter just before its block runs (inside its checkpoint);
        ``model_axis`` splits the blocks and, where the axis divides the
        vocabulary, the lookup and the head along ``model`` (the sharded
        trainer, ``parallel/fsdp.py``)."""
        memory = self.encode(frames, remat_policy, materialize, model_axis)
        return self.decode_train(tokens, memory, remat_policy, materialize, model_axis)

    def decode_step(self, tokens: torch.Tensor, cache: Cache, memory: torch.Tensor,
                    materialize: Optional[Materialize] = None,
                    layer_cache: Optional[LayerCache] = None,
                    model_axis: Optional[ModelAxis] = None) -> torch.Tensor:
        """One token per row (tokens [B, 1]) against the self caches (updated
        in place) and the memory; logits [B, 1, V] (the rank's vocab block
        where ``model_axis`` splits the head). A position past ``dec_pos``
        tiles it, as in the reference. The hooks as in ``LM.decode_step``
        (sharded serving, ``parallel/fsdp.py``): ``materialize`` gives each
        decoder block's weights inside the block, ``layer_cache(i, c)`` block
        i's self cache, ``model_axis`` splits the lookup, each block and the
        head along ``model``; the memory enters the decoder once
        (``ModelAxis.memory_in``: all-gathered along its frames where they
        split over ``model``, else as it is), and every block's
        cross-attention reads it whole."""
        pos = cache["pos"]
        x = self._embed(tokens, model_axis) + self.dec_pos[pos % self.dec_pos.shape[0]]
        if model_axis is not None:
            memory = model_axis.memory_in(memory)
        for i, c in enumerate(cache["self"]):
            axis = None if model_axis is None else model_axis.layer(i, "dec_blocks")
            with transformer._cache_for(layer_cache, i, c) as c:
                x = transformer._run_method(self.dec_blocks, i, "decode", materialize, x, pos,
                                            c, memory, axis, stack="dec_blocks")
        cache["pos"] = pos + 1
        return self._logits(x, model_axis)


def encdec_loss(model: EncDec, batch: Dict[str, Any], *,
                remat_policy: Optional[str] = None,
                compute_dtype: Optional[torch.dtype] = None,
                materialize: Optional[Materialize] = None,
                model_axis: Optional[ModelAxis] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """batch: frames [B, T_f, d], tokens [B, S], labels [B, S], optional mask
    -> (loss, metrics). ``compute_dtype`` casts the fp32/bf16 parameters
    inside the differentiated function, as ``transformer.lm_loss`` does.
    ``materialize(name, tensor)`` replaces each parameter before that cast:
    the embedding, positions and final norms at the start, a block's inside
    it (``EncDec.forward``). ``model_axis`` as in ``EncDec.forward``; where
    the head splits, the cross-entropy is the vocab-parallel one
    (``ModelAxis.xent``) on this rank's logits block; where the decoder's
    stream splits and the head does not, it reads the rank's positions'
    logits (``ModelAxis.seq_xent``)."""
    args = (batch["frames"], batch["tokens"])
    kw = {"remat_policy": remat_policy, "model_axis": model_axis}

    def prepare(name: str, p: torch.Tensor) -> torch.Tensor:
        if materialize is not None:
            p = materialize(name, p)
        if compute_dtype is not None and p.dtype in (torch.float32, torch.bfloat16):
            p = p.to(compute_dtype)
        return p

    if materialize is not None:
        outer = {n: prepare(n, p) for n, p in model.named_parameters()
                 if n.split(".", 1)[0] not in ("enc_blocks", "dec_blocks")}
        logits = functional_call(model, outer, args, {**kw, "materialize": prepare})
    elif compute_dtype is None:
        logits = model(*args, **kw)
    else:
        params = {n: prepare(n, p) for n, p in model.named_parameters()}
        logits = functional_call(model, params, args, kw)
    labels, mask = batch["labels"], batch.get("mask")
    if model_axis is not None and model_axis.head is not None:
        xent = model_axis.xent(logits, labels, mask)
    elif model_axis is not None and model_axis.seq is not None:
        xent = model_axis.seq_xent(logits, labels, mask, 0)
    else:
        xent = common.softmax_xent(logits, labels, mask)
    return xent, {"xent": xent, "moe_aux": xent.new_zeros((), dtype=torch.float32)}
