"""Sharded training and serving: parameters and AdamW moments as DTensors,
laid out by the logical-axis rule tables on a ``DeviceMesh``; the compute
split along ``model`` (``parallel/tensor_parallel.py``).

Counterpart of the reference's pjit step (``repro/launch/train.py``: params
``device_put`` to ``param_shardings``, the step jitted under the mesh) and of
``make_train_step(..., grad_shardings=...)``. :func:`shard_module` turns
every parameter of an LM into a DTensor ``Parameter`` with the placements of
``sharding.param_specs``; ``train_loop.make_train_step`` over a
:class:`ShardedModel` then trains it as GSPMD splits the reference's step:

* the batch is split along its first dim by the ``batch`` rule's axes
  (``sharding.batch_specs``); each rank takes its rows. Tokens, labels,
  mask and prefix stay whole along ``model``: the vocab-parallel lookup
  reads every position on every rank, and the loss reads the gathered
  logits. The batch specs' ``seq`` entry is carried out in the residual
  stream instead (next item);
* the model axis splits the compute: attention by query heads, the dense
  MLP by ``d_ff``, each MoE layer by experts (by every expert's ``d_ff``
  where the axis does not divide E), each RG-LRU layer by its recurrent
  channels (where the axis divides its gate blocks), the embedding and the
  head by vocabulary, with a sum over ``model`` after each row-parallel product, the
  MoE's combine and the lookup, a sum of the gradient over ``model`` before
  each column-parallel one, and the vocab-parallel cross-entropy on the
  rank's logits block. Each RWKV-6 layer splits as in serving: the time
  mix by heads, its term summed over ``model``, and the channel mix by
  ``d_ff``, its value term reduce-scattered along ``d`` and its product
  all-gathered (``tensor_parallel.LayerAxis.channel_mix``, each collective
  with its autograd);
* sequence parallelism (the ``seq`` rule, ``"model"`` under ``fsdp_tp``,
  ``tp_only`` and ``fsdp_tp_pod_fsdp``): the residual stream [B, P + S, d]
  between the sub-blocks is the rank's contiguous block of positions
  (``sharding.stream_split`` on the global shape; where ``model`` does not
  divide P + S, or under ``fsdp_tp_noseq``, the stream is whole and the
  path is the one above). The norms and residual adds run on the block;
  each sub-block's normed input is all-gathered along the sequence (its
  backward a reduce-scatter), and each sum over ``model`` after a
  row-parallel product, the MoE's combine or the lookup becomes a
  reduce-scatter along it (its backward an all-gather); the RWKV-6 channel
  mix's product goes to the rank's positions by one all-to-all (backward
  the inverse one). A compute that does not split along ``model`` (a
  layer, head or embedding the axis does not divide) runs on the gathered
  stream and keeps the rank's positions. Remat keeps each group's
  input as the rank's block: that is the memory the rule saves;
* each weight is materialized just before use (:class:`_Gather`): the
  embedding, final norm and head at the start of the forward, a layer
  group's inside the group, so again in remat's recompute. A weight whose
  compute splits (a MoE layer's expert leaves and an RG-LRU layer's among
  them) is brought to its ``model`` block and gathered over the other axes
  only -- the RG-LRU's gates, whole at rest, by a local slice, and under
  ``serve_2d`` a leaf laid out over ``(data, model)`` to the contiguous
  block of ``model`` alone (not where serving keeps its chunk, below);
  the RWKV-6 time mix's ``w_v``, rows at rest,
  by one all-to-all over ``model`` to its columns (not where serving keeps
  its ``embed`` block: it is computed with on its rows), and its ``w_o``,
  ``bonus``, ``decay_b`` and 1-D leaves, whole at rest, by a local
  slice --;
  every other weight is gathered whole (FSDP). Serving keeps some
  weights' ``embed`` block where it lies instead (below);
  The flash and scan
  kernels see ordinary tensors: DTensor's sharding propagation cannot see
  through the ctypes-bound kernels;
* a weight's gradient is summed over the ranks that saw other rows of the
  batch (the batch axes) and brought back to the weight's placement -- a
  reduce-scatter where the weight is sharded on those axes, an all-reduce
  where it is replicated on them, a local slice along the other axes. A
  split weight's block gradient is the rank's own. A weight that ``model``
  replicates but the rank reads only in part (``ModelAxis.sums_gradient``:
  K/V where ``n_kv_heads`` does not divide the axis, QK-norm's scales, the
  MoE router where the experts split, an RWKV-6 mix's ``mu_*`` and the
  time mix's ``decay_a`` where the mixer splits) has its gradient summed
  over ``model`` too. Where the stream's sequence splits, that is every
  replicated weight: the norms' scales, an unsplit layer's, embedding's or
  head's, since each rank back-propagates only its own positions' term;
  without the split the rest are computed whole and equal on every rank
  along ``model``, and not summed. A weight whole at rest and read by
  blocks (the RG-LRU's gates; the RWKV-6 time mix's ``w_o``, ``bonus``,
  ``decay_b`` and 1-D leaves) gets the blocks' gradients gathered over
  ``model``; ``tm.w_v``'s column block goes back to its row block by the
  inverse all-to-all before the sum over the batch axes.
  ``REPRO_GRAD_SYNC_BF16=1`` (``train_loop``) round-trips the reduced
  gradient through bf16, as the reference's step states it: a round trip
  of each rank's gradient before the reduction was tried and parts from the
  single process's round trip by up to 6.5e-5 in the loss after 6 steps
  (recurrentgemma-9b reduced, 4 ranks), as Adam turns the rounding of small
  gradients into whole steps;
* the loss is averaged over the global batch: each rank's mean is weighted
  by its share of the tokens and summed over the batch axes (ranks along
  ``model`` hold the same loss);
* AdamW updates the DTensors in place; its moments are DTensors with the
  parameters' placements (ZeRO), and the clip's norm is the global one,
  each block counted once.

Sharded serving (the reference's ``build_prefill_step`` and
``build_serve_step``): :meth:`ShardedModel.prefill` and
:meth:`ShardedModel.decode_step` take the global batch, each rank computes
its own rows, and the model axis splits the compute as in training, and
the RWKV-6 layers too: the time mix by heads and the channel mix by
``d_ff`` (``tensor_parallel.LayerAxis``: ``tm``, ``cm``), each rank's weights
its ``model`` block gathered over the other axes only. An LM's attention,
dense MLP, MoE, RWKV-6 mixers, RG-LRU, embedding and head, and the
encoder-decoder's blocks and tied embedding, are
weight-stationary where the rules allow, as the reference's ``serve_2d``
lays them out: a
weight whose
``embed`` dim the resolved spec splits over axes of more than one rank
that carry none of the batch's rows (``serve_2d``: ``data``, the rows on
``pod``; ``tensor_parallel.ModelAxis.stationary``) keeps that block, so
the rank computes with its ``(embed block x model block)`` and nothing of
it moves. Each column product (``wq``, ``wk``, ``wv``, ``w_gate``,
``w_up``, the head, the MoE's router and its experts' ``w_gate`` and
``w_up``) takes the rank's columns of the whole stream (the MoE's: of
each slot's token row) and sums its partial product over those axes, one
all-reduce of activations (the experts' two stacked: one); each row
product (``wo``, ``w_down``, the experts' ``w_down``) and the lookup give
the rank's block of the stream's columns, summed over ``model`` where the
layer splits and then all-gathered over those axes to the whole stream,
which every rank holds between the layers (the reference's ``act_embed:
None``). The MoE's router logits, summed so, are whole and equal on every
rank, which routes every token of the global groups as one process does.
An RWKV-6 layer keeps the blocks where its mixer splits along ``model``:
the time mix's ``w_r``, ``w_k``, ``w_g`` and ``decay_a`` and the channel
mix's ``w_k`` and ``w_r`` are column products, summed over ``data``; each
mixer's ``w_v`` [ff or heads' rows, embed] is computed with as it lies,
its ``model`` block of rows x ``embed`` block of columns, with no
all-to-all: the partial product is summed over ``model`` and the rank's
heads' (or receptance block's) columns taken by a masked sum over
``data`` (``tensor_parallel.ModelAxis.row``); the channel mix's product is
then gathered over ``model``. The time mix's ``decay_b`` [lora, d] is the
one RWKV-6 weight still gathered over ``data`` (0.5 MiB a layer in bf16 at
rwkv6-7b's width): its ``embed`` dim is also its heads' dim, which the
rank needs on ``model``; kept there, the decay's low-rank product would
have to gather its whole [B, d] output over ``data`` instead, twice the
bytes at decode_32k's 128 rows.
An RG-LRU layer serves on its layout at rest where ``rnn`` lays its
channels out over ``(data, model)`` (``tensor_parallel.ModelAxis._rnn_chunk``):
``conv_w``, ``conv_b``, ``lam``, ``w_out``'s rows and the state ``h`` and
``conv`` on the rank's chunk ``d M + m`` of the channels (kept ``Shard`` on
both axes, so nothing of them moves), ``w_in_rec`` and ``w_in_gate`` on
their (``embed`` block x ``model`` block), the gates whole; only
activations move (``RGLRU.prefill`` / ``decode`` with the layer's hook:
the input products summed over ``data`` and taken to the chunk by one
all-to-all over ``model``, the gates' input gathered to the chunk's gate
block where a chunk is narrower than one, ``w_out``'s term summed over
``data`` and ``model``). Where a chunk straddles a gate block's edge, the
chunks do not divide the width or ``model`` the gate blocks, the weights
and the state are gathered to the ``model`` block as below.
Under ``fsdp_tp`` and ``fsdp_tp_pod_fsdp`` the rows lie on ``data`` and
the weights are gathered as in training; a ``d_model`` the axes do not
divide resolves to whole. The
decode cache (:meth:`ShardedModel.init_cache`) is a structure of DTensors
laid out by ``sharding.cache_shardings``; an attention layer reads and
writes its K/V where they lie (a prefill fills its block, a decode step
merges partial softmaxes over the sequence's axes). A recurrent state is
brought to this rank's rows -- gathered in decode, fresh in a prefill,
which overwrites every entry -- and written back to its layout at rest when
the layer is done, entry by entry: a split RG-LRU layer's ``h`` and
``conv`` along the rank's block of channels, which under ``fsdp_tp`` (its
``model`` block) and under ``serve_2d`` (its ``(data, model)`` chunk) is
where they lie (no entry moves; under ``serve_2d`` the ``model`` block
gathered over ``data`` where the chunk form does not apply); a split
RWKV-6 time mix's ``wkv`` on the rank's heads, which
under ``fsdp_tp``, ``tp_only`` and ``serve_2d`` is where it lies (the WKV
kernel writes the new state into the block in place: no entry moves over
``model``); the RWKV-6 shifts, and an unsplit layer's state, whole along
the other dims. Logits come
back as a DTensor: rows on the batch axes, the vocabulary on ``model``
where it splits.

The sequence split is always the explicit gather (the reference's
``REPRO_SP_GATHER=1``); an LM's serving splits no sequence of the stream, as
the reference's ``prefill_block`` constrains none (the encoder-decoder's
encode does, below).

The encoder-decoder (whisper) trains on the mesh as the LMs do:
:meth:`ShardedModel.loss` splits its ``frames``, tokens, labels and mask
along their first dim by the ``batch`` rule, each encoder and decoder
block's self-attention, cross-attention and MLP split by query heads and
``d_ff`` along ``model``, the lookup, tied head and cross-entropy by
vocabulary where the axis divides it (whisper-medium's 51865 it does not:
they compute on every ``model`` rank, the rank's positions where the
decoder's stream splits), each block's weights materialized inside the
block. Its two streams split their sequence over ``model`` as an LM's does,
each on its own length: the encoder's [B, T_f, d] (the positions after it
and every block, as the reference constrains them) and the decoder's [B,
S, d] (``tensor_parallel.ModelAxis``'s ``stream`` by stack). The memory
leaves the encoder as the rank's block and enters the decoder once,
gathered along its sequence (``ModelAxis.memory_in``: the backward's
reduce-scatter sums every decoder block's term of its gradient at once);
where the encoder's stream is whole, its gradient is summed over
``model`` by one all-reduce, where some rank's term is partial.

The encoder-decoder serves on the mesh too (the reference's
``build_prefill_step`` jits ``encode``, ``build_serve_step``
``encdec_decode_step``): :meth:`ShardedModel.prefill` takes the global
``frames`` and encodes the rank's rows, every encoder block split by heads
and ``d_ff`` as in training, and its stream split along its sequence over
``model`` as training splits it (the reference constrains it to
``("batch", "seq", "act_embed")``): each block's normed input gathered,
each sum a reduce-scatter. It returns the memory as a DTensor laid out as
the reference's ``build_serve_step`` takes it, ``("batch", "seq", None)``
(:meth:`ShardedModel.memory_placements`): rows on the batch axes and
``Shard(1)`` on ``model`` where the frames split, ``Replicate`` where they
do not (``serve_2d``, whose ``seq`` is None; a T_f the axis does not
divide; an axis of one rank). :meth:`ShardedModel.decode_step` takes that
memory, a memory whole along ``model`` or a global tensor (each laid out
the same way, the rank's block of frames a local slice), and brings it
into the decoder once a step (``ModelAxis.memory_in``: one all-gather
along ``model`` where the frames split, nothing where they are whole); it
runs each decoder block's self-attention over the rank's block of its self
cache (:meth:`ShardedModel.init_cache` lays ``cache["self"]`` out as an
LM's K/V), its cross-attention on the rank's heads over the whole memory,
K and V projected from it again at every step as in the reference, and its
MLP on the rank's ``d_ff`` block. Under ``serve_2d`` the encode and each
decode step keep every block weight's and the tied embedding's ``embed``
block where it lies, as an LM's (above), but the cross-attention's ``wk``
and ``wv``, which read the memory: they are gathered over ``data``
(``tensor_parallel._MOVING_LEAVES``). Logits come back as an LM's.

``REPRO_CAST_BARRIER=1`` (``lm_loss``) casts each weight's block to the
compute dtype before :class:`_Gather` moves it, so the gathers carry bf16;
each gradient is widened before its reduction, which stays fp32, so the
step's values and gradients are the knob-off step's (the reference's
barrier changes no value either; its gradient sums are bf16 with and
without it).

Not yet (ROADMAP.md): the MoE's token all-to-all in place of its gather and
reduce-scatter; each expert's ``ff`` block kept on ``data`` in training
(``moe_ep2d``).
"""

from __future__ import annotations

import contextlib
import weakref
from typing import Any, Dict, Iterator, Optional, Tuple

import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (DTensor, Partial, Placement, Replicate, Shard,
                                      distribute_tensor)
from torch.nn.utils.stateless import _reparametrize_module

from repro_torch.models.model_zoo import Model
from repro_torch.models.transformer import LM, Cache
from repro_torch.parallel import sharding as shd
from repro_torch.parallel import tensor_parallel as tp

Rules = Dict[str, shd.MeshAxes]


def shard_module(module: nn.Module, mesh: DeviceMesh, rules: Rules) -> nn.Module:
    """Replace every parameter by a DTensor ``Parameter`` holding this rank's
    block of it. Every rank built the same seeded weights, so each takes its
    block without communication. In place; returns ``module``."""
    specs = shd.param_specs(mesh, rules, module)
    for name, spec in specs.items():
        owner, leaf = _owner(module, name)
        p = getattr(owner, leaf)
        place = shd.placements(mesh, spec)
        # a copy of the block, so the whole tensor is freed
        local = distribute_tensor(p.detach(), mesh, place, src_data_rank=None).to_local().clone()
        dt = DTensor.from_local(local, mesh, place, run_check=False, shape=p.shape,
                                stride=p.stride())
        owner.register_parameter(leaf, nn.Parameter(dt, requires_grad=p.requires_grad))
    return module


def _owner(module: nn.Module, name: str) -> Tuple[nn.Module, str]:
    path, _, leaf = name.rpartition(".")
    return (module.get_submodule(path) if path else module), leaf


def full_state(module: nn.Module) -> Dict[str, torch.Tensor]:
    """Every parameter whole (a collective over the mesh: every rank of it
    calls this), keyed by state-dict name."""
    return {n: p.detach().full_tensor() if isinstance(p, DTensor) else p.detach()
            for n, p in module.named_parameters()}


def _block_shape(shape: Tuple[int, ...], placements: Tuple[Placement, ...],
                 sizes: Tuple[int, ...]) -> Tuple[int, ...]:
    """A rank's block of a tensor of ``shape`` laid out by ``placements``
    (every split even)."""
    out = list(shape)
    for p, size in zip(placements, sizes):
        if isinstance(p, Shard):
            out[p.dim] //= size
    return tuple(out)


def _reduce_placements(mesh: DeviceMesh, axes: Tuple[str, ...]) -> Tuple[Placement, ...]:
    """``Partial`` (a sum pending) on the batch axes, ``Replicate`` on the rest."""
    return tuple(Partial() if name in axes else Replicate() for name in mesh.mesh_dim_names)


class _Gather(torch.autograd.Function):
    """A DTensor's local block -> the tensor laid out by ``keep`` (the whole
    tensor, or its ``model`` block gathered over the other axes). A mesh dim
    whose block moves to another tensor dim (the RWKV-6 time mix's ``w_v``,
    rows at rest, columns computed with) moves last, once the other dims are
    in place, by one functional all-to-all of the rank's block
    (``MeshCollectives.move``): DTensor's own plan for the whole move gathers the
    tensor whole, and its all-to-all is not a functional collective, which
    the dry run's counter would not see. Backward: the gradient laid out by
    ``back`` (``keep`` with a sum pending over the batch axes, and over
    ``model`` for a weight read in part); a moved block first goes back to
    the dim it lies on at rest by the inverse all-to-all, then DTensor
    redistributes the rest to the block's placement (the sums over the
    batch axes, the gathers of a whole-at-rest weight's blocks). ``dtype``
    (``REPRO_CAST_BARRIER``): the block is cast to it before it moves, and
    the gradient widened back to the block's dtype before its own
    collectives, so it is reduced as without the cast."""

    @staticmethod
    def forward(ctx, local, mesh, placements, shape, stride, keep, back, dtype=None):
        ctx.mesh, ctx.placements, ctx.back = mesh, placements, back
        ctx.shape, ctx.stride, ctx.dtype = shape, stride, local.dtype
        if dtype is not None:
            local = local.to(dtype)
        if keep == placements:
            ctx.moved = ()
            return local.view_as(local)
        first = tuple(p if isinstance(p, Shard) and isinstance(k, Shard) else k
                      for p, k in zip(placements, keep))
        ctx.moved = tuple((i, p, k) for i, (p, k) in enumerate(zip(first, keep)) if p != k)
        out = DTensor.from_local(local.detach(), mesh, placements, run_check=False,
                                 shape=shape, stride=stride).redistribute(mesh, first).to_local()
        for i, p, k in ctx.moved:
            out = tp.MeshCollectives(mesh).move(out, p.dim, k.dim, mesh.mesh_dim_names[i])
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.to(ctx.dtype)
        back = list(ctx.back)
        for i, p, k in reversed(ctx.moved):
            grad = tp.MeshCollectives(ctx.mesh).move(grad, k.dim, p.dim,
                                                     ctx.mesh.mesh_dim_names[i])
            back[i] = p
        back = tuple(back)
        if back == ctx.placements:
            return grad, None, None, None, None, None, None, None
        pending = DTensor.from_local(grad.contiguous(), ctx.mesh, back, run_check=False,
                                     shape=ctx.shape, stride=ctx.stride)
        local = pending.redistribute(ctx.mesh, ctx.placements).to_local()
        return local, None, None, None, None, None, None, None


class _SumOverBatch(torch.autograd.Function):
    """Sum over the batch axes; the backward passes each rank's own term's
    gradient through (1 for a sum)."""

    @staticmethod
    def forward(ctx, x, mesh, reduce):
        return _sum_over_batch(x, mesh, reduce)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


def _sum_over_batch(x: torch.Tensor, mesh: DeviceMesh, reduce) -> torch.Tensor:
    replicate = tuple(Replicate() for _ in reduce)
    return DTensor.from_local(x.detach(), mesh, reduce, run_check=False).redistribute(
        mesh, replicate).to_local()


class ShardedModel:
    """A :class:`~repro_torch.models.model_zoo.Model` trained on a mesh: its
    ``loss`` takes the global batch and an LM (or an encoder-decoder) whose
    parameters are DTensors (:func:`shard_module`), and returns the global
    batch's mean loss."""

    def __init__(self, model: Model, mesh: DeviceMesh, rules: Rules):
        self.model, self.mesh, self.rules = model, mesh, rules
        self.cfg, self.device = model.cfg, model.device
        self._memo: Dict = {}  # serving's specs by name and shape
        self._shapes: "weakref.WeakKeyDictionary[LM, Dict]" = weakref.WeakKeyDictionary()

    def init(self, seed: int = 0, dtype: torch.dtype = torch.float32) -> LM:
        return shard_module(self.model.init(seed, dtype), self.mesh, self.rules)

    def shard(self, lm: LM) -> LM:
        return shard_module(lm, self.mesh, self.rules)

    def local_batch(self, batch: Dict[str, torch.Tensor]
                    ) -> Tuple[Dict[str, torch.Tensor], Tuple[str, ...]]:
        """This rank's rows of ``batch`` and the mesh axes the rows split over.
        The batch specs' ``seq`` entry is not taken here: every position
        stays on every ``model`` rank, and the residual stream splits it
        (``model_axis``'s ``stream``)."""
        axes = self._row_axes(tuple(next(iter(batch.values())).shape))
        place = shd.placements(self.mesh, (axes or None,))
        return {k: distribute_tensor(v, self.mesh, place, src_data_rank=None).to_local()
                for k, v in batch.items()}, axes

    def _row_axes(self, shape: Tuple[int, ...]) -> Tuple[str, ...]:
        """The mesh axes the rows (the first dim) of a batch leaf of
        ``shape`` split over, by the ``batch`` rule (``sharding.batch_specs``);
        every leaf of a batch has the same rows."""
        leaf = torch.empty(shape, device="meta")
        axes = shd.batch_specs(self.mesh, self.rules, {"x": leaf})["x"][0]
        return () if axes is None else (axes,) if isinstance(axes, str) else tuple(axes)

    def memory_placements(self, shape: Tuple[int, ...]) -> Tuple[Placement, ...]:
        """The encoder's memory [B, T_f, d] laid out as the reference's serve
        step takes it, ``("batch", "seq", None)``: its rows on the batch
        rule's axes, and its frames ``Shard(1)`` on ``model`` exactly where
        ``sharding.stream_split`` splits the encoder's stream of that shape
        (the encode keeps the rank's block of it); else whole along
        ``model`` (``serve_2d``, a T_f the axis does not divide, an axis of
        one rank)."""
        place = list(shd.placements(self.mesh, (self._row_axes(shape) or None,)))
        if shd.stream_split(self.mesh, self.rules, shape) is not None:
            place[self.mesh.mesh_dim_names.index("model")] = Shard(1)
        return tuple(place)

    def memory(self, x: torch.Tensor) -> DTensor:
        """A global memory [B, T_f, d] laid out by :meth:`memory_placements`:
        each rank keeps its rows and, where the frames split, its block of
        them; no communication."""
        return distribute_tensor(x, self.mesh, self.memory_placements(tuple(x.shape)),
                                 src_data_rank=None)

    def _weights(self, axis: tp.ModelAxis, row_axes: Tuple[str, ...]):
        """The ``materialize`` hook of training (and, with no gradient, of
        serving): a weight whose compute splits along ``model`` is brought to
        its ``model`` block (``axis.split``: where it lies, or a slice of a
        weight whole at rest; an RG-LRU leaf that serves on its ``(data,
        model)`` chunk keeps it, on both axes) and gathered over the other
        axes, but for the axes of an ``embed`` block that stays where it
        lies in serving (``axis.stationary``); every other weight is
        gathered whole. Its
        gradient comes back summed over the batch axes, and over ``model``
        where ``axis.sums_gradient``; the blocks of a weight whole at rest
        are gathered over ``model``. A mesh dim of one rank holds the whole
        dim: nothing moves over it. ``dtype`` (``lm_loss`` under
        ``REPRO_CAST_BARRIER``): the block is cast before it moves
        (:class:`_Gather`)."""
        names, sizes = self.mesh.mesh_dim_names, self.mesh.shape

        def weight(name: str, p: DTensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
            split, block = axis.split(name), axis.stationary(name)

            def kept(pl: Placement, n: str, size: int) -> Placement:
                if size == 1:
                    return pl
                if split is not None and n in split.axes:  # model, or an RG-LRU chunk's
                    return Shard(split.dim)
                if block is not None and n in block.axes:
                    return Shard(block.dim)
                return Replicate()

            keep = tuple(kept(pl, n, size) for pl, n, size in zip(p.placements, names, sizes))
            sums = axis.sums_gradient(name)
            back = tuple(Partial() if size > 1 and (n in row_axes or (sums and n == "model"))
                         else k for n, k, size in zip(names, keep, sizes))
            return _Gather.apply(p.to_local(), self.mesh, p.placements, p.shape, p.stride(),
                                 keep, back, dtype)

        return weight

    def loss(self, lm: LM, batch: Dict[str, Any], **kw
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """kw as ``Model.loss``: ``remat_policy``, ``compute_dtype``. An LM's
        residual stream [B, P + S, d] splits its sequence over ``model``
        where the rules say so (``sharding.stream_split``); so do the
        encoder-decoder's two streams, the encoder's [B, T_f, d] and the
        decoder's [B, S, d], each on its own length."""
        local, axes = self.local_batch(batch)
        reduce = _reduce_placements(self.mesh, axes)
        B, S = batch["tokens"].shape
        d = self.cfg.d_model
        if self.cfg.is_encoder_decoder:
            stream = {"enc_blocks": (B, batch["frames"].shape[1], d), "dec_blocks": (B, S, d)}
        else:
            prefix = batch.get("prefix_embeds")
            stream = (B, S + (0 if prefix is None else prefix.shape[1]), d)
        axis = self.model_axis(lm, None, axes, B, stream)
        loss, metrics = self.model.loss(lm, local, materialize=self._weights(axis, axes),
                                        model_axis=axis, **kw)
        mask = local.get("mask")
        n_local = (mask.float().sum() if mask is not None
                   else torch.tensor(float(local["tokens"].numel()), device=loss.device))
        share = n_local / _sum_over_batch(n_local, self.mesh, reduce)
        metrics = {k: _sum_over_batch(v.detach() * share, self.mesh, reduce)
                   for k, v in metrics.items()}
        return _SumOverBatch.apply(loss * share, self.mesh, reduce), metrics

    # -- serving --------------------------------------------------------------

    def init_cache(self, batch: int, max_len: int, dtype: torch.dtype = torch.bfloat16
                   ) -> Cache:
        """``Model.init_cache``'s zeroed cache, each leaf a DTensor laid out by
        ``sharding.cache_shardings``: an LM's ``layers``, or the
        encoder-decoder's decoder self caches ``self`` (K/V as an LM's)."""
        cache = self.model.init_cache(batch, max_len, dtype)
        key = tp.cache_key(cache)
        shardings = shd.cache_shardings(self.mesh, self.rules, cache)
        layers = [{k: distribute_tensor(t, self.mesh, sh[k].placements,
                                        src_data_rank=None)
                   for k, t in c.items()}
                  for c, sh in zip(cache[key], shardings[key])]
        return {key: layers, "pos": cache["pos"]}

    def _layer_cache(self, axis: tp.ModelAxis, rows: Tuple[Placement, ...], gather: bool):
        """The ``layer_cache`` hook. An attention layer's K/V: this rank's
        blocks where they lie (the layer's ``LayerAxis`` reads and writes
        them). A state (RG-LRU, RWKV-6), entry by entry: this rank's rows
        and, where the layer splits, its block -- the RG-LRU's channels
        (``LayerAxis.rnn``: ``h`` and ``conv`` along their last dim), the
        RWKV-6 time mix's heads (``LayerAxis.tm``: ``wkv`` along dim 1) --,
        else the entry whole along the other dims. An entry that lies so at
        rest is read and written in place; any other is gathered (decode)
        or fresh (a prefill overwrites every entry) and written back to its
        layout at rest when the layer is done (the RWKV-6 shifts, which the
        next token's mixes read whole: gathered in decode, and written back
        as the rank's block, a local slice)."""
        names, sizes = self.mesh.mesh_dim_names, self.mesh.shape

        def place(layer: tp.LayerAxis, key: str, t: DTensor) -> Tuple[Placement, ...]:
            split, dim = ((layer.rnn, t.ndim - 1) if key in ("h", "conv")
                          else (layer.tm, 1) if key == "wkv" else (None, None))
            return rows if split is None else tuple(
                Shard(dim) if n in split.axes else r for n, r in zip(names, rows))

        @contextlib.contextmanager
        def hook(index: int, cache: Dict[str, DTensor]) -> Iterator[Dict[str, torch.Tensor]]:
            local = {k: t.to_local() for k, t in cache.items()}
            if "k" in cache:
                yield local
                return
            layer = axis.layer(index)
            want = {k: place(layer, k, t) for k, t in cache.items()}
            moved = [k for k, t in cache.items() if want[k] != t.placements]
            for k in moved:
                t = cache[k]
                local[k] = (t.redistribute(self.mesh, want[k]).to_local() if gather
                            else t.to_local().new_empty(_block_shape(t.shape, want[k], sizes)))
            yield local
            for k in moved:
                t = cache[k]
                back = DTensor.from_local(local[k], self.mesh, want[k], run_check=False,
                                          shape=t.shape, stride=t.stride())
                t.to_local().copy_(back.redistribute(self.mesh, t.placements).to_local())

        return hook

    def model_axis(self, lm: LM, cache: Optional[Cache], row_axes: Tuple[str, ...],
                   n_rows: int, stream=None, stationary: bool = False) -> tp.ModelAxis:
        """This rank's view of the ``model`` split for serving ``lm`` over
        ``cache`` (training: None, and the residual stream's global shape
        ``stream``, or the encoder-decoder's two by stack), the global
        batch's ``n_rows`` rows split over ``row_axes``; ``stationary``
        (serving): the weights' ``embed`` blocks stay where the rules allow
        (``ModelAxis.stationary``)."""
        shapes = self._shapes.get(lm)
        if shapes is None:
            shapes = self._shapes[lm] = tp.param_shapes(lm)
        return tp.ModelAxis(self.mesh, self.rules, shapes, cache,
                            tp.MeshCollectives(self.mesh), memo=self._memo,
                            rows=(row_axes, n_rows), stream=stream,
                            weight_stationary=stationary)

    def _serve(self, lm: LM, method: str, batch: Dict[str, torch.Tensor], cache: Cache,
               memory: Optional[torch.Tensor] = None) -> DTensor:
        local, axes = self.local_batch(batch)
        rows = shd.placements(self.mesh, (axes or None,))  # this rank's rows
        place = stream = None
        if method == "encode" or memory is not None:  # the memory as the reference lays it out
            shape = tuple((batch["frames"] if method == "encode" else memory).shape)
            place = self.memory_placements(shape)
            if Shard(1) in place:  # the frames split along model
                stream = {"enc_blocks": shape}
            if memory is not None:  # a memory whole along model: the rank's block, no move
                mem = memory if isinstance(memory, DTensor) else self.memory(memory)
                memory = mem.redistribute(self.mesh, place).to_local()
        axis = self.model_axis(lm, cache, axes, next(iter(batch.values())).shape[0], stream,
                               stationary=True)
        weight = self._weights(axis, ())  # under no_grad: the gather alone
        # every weight outside the stacks of blocks, which gather their own
        outer = {n: weight(n, p) for n, p in lm.named_parameters()
                 if n.split(".", 1)[0] not in tp.SPLIT_MODULES}
        hooks = {"materialize": weight, "model_axis": axis,
                 "layer_cache": self._layer_cache(axis, rows, gather=method == "decode")}
        with _reparametrize_module(lm, outer):
            if method == "encode":  # the rank's rows, and its block of the frames where they split
                out = lm.encode(local["frames"], materialize=weight, model_axis=axis)
                return DTensor.from_local(out, self.mesh, place, run_check=False)
            if method == "prefill":
                out = lm.prefill(local["tokens"], cache, local.get("prefix_embeds"), **hooks)
            elif memory is None:
                out = lm.decode_step(local["tokens"], cache, **hooks)
            else:  # the encoder-decoder: the memory gathered once, before the first block
                out = lm.decode_step(local["tokens"], cache, memory, **hooks)
        if axis.head is not None:  # this rank's vocab block
            names = self.mesh.mesh_dim_names
            rows = tuple(Shard(out.ndim - 1) if n == "model" else r
                         for n, r in zip(names, rows))
        return DTensor.from_local(out, self.mesh, rows, run_check=False)

    def prefill(self, lm: LM, batch: Dict[str, torch.Tensor], cache: Cache
                ) -> Tuple[DTensor, Cache]:
        """``Model.prefill`` on the mesh: batch holds the global ``tokens`` (and
        ``prefix_embeds``); returns (last-token logits [B, 1, V], rows on the
        batch axes and the vocabulary on ``model`` where it splits; ``cache``
        filled). For the encoder-decoder, batch holds the global ``frames``
        [B, T_f, d] and the prefill is the encode: returns (the memory
        [B, T_f, d] laid out by :meth:`memory_placements`: rows on the batch
        axes, ``Shard(1)`` on ``model`` where the frames split, else
        ``Replicate``; ``cache`` as given)."""
        method = "encode" if self.cfg.is_encoder_decoder else "prefill"
        return self._serve(lm, method, batch, cache), cache

    def decode_step(self, lm: LM, cache: Cache, tokens: torch.Tensor,
                    memory: Optional[torch.Tensor] = None) -> Tuple[DTensor, Cache]:
        """``Model.decode_step`` on the mesh: tokens [B, 1], the global batch;
        for the encoder-decoder, ``memory`` [B, T_f, d] as :meth:`prefill`
        returns it, a DTensor of its rows whole along ``model``, or a global
        tensor; each is laid out by :meth:`memory_placements` (a memory whole
        along ``model`` gives the rank its block of frames, a local slice).
        Where the frames split, the memory is gathered once a step, before
        the first decoder block (``ModelAxis.memory_in``)."""
        return self._serve(lm, "decode", {"tokens": tokens}, cache, memory), cache
