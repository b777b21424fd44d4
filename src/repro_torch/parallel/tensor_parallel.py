"""Tensor-parallel compute on the ``model`` axis: one rank's share of
attention, the dense MLP, the MoE experts, the RG-LRU's recurrent channels,
the embedding and the vocab head, and of the RWKV-6 time mix's heads and
channel mix's ``d_ff``, in serving and in training.

What GSPMD does to the reference's ``build_prefill_step``,
``build_serve_step`` and ``train_step`` under the strategies' ``heads``,
``kv_heads``, ``ff``, ``experts``, ``vocab`` and ``seq_cache`` rules
and ``rnn`` rules (``repro/parallel/sharding.py``), written out: every weight and cache keeps
its layout at rest, and the compute follows it. A :class:`ModelAxis` is one
rank's view of the split; the model code takes it as its ``model_axis``
hook (None in one process) and asks it

* ``split(name)``: the model split of a parameter (``sharding.model_split``
  on its resolved spec) where its compute splits (:func:`splits_compute`):
  the rank's query heads of ``wq``/``bq``/``wo``, its KV heads where
  ``n_kv_heads`` divides the axis, its ``d_ff`` columns, its block of each
  MoE layer's experts (dim 0 of ``w_up``/``w_gate``/``w_down`` where the
  axis divides E, else every expert's ``d_ff`` columns where it divides
  ``d_ff``, as the resolver gives the spec), its vocab rows, an RWKV-6
  layer's blocks (:meth:`ModelAxis._rwkv_split`);
* ``from_split(x)``: the sum over ``model`` after a row-parallel product
  (attention's ``wo``, the MLP's ``w_down``, the RG-LRU's ``w_out``, the
  RWKV-6 time mix's ``w_o``, the MoE's combine) and after
  the vocab-parallel lookup; its backward passes the gradient through
  (a reduce-scatter where the stream's sequence splits, below). A
  layer sums only where the contracted dim was split (:class:`LayerAxis`
  ``attn_sum``, ``mlp_sum``, ``rglru_sum``, ``tm_sum``, ``moe_sum``): a weight the axis
  does not divide
  is whole on every rank, and a sum would multiply it by the axis;
* ``to_split(x)``: the column-parallel input (after ``norm1``, ``norm2`` and
  ``final_norm`` where the layer or the head splits; the RG-LRU's two input
  products): the identity, whose
  backward sums the gradient over ``model``, so the norm's input gradient,
  and its scale's, are whole and equal on every rank (an all-gather where
  the stream's sequence splits, below);
* ``sums_gradient(name)``: whether a weight the axis replicates is read in
  part by the rank (``wk``/``wv``/``bk``/``bv`` where ``n_kv_heads`` does not
  divide the axis, QK-norm's scales: the rank's query heads read some of
  them; the router where the experts split: each gate's gradient comes
  from the rank's own experts' term; an RWKV-6 mix's ``mu_*`` and the time
  mix's ``decay_a`` where the mixer splits: they read the whole input), so
  its gradient is a partial term to be summed over ``model``; without the
  sequence split every other replicated weight is computed whole and equal
  on every rank;
* ``xent(logits, labels, mask)``: the vocab-parallel cross-entropy on the
  rank's [B, S, V/M] logits block: the row max over ``model`` (no
  gradient), the sum of ``exp`` over ``model``, the label's logit from the
  rank that holds it; the [B, S, V] logits are never whole;
* ``layer(i)``: the attention layer's :class:`LayerAxis` -- the KV heads its
  query heads read, the prefill's cache fill and decode attention over the
  cache where it lies; and the MoE layer (``LayerAxis.moe``): its tokens
  routed whole on every rank in the global batch's groups, as in one
  process, the rank's experts (or ff columns) computed and their term
  summed over ``model``, and in training its aux term, the global batch's.
  The router reads its input whole on every rank, so the aux term's part
  of the router's and the input's gradients would count once a rank where
  they are summed: :class:`_OneShare` lets it in at 1/M a rank.

The cache's K/V [B, L, Hkv, D] at rest (``sharding.cache_shardings``) splits
its sequence over the ``seq_cache`` axes (``model``, or ``data`` and
``model`` under ``serve_2d``) where they divide L, else its heads over
``model`` where they divide Hkv, else neither:

* prefill: where the weights split the KV heads and the cache the sequence,
  one all-to-all over ``model`` a layer takes the rank's heads to its
  positions; where every rank computed K/V whole, it writes its own
  positions, no communication;
* decode, sequence split: the step's q is gathered over ``model`` (B x Hq x
  D); each rank takes, in fp32, the partial softmax of every query head
  over the positions it holds (row max, sum, weighted V:
  ``flash_attention.ref.partial_attention``); the partials merge by
  log-sum-exp over the sequence's axes, and each rank keeps its own heads'
  rows for the row-parallel ``wo``. The new token's K/V row is written only
  where slot ``pos % L`` lies (gathered over ``model`` first where the
  weights split the KV heads). No cache entry moves;
* decode, heads split or whole, or a sequence split over axes of one rank
  (its one shard holds every position, as one process's cache does): the
  plain path on the rank's heads.

Collectives come from a ``comm`` object: :class:`MeshCollectives` (the
functional collectives on a ``DeviceMesh``, which the dry run's counter
sees), or :class:`Shares` (one process computing one rank's share in turn:
each reduction over ``model``, forward or backward, returns the rank's own
term, for the caller to combine -- a caller that feeds every rank's share
the same input and adds their outputs has autograd sum the input's
gradient; :meth:`Shares.merge_xent` combines the cross-entropy's terms; in
the sequence form the caller feeds each gather the gathered input and
sums and slices the whole term each reduce-scatter returns; the RWKV-6
channel mix's value terms it combines itself, :func:`rwkv_shares` and
:func:`seq_shares`).

A split weight's gradient is the rank's own block. That holds for the
RG-LRU's gates and the RWKV-6 time mix's ``w_o``, ``bonus``, ``decay_b``
and 1-D leaves too, which lie whole on every rank: the rank materializes
its blocks of them (``parallel/fsdp.py``), and the backward gathers the
blocks' gradients over ``model`` into the whole one, the sum over the
ranks' partial terms without its zeros.

The RWKV-6 layer splits in serving and in training alike: the time mix by
heads where the axis divides them -- r, k, v, g and the decay on the
rank's heads, WKV on them (in serving against the state's block on them,
which lies so at rest and is read and written in place; in training
through the chunked twin, the reference's training path), the per-head
group norm on the rank's ``out_norm`` block, and ``w_o``'s rows giving the
rank's term of a sum over ``model`` (one all-reduce, as attention's, or a
reduce-scatter along the sequence); ``w_v`` lies on its rows at rest (the
channel mix's rule, by leaf name), and the weights' gather brings it to
its columns (one all-to-all over ``model`` of the rank's block; in
training its gradient goes back to the rows by the inverse one). The
channel mix splits by ``d_ff`` where the resolved specs split ``w_k``'s
and ``w_v``'s ``ff`` dim and ``w_r``'s columns: the rank's value term is
reduce-scattered along ``d``, multiplied by the rank's block of the
receptance, and the product all-gathered along ``d``, or taken to the
rank's positions by one all-to-all where the stream's sequence splits
(:meth:`LayerAxis.channel_mix`, each collective with its autograd; no
``w_r`` gathered). The two conditions are independent. The mixes' ``mu_*``
and ``decay_a`` read the whole input: their gradients are partial terms,
summed over ``model``.

Out of this split, computed whole on every rank: an RWKV-6 mixer the axis
does not divide, an RG-LRU layer whose gate blocks the axis does not
divide, the MoE router (its gradient summed where the experts split) and
every norm.

Sequence parallelism in training (``seq``, the rank's positions of the
residual stream: ``sharding.stream_split``, given the stream's global
shape): the stream between sub-blocks is the rank's block [B, S'/M, d].
``to_split`` then all-gathers the normed block along the sequence
(:class:`_GatherSeq`, backward a reduce-scatter, which sums the ranks'
terms as ``_ToSplit``'s all-reduce did) and ``from_split`` reduce-scatters
the row-parallel term (:class:`_ReduceScatter`, backward an all-gather); a
compute that does not split (a layer, head or embedding the axis does not
divide) takes the gathered stream
(``gather``) and keeps the rank's positions (``own``: the slice's backward
pads with zeros). Each rank then back-propagates only its own positions'
term through every replicated weight, so ``sums_gradient`` names them all:
the norms' and unsplit mixers' gradients are summed over ``model`` where the
sequence splits, and not otherwise (equal on every rank). The MoE gathers
its rows along the sequence before the batch axes and reduce-scatters its
combine, so each rank still routes every token of the global groups and
no token all-to-all is taken; :class:`Shares` plays the sequence form for
one rank at a time (:func:`seq_shares`; an encoder-decoder block,
:func:`block_shares`). The encoder-decoder has two streams, the encoder's
and the decoder's, each split on its own length (:meth:`ModelAxis.on`);
the encoder's memory enters the decoder once, gathered whole
(:meth:`ModelAxis.memory_in`), and each block's cross-attention reads it
with no collective of its own.

Weight-stationary serving (the reference's ``serve_2d``, whose batch lies
off ``data``): a ``ModelAxis`` built with ``weight_stationary`` keeps the
``embed`` block of attention's, the dense MLP's, the MoE's (router and
experts), the RWKV-6 mixers' (where they split; all but ``tm.decay_b``),
the encoder-decoder's blocks' (all but the cross-attention's ``wk`` and
``wv``), the embedding's and the head's weights where the resolved spec puts it
(:meth:`ModelAxis.stationary`), so a rank holds the ``(embed block x
model block)`` of each (a MoE leaf's: its experts', or every expert's ff
block, times its embed block). The stream stays whole on every rank;
``column`` (:meth:`ModelAxis.column`, :meth:`LayerAxis.column`) multiplies
the rank's columns of it by the block and sums the partial product over
the block's axes, and ``whole`` (:meth:`ModelAxis.whole`, after
:meth:`LayerAxis.out`'s sum over ``model``) gathers a row product's or the
lookup's block of columns back to the whole stream. The model code calls
``column`` at each column product and ``out`` after each sub-block, and
branches on no strategy: without the block both are what they were. The
MoE takes a hook from :meth:`LayerAxis.moe` where its blocks stay
(:class:`_ModuleAxis`): its router's logits summed over the block's axes,
so every rank routes every token as one process; the dispatch of the
rank's columns; the experts' partial pre-activations summed; its output
the rank's block of columns, which :meth:`LayerAxis.moe` gathers. The
RWKV-6 time mix and channel mix take one too (:meth:`LayerAxis.hook`):
``w_r``, ``w_k``, ``w_g``, ``decay_a`` and the channel mix's ``w_k`` and
``w_r`` through ``column``; each ``w_v``, whose rows are its ``model``
block and whose columns its ``embed`` block, through ``row``
(:meth:`ModelAxis.row`: summed over ``model``, then the rank's ``model``
block of columns by a masked sum over ``data``), so WKV runs on the
rank's heads over its state block as before and the channel mix's value
and receptance meet on one block of columns, whose product is gathered
over ``model``. ``tm.decay_b`` [lora, d], whose ``embed`` dim is also its
heads' dim, is the one RWKV-6 weight still gathered over ``data``. An
RG-LRU layer whose ``rnn`` resolves to ``("data", "model")`` serves on the
rank's chunk ``d M + m`` of its channels, where ``conv_w``, ``conv_b``,
``lam``, ``w_out``'s rows and the state lie at rest
(:meth:`ModelAxis._rnn_chunk`), so no weight and no state entry moves: its
hook (:meth:`LayerAxis.hook`, :class:`_RnnAxis`) sums ``w_in_rec``'s and
``w_in_gate``'s partial products over ``data``, takes their ``model`` block
to the chunk by one all-to-all over ``model``, and gives the gates the
chunk's columns (their input the chunk's gate block, gathered where a chunk
is narrower than a block); ``w_out``'s term is summed over ``data`` and
``model`` (:meth:`LayerAxis.out`). The encoder-decoder's blocks take the
same products with no hook of their own, in the encode and in every decode
step: each encoder and decoder block's ``wq``, ``wk``, ``wv`` and ``w_up``
through ``column``, its ``wo`` and ``w_down`` ending in
:meth:`LayerAxis.out`; the decoder's cross-attention ``wq`` through
``column`` (the bias added once, after the sum) and its ``wo`` ending in
``out(h, "xattn_sum")``. The tied embedding keeps its block as the lookup
(its columns gathered by ``whole``) and as the head (``column``: the
partial logits summed). The cross-attention's ``wk`` and ``wv``, which
read the memory [B, T_f, d] rather than the step's token, are gathered
over ``data`` (``_MOVING_LEAVES``): kept, their partial K and V of every
frame would be summed at every step.

A layout whose collectives fall inside a layer, such as decode over a K/V
cache split by sequence (each rank's partial softmax merged over
``model``), or a weight-stationary grid (the sums over ``data``), cannot be
played one rank at a time: :class:`ThreadRanks` runs every rank of a
``model`` axis or a (``data`` x ``model``) grid at once, one thread each, in
one process (:func:`thread_shares`).
"""

from __future__ import annotations

import copy
import functools
import math
import threading
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple, Union

import torch
import torch.distributed._functional_collectives as funcol
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.nn.utils.stateless import _reparametrize_module

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.models import common
from repro_torch.models.moe import bf16_gates, group_size_for
from repro_torch.parallel import sharding as shd

# each stack's submodules whose compute splits along ``model`` (the LM's
# layers, the encoder-decoder's blocks), and the models' own leaves
SPLIT_MODULES = {"layers": ("attn", "mlp", "moe", "rglru", "tm", "cm"),
                 "enc_blocks": ("attn", "mlp"),
                 "dec_blocks": ("attn", "xattn", "mlp")}
SPLIT_LEAVES = ("embed", "unembed")
# the weights among them that move in serving all the same (every other one
# keeps its ``embed`` block there, ModelAxis.stationary):
# * the time mix's decay_b [lora, d], whose embed dim is also its heads' dim
#   (the rank's heads cannot stay on data);
# * the cross-attention's wk and wv, the only column products that read the
#   memory [B, T_f, d] and not the step's one token: kept, each decode step
#   would sum partial K and V [B, T_f, d/M] over data (at decode_32k's B 128
#   x 1500 frames, 64 columns a rank in bf16: 23.4 MiB each, about 1125 MiB
#   over whisper-medium's 24 blocks), where gathering their [d/D, H/M, hd]
#   blocks moves 48 x 128 KiB = 6 MiB a step
_MOVING_LEAVES = ("tm.decay_b", "xattn.wk", "xattn.wv")
# the RG-LRU's leaves with an embed block that stays: its two column products'
# (the others lie on the rank's chunk of the channels, ModelAxis._rnn_chunk)
_RNN_COLUMNS = ("w_in_rec", "w_in_gate")
# the row product ending each stationary part, by its LayerAxis sum
_ROW_LEAVES = {"attn_sum": "attn.wo", "xattn_sum": "xattn.wo", "mlp_sum": "mlp.w_down"}
# the RWKV-6 mixers and the dim of each leaf's block
_RWKV_MODULES = ("tm", "cm")
_TM_DIMS = {"w_r": 1, "w_k": 1, "w_v": 1, "w_g": 1, "decay_b": 1, "w_o": 0,
            "decay_base": 0, "out_norm": 0, "bonus": 0}
_CM_DIMS = {"w_k": 1, "w_v": 0, "w_r": 1}


def _stays(name: str) -> bool:
    """Whether a parameter is one whose ``embed`` block may stay where it
    lies in serving (:meth:`ModelAxis.stationary`): a weight whose compute
    splits (:func:`splits_compute`: attention's, the decoder's
    cross-attention's, the MLPs', the MoE's, the RWKV-6 mixers', the
    embedding and the head) but those of ``_MOVING_LEAVES``, and of the
    RG-LRU's only ``w_in_rec`` and ``w_in_gate``."""
    parts = name.split(".")
    return (splits_compute(name) and ".".join(parts[2:]) not in _MOVING_LEAVES
            and (len(parts) == 1 or parts[2] != "rglru" or parts[3] in _RNN_COLUMNS))


def splits_compute(name: str) -> bool:
    """Whether a parameter's compute may split along ``model``: attention's
    (the decoder's cross-attention's too), the dense MLP's, the MoE's and the
    RG-LRU's weights, the RWKV-6 time mix's and channel mix's, the
    embedding and the head. The MoE's router is among them with its spec
    unsplit: it is read whole, its gradient summed where the experts split
    (``ModelAxis.sums_gradient``). The encoder-decoder's positions, and
    every norm, are gathered whole."""
    parts = name.split(".")
    if len(parts) == 1:
        return name in SPLIT_LEAVES
    return len(parts) == 4 and parts[2] in SPLIT_MODULES.get(parts[0], ())


def _done(t: torch.Tensor) -> torch.Tensor:
    """A functional collective's result, waited for."""
    return t.wait() if isinstance(t, funcol.AsyncCollectiveTensor) else t


class MeshCollectives:
    """Collectives over one axis of a ``DeviceMesh`` at a time. Over an axis
    of one rank each is the identity, and returns its input."""

    def __init__(self, mesh: DeviceMesh):
        self.mesh = mesh
        self.sizes = shd.axis_sizes(mesh)

    def _group(self, axis: str):
        return (self.mesh, self.mesh.mesh_dim_names.index(axis))

    def all_reduce(self, x: torch.Tensor, axis: str, op: str = "sum") -> torch.Tensor:
        if self.sizes[axis] == 1:
            return x
        return _done(funcol.all_reduce(x, op, self._group(axis)))

    def all_gather(self, x: torch.Tensor, dim: int, axis: str) -> torch.Tensor:
        if self.sizes[axis] == 1:
            return x
        return _done(funcol.all_gather_tensor(x.contiguous(), dim, self._group(axis)))

    def all_to_all(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """Equal blocks of dim 0: block j goes to the axis's rank j, and the
        result's block i came from rank i. A caller lays the blocks it sends
        along a new dim 0 (``torch.stack`` of its chunks, as :meth:`move`
        and the prefill's cache fill do) and unbinds what it receives."""
        if self.sizes[axis] == 1:
            return x
        return _done(funcol.all_to_all_single(x.contiguous(), None, None, self._group(axis)))

    def move(self, x: torch.Tensor, src: int, dst: int, axis: str) -> torch.Tensor:
        """A rank's block of a tensor split along dim ``src`` over ``axis``
        -> its block of the split along ``dst``: one all-to-all, chunk j of
        ``x`` along ``dst`` to rank j, the chunks received laid along
        ``src`` in rank order."""
        got = self.all_to_all(torch.stack(x.chunk(self.sizes[axis], dst)), axis)
        return torch.cat(got.unbind(0), src)

    def reduce_scatter(self, x: torch.Tensor, dim: int, axis: str) -> torch.Tensor:
        """The sum over the axis, split along ``dim``: rank i keeps block i."""
        if self.sizes[axis] == 1:
            return x
        return _done(funcol.reduce_scatter_tensor(x.contiguous(), "sum", dim,
                                                  self._group(axis)))


class Shares:
    """One rank's share computed alone: a reduction over ``model`` (a sum, or
    the cross-entropy's max) is left to the caller, so ``all_reduce``
    returns the rank's own term, forward and backward."""

    def all_reduce(self, x: torch.Tensor, axis: str, op: str = "sum") -> torch.Tensor:
        if axis != "model" or op not in ("sum", "max"):
            raise NotImplementedError(f"a share alone has no {op} over {axis}")
        return x

    @staticmethod
    def merge_xent(terms: List[Tuple[torch.Tensor, torch.Tensor]]
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Every rank's :meth:`ModelAxis.xent_terms` (the log-sum-exp of its
        own logits block, its own label logit) -> the terms over ``model``, as
        the mesh's reductions give them to every rank."""
        lse = torch.logsumexp(torch.stack([t[0] for t in terms]), 0)
        return lse, sum(gold for _, gold in terms)

    def all_gather(self, x, dim, axis):
        """The stream's sequence (dim 1 over ``model``): the caller plays the
        gather and feeds the gathered input, so this is the identity.
        Nothing else is gathered."""
        if (dim, axis) != (1, "model"):
            raise NotImplementedError("a share alone gathers nothing: give it a layout "
                                      "without a sequence-split cache")
        return x

    def reduce_scatter(self, x, dim, axis):
        """The stream's sequence: the rank's whole term, for the caller to sum
        over the ranks and slice."""
        if (dim, axis) != (1, "model"):
            raise NotImplementedError(f"a share alone has no reduce-scatter over {axis}")
        return x

    def all_to_all(self, x, axis):
        raise NotImplementedError("a share alone moves nothing: give it a layout "
                                  "without a sequence-split cache")


def _coordinate(r: int, sizes: Mapping[str, int]) -> Dict[str, int]:
    """Rank r's index along each axis of a mesh of ``sizes`` (in mesh
    order), row-major, as ``DeviceMesh`` numbers its ranks."""
    out = {}
    for name in reversed(list(sizes)):
        r, out[name] = divmod(r, sizes[name])
    return {name: out[name] for name in sizes}


class ThreadRanks:
    """A mesh played by threads of one process, on one device, a thread a
    rank: a ``model`` axis of ``size`` ranks, or a grid of axis sizes in
    mesh order (``{"data": 2, "model": 4}``), rank r at its row-major
    coordinate, as ``DeviceMesh`` numbers its ranks. Every rank takes the
    same collectives in the same order, as on a mesh: each meets the
    others' at a barrier and returns what the mesh's would over its group
    along the axis, the group's terms reduced in rank order in their own
    dtype. :meth:`rank` is rank r's comm, :meth:`run` runs a function on
    every rank at once."""

    def __init__(self, size: Union[int, Mapping[str, int]]):
        self.sizes = dict(size) if isinstance(size, Mapping) else {"model": size}
        self.size = math.prod(self.sizes.values())
        # a rank left waiting (one that skipped a collective the others
        # took) raises instead of hanging the process
        self._barrier = threading.Barrier(self.size, timeout=600.0)
        self._slots: List[Optional[torch.Tensor]] = [None] * self.size

    def rank(self, r: int) -> "_ThreadRank":
        return _ThreadRank(self, r)

    def coordinate(self, r: int) -> Dict[str, int]:
        """Rank r's index along each axis (row-major)."""
        return _coordinate(r, self.sizes)

    def group(self, r: int, axis: str) -> List[int]:
        """The ranks of r's group along ``axis`` (r's other coordinates),
        in the axis's order."""
        stride = math.prod(list(self.sizes.values())[list(self.sizes).index(axis) + 1:])
        first = r - self.coordinate(r)[axis] * stride
        return [first + j * stride for j in range(self.sizes[axis])]

    def exchange(self, r: int, x: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's ``x``, in rank order, once all have given theirs."""
        self._slots[r] = x
        self._barrier.wait()
        got = list(self._slots)
        self._barrier.wait()  # no rank overwrites its slot before all have read
        return got

    def run(self, fn: Callable[[int], Any]) -> List[Any]:
        """``fn(r)`` for every rank r, each in its own thread -> the results in
        rank order. A rank that raises breaks the barrier, so the others stop
        too, and its error is raised here."""
        out: List[Any] = [None] * self.size
        errors: List[BaseException] = []

        def one(r: int) -> None:
            try:
                out[r] = fn(r)
            except BaseException as e:  # re-raised below, in the caller's thread
                errors.append(e)
                self._barrier.abort()

        threads = [threading.Thread(target=one, args=(r,)) for r in range(self.size)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise next((e for e in errors if not isinstance(e, threading.BrokenBarrierError)),
                       errors[0])
        return out


class _ThreadRank:
    """Rank ``r``'s collectives over a :class:`ThreadRanks` mesh. Over an
    axis of one rank each is the identity, as :class:`MeshCollectives`'."""

    def __init__(self, ranks: ThreadRanks, r: int):
        self.ranks, self.r = ranks, r

    def _over(self, x: torch.Tensor, axis: str) -> List[torch.Tensor]:
        if axis not in self.ranks.sizes:
            raise NotImplementedError(f"the threads play {tuple(self.ranks.sizes)}, not {axis}")
        if self.ranks.sizes[axis] == 1:
            return [x]
        got = self.ranks.exchange(self.r, x)
        return [got[i] for i in self.ranks.group(self.r, axis)]

    def all_reduce(self, x: torch.Tensor, axis: str, op: str = "sum") -> torch.Tensor:
        reduce = {"sum": torch.add, "max": torch.maximum}[op]
        return functools.reduce(reduce, self._over(x, axis))

    def all_gather(self, x: torch.Tensor, dim: int, axis: str) -> torch.Tensor:
        return torch.cat(self._over(x, axis), dim)

    def reduce_scatter(self, x: torch.Tensor, dim: int, axis: str) -> torch.Tensor:
        """The sum over the axis, split along ``dim``: the rank's block."""
        total = self.all_reduce(x, axis)
        return total.chunk(self.ranks.sizes[axis], dim)[self.ranks.coordinate(self.r)[axis]]

    def all_to_all(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """As :meth:`MeshCollectives.all_to_all`: block j of dim 0 to the
        group's rank j; the result's block i from rank i."""
        got = self._over(x, axis)
        mine = self.ranks.coordinate(self.r)[axis]
        return torch.cat([t.chunk(len(got), 0)[mine] for t in got], 0)


Comm = Union[MeshCollectives, Shares, _ThreadRank]


class _ToSplit(torch.autograd.Function):
    """Into the split: the identity; backward, the gradient summed over
    ``model`` (each rank's term comes from its own heads, columns or rows)."""

    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.comm.all_reduce(grad, "model"), None


class _LogSumExp(torch.autograd.Function):
    """The log-sum-exp [B, S] over ``model`` of the rank's fp32 logits block
    [B, S, V/M]: ``max + log(sum(exp(logits - max)))``, the max and the sum
    taken over ``model`` (the max without a gradient). Backward: the
    gradient times ``exp(logits - lse)`` on the rank's block, no
    communication; both sides are ``torch.logsumexp``'s own formulas, so a
    one-rank axis computes it bit for bit."""

    @staticmethod
    def forward(ctx, logits, comm):
        m = comm.all_reduce(logits.amax(-1), "model", "max")
        s = comm.all_reduce(torch.exp(logits - m[..., None]).sum(-1), "model")
        lse = torch.log(s) + m
        ctx.save_for_backward(logits, lse)
        return lse

    @staticmethod
    def backward(ctx, grad):
        logits, lse = ctx.saved_tensors
        return grad[..., None] * torch.exp(logits - lse[..., None]), None


class _OneShare(torch.autograd.Function):
    """A term whole and equal on every rank along ``model`` (the MoE's aux
    loss) whose gradient enters sums over ``model``: the identity; backward,
    the gradient divided by the axis's size, so the sums count it once."""

    @staticmethod
    def forward(ctx, x, size):
        ctx.size = size
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad / ctx.size, None


class _SummedGates(torch.autograd.Function):
    """The MoE gates passed through bf16 (``moe.bf16_gates``) where each
    rank's expert outputs are a partial term (the ff split): backward, the
    gates' gradient summed over ``model`` before its bf16 rounding, as one
    process rounds the whole, and 1/M of it returned to each rank, whose
    router and input gradients are summed over ``model``. A share alone
    has no other rank's term to round with, and raises."""

    @staticmethod
    def forward(ctx, top_vals, dtype, comm, size):
        ctx.comm, ctx.size, ctx.dtype = comm, size, top_vals.dtype
        return bf16_gates(top_vals, dtype)

    @staticmethod
    def backward(ctx, grad):
        if isinstance(ctx.comm, Shares):
            raise NotImplementedError("a share alone cannot round the summed gradient of "
                                      "the gates of an ff-split MoE: run it on the ranks")
        whole = ctx.comm.all_reduce(grad, "model")
        return whole.to(torch.bfloat16).to(ctx.dtype) / ctx.size, None, None, None


class _FromSplit(torch.autograd.Function):
    """Out of the split: the sum over ``model``; backward, the gradient passed
    through to each rank's term."""

    @staticmethod
    def forward(ctx, x, comm):
        out = comm.all_reduce(x, "model")
        return x.view_as(x) if out is x else out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherSeq(torch.autograd.Function):
    """The rank's block of the stream [B, S'/M, ...] all-gathered over
    ``model`` along the sequence; backward, the gradient reduce-scattered
    (every rank's term summed, the rank's block kept)."""

    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        out = comm.all_gather(x, 1, "model")
        return x.view_as(x) if out is x else out

    @staticmethod
    def backward(ctx, grad):
        return ctx.comm.reduce_scatter(grad, 1, "model"), None


class _ReduceScatter(torch.autograd.Function):
    """A term reduce-scattered over ``model`` along ``dim``: the sum, the
    rank's block of it (a row-parallel term [B, S', ...] along the sequence;
    the RWKV-6 channel mix's value term along ``d``); backward, the gradient
    all-gathered along ``dim`` (every rank's term reads every position or
    column)."""

    @staticmethod
    def forward(ctx, x, comm, dim):
        ctx.comm, ctx.dim = comm, dim
        out = comm.reduce_scatter(x, dim, "model")
        return x.view_as(x) if out is x else out

    @staticmethod
    def backward(ctx, grad):
        return ctx.comm.all_gather(grad, ctx.dim, "model"), None, None


class _GatherWhole(torch.autograd.Function):
    """The rank's block of a tensor that is then whole and equal on every
    rank, all-gathered over ``model`` along ``dim`` (the RWKV-6 channel
    mix's column block [..., d/M]; the encoder's memory [B, T_f/M, d] where
    no rank's gradient of it is a partial term); backward, the rank's block
    of the gradient, which is whole and equal on every rank too. ``index``:
    the rank's coordinate on ``model``."""

    @staticmethod
    def forward(ctx, x, comm, index, dim):
        ctx.dim, ctx.lo, ctx.n = dim, index * x.shape[dim], x.shape[dim]
        out = comm.all_gather(x, dim, "model")
        return x.view_as(x) if out is x else out

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.lo, ctx.n), None, None, None


class _ToPositions(torch.autograd.Function):
    """The rank's column block [B, S', d/M] of a term whole along the
    sequence -> the rank's positions [B, S'/M, d] of it: one all-to-all over
    ``model`` (:meth:`MeshCollectives.move`); backward, the inverse one. Each rank
    back-propagates only its own positions, so the move carries 1/M of the
    stream each way, where an all-gather along ``d`` and a slice would take
    a whole-stream reduce-scatter in the backward."""

    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return comm.move(x, x.ndim - 1, 1, "model")

    @staticmethod
    def backward(ctx, grad):
        return ctx.comm.move(grad, 1, grad.ndim - 1, "model"), None


def _sum_over(x: torch.Tensor, comm: Comm, axes: Tuple[str, ...]) -> torch.Tensor:
    for name in axes:
        x = comm.all_reduce(x, name)
    return x


class _SumAndUse(torch.autograd.Function):
    """The sum over the batch axes of a term every rank then uses in its own
    loss; backward, the gradient summed over them too."""

    @staticmethod
    def forward(ctx, x, comm, axes):
        ctx.comm, ctx.axes = comm, axes
        out = _sum_over(x, comm, axes)
        return x.view_as(x) if out is x else out

    @staticmethod
    def backward(ctx, grad):
        return _sum_over(grad, ctx.comm, ctx.axes), None, None


class _GatherRows(torch.autograd.Function):
    """Rows [B, ...] gathered over the batch axes, in row-major order of the
    axes (this rank's block is block ``index``); backward, the gradient
    summed over them (every rank's loss read every row) and this rank's rows
    kept."""

    @staticmethod
    def forward(ctx, x, comm, axes, index):
        ctx.comm, ctx.axes, ctx.rows = comm, axes, slice(index * len(x), (index + 1) * len(x))
        for name in reversed(axes):  # the innermost axis first: row-major
            x = comm.all_gather(x, 0, name)
        return x

    @staticmethod
    def backward(ctx, grad):
        return _sum_over(grad, ctx.comm, ctx.axes)[ctx.rows], None, None, None


def cache_key(cache: Mapping[str, Any]) -> str:
    """The key of a decode cache's per-layer list: an LM's ``layers``, or
    the encoder-decoder's decoder self caches, ``self``."""
    return "layers" if "layers" in cache else "self"


def param_shapes(lm: nn.Module) -> Dict[str, Tuple[int, ...]]:
    """Each parameter's global shape (a DTensor's too), by state-dict name."""
    return {n: tuple(p.shape) for n, p in lm.named_parameters()}


def kv_heads(q_lo: int, q_hi: int, n_q: int, n_kv: int) -> Union[slice, List[int]]:
    """The KV heads query heads ``[q_lo, q_hi)`` read (query head i reads KV
    head i // (n_q / n_kv)), in the form flash pairs them: a slice where the
    rank's query heads group evenly onto it, else one KV head per query head."""
    g = n_q // n_kv
    lo, hi = q_lo // g, (q_hi - 1) // g + 1
    n, m = q_hi - q_lo, hi - lo
    if n % m == 0 and all((q_lo + j) // g - lo == j // (n // m) for j in range(n)):
        return slice(lo, hi)
    return [(q_lo + j) // g for j in range(n)]


class ModelAxis:
    """One rank's view of the ``model`` split for one serving call or one
    training loss.

    ``shapes``: the LM's parameters' global shapes by state-dict name
    (:func:`param_shapes`); ``cache``: its decode cache (global shapes; None
    in training);
    ``coord``: the rank's mesh coordinate where ``mesh`` is given by axis
    sizes; ``memo``: a dict kept across one rank's calls (a split depends
    only on the name and the shape); ``rows``: the mesh axes the batch's rows
    split over and the global batch (none: the rows are whole); ``stream``:
    in training, the residual stream's global shape (B, S', d), whose
    sequence splits over ``model`` where the rules say so
    (``sharding.stream_split``: ``seq``, the rank's positions, or None); for
    the encoder-decoder, each stream's by stack, ``{"enc_blocks": (B, T_f,
    d), "dec_blocks": (B, S, d)}``, which split independently. ``seq`` is
    then the decoder's, the stream the lookup and the head read;
    :meth:`on` gives the encoder's view, which keeps ``weight_stationary``.
    ``weight_stationary`` (serving): the ``embed`` blocks of attention's,
    the dense MLP's, the MoE's, the RWKV-6 mixers', the RG-LRU's input
    products', the encoder-decoder's blocks', the embedding's and the
    head's weights stay where they lie where the rules allow
    (:meth:`stationary`), and the products they enter are summed or
    gathered over those blocks' axes (:meth:`column`, :meth:`summed`,
    :meth:`whole`); an RG-LRU layer serves on its ``(data, model)`` chunk
    of the channels where ``rnn`` lays them out so (:meth:`_rnn_chunk`)."""

    def __init__(self, mesh: shd.Mesh, rules: Dict[str, shd.MeshAxes],
                 shapes: Mapping[str, Tuple[int, ...]], cache: Optional[Mapping[str, Any]],
                 comm: Comm,
                 coord: Optional[Mapping[str, int]] = None, memo: Optional[Dict] = None,
                 rows: Tuple[Tuple[str, ...], int] = ((), 0),
                 stream: Union[None, Tuple[int, int, int],
                               Mapping[str, Tuple[int, int, int]]] = None,
                 weight_stationary: bool = False):
        self.mesh, self.rules, self.shapes, self.comm = mesh, rules, shapes, comm
        self.row_axes, self.n_rows = rows
        self.weight_stationary = weight_stationary
        self.sizes = shd.axis_sizes(mesh)
        self.coord = shd.coordinate(mesh, coord)
        streams = (stream if isinstance(stream, Mapping)
                   else {} if stream is None else {"layers": stream})
        self._seqs = {k: shd.stream_split(mesh, rules, s, self.coord)
                      for k, s in streams.items()}
        self.seq = self._seqs.get("dec_blocks", self._seqs.get("layers"))
        self._root, self._encoder = self, None
        self._layers = None if cache is None else cache[cache_key(cache)]
        self._memo = {} if memo is None else memo
        self.head = self.split("unembed" if "unembed" in shapes else "embed")

    def on(self, name: str) -> "ModelAxis":
        """This axis as the stream that stack or parameter ``name`` works on
        splits it: the encoder's (``enc_blocks``, ``enc_pos``, ``enc_norm``:
        a view whose ``seq`` is the encoder stream's split), else the one
        stream of an LM or the decoder's, the root axis itself."""
        root = self._root
        if not name.startswith("enc_"):
            return root
        if root._encoder is None:
            root._encoder = copy.copy(root)
            root._encoder.seq = root._seqs.get("enc_blocks")
        return root._encoder

    def split(self, name: str) -> Optional[shd.Split]:
        """The model split of parameter ``name`` where its compute splits,
        else None (also for a name the LM does not have)."""
        shape = self.shapes.get(name)
        if shape is None or not splits_compute(name):
            return None
        parts = name.split(".")
        rwkv = len(parts) == 4 and parts[2] in _RWKV_MODULES
        # the time mix's w_v splits its rows where its embed block stays
        key = (name, shape, self.weight_stationary, self.row_axes)
        if key not in self._memo and ".rglru." in name:
            self._memo[key] = self._rnn_split(name, shape)
        if key not in self._memo and rwkv:
            self._memo[key] = self._rwkv_split(name, shape)
        if key not in self._memo:
            leaf = name.rsplit(".", 1)[-1]
            spec = shd.resolve_spec(self.mesh, self.rules,
                                    shd.logical_for_leaf(leaf, len(shape)), shape)
            split = shd.model_split(self.mesh, spec, shape, self.coord)
            if split is not None and split.axes != ("model",):
                raise NotImplementedError(f"{name}: spec {spec} splits a dim over "
                                          f"{split.axes}; only a split over model alone "
                                          "is served")
            self._memo[key] = split
        return self._memo[key]

    def _rnn_split(self, name: str, shape: Tuple[int, ...]) -> Optional[shd.Split]:
        """An RG-LRU leaf's block along its channel dim (its logical ``rnn``
        dim, the gates' ``blocks``): the ``model`` block
        ``[m n/M, (m+1) n/M)``, where the rules split
        ``rnn`` over ``model`` and the axis divides the layer's gate blocks;
        else None (the layer runs whole). Where the layer lies on the rank's
        ``(data, model)`` chunk of the channels (:meth:`_rnn_chunk`: serving
        under ``serve_2d``), ``conv_w``'s, ``conv_b``'s and ``lam``'s block
        and ``w_out``'s rows are that chunk, where they lie at rest; the
        gates, whole at rest, are None (the layer's hook reads the chunk's
        columns, ``_RnnAxis.gates``); ``w_in_rec`` and ``w_in_gate`` keep
        their ``model`` block of columns (and their ``embed`` block,
        :meth:`stationary`). Elsewhere the block is ``model``'s alone, also
        where ``serve_2d`` lays a leaf out over ``(data, model)`` and the
        chunk form does not apply: the weights' gather brings it there
        (``parallel/fsdp.py``)."""
        M = self.sizes.get("model")
        prefix, leaf = name.rsplit(".", 1)
        n_blocks = self.shapes[prefix + ".gate_a"][0]
        if M is None or "model" not in shd._axes(self.rules.get("rnn")) or n_blocks % M:
            return None
        logical = shd.logical_for_leaf(leaf, len(shape))
        dim = next(i for i, a in enumerate(logical) if a in ("rnn", "blocks"))
        chunk = self._rnn_chunk(prefix)
        if chunk is not None and leaf not in _RNN_COLUMNS:
            return None if logical[dim] == "blocks" else chunk._replace(dim=dim)
        step, m = shape[dim] // M, self.coord["model"]
        return shd.Split(dim, ("model",), m * step, (m + 1) * step)

    def _rnn_chunk(self, prefix: str) -> Optional[shd.Split]:
        """The rank's chunk of the channels of the RG-LRU layer ``prefix``
        (``layers.{i}.rglru``) where it serves on its layout at rest: under
        ``weight_stationary``, where ``rnn`` resolves to ``("data",
        "model")`` for the layer's width w (``serve_2d``: ``conv_w``,
        ``conv_b``, ``lam``, ``w_out``'s rows and the state ``h`` and
        ``conv``), chunk ``c = d M + m`` of the ``D M``, row-major:
        ``Split(0, ("data", "model"), c w/DM, (c+1) w/DM)``. None (the
        gathered path, on the ``model`` block) where ``data`` holds one rank
        or the batch's rows, where ``D M`` does not divide w (the resolver
        then drops ``model``), where ``model`` does not divide the gate
        blocks, or where a chunk straddles a gate block's edge (neither of
        the chunk's and the block's widths a multiple of the other)."""
        if not self.weight_stationary or "data" in self.row_axes:
            return None
        w, n_blocks = self.shapes[prefix + ".lam"][0], self.shapes[prefix + ".gate_a"][0]
        spec = shd.resolve_spec(self.mesh, self.rules, shd.logical_for_leaf("lam", 1), (w,))
        if shd._axes(spec[0]) != ("data", "model") or self.sizes["data"] == 1:
            return None
        n = self.sizes["data"] * self.sizes["model"]
        if n_blocks % self.sizes["model"] or (n % n_blocks and n_blocks % n):
            return None
        return shd.dim_split(self.mesh, spec, 0, (w,), self.coord)

    def _rwkv_split(self, name: str, shape: Tuple[int, ...]) -> Optional[shd.Split]:
        """An RWKV-6 leaf's ``model`` block, in serving and in training: the
        rank's contiguous block along its dim in ``_TM_DIMS`` (the time mix's
        heads: ``d / M`` columns of ``w_r``/``w_k``/``w_v``/``w_g``/
        ``decay_b``, entries of ``decay_base``/``out_norm``, rows of ``w_o``,
        and ``H / M`` rows of ``bonus``) where the axis divides the heads, or
        in ``_CM_DIMS`` (the channel mix's ``d_ff`` block: ``w_k``'s columns,
        ``w_v``'s rows, and ``d / M`` of ``w_r``'s columns) where the resolved
        specs split those dims over ``model``; else None (the mixer runs
        whole). The mixes' ``mu_*`` and ``decay_a`` read the whole input:
        None, their gradients summed over ``model`` where the mixer splits
        (:meth:`sums_gradient`). ``tm.w_v`` lies on its rows at rest (its
        resolved spec reads the leaf name alone); its block here is its
        columns, and the weights' gather brings it there (and its gradient
        back), but where its ``embed`` block stays (:meth:`stationary`),
        where it lies: its rows, the input of :meth:`row`."""
        M = self.sizes.get("model")
        prefix, leaf = name.rsplit(".", 1)
        dims = _TM_DIMS if prefix.endswith(".tm") else _CM_DIMS
        if M is None or leaf not in dims:
            return None
        if dims is _TM_DIMS and self.shapes[prefix + ".bonus"][0] % M:
            return None
        if dims is _CM_DIMS:
            for other, dim in _CM_DIMS.items():
                full = self.shapes[f"{prefix}.{other}"]
                spec = shd.resolve_spec(self.mesh, self.rules,
                                        shd.logical_for_leaf(other, len(full)), full)
                split = shd.model_split(self.mesh, spec, full, self.coord)
                if split is None or split.dim != dim or split.axes != ("model",):
                    return None
        dim = dims[leaf]
        if dims is _TM_DIMS and leaf == "w_v" and self.stationary(name) is not None:
            dim = 0
        step, m = shape[dim] // M, self.coord["model"]
        return shd.Split(dim, ("model",), m * step, (m + 1) * step)

    def stationary(self, name: str) -> Optional[shd.Split]:
        """Under ``weight_stationary``, the rank's block of the ``embed`` dim
        of parameter ``name`` (``sharding.embed_split``) that stays where it
        lies, as the reference's ``serve_2d`` keeps it: for attention's, the
        dense MLP's, the MoE's and the RWKV-6 mixers' weights (but
        ``tm.decay_b``) and the RG-LRU's ``w_in_rec`` and ``w_in_gate`` of the
        LM's layers, for the encoder-decoder's blocks' attention and MLP
        weights (but the cross-attention's ``wk`` and ``wv``), the embedding
        and the head (:func:`_stays`), where the resolved spec
        splits that dim over axes that hold more than one rank, none of them
        an axis the batch's rows split over (``serve_2d``'s ``data``; under
        ``fsdp_tp`` the rows lie on it); for an RWKV-6 mixer's weight, where
        the mixer splits along ``model`` (the time mix's heads, the channel
        mix's ``d_ff``); for an RG-LRU weight, where the layer serves on its
        chunk of the channels (:meth:`_rnn_chunk`). Else None: the weight is
        gathered over those axes (a ``d_model`` they do not divide resolves
        to whole), as in training."""
        shape = self.shapes.get(name)
        if not self.weight_stationary or shape is None or not _stays(name):
            return None
        key = ("stationary", name, shape, self.row_axes)
        if key not in self._memo:
            block = shd.embed_split(self.mesh, self.rules, name, shape, self.coord)
            if block is not None and (math.prod(self.sizes[a] for a in block.axes) == 1
                                      or any(a in self.row_axes for a in block.axes)
                                      or self._rwkv_whole(name)
                                      or (".rglru." in name
                                          and self._rnn_chunk(name.rsplit(".", 1)[0]) is None)):
                block = None
            self._memo[key] = block
        return self._memo[key]

    def _rwkv_whole(self, name: str) -> bool:
        """Whether ``name`` is a leaf of an RWKV-6 mixer that runs whole
        along ``model`` (the axis divides neither its heads nor, for the
        channel mix, the resolved ``d_ff`` split)."""
        prefix = name.rsplit(".", 1)[0]
        leaf = {"tm": "bonus", "cm": "w_v"}.get(prefix.rsplit(".", 1)[-1])
        return leaf is not None and self.split(f"{prefix}.{leaf}") is None

    def column(self, x: torch.Tensor, w: torch.Tensor, name: str) -> torch.Tensor:
        """A column product ``x @ w`` of the whole stream x [..., d] and the
        weight ``w`` as the rank computes with it, laid out [embed, ...]:
        where parameter ``name``'s ``embed`` block stays (:meth:`stationary`),
        the rank's block of x's columns times it, the partial product summed
        over the block's axes (one all-reduce of activations an axis); else
        ``x @ w``. Serving only: the sum has no backward."""
        return self.summed(self.columns(x, name) @ w, name)

    def columns(self, x: torch.Tensor, name: str) -> torch.Tensor:
        """The rank's block of x's columns [..., d/D] where parameter
        ``name``'s ``embed`` block stays (:meth:`stationary`), else x."""
        block = self.stationary(name)
        return x if block is None else x[..., block.lo:block.hi]

    def summed(self, x: torch.Tensor, name: str) -> torch.Tensor:
        """A partial product over parameter ``name``'s ``embed`` block where
        that block stays, summed over the block's axes (one all-reduce of
        activations an axis); else x. Serving only: no backward."""
        block = self.stationary(name)
        return x if block is None else _sum_over(x, self.comm, block.axes)

    def row(self, x: torch.Tensor, w: torch.Tensor, name: str) -> torch.Tensor:
        """The product ``x @ w`` with an RWKV-6 mixer's ``w_v`` as the rank
        computes with it, where its ``embed`` block of columns stays
        (:meth:`stationary`) and its rows are its ``model`` block
        (:meth:`split`): x is the whole input [..., n], whose ``model``
        block is taken here (the time mix), or that block [..., n/M] (the
        channel mix's hidden, on the rank's ``d_ff`` block). The partial
        product [..., d/D], the block's columns, is summed over ``model``;
        the rank then takes its ``model`` block of the output's columns
        [..., d/M] (the time mix's heads, the channel mix's receptance
        block) by laying what it holds of them into zeros and summing over
        the block's axes: d/M columns move, where a gather of the whole
        output and a slice would move d. Else ``x @ w``. Serving only: the
        sums have no backward."""
        block = self.stationary(name)
        if block is None:
            return x @ w
        split = self.split(name)
        if x.shape[-1] != w.shape[0]:
            x = x[..., split.lo:split.hi]
        part = self.comm.all_reduce(x @ w, "model")
        n, M, m = self.shapes[name][-1], self.sizes["model"], self.coord["model"]
        lo, hi = m * n // M, (m + 1) * n // M
        out = part.new_zeros(part.shape[:-1] + (hi - lo,))
        a, b = max(lo, block.lo), min(hi, block.hi)
        if a < b:
            out[..., a - lo:b - lo] = part[..., a - block.lo:b - block.lo]
        return _sum_over(out, self.comm, block.axes)

    def whole(self, x: torch.Tensor, name: str) -> torch.Tensor:
        """The output [..., d/D] of a product with parameter ``name`` whose
        ``embed`` block stays (a row product, or the lookup): the rank's
        block of the stream's columns, all-gathered over the block's axes,
        row-major, to the whole stream [..., d]; else ``x``."""
        block = self.stationary(name)
        if block is None:
            return x
        for a in reversed(block.axes):  # the innermost axis first: row-major
            x = self.comm.all_gather(x, x.ndim - 1, a)
        return x

    def from_split(self, x: torch.Tensor) -> torch.Tensor:
        """Out of a row-parallel product: the sum over ``model``, its backward
        passing the gradient through; where the sequence splits, the sum
        reduce-scattered along it (the rank's block), its backward an
        all-gather."""
        if self.seq is not None:
            return _ReduceScatter.apply(x, self.comm, 1)
        return _FromSplit.apply(x, self.comm)

    def to_split(self, x: torch.Tensor) -> torch.Tensor:
        """Into a column-parallel product: the identity, its backward summing
        the gradient over ``model``; where the sequence splits, the rank's
        block all-gathered along it, its backward a reduce-scatter."""
        if self.seq is not None:
            return _GatherSeq.apply(x, self.comm)
        return _ToSplit.apply(x, self.comm)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Into a compute that does not split along ``model`` (a mixer, a
        layer the axis does not divide): where the sequence splits, the
        rank's block all-gathered, as :meth:`to_split`; else ``x``."""
        return x if self.seq is None else _GatherSeq.apply(x, self.comm)

    def own(self, x: torch.Tensor) -> torch.Tensor:
        """Out of such a compute, whole on every rank: where the sequence
        splits, the rank's positions (the slice's backward pads the gradient
        with zeros); else ``x``."""
        return x if self.seq is None else x[:, self.seq.lo:self.seq.hi]

    def sums_gradient(self, name: str) -> bool:
        """Whether parameter ``name`` is replicated over ``model`` (its
        resolved spec does not split it) and yet read in part by this rank,
        so that its gradient is this rank's term of a sum over ``model``:
        where its module's compute splits; and, where the sequence of the
        stream it works on splits (:meth:`on`: the encoder's for its
        positions, final norm and blocks, else the decoder's or the LM's),
        every replicated weight, since each rank back-propagates only its
        own positions' term (the norms on its block, a mixer or an unsplit
        layer, embedding or head through :meth:`own`)."""
        if self.split(name) is not None:
            return False
        if self.on(name).seq is not None:
            return True
        if not splits_compute(name):
            return False
        parts = name.split(".")
        if len(parts) == 1:  # the embedding and the head split with the vocabulary
            return False
        return getattr(self.layer(int(parts[1]), parts[0]), parts[2] + "_sum")

    def xent_terms(self, logits: torch.Tensor, labels: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The vocab-parallel cross-entropy's terms [B, S] on this rank's
        logits block [B, S, V/M] (the head's split, after the final softcap),
        in fp32 (fp64 stays fp64): the log-sum-exp over ``model`` (the row max over ``model``,
        the sum of ``exp`` over ``model``: :class:`_LogSumExp`) and the label's
        logit, a masked gather on each rank summed over ``model`` (only its
        owner's is not 0). Under :class:`Shares`, the rank's own terms."""
        split = self.head
        logits = common.at_least_fp32(logits)
        labels = labels.long()
        inside = (labels >= split.lo) & (labels < split.hi)
        gold = logits.gather(-1, torch.where(inside, labels - split.lo, 0)[..., None])[..., 0]
        return _LogSumExp.apply(logits, self.comm), _FromSplit.apply(
            torch.where(inside, gold, 0.0), self.comm)

    def xent(self, logits: torch.Tensor, labels: torch.Tensor,
             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``common.softmax_xent`` on this rank's logits block: the masked mean
        of ``log-sum-exp - label logit`` (:meth:`xent_terms`)."""
        lse, gold = self.xent_terms(logits, labels)
        return common.masked_mean(lse - gold, mask)

    def seq_xent(self, logits: torch.Tensor, labels: torch.Tensor,
                 mask: Optional[torch.Tensor], prefix_len: int) -> torch.Tensor:
        """``common.softmax_xent`` where the sequence splits and the head does
        not: ``logits`` [B, S'/M, V] are the rank's positions of the stream,
        the prefix's ``prefix_len`` rows among them (dropped here); labels and
        mask are whole. The rank's masked sum of ``log-sum-exp - label
        logit`` is summed over ``model`` and divided by the whole count."""
        first = max(self.seq.lo, prefix_len)
        logits = common.at_least_fp32(logits[:, first - self.seq.lo:])
        cols = slice(first - prefix_len, self.seq.hi - prefix_len)
        nll = torch.logsumexp(logits, -1) - logits.gather(
            -1, labels[:, cols].long()[..., None])[..., 0]
        mask = torch.ones_like(labels, dtype=nll.dtype) if mask is None else mask.to(nll.dtype)
        return (_FromSplit.apply((nll * mask[:, cols]).sum(), self.comm)
                / torch.clamp(mask.sum(), min=1.0))

    def layer(self, index: int, stack: str = "layers") -> "LayerAxis":
        """Layer ``index`` of the LM, or block ``index`` of the
        encoder-decoder's ``stack`` (``enc_blocks``, ``dec_blocks``), on its
        stream's view (:meth:`on`)."""
        return LayerAxis(self.on(stack), index, stack)

    def memory_in(self, memory: torch.Tensor) -> torch.Tensor:
        """The encoder's memory into the decoder, once for every block's
        cross-attention: the rank's positions [B, T_f/M, d] where the
        encoder's stream splits, else the whole [B, T_f, d] -> the whole
        memory. A rank's gradient of it is a partial term where some
        cross-attention splits by heads (each rank's K and V from its own
        heads) or the decoder's stream splits (each rank back-propagates its
        own positions): there it is all-gathered along the sequence
        (backward a reduce-scatter: every rank's term summed, the rank's
        block kept), or, whole, goes in through ``_ToSplit`` (backward an
        all-reduce). Else every rank's gradient is whole and equal: the
        gather's backward keeps the rank's block, and a whole memory goes in
        as it is. The decoder's blocks add their terms on the rank, so one
        collective sums them all. A decode step (no gradient; ``stream``
        gives the encoder's shape where the memory comes split) takes the
        forward alone: one all-gather where the frames split, else
        nothing."""
        partial = self.seq is not None or any(  # some block's xattn_sum
            self.split(n) is not None for n in self.shapes
            if n.startswith("dec_blocks.") and n.endswith(".xattn.wo"))
        if self.on("enc_blocks").seq is not None:
            if partial:
                return _GatherSeq.apply(memory, self.comm)
            return _GatherWhole.apply(memory, self.comm, self.coord["model"], 1)
        return _ToSplit.apply(memory, self.comm) if partial else memory

    def _cache_shape(self, index: int):
        if self._layers is None:
            return None
        c = self._layers[index]
        return tuple(c["k"].shape) if "k" in c else None

    def cache_split(self, index: int, dim: int) -> Optional[shd.Split]:
        """Dim ``dim`` of layer ``index``'s K/V cache at rest."""
        shape = self._cache_shape(index)
        key = ("cache", shape, dim)
        if key not in self._memo:
            spec = shd.resolve_spec(self.mesh, self.rules, shd.CACHE_LOGICAL["k"], shape)
            self._memo[key] = shd.dim_split(self.mesh, spec, dim, shape, self.coord)
        return self._memo[key]


class _ModuleAxis:
    """One module's leaves under :class:`ModelAxis`'s weight-stationary
    products (``column``, ``columns``, ``summed``, ``row``), by leaf name:
    the hook ``MoE.forward``, ``TimeMix.forward`` and ``ChannelMix.parts``
    take (:meth:`LayerAxis.hook`)."""

    def __init__(self, axis: ModelAxis, prefix: str):
        self.axis, self.prefix = axis, prefix

    def column(self, x: torch.Tensor, w: torch.Tensor, leaf: str) -> torch.Tensor:
        return self.axis.column(x, w, self.prefix + leaf)

    def columns(self, x: torch.Tensor, leaf: str) -> torch.Tensor:
        return self.axis.columns(x, self.prefix + leaf)

    def summed(self, x: torch.Tensor, leaf: str) -> torch.Tensor:
        return self.axis.summed(x, self.prefix + leaf)

    def row(self, x: torch.Tensor, w: torch.Tensor, leaf: str) -> torch.Tensor:
        return self.axis.row(x, w, self.prefix + leaf)


class _RnnAxis(_ModuleAxis):
    """An RG-LRU layer's hook where it serves on the rank's ``(data, model)``
    chunk of its channels (``ModelAxis._rnn_chunk``; ``RGLRU.prefill`` and
    ``decode`` take it): the input products' ``model`` block taken to the
    chunk (:meth:`own`) and the gates' columns of the chunk (:meth:`gates`);
    ``column``, ``columns`` and ``summed`` as the other modules'."""

    def __init__(self, axis: ModelAxis, prefix: str, chunk: shd.Split):
        super().__init__(axis, prefix)
        self.chunk = chunk

    def own(self, t: torch.Tensor) -> torch.Tensor:
        """The ``model`` block [..., w/M] of the input products (the gate
        branch and the recurrent input stacked along dim 0), as the sum over
        ``data`` leaves it on every rank of model index m -> the rank's chunk
        [..., w/DM]. Chunk ``c = d M + j`` lies in ``model`` block ``c // D``,
        so rank j of the ``model`` group takes it from that group's rank: one
        all-to-all over ``model`` of [M, ..., w/DM], block j the chunk rank j
        needs from this rank, zeros where it needs none (w/D columns a row
        sent, where an all-gather of the blocks and a slice would take w)."""
        sizes, coord = self.axis.sizes, self.axis.coord
        D, M, d, m = sizes["data"], sizes["model"], coord["data"], coord["model"]
        n = self.chunk.hi - self.chunk.lo
        send = t.new_zeros((M,) + t.shape[:-1] + (n,))
        for j in range(M):
            c = d * M + j
            if c // D == m:
                send[j] = t[..., c % D * n:(c % D + 1) * n]
        return self.axis.comm.all_to_all(send, "model")[(d * M + m) // D]

    def gates(self, u: torch.Tensor, weights: Tuple[torch.Tensor, ...]
              ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
        """The block-diagonal gates' input and weights (``gate_a``,
        ``gate_a_b``, ``gate_x``, ``gate_x_b``, whole at rest: local views)
        for the rank's chunk of the channels, u [..., w/DM] the conv'd chunk:
        where the chunk spans whole gate blocks, u and its blocks (nothing
        moves); else the chunk's columns of its gate block, whose input is
        the block's channels: u all-gathered over ``model`` (the block lies
        in the ``model`` group's w/D channels where M chunks span whole
        blocks), and over ``data`` too where it does not (every rank takes
        the same collectives)."""
        lo, hi = self.chunk.lo, self.chunk.hi
        bw = weights[0].shape[1]
        if hi - lo >= bw:
            return u, tuple(w[lo // bw:hi // bw] for w in weights)
        M = self.axis.sizes["model"]
        x = self.axis.comm.all_gather(u, u.ndim - 1, "model")
        base = self.axis.coord["data"] * M * (hi - lo)  # the group's first channel
        if M * (hi - lo) % bw:
            x, base = self.axis.comm.all_gather(x, x.ndim - 1, "data"), 0
        b = lo // bw
        cols = slice(lo - b * bw, hi - b * bw)
        ga, gab, gx, gxb = weights
        return x[..., b * bw - base:(b + 1) * bw - base], (
            ga[b:b + 1, :, cols], gab[b:b + 1, cols], gx[b:b + 1, :, cols], gxb[b:b + 1, cols])


class LayerAxis:
    """A layer's split: whether attention, the MLP, the RG-LRU, the RWKV-6
    time mix and channel mix and the MoE end in a sum over ``model``, the
    rank's query and KV heads, its recurrent channels, its RWKV-6 heads and
    ``d_ff`` block, its experts, and its K/V cache's layout.

    An encoder-decoder block (``stack`` ``enc_blocks`` or ``dec_blocks``)
    reads its own leaves: its self-attention's heads and sums, the MLP's,
    and in the decoder ``xattn_sum`` and ``cross``, the cross-attention's
    view (``attn`` ``"xattn"``: its query and KV heads, equal in number, and
    its ``attn_sum``). In serving a decoder block's self-attention has its
    self cache's layout (``cache["self"]``), as an LM's attention layer;
    the cross-attention and the encoder blocks have no cache."""

    def __init__(self, axis: ModelAxis, index: int, stack: str = "layers",
                 attn: str = "attn"):
        self.axis = axis
        pre = f"{stack}.{index}."
        self._pre, self._attn = pre, attn
        self.attn_sum = axis.split(pre + attn + ".wo") is not None
        self.xattn_sum = axis.split(pre + "xattn.wo") is not None
        self.mlp_sum = axis.split(pre + "mlp.w_down") is not None
        self.rnn = axis.split(pre + "rglru.lam")  # the rank's channels, or None: all
        self.rglru_sum = self.rnn is not None
        # serving: the (data, model) chunk of channels the RG-LRU serves on, or None
        self.rglru_block = None if self.rnn is None or self.rnn.axes == ("model",) else self.rnn
        self.tm = axis.split(pre + "tm.bonus")  # the rank's RWKV-6 heads, or None: all
        self.tm_sum = self.tm is not None
        self.cm = axis.split(pre + "cm.w_v")    # its channel mix's d_ff block, or None
        self.cm_sum = self.cm is not None
        # the rank's experts (dim 0) or every expert's ff columns (dim 2), or None: all
        self.experts = axis.split(pre + "moe.w_up")
        self.moe_sum = self.experts is not None
        # serving: the embed block of the experts', the time mix's and the
        # channel mix's weights that stays where it lies, or None
        self.moe_block = axis.stationary(pre + "moe.w_up")
        self.tm_block = axis.stationary(pre + "tm.w_r")
        self.cm_block = axis.stationary(pre + "cm.w_k")
        self.q = axis.split(pre + attn + ".wq")    # the rank's query heads, or None: all
        self.kv = axis.split(pre + attn + ".wk")   # its KV heads, or None: all
        if pre + attn + ".wq" in axis.shapes:
            self.n_heads = axis.shapes[pre + attn + ".wq"][1]
            self.n_kv_heads = axis.shapes[pre + attn + ".wk"][1]
        if attn == "attn" and pre + "xattn.wq" in axis.shapes:
            self.cross = LayerAxis(axis, index, stack, "xattn")
        if (stack not in ("layers", "dec_blocks") or attn != "attn"
                or axis._cache_shape(index) is None):
            return
        self.length = axis._cache_shape(index)[1]
        self.seq = axis.cache_split(index, 1)    # the positions held, or None: all
        self.heads = axis.cache_split(index, 2)  # the KV heads held, or None: all
        seq_axes = () if self.seq is None else self.seq.axes
        # the kv_heads rule splits the weights and, where the sequence did not
        # take model, the cache alike; a sequence split over model ends with it
        if ((self.heads is not None and self.heads[2:] != self.kv[2:])
                or (self.kv is not None and self.heads is None and "model" not in seq_axes)
                or ("model" in seq_axes and seq_axes[-1] != "model")):
            raise NotImplementedError(f"layer {index}: cache heads {self.heads}, sequence "
                                      f"{self.seq}, weights' KV heads {self.kv}")

    def _name(self, leaf: str) -> str:
        """The state-dict name of the attention's (on the cross view,
        :attr:`cross`, the cross-attention's) or the MLP's leaf."""
        module = self._attn if leaf in ("wq", "wk", "wv", "wo") else "mlp"
        return f"{self._pre}{module}.{leaf}"

    def hook(self, module: str) -> Optional[_ModuleAxis]:
        """The weight-stationary hook of the layer's ``module`` (``moe``,
        ``tm``, ``cm``) where its weights keep their ``embed`` block
        (``moe_block``, ``tm_block``, ``cm_block``), or of its ``rglru``
        where it serves on its chunk of the channels (``rglru_block``:
        :class:`_RnnAxis`), else None."""
        block = getattr(self, module + "_block")
        if block is None:
            return None
        if module == "rglru":
            return _RnnAxis(self.axis, f"{self._pre}{module}.", block)
        return _ModuleAxis(self.axis, f"{self._pre}{module}.")

    def column(self, x: torch.Tensor, w: torch.Tensor, leaf: str) -> torch.Tensor:
        """The column product ``x @ w`` with the attention's or the MLP's
        weight ``leaf`` (``wq``, ``wk``, ``wv``, ``w_gate``, ``w_up``), laid out
        [embed, ...]: :meth:`ModelAxis.column` (summed over its ``embed``
        block's axes where that block stays)."""
        return self.axis.column(x, w, self._name(leaf))

    def out(self, h: torch.Tensor, which: Optional[str] = None) -> torch.Tensor:
        """A sub-block's output h: summed over ``model`` where ``which``
        (``attn_sum``, ``mlp_sum``, ``rglru_sum``, ``tm_sum``) says the
        contracted dim split (:meth:`ModelAxis.from_split`), else the rank's
        positions of it (:meth:`ModelAxis.own`); then, where the part's row
        weight (attention's ``wo``, the cross-attention's ``xattn.wo``, the
        MLP's ``w_down``: ``_ROW_LEAVES``) keeps its ``embed`` block, the
        rank's block of columns gathered to the whole stream
        (:meth:`ModelAxis.whole`); where the RG-LRU serves on its chunk of
        the channels (``rglru_block``), the product with ``w_out``'s rows of
        the chunk is summed over the chunk's other axes (``data``) too."""
        axis = self.axis
        h = axis.from_split(h) if which and getattr(self, which) else axis.own(h)
        if which == "rglru_sum" and self.rglru_block is not None:
            h = _sum_over(h, axis.comm, tuple(a for a in self.rglru_block.axes if a != "model"))
        row = _ROW_LEAVES.get(which)
        return h if row is None else axis.whole(h, self._pre + row)

    def moe(self, moe, h: torch.Tensor, with_aux: bool = False):
        """The MoE layer on this rank's rows [B, S, d] (after ``norm2``), its
        tokens routed in the global batch's groups, as in one process: where
        the rows hold whole groups, the global group size; else the rows
        gathered over the batch axes, the global batch routed, and this
        rank's rows kept. Where the stream's sequence splits, ``h`` is the
        rank's block [B, S'/M, d], gathered along the sequence first (its
        backward, a reduce-scatter, runs after the rows' gather's), and the
        output ends as the rank's block. Where the experts split
        (``moe_sum``), the rank computes its experts, or every expert's ff
        columns (the gates' gradient then summed before its rounding:
        :class:`_SummedGates`), and the output is summed over ``model``
        (``to_split`` in, ``from_split`` out: a reduce-scatter where the
        sequence splits); else it is computed whole (``gather`` in, ``own``
        out). The aux term is whole and equal on every rank along ``model``;
        where its gradient enters a sum over ``model`` (the experts or the
        sequence split), it counts at 1/M a rank (:class:`_OneShare`).
        In serving, where the weights keep their ``embed`` block
        (``moe_block``), the module takes the hook (:class:`_ModuleAxis`):
        every rank routes every token from the router's logits summed over
        the block's axes, and computes with its (experts or ff block) x
        (embed block) of each expert leaf; its output, the rank's block of
        columns, is summed over ``model`` and then gathered over the
        block's axes to the whole stream (:meth:`ModelAxis.whole`).
        ``with_aux`` (training): (out, the global batch's aux term, as every
        rank along the batch axes holds it); else out."""
        axis = self.axis
        M = axis.sizes["model"]
        h = axis.to_split(h) if self.moe_sum else axis.gather(h)
        B, S = h.shape[:2]
        kw = {}
        if self.moe_block is not None:
            kw["axis"] = self.hook("moe")
        if self.moe_sum:
            if self.experts.dim == 0:
                kw["experts"] = (self.experts.lo, self.experts.hi)
            else:  # every expert's ff columns: each gate's gradient is a partial term
                kw["gates"] = lambda t, dtype: _SummedGates.apply(t, dtype, axis.comm, M)
        g = group_size_for(axis.n_rows * S) if axis.row_axes else None
        if g is None or (B * S) % g == 0:
            if g is not None:
                kw["group_size"] = g
            out, aux = moe(h, **kw)
            if with_aux and axis.row_axes:  # the mean over every rank's groups
                aux = _SumAndUse.apply(aux * (B / axis.n_rows), axis.comm, axis.row_axes)
        else:
            index = 0
            for name in axis.row_axes:
                index = index * axis.sizes[name] + axis.coord[name]
            out, aux = moe(_GatherRows.apply(h, axis.comm, axis.row_axes, index), **kw)
            out = out[index * B:(index + 1) * B]
        out = axis.from_split(out) if self.moe_sum else axis.own(out)
        out = axis.whole(out, self._pre + "moe.w_down")
        if self.moe_sum or axis.seq is not None:
            aux = _OneShare.apply(aux, M)
        return (out, aux) if with_aux else out

    def channel_mix(self, cm, h: torch.Tensor, shift: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The RWKV-6 channel mix on the rank's ``d_ff`` block (``cm_sum``) of
        h [B, S, d], the whole stream (the caller's ``to_split``, which
        gathers the sequence where it splits): the rank's value term [B, S,
        d] (``ChannelMix.parts``) reduce-scattered along ``d`` to its block
        of the sum (backward an all-gather along ``d``), times the rank's
        receptance block [B, S, d/M]. The product goes out whole, all-gathered
        along ``d`` (backward the rank's block of the gradient, whole and
        equal on every rank); or, where the stream's sequence splits, as the
        rank's positions [B, S/M, d], by one all-to-all (backward the inverse
        one). -> (out, new shift state [B, d]).

        In serving, where the weights keep their ``embed`` block
        (``cm_block``), the mix takes the hook (:meth:`hook`): ``w_k``'s and
        ``w_r``'s partial products are summed over the block's axes, so the
        receptance is the rank's ``model`` block of d's columns, and
        ``w_v``'s, the block's columns of the value, is summed over
        ``model`` and taken to that same ``model`` block
        (:meth:`ModelAxis.row`: a masked sum over ``data`` of d/M columns);
        their product is all-gathered along ``d`` over ``model``. Of the
        routes that end with the output whole, this moves fewest bytes: a
        gather of the summed value over ``data`` (d columns), or of the
        receptance over ``model``, before the product would add d columns
        to the d/M this moves.

        Under :class:`Shares` the reduce-scatter's other side is the
        caller's, and this raises: a share's term is ``ChannelMix.parts``
        on its blocks -- its value term, to be summed over the ranks and
        sliced to each rank's ``d`` block, and its receptance block, which
        multiplies that slice; the products laid side by side are the
        output (:func:`rwkv_shares` and :func:`seq_shares` play it)."""
        axis = self.axis
        if isinstance(axis.comm, Shares):
            raise NotImplementedError("a share alone holds only its value term of the "
                                      "channel mix: combine ChannelMix.parts over the "
                                      "shares (tensor_parallel.rwkv_shares)")
        hook = self.hook("cm")
        if hook is not None:  # serving: no backward
            v, r, new_shift = cm.parts(h, shift, hook)
            return axis.comm.all_gather(r * v, h.ndim - 1, "model"), new_shift
        v, r, new_shift = cm.parts(h, shift)
        out = r * _ReduceScatter.apply(v, axis.comm, v.ndim - 1)
        if axis.seq is not None:
            return _ToPositions.apply(out, axis.comm), new_shift
        return _GatherWhole.apply(out, axis.comm, axis.coord["model"], out.ndim - 1), new_shift

    def kv_for_queries(self, k: torch.Tensor, v: torch.Tensor):
        """The KV heads [B, S, h, D] this rank's query heads read: its own
        where the weights split them, all where its query heads are all, else
        those of :func:`kv_heads` (the weights replicate K/V, so every rank
        computed all of them)."""
        if self.q is None or self.kv is not None:
            return k, v
        idx = kv_heads(self.q.lo, self.q.hi, self.n_heads, self.n_kv_heads)
        return k[:, :, idx].contiguous(), v[:, :, idx].contiguous()

    def fill_cache(self, cache: Dict[str, torch.Tensor], k: torch.Tensor,
                   v: torch.Tensor) -> None:
        """Prefill: write this rank's block of the cache at rest from its K/V
        [B, S, h, D] (its KV heads, or all)."""
        L = self.length
        lo, hi = (0, L) if self.seq is None else (self.seq.lo, self.seq.hi)
        for name, t in (("k", k), ("v", v)):
            local = cache[name]
            if self.kv is None or self.heads is not None:  # the heads this block holds
                _write_prompt(local, t, L, lo)
                continue
            # the rank's KV heads, a cache of every head over its positions: an
            # all-to-all over model takes each head block to its positions
            M, m = self.axis.sizes["model"], self.axis.coord["model"]
            c = hi - lo
            first = lo - m * c  # the model group's positions are contiguous
            send = t.new_empty((t.shape[0], M * c) + tuple(t.shape[2:]))
            _write_prompt(send, t, L, first)
            B, _, h, D = send.shape
            got = self.axis.comm.all_to_all(send.view(B, M, c, h, D).transpose(0, 1), "model")
            local.copy_(got.permute(1, 2, 0, 3, 4).reshape(B, c, M * h, D))

    def decode_attention(self, q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
                         pos: int, cache: Dict[str, torch.Tensor],
                         softcap: Optional[float]) -> torch.Tensor:
        """One token's attention [B, 1, h, D] for this rank's query heads,
        over the cache where it lies, after writing the token's K/V row."""
        comm, L = self.axis.comm, self.length
        lo, hi = (0, L) if self.seq is None else (self.seq.lo, self.seq.hi)
        slot = pos % L
        rows = torch.stack([k_new[:, 0], v_new[:, 0]])  # [2, B, h, D]
        if self.kv is not None and self.heads is None:  # the owner holds every head
            rows = comm.all_gather(rows, 2, "model")
        if lo <= slot < hi:
            cache["k"][:, slot - lo] = rows[0]
            cache["v"][:, slot - lo] = rows[1]
        n_valid = min(pos + 1, L)
        # every position is here (no split, or a split over axes of one rank,
        # whose one shard is the whole cache): the plain path, as one process
        if self.seq is None or all(self.axis.sizes[a] == 1 for a in self.seq.axes):
            k, v = self.kv_for_queries(cache["k"], cache["v"])
            kv_len = torch.full((q.shape[0],), n_valid, device=q.device)
            return fa_ops.attention(q, k, v, causal=False, kv_len=kv_len, softcap=softcap)
        qa = q  # the queries of every head this block holds
        if self.q is not None and self.heads is None:
            qa = comm.all_gather(q, 2, "model")
        valid = torch.arange(lo, hi, device=q.device) < n_valid
        m, l, o = fa_ref.partial_attention(qa, cache["k"], cache["v"], valid, softcap)
        top = m
        for axis in self.seq.axes:
            top = comm.all_reduce(top, axis, "max")
        scale = torch.exp(m - top)
        lo_sum = torch.cat([l * scale, o * scale], dim=-1)
        for axis in self.seq.axes:
            lo_sum = comm.all_reduce(lo_sum, axis)
        out = fa_ref.merge_partials(lo_sum[..., :1], lo_sum[..., 1:], q.dtype)
        if qa is not q:
            out = out[:, :, self.q.lo:self.q.hi]
        return out


def _write_prompt(out: torch.Tensor, t: torch.Tensor, L: int, first: int) -> None:
    """Positions ``[first, first + out.shape[1])`` of a length-``L`` cache
    filled from the prompt's K or V ``t`` [B, S, ...] into ``out``: the prompt
    then zeros, or, for a prompt longer than the cache (a window's ring), its
    last L positions with position p at slot p % L (``Attention.prefill``)."""
    S, n = t.shape[1], out.shape[1]
    if L >= S:
        k = max(0, min(first + n, S) - first)
        out[:, :k].copy_(t[:, first:first + k])
        out[:, k:].zero_()
    else:
        out.copy_(torch.roll(t[:, S - L:], S % L, dims=1)[:, first:first + n])


def share(lm: nn.Module, cache: Optional[Mapping[str, Any]],
          rank: Union[int, Mapping[str, int]], size: Union[int, Mapping[str, int]],
          rules: Optional[Dict[str, shd.MeshAxes]] = None,
          seq_len: Union[None, int, Mapping[str, int]] = None,
          comm: Optional[_ThreadRank] = None, rows: Optional[int] = None):
    """Rank ``rank`` of a ``size``-way ``model`` axis computed alone, in one
    process (whole weights and cache given -- an LM's ``layers`` or the
    encoder-decoder's ``self`` caches --; no cache in training): (its
    :class:`ModelAxis` over :class:`Shares`, its block of each parameter by
    state-dict name -- a view, so a gradient reaches the whole weight --, its
    block of the cache). The rules are ``rules`` (default ``fsdp_tp``'s)
    with the cache's sequence whole, so the cache splits its heads as the
    weights do (an RG-LRU state: a copy a rank, of the rank's channels; an
    RWKV-6 layer's: a copy a rank, the WKV state the block of its heads
    where the time mix splits, the shifts whole) and no collective but
    the final sums is needed: each output
    that ends in a sum over ``model`` is this rank's term of it, and so is
    the input gradient of each ``to_split``. ``seq_len`` (training): the
    stream's S', whose sequence then splits as the rules say (the
    sequence form: the caller feeds each gather the gathered input, and
    sums and slices the terms each reduce-scatter returns whole;
    :meth:`ModelAxis.own` gives the rank's positions); for the
    encoder-decoder, each stream's by stack (``{"enc_blocks": T_f,
    "dec_blocks": S}``, :func:`block_shares`). ``comm``: rank
    ``rank`` of a :class:`ThreadRanks` mesh, whose ranks run together, so
    the rules' cache layout is kept: a K/V cache split by sequence gives the
    rank its positions' block.

    ``size`` may be a grid of axis sizes in mesh order (``{"data": 2,
    "model": 4}``) and ``rank`` a coordinate on it or its row-major index,
    as :class:`ThreadRanks` numbers its ranks. A K/V cache's rows then
    split as the rules' ``batch`` axes take them (the rank's rows), and a
    model served with a cache (an LM, or the encoder-decoder's decoder)
    keeps its weights' ``embed`` blocks where the rules allow
    (:meth:`ModelAxis.stationary`): the rank's block of such a weight is
    its ``(embed block x model block)`` (the time mix's ``w_v``: its
    ``model`` block of rows x its embed block of columns); a recurrent
    state's copy holds the rank's rows, and an RG-LRU layer that serves on
    its ``(data, model)`` chunk of the channels (``ModelAxis._rnn_chunk``)
    holds that chunk of its leaves and state. ``rows``: the global batch's
    rows of a serving call without a cache (the encoder-decoder's encode),
    which then keeps those blocks as a cached call does, its rows split
    as a cache's would. Sums over an axis but ``model`` need the threads."""
    rules = rules or shd.STRATEGIES["fsdp_tp"]()
    if comm is None:
        rules = {**rules, "seq_cache": None}
    mesh = dict(size) if isinstance(size, Mapping) else {"model": size}
    coord = dict(rank) if isinstance(rank, Mapping) else _coordinate(rank, mesh)
    key = None if cache is None else cache_key(cache)
    row_axes, n_rows = (), 0
    if cache is not None or rows is not None:  # the mesh axes the batch's rows split over
        n_rows = next(iter(cache[key][0].values())).shape[0] if rows is None else rows
        spec = shd.batch_specs(mesh, rules, {"x": torch.empty((n_rows, 1), device="meta")})["x"]
        row_axes = shd._axes(spec[0])
        index, n = 0, 1  # the rank's block of the rows, row-major over their axes
        for a in row_axes:
            index, n = index * mesh[a] + coord[a], n * mesh[a]
        own_rows = slice(index * n_rows // n, (index + 1) * n_rows // n)
    d = lm.cfg.d_model
    stream = (None if seq_len is None
              else {k: (1, n, d) for k, n in seq_len.items()} if isinstance(seq_len, Mapping)
              else (1, seq_len, d))
    axis = ModelAxis(mesh, rules, param_shapes(lm), cache, Shares() if comm is None else comm,
                     coord=coord, rows=(row_axes, n_rows), stream=stream,
                     weight_stationary=cache is not None or rows is not None)
    params = {}
    for name, p in lm.named_parameters():
        for split in (axis.split(name), axis.stationary(name)):
            if split is not None:
                p = p.narrow(split.dim, split.lo, split.hi - split.lo)
        params[name] = p
    if cache is None:
        return axis, params, None
    layers = []
    for i, c in enumerate(cache[key]):
        if "k" in c:  # the rank's rows, positions and heads
            block = c
            for dim in (0, 1, 2):
                split = axis.cache_split(i, dim)
                if split is not None:
                    block = {k: t.narrow(dim, split.lo, split.hi - split.lo)
                             for k, t in block.items()}
            layers.append(c if block is c else {k: t.clone() for k, t in block.items()})
            continue
        if "wkv" in c:  # a copy of the rank's rows, the WKV state on the rank's heads
            heads = axis.layer(i).tm
            layers.append({k: (t[own_rows] if k != "wkv" or heads is None
                               else t[own_rows, heads.lo:heads.hi]).clone() for k, t in c.items()})
            continue
        rnn = axis.layer(i).rnn if "h" in c else None  # the rank's channels of the state
        cols = slice(None) if rnn is None else slice(rnn.lo, rnn.hi)
        layers.append({k: t[own_rows][..., cols].clone() for k, t in c.items()})
    return axis, params, {key: layers, "pos": cache["pos"]}


def _played_channel_mix(terms, dtype: torch.dtype) -> torch.Tensor:
    """The RWKV-6 channel mix's output from every rank's (value term,
    receptance block) (``ChannelMix.parts`` on its ``d_ff`` block), as
    :meth:`LayerAxis.channel_mix` combines them over ``model``: the value
    terms added in fp32, each rank's receptance block times its ``d`` block
    of the sum, the products laid side by side."""
    v = sum(t.float() for t, _ in terms).to(dtype)
    w = v.shape[-1] // len(terms)
    return torch.cat([r * v[..., m * w:(m + 1) * w] for m, (_, r) in enumerate(terms)], -1)


def rwkv_shares(lm: nn.Module, index: int, shares, x: torch.Tensor, carried: bool = False
                ) -> torch.Tensor:
    """Layer ``index``'s RWKV-6 ``Block.prefill`` (or, ``carried``, its
    ``Block.decode``) on every rank's share in turn (``shares``: each
    rank's (axis, parameter blocks, cache blocks) from :func:`share`; each
    rank reads and writes its own cache), the collectives played here: the
    time mix's terms are added in fp32 where it splits (``tm_sum``), else
    rank 0's whole output is taken; where the channel mix splits
    (``cm_sum``), the ranks' value terms are added in fp32, each rank's
    receptance block multiplies its ``d`` block of the sum, and the
    products are laid side by side, else rank 0's whole output is taken.
    Without caches (training: :func:`share` given none), ``Block.forward``'s
    two halves, ``Block.mix`` and the channel mix, on the whole stream:
    each half's normed input reaches every rank through a cast from fp32, so
    autograd adds its gradient's terms in fp32, as ``to_split``'s all-reduce
    adds them, and a gradient reaches each weight through its rank's block.
    -> the block's output."""
    block = lm.layers[index]
    layer = shares[0][0].layer(index)
    train = shares[0][2] is None

    def each(fn, norm):
        with _reparametrize_module(lm, shares[0][1]):  # the norms are whole on every rank
            h = common.apply_norm(norm, x).float()
        outs = []
        for axis, params, cache in shares:
            with _reparametrize_module(lm, params):
                outs.append(fn(h.to(x.dtype), axis.layer(index),
                               None if train else cache["layers"][index]))
        return outs

    def added(terms):
        return sum(t.float() for t in terms).to(x.dtype)

    def time_mix(h, layer, c):
        return block.mix(h, None, layer) if train else block._time_mix(h, c, carried)

    tm = each(time_mix, block.norm1)
    x = x + (added(tm) if layer.tm_sum else tm[0])

    def channel(h, layer, c):
        if not layer.cm_sum:
            return block.feed_forward(h, layer)[0] if train else block._ffn(h, c, carried), None
        v, r, new_shift = block.cm.parts(h, c["cm_shift"] if carried else None)
        if not train:
            c["cm_shift"].copy_(new_shift)
        return v, r

    cm = each(channel, block.norm2)
    return x + (_played_channel_mix(cm, x.dtype) if layer.cm_sum else cm[0][0])


def seq_shares(lm: nn.Module, index: int, shares, x: torch.Tensor, positions: torch.Tensor,
               parts: Tuple[str, ...] = ("mix", "feed_forward")
               ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Layer ``index``'s ``Block.forward`` (or the halves ``parts`` of it)
    on every rank's share in turn, in the sequence form (``shares``: each
    rank's (axis, parameter blocks, _) from :func:`share` with
    ``seq_len``), the collectives' other side played here: each rank
    normalizes its own block of x [B, S', d]; the normed blocks,
    concatenated, are every rank's gathered input; the whole terms a
    reduce-scatter returns are summed in fp32 and sliced, a rank's own
    positions taken as they are. The gathered input reaches each rank
    through a cast from fp32, so autograd sums its gradient's terms in fp32
    too. -> (the ranks' output blocks concatenated, each rank's aux term)."""
    block = lm.layers[index]
    bounds = [(axis.seq.lo, axis.seq.hi) for axis, _, _ in shares]
    xs = [x[:, lo:hi] for lo, hi in bounds]

    def each(fn, norm):
        normed = []
        for (_, params, _), xr in zip(shares, xs):
            with _reparametrize_module(lm, params):
                normed.append(common.apply_norm(getattr(block, norm), xr))
        gathered = torch.cat(normed, 1).float()
        outs = []
        for axis, params, _ in shares:
            with _reparametrize_module(lm, params):
                outs.append(fn(gathered.to(x.dtype), axis.layer(index)))
        return outs

    def add(outs):
        if outs[0].shape[1] == x.shape[1]:  # whole terms: summed, each rank's block
            total = sum(o.float() for o in outs).to(x.dtype)
            outs = [total[:, lo:hi] for lo, hi in bounds]
        return [xr + o for xr, o in zip(xs, outs)]

    aux = []
    if "mix" in parts:
        xs = add(each(lambda h, layer: block.mix(h, positions, layer), "norm1"))
    if "feed_forward" in parts and block.mixer == "rwkv" and shares[0][0].layer(index).cm_sum:
        out = _played_channel_mix(each(lambda h, layer: block.cm.parts(h)[:2], "norm2"),
                                  x.dtype)
        xs = [xr + out[:, lo:hi] for xr, (lo, hi) in zip(xs, bounds)]
        aux = [x.new_zeros((), dtype=torch.float32) for _ in shares]
    elif "feed_forward" in parts:
        ffn = each(lambda h, layer: block.feed_forward(h, layer), "norm2")
        xs, aux = add([o for o, _ in ffn]), [a for _, a in ffn]
    return torch.cat(xs, 1), aux


def block_shares(model: nn.Module, stack: str, index: int, shares, x: torch.Tensor,
                 positions: Optional[torch.Tensor], memory: Optional[torch.Tensor] = None,
                 pos: Optional[int] = None) -> torch.Tensor:
    """Block ``index`` of the encoder-decoder's ``stack`` (``EncBlock`` /
    ``DecBlock.forward``, ``memory`` the decoder's) on every rank's share in
    turn, the stream whole on every rank (``shares``: each rank's (axis,
    parameter blocks, cache blocks) from :func:`share`), the sums over
    ``model`` played here: each part's normed input (the memory too) reaches
    every rank through a cast from fp32, so autograd adds its gradient's
    terms in fp32, as ``to_split``'s all-reduce adds them; the ranks' output
    terms are added in fp32 where the part splits, else rank 0's whole term
    is taken. The sequence form, where the shares' axes split the stack's
    stream (:func:`share` with ``seq_len``), as :func:`seq_shares` plays an
    LM layer: each rank normalizes its own block of x [B, S', d]; the
    normed blocks, concatenated, are every rank's gathered input; the whole
    terms of a split part are summed in fp32 and sliced to each rank's
    block, and an unsplit part's ranks each give their own positions. The
    memory reaches every rank whole in both forms, as
    ``ModelAxis.memory_in`` gives it. With ``pos``, one ``DecBlock.decode``
    step at position ``pos`` (x [B, 1, d]; ``positions`` unused): the
    self-attention over each rank's block of its self cache, which it
    writes, and the cross-attention's decode path. -> the block's output."""
    block = getattr(model, stack)[index]
    wide = None if memory is None else memory.float()
    views = [axis.on(stack) for axis, _, _ in shares]
    seq = pos is None and views[0].seq is not None
    bounds = [(v.seq.lo, v.seq.hi) if seq else (0, x.shape[1]) for v in views]
    xs = [x[:, lo:hi] for lo, hi in bounds] if seq else [x]

    def mix(h, layer, cache):
        if pos is None:
            return block.mix(h, positions, layer)
        return block.mix_step(h, pos, cache["self"][index], layer)

    def cross(h, layer, _):
        return block.cross(h, wide.to(x.dtype), layer, decode=pos is not None)

    parts = [("norm1", "attn_sum", mix)]
    if memory is not None:
        parts.append(("norm_x", "xattn_sum", cross))
    parts.append(("norm2", "mlp_sum", lambda h, layer, _: block.feed_forward(h, layer)))
    for norm, which, fn in parts:
        h = torch.cat([common.apply_norm(getattr(block, norm), xr) for xr in xs], 1).float()
        terms = []
        for axis, params, cache in shares:
            with _reparametrize_module(model, params):
                terms.append(fn(h.to(x.dtype), axis.layer(index, stack), cache))
        if getattr(shares[0][0].layer(index, stack), which):
            total = sum(t.float() for t in terms).to(x.dtype)
            terms = [total[:, lo:hi] for lo, hi in bounds]
        xs = [xr + t for xr, t in zip(xs, terms)]
    return torch.cat(xs, 1)


def thread_shares(model: nn.Module, stack: Optional[str], index: int,
                  size: Union[int, Mapping[str, int]],
                  cache: Mapping[str, Any], run: Callable[[nn.Module, Any, Any], Any],
                  rules: Optional[Dict[str, shd.MeshAxes]] = None,
                  seq_len: Optional[Mapping[str, int]] = None, rows: Optional[int] = None):
    """Block ``index`` of ``model``'s ``stack`` (``layers``, ``dec_blocks``)
    on every rank of a ``size``-way ``model`` axis, or of a grid of axis
    sizes (``{"data": 2, "model": 4}``), at once, one thread a rank
    (:class:`ThreadRanks`), under ``rules`` (default ``fsdp_tp``'s) with
    their cache layout kept: ``run(block, layer_axis, cache)`` on the
    rank's own copy of the block, which holds its parameter blocks, with
    its :class:`LayerAxis` and its block of the whole ``cache``
    (:func:`share`) -> (each rank's result, each rank's cache block), in
    rank order. ``stack`` None: the whole model, ``run(model, model_axis,
    cache)`` with the rank's :class:`ModelAxis`. The sums are the threads'
    all-reduces, so every rank's stream is the whole one, as on a mesh.
    ``seq_len``: the streams' lengths by stack, as :func:`share` takes them
    (a decode step's ``{"enc_blocks": T_f}``: the memory's frames split
    where the rules split the encoder's stream, ``ModelAxis.memory_in``
    then gathering them). ``cache`` None and ``rows`` (a serving call
    without a cache, the encode of ``rows`` rows): the weights keep their
    ``embed`` blocks as :func:`share` gives them with ``rows``."""
    ranks = ThreadRanks(size)
    block = model if stack is None else getattr(model, stack)[index]
    prefix = "" if stack is None else f"{stack}.{index}."
    made = []
    for r in range(ranks.size):
        axis, params, rank_cache = share(model, cache, r, size, rules, seq_len,
                                         comm=ranks.rank(r), rows=rows)
        own = {n[len(prefix):]: p for n, p in params.items() if n.startswith(prefix)}
        # the rank's module: the block's structure, its weights left on meta
        # (the rank's blocks are put in when it runs)
        empty = {id(p): nn.Parameter(torch.empty_like(p, device="meta"), p.requires_grad)
                 for p in block.parameters()}
        view = axis if stack is None else axis.layer(index, stack)
        made.append((copy.deepcopy(block, empty), own, view, rank_cache))

    def one(r: int):
        rank_block, own, view, rank_cache = made[r]
        with _reparametrize_module(rank_block, own):
            return run(rank_block, view, rank_cache)

    return ranks.run(one), [m[3] for m in made]
