"""Sharded training: parameters and AdamW moments as DTensors, laid out by
the logical-axis rule tables on a ``DeviceMesh``; compute on gathered weights.

Counterpart of the reference's pjit step (``repro/launch/train.py``: params
``device_put`` to ``param_shardings``, the step jitted under the mesh) and of
``make_train_step(..., grad_shardings=...)``. :func:`shard_module` turns
every parameter of an LM into a DTensor ``Parameter`` with the placements of
``sharding.param_specs``; ``train_loop.make_train_step`` over a
:class:`ShardedModel` then trains it:

* the batch is split along its first dim by the ``batch`` rule's axes
  (``sharding.batch_specs``); each rank takes its rows;
* each weight is gathered whole just before use (:class:`_Gather`): the
  embedding, final norm and head at the start of the forward, a layer
  group's inside the group, so again in remat's recompute (FSDP). The flash
  and scan kernels see ordinary tensors: DTensor's sharding propagation
  cannot see through the ctypes-bound kernels;
* a weight's gradient is summed over the ranks that saw other rows of the
  batch (the batch axes) and brought back to the weight's placement -- a
  reduce-scatter where the weight is sharded on those axes, an all-reduce
  where it is replicated on them, a local slice along the other axes. Ranks
  along ``model`` saw the same rows: their gradients are equal, not summed
  again. ``REPRO_GRAD_SYNC_BF16=1`` (``train_loop``) round-trips the
  reduced gradient through bf16, as the reference's step states it: a
  round trip of each rank's gradient before the reduction was tried and
  parts from the single process's round trip by up to 6.5e-5 in the loss
  after 6 steps (recurrentgemma-9b reduced, 4 ranks), as Adam turns the
  rounding of small gradients into whole steps;
* the loss is averaged over the global batch: each rank's mean is weighted
  by its share of the tokens and summed over the batch axes;
* AdamW updates the DTensors in place; its moments are DTensors with the
  parameters' placements (ZeRO), and the clip's norm is the global one.

Not yet (ROADMAP.md): the ``model`` axis holds weights sharded at rest but
does not split the compute. Tensor-parallel compute -- heads, ff and rnn
split through the kernels, the ``act_*`` and ``seq`` rules of
``shard_activation``, ``REPRO_SP_GATHER`` and ``REPRO_CAST_BARRIER`` -- is a
later item; the batch's ``seq`` entry (sequence parallelism) is not applied.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Partial, Placement, Replicate, distribute_tensor

from repro_torch.models.model_zoo import Model
from repro_torch.models.transformer import LM, lm_loss
from repro_torch.parallel import sharding as shd

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


def _reduce_placements(mesh: DeviceMesh, axes: Tuple[str, ...]) -> Tuple[Placement, ...]:
    """``Partial`` (a sum pending) on the batch axes, ``Replicate`` on the rest."""
    return tuple(Partial() if name in axes else Replicate() for name in mesh.mesh_dim_names)


class _Gather(torch.autograd.Function):
    """A DTensor's local block -> the whole tensor (all-gather). Backward:
    the whole gradient, a sum pending over the batch axes, redistributed to
    the block's placement."""

    @staticmethod
    def forward(ctx, local, mesh, placements, shape, stride, reduce):
        ctx.mesh, ctx.placements, ctx.reduce = mesh, placements, reduce
        return DTensor.from_local(local.detach(), mesh, placements, run_check=False,
                                  shape=shape, stride=stride).full_tensor()

    @staticmethod
    def backward(ctx, grad):
        pending = DTensor.from_local(grad.contiguous(), ctx.mesh, ctx.reduce, run_check=False)
        local = pending.redistribute(ctx.mesh, ctx.placements).to_local()
        return local, None, None, None, None, None


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
    ``loss`` takes the global batch and an LM whose parameters are DTensors
    (:func:`shard_module`), and returns the global batch's mean loss."""

    def __init__(self, model: Model, mesh: DeviceMesh, rules: Rules):
        self.model, self.mesh, self.rules = model, mesh, rules
        self.cfg, self.device = model.cfg, model.device

    def init(self, seed: int = 0, dtype: torch.dtype = torch.float32) -> LM:
        return shard_module(self.model.init(seed, dtype), self.mesh, self.rules)

    def shard(self, lm: LM) -> LM:
        return shard_module(lm, self.mesh, self.rules)

    def local_batch(self, batch: Dict[str, torch.Tensor]
                    ) -> Tuple[Dict[str, torch.Tensor], Tuple[str, ...]]:
        """This rank's rows of ``batch`` and the mesh axes the rows split over."""
        specs = shd.batch_specs(self.mesh, self.rules, batch)
        axes = specs["tokens"][0]
        axes = () if axes is None else (axes,) if isinstance(axes, str) else tuple(axes)
        place = shd.placements(self.mesh, (axes or None,))
        return {k: distribute_tensor(v, self.mesh, place, src_data_rank=None).to_local()
                for k, v in batch.items()}, axes

    def loss(self, lm: LM, batch: Dict[str, Any], **kw
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """kw as ``Model.loss``: ``remat_policy``, ``compute_dtype``."""
        local, axes = self.local_batch(batch)
        reduce = _reduce_placements(self.mesh, axes)

        def gather(name: str, p: torch.Tensor) -> torch.Tensor:
            return _Gather.apply(p.to_local(), self.mesh, p.placements, p.shape, p.stride(),
                                 reduce)

        loss, metrics = lm_loss(lm, local, materialize=gather, **kw)
        mask = local.get("mask")
        n_local = (mask.float().sum() if mask is not None
                   else torch.tensor(float(local["tokens"].numel()), device=loss.device))
        share = n_local / _sum_over_batch(n_local, self.mesh, reduce)
        metrics = {k: _sum_over_batch(v.detach() * share, self.mesh, reduce)
                   for k, v in metrics.items()}
        return _SumOverBatch.apply(loss * share, self.mesh, reduce), metrics
