"""GPipe-style pipeline parallelism over one mesh dim (the "pod" axis).

Counterpart of ``repro/parallel/pipeline.py``, on ``torch.distributed``
point-to-point operations instead of ``shard_map`` and ``lax.ppermute``.
``pipeline_apply`` runs a layer-stage pipeline: each rank along ``axis``
owns one stage's parameters, and microbatches stream through the stages by
neighbour shifts. The schedule is the classic GPipe fill-drain loop of
``n_micro + n_stages - 1`` ticks: at tick t, stage s processes microbatch
t - s, a bubble fraction of (n_stages - 1) / (n_micro + n_stages - 1).
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

Params = Dict[str, torch.Tensor]


def pipeline_apply(stage_fn: Callable[[Params, torch.Tensor], torch.Tensor],
                   stage_params: Params,  # leaves stacked [n_stages, ...]
                   x: torch.Tensor,       # [n_micro, micro_batch, ...], the same on every rank
                   mesh: DeviceMesh, axis: str = "pod") -> torch.Tensor:
    """Run x through n_stages sequential stages, pipelined along ``axis``.

    Every rank of the mesh calls it. Returns [n_micro, micro_batch, ...], the
    final stage's output, on every rank; it equals ``pipeline_reference``.
    Stage 0 injects microbatch t at tick t; each tick the ring shifts every
    stage's output to the next stage (the wrap edge carries junk that stage
    0 ignores); the last stage's outputs are broadcast at the end."""
    group = mesh.get_group(axis)
    ranks = dist.get_process_group_ranks(group)
    n_stages = len(ranks)
    stage = mesh.get_local_rank(axis)
    n_micro = x.shape[0]
    params = {k: v[stage] for k, v in stage_params.items()}
    buf = torch.zeros_like(x[0])
    outputs = torch.zeros_like(x)
    for t in range(n_micro + n_stages - 1):
        inject = x[t] if t < n_micro else torch.zeros_like(x[0])
        state_out = stage_fn(params, inject if stage == 0 else buf)
        out_idx = t - (n_stages - 1)
        if out_idx >= 0:
            outputs[out_idx] = state_out
        if n_stages == 1:
            buf = state_out
            continue
        buf = torch.empty_like(state_out)
        ops = [dist.P2POp(dist.isend, state_out.contiguous(), ranks[(stage + 1) % n_stages],
                          group),
               dist.P2POp(dist.irecv, buf, ranks[(stage - 1) % n_stages], group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    # outputs are valid only on the last stage: every rank returns them
    dist.broadcast(outputs, src=ranks[-1], group=group)
    return outputs


def pipeline_reference(stage_fn: Callable[[Params, torch.Tensor], torch.Tensor],
                       stage_params: Params, x: torch.Tensor) -> torch.Tensor:
    """Sequential oracle: fold each microbatch through all stages."""
    n_stages = next(iter(stage_params.values())).shape[0]

    def one_micro(mb):
        h = mb
        for s in range(n_stages):
            h = stage_fn({k: v[s] for k, v in stage_params.items()}, h)
        return h

    return torch.stack([one_micro(mb) for mb in x])


def bubble_fraction(n_micro: int, n_stages: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)
