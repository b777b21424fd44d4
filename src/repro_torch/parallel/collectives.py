"""Distributed-optimization collectives: int8-compressed gradient sync.

Counterpart of ``repro/parallel/collectives.py``, on ``torch.distributed``
process groups (gloo on the CPU, NCCL on the card) instead of a
``shard_map`` axis. For a slow inter-pod axis, an fp32 gradient all-reduce
dominates step time at multi-pod scale. ``compressed_psum_int8`` is the
standard 1-byte scheme with per-row scales: quantize -> all_gather (int8
payload + fp32 scales) -> dequantize and sum locally. Wire bytes drop about
4x against an fp32 ring all-reduce of the same tensor; the caller carries
the quantization residual into the next step (error feedback keeps SGD
unbiased -- Karimireddy et al., arXiv:1901.09847).

Quantization rounds half to even, as ``jnp.round`` does.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

ROW = 256  # elements a scale


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 quantization.  x [R, C] -> (q int8, scale [R])."""
    absmax = x.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale[..., 0]


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale[..., None]


def _rows(x: torch.Tensor) -> torch.Tensor:
    """x flattened, zero-padded to a multiple of ROW, as rows [R, ROW]."""
    flat = x.reshape(-1)
    return F.pad(flat, (0, (-flat.numel()) % ROW)).reshape(-1, ROW)


def compressed_psum_int8(x: torch.Tensor, group: Optional[dist.ProcessGroup] = None
                         ) -> torch.Tensor:
    """Sum of ``x`` over the ranks of ``group`` with int8 on the wire.

    Every rank of the group calls it. The result equals the exact sum up to
    per-row quantization error (<= absmax/127 per element per participant)."""
    q, scale = quantize_int8(_rows(x))
    n = dist.get_world_size(group)
    q_all = [torch.empty_like(q) for _ in range(n)]
    s_all = [torch.empty_like(scale) for _ in range(n)]
    dist.all_gather(q_all, q, group=group)
    dist.all_gather(s_all, scale, group=group)
    total = dequantize_int8(torch.stack(q_all), torch.stack(s_all)).sum(dim=0)
    return total.reshape(-1)[: x.numel()].reshape(x.shape)


def compressed_grad_sync(grads: Dict[str, torch.Tensor],
                         group: Optional[dist.ProcessGroup] = None,
                         residual: Optional[Dict[str, torch.Tensor]] = None
                         ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Compressed sum of every gradient with error feedback.

    Returns (synced_grads, new_residual): callers carry ``residual`` into
    the next step, where it is added to the local grads before syncing."""
    if residual is not None:
        grads = {n: g + residual[n] for n, g in grads.items()}
    synced = {n: compressed_psum_int8(g, group) for n, g in grads.items()}

    # residual: what compression lost of *this* worker's contribution
    def res_one(g):
        deq = dequantize_int8(*quantize_int8(_rows(g))).reshape(-1)[: g.numel()]
        return g - deq.reshape(g.shape)

    return synced, {n: res_one(g) for n, g in grads.items()}


def wire_bytes_fp32_allreduce(n_elements: int, participants: int) -> int:
    """Ring all-reduce: 2 (P-1)/P N * 4 bytes per device."""
    return int(2 * (participants - 1) / participants * n_elements * 4)


def wire_bytes_int8_allgather(n_elements: int, participants: int) -> int:
    """all_gather of int8 payload + fp32 per-256 scales."""
    payload = n_elements + 4 * (n_elements // 256 + 1)
    return int((participants - 1) / participants * payload * participants)
