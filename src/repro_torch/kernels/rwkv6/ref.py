"""Plain PyTorch RWKV-6 (Finch) WKV recurrence: the twin of the CUDA kernel.

Counterpart of ``repro/kernels/rwkv6/ref.py``. Per head, with an fp32
state S in R^{K x V} (arXiv:2404.05892):

    y_t = (S_{t-1} + (u * k_t) v_t^T)^T r_t
    S_t = diag(w_t) S_{t-1} + k_t v_t^T

``wkv6_reference`` is the forward twin, one loop over T. The state update is
a multiply and then an add (no fused multiply-add), the rounding the CUDA
kernel reproduces. ``wkv6_chunked`` is the training twin: the same steps, cut
into checkpointed chunks of ``CHUNK_T`` as the reference's oracle is, so
autograd keeps one [B, H, K, V] state per chunk instead of one per step.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

CHUNK_T = 128


def _steps(S, r, k, v, w, u32):
    """Run the recurrence over r, k, v, w [B, t, H, *] from S; -> (S, y in r.dtype)."""
    ys = []
    for t in range(r.shape[1]):
        kv = k[:, t].float()[..., None] * v[:, t].float()[..., None, :]
        ys.append((r[:, t].float()[..., None] * (S + u32 * kv)).sum(dim=-2).to(r.dtype))
        S = w[:, t].float()[..., None] * S + kv
    return S, torch.stack(ys, dim=1)


def _initial_state(r, v, s0):
    B, _, H, K = r.shape
    if s0 is None:
        return torch.zeros((B, H, K, v.shape[-1]), dtype=torch.float32, device=r.device)
    return s0.float()


def wkv6_reference(
    r: torch.Tensor,  # [B, T, H, K]
    k: torch.Tensor,  # [B, T, H, K]
    v: torch.Tensor,  # [B, T, H, V]
    w: torch.Tensor,  # [B, T, H, K] decay in (0, 1)
    u: torch.Tensor,  # [H, K] bonus
    s0: Optional[torch.Tensor] = None,  # [B, H, K, V]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y [B, T, H, V] in r.dtype, s_final [B, H, K, V] in fp32)."""
    S, ys = _steps(_initial_state(r, v, s0), r, k, v, w, u.float()[None, :, :, None])
    return ys, S


def wkv6_chunked(r, k, v, w, u, s0=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``wkv6_reference`` with each chunk of ``CHUNK_T`` steps (shrunk to a
    divisor of T, as the reference does) under ``torch.utils.checkpoint``:
    the same values, and the backward recomputes a chunk's states."""
    T = r.shape[1]
    ct = CHUNK_T
    while T % ct:
        ct -= 1
    S = _initial_state(r, v, s0)
    u32 = u.float()[None, :, :, None]
    ys = []
    for i in range(0, T, ct):
        S, y = checkpoint(_steps, S, r[:, i:i + ct], k[:, i:i + ct], v[:, i:i + ct],
                          w[:, i:i + ct], u32, use_reentrant=False)
        ys.append(y)
    return torch.cat(ys, dim=1), S
