"""Plain PyTorch RWKV-6 (Finch) WKV recurrence: the twin of the CUDA kernel.

Counterpart of ``repro/kernels/rwkv6/ref.py``. Per head, with an fp32
state S in R^{K x V} (arXiv:2404.05892):

    y_t = (S_{t-1} + (u * k_t) v_t^T)^T r_t
    S_t = diag(w_t) S_{t-1} + k_t v_t^T

The reference cuts time into checkpointed chunks for autodiff only; this
forward twin is one loop over T. The state update is a multiply and then an
add (no fused multiply-add), the rounding the CUDA kernel reproduces.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def wkv6_reference(
    r: torch.Tensor,  # [B, T, H, K]
    k: torch.Tensor,  # [B, T, H, K]
    v: torch.Tensor,  # [B, T, H, V]
    w: torch.Tensor,  # [B, T, H, K] decay in (0, 1)
    u: torch.Tensor,  # [H, K] bonus
    s0: Optional[torch.Tensor] = None,  # [B, H, K, V]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y [B, T, H, V] in r.dtype, s_final [B, H, K, V] in fp32)."""
    B, T, H, K = r.shape
    V = v.shape[-1]
    S = (torch.zeros((B, H, K, V), dtype=torch.float32, device=r.device)
         if s0 is None else s0.float())
    u32 = u.float()[None, :, :, None]
    ys = torch.empty((B, T, H, V), dtype=r.dtype, device=r.device)
    for t in range(T):
        kv = k[:, t].float()[..., None] * v[:, t].float()[..., None, :]
        y = (r[:, t].float()[..., None] * (S + u32 * kv)).sum(dim=-2)
        ys[:, t] = y.to(r.dtype)
        S = w[:, t].float()[..., None] * S + kv
    return ys, S
