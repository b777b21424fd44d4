"""Plain PyTorch RG-LRU diagonal recurrence: the twin of the CUDA scan.

Counterpart of ``repro/kernels/rglru/ref.py``:

    h_t = a_t * h_{t-1} + b_t

with an fp32 carry. Returns ``h`` in the input dtype and ``h_final`` in fp32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def linear_scan_reference(
    a: torch.Tensor,  # [B, T, C] decay in (0, 1]
    b: torch.Tensor,  # [B, T, C] input term
    h0: Optional[torch.Tensor] = None,  # [B, C] initial state
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (h [B, T, C] in a.dtype, h_final [B, C] in fp32)."""
    B, T, C = a.shape
    h = (torch.zeros((B, C), dtype=torch.float32, device=a.device)
         if h0 is None else h0.float())
    hs = torch.empty((B, T, C), dtype=a.dtype, device=a.device)
    for t in range(T):
        h = a[:, t].float() * h + b[:, t].float()
        hs[:, t] = h.to(a.dtype)
    return hs, h
