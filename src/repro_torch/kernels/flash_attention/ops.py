"""Public attention op: the CUDA flash kernel on the card, plain PyTorch on the CPU.

Counterpart of ``repro/kernels/flash_attention/ops.py``. ``attention`` takes
the model's [B, S, H, D] layout, which the kernel reads in place.

  * a CPU tensor, or a ``kv_len`` (variable-length decode masking), takes the
    plain path in ``ref`` -- as the reference sends ``kv_len`` and non-TPU
    backends to its jnp oracle;
  * a CUDA tensor without ``kv_len`` launches the kernel, or raises.

Forward only: the training backward (a recompute through ``ref``) comes with
the training slice.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels.cuda_build import CudaKernel, check_cuda_tensor
from repro_torch.kernels.flash_attention import ref

SOURCE = Path(__file__).parent / "csrc" / "flash_attention.cu"
HEAD_DIMS = (16, 32, 64, 128, 256)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_c = ctypes.c_int
KERNEL = CudaKernel(
    "flash_attention", SOURCE, "flash_attention_fwd",
    [ctypes.c_void_p] * 4 + [_c] * 10 + [ctypes.c_float] * 2 + [_c, _c],
)


def flash_attention_cuda(q, k, v, *, causal: bool = True,
                         window: Optional[int] = None,
                         softcap: Optional[float] = None,
                         q_offset: int = 0) -> torch.Tensor:
    """Launch the kernel on [B, S, H, D] CUDA tensors. Returns [B, S_q, H_q, D]."""
    B, S_q, H_q, D = q.shape
    S_k, H_kv = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"flash kernel takes float32 or bfloat16, got {q.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash kernel takes head_dim in {HEAD_DIMS}, got {D}")
    if H_kv == 0 or H_q % H_kv:
        raise ValueError(f"H_q={H_q} not a multiple of H_kv={H_kv}")
    dev = q.device
    check_cuda_tensor("q", q, q.dtype, (B, S_q, H_q, D), dev)
    check_cuda_tensor("k", k, q.dtype, (B, S_k, H_kv, D), dev)
    check_cuda_tensor("v", v, q.dtype, (B, S_k, H_kv, D), dev)
    out = torch.empty_like(q)
    KERNEL.launch(
        dev, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, S_q, S_k, H_q, H_kv, D, int(causal),
        int(window is not None), int(window or 0),
        int(softcap is not None), float(softcap or 0.0),
        1.0 / math.sqrt(D), int(q_offset), _DTYPE_CODE[q.dtype],
    )
    return out


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              softcap: Optional[float] = None, q_offset: int = 0,
              kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Grouped-query attention with optional sliding window / soft-capping.

    q [B, S_q, H_q, D], k/v [B, S_k, H_kv, D] -> [B, S_q, H_q, D].
    """
    if kv_len is not None or q.device.type == "cpu":
        return ref.attention_plain(q, k, v, causal=causal, window=window,
                                   softcap=softcap, q_offset=q_offset,
                                   kv_len=kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"attention: unsupported device {q.device}")
    return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                softcap=softcap, q_offset=q_offset)
