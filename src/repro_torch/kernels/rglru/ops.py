"""Public RG-LRU scan op: the CUDA scan on the card, plain PyTorch on the CPU.

Counterpart of ``repro/kernels/rglru/ops.py``, forward only (the backward,
the same scan on reversed inputs, comes with the training slice).

As in the reference, ``h_final`` comes back in fp32 from the plain path and
in the input dtype from the kernel; callers that keep it cast it to fp32.

On the card the one kernel source has two paths; ``route_for(dtype, C)``
picks one before the launch and the wrapper passes it to the kernel:
  - ``"ring"``: a row of C elements is a multiple of 16 bytes, so TMA feeds
    the walk from a shared-memory ring (every serving shape: C = 4096);
  - ``"simple"``: any other C (bf16 with C % 8 != 0), each thread loading its
    own chunks of steps.
Neither path falls back to the plain twin; a failed launch raises.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.kernels.cuda_build import CudaKernel, check_cuda_tensor
from repro_torch.kernels.rglru import ref

SOURCE = Path(__file__).parent / "csrc" / "rglru_scan.cu"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def route_for(dtype: torch.dtype, C: int) -> str:
    """The path a CUDA call on [B, T, C] inputs of ``dtype`` takes: "ring" or
    "simple"."""
    if dtype not in _DTYPE_CODE:
        raise ValueError(f"rglru scan takes float32 or bfloat16, got {dtype}")
    return "ring" if C * dtype.itemsize % 16 == 0 else "simple"


KERNEL = CudaKernel(
    "rglru_scan", SOURCE, "rglru_scan_fwd",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5,
)


def rglru_scan_cuda(a: torch.Tensor, b: torch.Tensor,
                    h0: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel. Returns (h [B,T,C], h_final [B,C]) in a.dtype."""
    B, T, C = a.shape
    route = route_for(a.dtype, C)
    dev = a.device
    check_cuda_tensor("a", a, a.dtype, (B, T, C), dev)
    check_cuda_tensor("b", b, a.dtype, (B, T, C), dev)
    if h0 is not None:
        check_cuda_tensor("h0", h0, a.dtype, (B, C), dev)
    h = torch.empty_like(a)
    h_final = torch.empty((B, C), dtype=a.dtype, device=dev)
    KERNEL.launch(
        dev, a.data_ptr(), b.data_ptr(),
        None if h0 is None else h0.data_ptr(), h.data_ptr(), h_final.data_ptr(),
        B, T, C, _DTYPE_CODE[a.dtype], int(route == "ring"),
    )
    return h, h_final


def linear_scan(a: torch.Tensor, b: torch.Tensor,
                h0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Diagonal linear recurrence h_t = a_t h_{t-1} + b_t.

    Returns (h [B,T,C], h_final [B,C])."""
    if a.device.type == "cpu":
        return ref.linear_scan_reference(a, b, h0)
    if a.device.type != "cuda":
        raise ValueError(f"linear_scan: unsupported device {a.device}")
    return rglru_scan_cuda(a, b, h0)
