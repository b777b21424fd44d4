"""Public WKV6 op: the CUDA kernel on the card, plain PyTorch on the CPU.

Counterpart of ``repro/kernels/rwkv6/ops.py``. The kernel is the forward of
prefill and decode. Training goes through the oracle, as in the reference
(its kernel is forward only): when grad is enabled and an input requires it,
``wkv`` runs the chunked twin ``ref.wkv6_chunked`` on any device. That is the
reference's design, not a fallback: a failed kernel launch still raises.

Both paths return ``y`` in r's dtype and ``s_final`` in fp32. With ``out``
the final state is written there, and ``out`` may be ``s0`` itself: decode
updates its cached state in place.

The launch is the operator ``torch.ops.repro_torch.wkv6`` (as
``flash_attention/ops.py`` registers its own), which writes the final state
into its ``s_final`` argument: its CUDA implementation launches the kernel,
its fake implementation returns y's shape and dtype, so a ``meta`` tensor
(the dry run) follows the card's route.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.kernels.cuda_build import CudaKernel, check_cuda_tensor
from repro_torch.kernels.rwkv6 import ref

SOURCE = Path(__file__).parent / "csrc" / "wkv6.cu"
HEAD_SIZE = 64  # the kernel's K = V
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

KERNEL = CudaKernel(
    "wkv6", SOURCE, "wkv6_fwd",
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6,
)


def wkv6_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
              u: torch.Tensor, s0: Optional[torch.Tensor] = None,
              out: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel. Returns (y [B,T,H,V] in r.dtype, s_final [B,H,K,V] fp32)."""
    B, T, H, K = r.shape
    V = v.shape[-1]
    if r.dtype not in _DTYPE_CODE:
        raise ValueError(f"wkv6 kernel takes float32 or bfloat16, got {r.dtype}")
    if K != HEAD_SIZE or V != HEAD_SIZE:
        raise ValueError(f"wkv6 kernel takes K = V = {HEAD_SIZE}, got K={K}, V={V}")
    dev = r.device
    check_cuda_tensor("r", r, r.dtype, (B, T, H, K), dev)
    check_cuda_tensor("k", k, r.dtype, (B, T, H, K), dev)
    check_cuda_tensor("v", v, r.dtype, (B, T, H, V), dev)
    check_cuda_tensor("w", w, r.dtype, (B, T, H, K), dev)
    check_cuda_tensor("u", u, r.dtype, (H, K), dev)
    if s0 is not None:
        check_cuda_tensor("s0", s0, torch.float32, (B, H, K, V), dev)
    if out is None:
        s_final = torch.empty((B, H, K, V), dtype=torch.float32, device=dev)
    else:
        check_cuda_tensor("out", out, torch.float32, (B, H, K, V), dev)
        if s0 is not None and out.data_ptr() != s0.data_ptr() and _overlap(out, s0):
            raise ValueError("wkv6: out must be s0 itself or not overlap it")
        s_final = out
    y = torch.empty((B, T, H, V), dtype=r.dtype, device=dev)
    KERNEL.launch(
        dev, r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        None if s0 is None else s0.data_ptr(), y.data_ptr(), s_final.data_ptr(),
        B, T, H, K, V, _DTYPE_CODE[r.dtype],
    )
    return y, s_final


def _overlap(a: torch.Tensor, b: torch.Tensor) -> bool:
    a0, b0 = a.data_ptr(), b.data_ptr()
    return a0 < b0 + b.numel() * b.element_size() and b0 < a0 + a.numel() * a.element_size()


_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("wkv6(Tensor r, Tensor k, Tensor v, Tensor w, Tensor u, Tensor? s0, "
            "Tensor(a!) s_final) -> Tensor")


def _wkv6_op_cuda(r, k, v, w, u, s0, s_final):
    return wkv6_cuda(r, k, v, w, u, s0, s_final)[0]


_LIB.impl("wkv6", _wkv6_op_cuda, "CUDA")


@torch.library.register_fake("repro_torch::wkv6", lib=_LIB)
def _wkv6_fake(r, k, v, w, u, s0, s_final):
    """y's shape in r's dtype; raises on a dtype or head size the kernel refuses."""
    if r.dtype not in _DTYPE_CODE:
        raise ValueError(f"wkv6 kernel takes float32 or bfloat16, got {r.dtype}")
    if r.shape[-1] != HEAD_SIZE or v.shape[-1] != HEAD_SIZE:
        raise ValueError(f"wkv6 kernel takes K = V = {HEAD_SIZE}")
    return r.new_empty(v.shape)


def wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
        u: torch.Tensor, s0: Optional[torch.Tensor] = None,
        out: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """RWKV-6 WKV. Returns (y [B,T,H,V], s_final [B,H,K,V]); s_final is
    ``out`` when given."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (r, k, v, w, u, s0)):
        y, s_final = ref.wkv6_chunked(r, k, v, w, u, s0)
        return y, (s_final if out is None else out.copy_(s_final))
    if r.device.type == "cpu":
        y, s_final = ref.wkv6_reference(r, k, v, w, u, s0)
        return y, (s_final if out is None else out.copy_(s_final))
    if r.device.type not in ("cuda", "meta"):
        raise ValueError(f"wkv: unsupported device {r.device}")
    s_final = out
    if s_final is None:
        B, _, H, K = r.shape
        s_final = torch.empty((B, H, K, v.shape[-1]), dtype=torch.float32, device=r.device)
    return torch.ops.repro_torch.wkv6(r, k, v, w, u, s0, s_final), s_final
