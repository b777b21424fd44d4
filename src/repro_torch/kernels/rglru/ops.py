"""Public RG-LRU scan op: the CUDA scan on the card, plain PyTorch on the CPU.

Counterpart of ``repro/kernels/rglru/ops.py``. ``linear_scan`` is
differentiable: its backward is the reference's custom VJP, the same scan run
again on time-reversed inputs (the CUDA kernel on the card), so a training
step launches the kernel in its forward and again in its backward.

As in the reference, ``h_final`` comes back in fp32 from the plain path and
in a's dtype from the kernel; callers that keep it cast it to fp32.

The kernel reads a and b each in its own dtype and writes h in a's: the pairs
(fp32, fp32), (bf16, bf16) and (bf16, fp32). The last is the backward under
bf16 compute (a bf16 decay, the fp32 upstream gradient), which the reference's
Pallas kernel takes the same way, rounding only its output g to bf16.

On the card the one kernel source has two paths; ``route_for(dtype, C,
dtype_b)`` picks one before the launch and the wrapper passes it to the kernel:
  - ``"ring"``: a row of C elements of a and of b is a multiple of 16 bytes,
    so TMA feeds the walk from a shared-memory ring (every model width here:
    C = 4096);
  - ``"simple"``: any other C (bf16 with C % 8 != 0), each thread loading its
    own chunks of steps.
Neither path falls back to the plain twin; a failed launch raises.

The launch is the operator ``torch.ops.repro_torch.rglru_scan`` (as
``flash_attention/ops.py`` registers its own): its CUDA implementation
launches the kernel, its fake implementation returns h and h_final's shapes
and dtype, so a ``meta`` tensor (the dry run) follows the card's route.
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
_DTYPE_PAIRS = ((torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
                (torch.bfloat16, torch.float32))


def route_for(dtype: torch.dtype, C: int,
              dtype_b: Optional[torch.dtype] = None) -> str:
    """The path a CUDA call on [B, T, C] inputs takes: "ring" or "simple".
    ``dtype`` is a's, ``dtype_b`` b's (a's when not given)."""
    dtype_b = dtype if dtype_b is None else dtype_b
    if (dtype, dtype_b) not in _DTYPE_PAIRS:
        raise ValueError(f"rglru scan takes (a, b) dtypes in {_DTYPE_PAIRS}, "
                         f"got ({dtype}, {dtype_b})")
    rows_fit = all(C * t.itemsize % 16 == 0 for t in (dtype, dtype_b))
    return "ring" if rows_fit else "simple"


KERNEL = CudaKernel(
    "rglru_scan", SOURCE, "rglru_scan_fwd",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6,
)


def rglru_scan_cuda(a: torch.Tensor, b: torch.Tensor,
                    h0: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel. Returns (h [B,T,C], h_final [B,C]) in a.dtype."""
    B, T, C = a.shape
    route = route_for(a.dtype, C, b.dtype)
    dev = a.device
    check_cuda_tensor("a", a, a.dtype, (B, T, C), dev)
    check_cuda_tensor("b", b, b.dtype, (B, T, C), dev)
    if h0 is not None:
        check_cuda_tensor("h0", h0, a.dtype, (B, C), dev)
    h = torch.empty_like(a)
    h_final = torch.empty((B, C), dtype=a.dtype, device=dev)
    KERNEL.launch(
        dev, a.data_ptr(), b.data_ptr(),
        None if h0 is None else h0.data_ptr(), h.data_ptr(), h_final.data_ptr(),
        B, T, C, _DTYPE_CODE[a.dtype], _DTYPE_CODE[b.dtype], int(route == "ring"),
    )
    return h, h_final


_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("rglru_scan(Tensor a, Tensor b, Tensor? h0) -> (Tensor, Tensor)")
_LIB.impl("rglru_scan", rglru_scan_cuda, "CUDA")


@torch.library.register_fake("repro_torch::rglru_scan", lib=_LIB)
def _scan_fake(a, b, h0):
    """(h, h_final) shapes in a's dtype; raises on a dtype pair the kernel refuses."""
    route_for(a.dtype, a.shape[-1], b.dtype)
    return torch.empty_like(a), a.new_empty((a.shape[0], a.shape[-1]))


def _scan(a, b, h0=None):
    """The forward route: the plain loop for CPU tensors, else the kernel
    (for a meta tensor its fake implementation)."""
    if a.device.type == "cpu":
        return ref.linear_scan_reference(a, b, h0)
    if a.device.type not in ("cuda", "meta"):
        raise ValueError(f"linear_scan: unsupported device {a.device}")
    return torch.ops.repro_torch.rglru_scan(a, b, h0)


class _LinearScan(torch.autograd.Function):
    """The reference's ``_scan`` custom VJP (``repro/kernels/rglru/ops.py``).

    With upstream dh: g_t = dh_t + a_{t+1} g_{t+1} is the same recurrence on
    reversed time, so the backward runs ``_scan`` on (a reversed and shifted
    by one step, ones first, in a's dtype; the reversed fp32 dh). Then
    db = g, da = g * h_{t-1} (both in a's dtype) and dh0 = g_1 * a_1."""

    @staticmethod
    def forward(ctx, a, b, h0):
        h, h_final = _scan(a, b, h0)
        ctx.save_for_backward(a, h, h0)
        return h, h_final

    @staticmethod
    def backward(ctx, dh, dh_final):
        a, h, h0 = ctx.saved_tensors
        # a fresh contiguous fp32 copy: the kernel takes dense rows, and the
        # final state's gradient is added into it
        dh = dh.to(torch.float32, memory_format=torch.contiguous_format, copy=True)
        dh[:, -1] += dh_final.float()
        a_rev = a.flip(1)
        a_shift = torch.cat([torch.ones_like(a_rev[:, :1]), a_rev[:, :-1]], dim=1)
        g_rev, _ = _scan(a_shift, dh.flip(1))
        g = g_rev.flip(1).float()
        first = torch.zeros_like(h[:, :1]) if h0 is None else h0[:, None]
        h_prev = torch.cat([first.float(), h[:, :-1].float()], dim=1)
        da = (g * h_prev).to(a.dtype)
        db = g.to(a.dtype)
        dh0 = None if h0 is None else (g[:, 0] * a[:, 0].float()).to(h0.dtype)
        return da, db, dh0


def linear_scan(a: torch.Tensor, b: torch.Tensor,
                h0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable diagonal linear recurrence h_t = a_t h_{t-1} + b_t.

    Returns (h [B,T,C], h_final [B,C])."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (a, b, h0)):
        return _LinearScan.apply(a, b, h0)
    return _scan(a, b, h0)
