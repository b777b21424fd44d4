"""Public attention op: the CUDA flash kernels on the card, plain PyTorch on the CPU.

Counterpart of ``repro/kernels/flash_attention/ops.py``. ``attention`` takes
the model's [B, S, H, D] layout, which both kernels read in place.

  * a CPU tensor, or a ``kv_len`` (variable-length decode masking), takes the
    plain path in ``ref`` -- as the reference sends ``kv_len`` and non-TPU
    backends to its jnp oracle;
  * a CUDA tensor without ``kv_len`` launches one of two kernels, chosen
    before the launch by ``kernel_for(dtype, head_dim)``, or raises:
      - ``"wgmma"`` (``csrc/flash_attention_sm90.cu``): bf16 with head_dim
        64, 128 or 256, on the tensor cores -- every bf16 config of the
        repo (whisper-medium's encoder, decoder and cross-attention at 64);
      - ``"simt"`` (``csrc/flash_attention.cu``): everything else it takes,
        on the CUDA cores: fp32 inputs (the card-vs-CPU checks and fp32
        training, which TF32 would take out of the fp32 comparison) and
        bf16 at head_dim 16 and 32.
    A failed launch raises; nothing retries on the other kernel or the twin.
  * a ``meta`` tensor (the dry run, ``launch/dryrun.py``) takes the card's
    route too: the launch is the operator ``torch.ops.repro_torch.
    flash_attention``, whose CUDA implementation launches the kernel and
    whose fake implementation (the meta kernel, and the one a
    ``FakeTensorMode`` runs) returns the output's shape and dtype only. Its
    FLOP formula, 4 B H_q D a visible (query, key) pair (``visible_pairs``),
    is registered for ``FlopCounterMode``.

Differentiable, as the reference's custom VJP: when grad is on and an input
requires it, the forward above runs inside a ``torch.autograd.Function`` that
saves q, k, v (never the scores); its backward recomputes through
``ref.mha_reference`` and returns that VJP. The reference's backward is XLA,
not Pallas, so no backward kernel stands in for it.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Optional

import numpy as np
import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels.cuda_build import CudaKernel, check_cuda_tensor
from repro_torch.kernels.flash_attention import ref

SOURCE = Path(__file__).parent / "csrc" / "flash_attention.cu"
SOURCE_SM90 = Path(__file__).parent / "csrc" / "flash_attention_sm90.cu"
HEAD_DIMS = (16, 32, 64, 128, 256)
WGMMA_HEAD_DIMS = (64, 128, 256)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_c = ctypes.c_int
KERNEL = CudaKernel(
    "flash_attention", SOURCE, "flash_attention_fwd",
    [ctypes.c_void_p] * 4 + [_c] * 10 + [ctypes.c_float] * 2 + [_c, _c],
)
WGMMA_KERNEL = CudaKernel(
    "flash_attention_wgmma", SOURCE_SM90, "flash_attention_sm90_fwd",
    [ctypes.c_void_p] * 4 + [_c] * 10 + [ctypes.c_float] * 2 + [_c],
)


def kernel_for(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel a CUDA call with these inputs launches: "wgmma" or "simt"."""
    if dtype == torch.bfloat16 and head_dim in WGMMA_HEAD_DIMS:
        return "wgmma"
    return "simt"


def _check_heads(name, dtypes, head_dims, q, k):
    """Raise unless ``name`` takes q's dtype, head_dim and head counts."""
    D, H_q, H_kv = q.shape[-1], q.shape[2], k.shape[2]
    if q.dtype not in dtypes:
        raise ValueError(f"{name} takes {dtypes}, got {q.dtype}")
    if D not in head_dims:
        raise ValueError(f"{name} takes head_dim in {head_dims}, got {D}")
    if H_kv == 0 or H_q % H_kv:
        raise ValueError(f"H_q={H_q} not a multiple of H_kv={H_kv}")


def _launch(kern, dtypes, head_dims, q, k, v, causal, window, softcap, q_offset,
            *extra):
    """Check q, k, v against what ``kern`` takes (raise otherwise), launch it
    with the common arguments then ``extra``; return the output."""
    B, S_q, H_q, D = q.shape
    S_k, H_kv = k.shape[1], k.shape[2]
    _check_heads(kern.name, dtypes, head_dims, q, k)
    if q.device.type != "cuda":
        raise ValueError(f"{kern.name} takes CUDA tensors, got {q.device}")
    dev = q.device
    check_cuda_tensor("q", q, q.dtype, (B, S_q, H_q, D), dev)
    check_cuda_tensor("k", k, q.dtype, (B, S_k, H_kv, D), dev)
    check_cuda_tensor("v", v, q.dtype, (B, S_k, H_kv, D), dev)
    out = torch.empty_like(q)
    kern.launch(
        dev, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, S_q, S_k, H_q, H_kv, D, int(causal),
        int(window is not None), int(window or 0),
        int(softcap is not None), float(softcap or 0.0),
        1.0 / math.sqrt(D), int(q_offset), *extra,
    )
    return out


def flash_attention_cuda(q, k, v, *, causal: bool = True,
                         window: Optional[int] = None,
                         softcap: Optional[float] = None,
                         q_offset: int = 0) -> torch.Tensor:
    """Launch the CUDA-core kernel on [B, S, H, D] CUDA tensors (fp32 or bf16,
    any head_dim in ``HEAD_DIMS``). Returns [B, S_q, H_q, D]."""
    return _launch(KERNEL, tuple(_DTYPE_CODE), HEAD_DIMS, q, k, v, causal, window,
                   softcap, q_offset, _DTYPE_CODE.get(q.dtype))


def flash_attention_wgmma_cuda(q, k, v, *, causal: bool = True,
                               window: Optional[int] = None,
                               softcap: Optional[float] = None,
                               q_offset: int = 0) -> torch.Tensor:
    """Launch the tensor-core kernel on [B, S, H, D] bf16 CUDA tensors with
    head_dim in ``WGMMA_HEAD_DIMS``. Returns [B, S_q, H_q, D]."""
    return _launch(WGMMA_KERNEL, (torch.bfloat16,), WGMMA_HEAD_DIMS, q, k, v, causal,
                   window, softcap, q_offset)


_LAUNCHERS = {"wgmma": flash_attention_wgmma_cuda, "simt": flash_attention_cuda}

# The launch as an operator of its own: the dispatcher sends a CUDA tensor
# to the kernel and a meta or fake one to ``_flash_fake``. Registered through
# ``torch.library.Library`` rather than the ``custom_op`` decorator, whose
# Python wrapper costs some 45 us a call against 3 us for this form (CPU
# host, timeit), on decode paths that are bound by the host.
_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("flash_attention(Tensor q, Tensor k, Tensor v, bool causal, int? window, "
            "float? softcap, int q_offset) -> Tensor")


def _flash_cuda(q, k, v, causal, window, softcap, q_offset):
    launch = _LAUNCHERS[kernel_for(q.dtype, q.shape[-1])]
    return launch(q, k, v, causal=causal, window=window, softcap=softcap,
                  q_offset=q_offset)


_LIB.impl("flash_attention", _flash_cuda, "CUDA")


@torch.library.register_fake("repro_torch::flash_attention", lib=_LIB)
def _flash_fake(q, k, v, causal, window, softcap, q_offset):
    """The output's shape and dtype; raises where the launch would on them."""
    if kernel_for(q.dtype, q.shape[-1]) == "wgmma":
        _check_heads(WGMMA_KERNEL.name, (torch.bfloat16,), WGMMA_HEAD_DIMS, q, k)
    else:
        _check_heads(KERNEL.name, tuple(_DTYPE_CODE), HEAD_DIMS, q, k)
    return torch.empty_like(q, memory_format=torch.contiguous_format)


def visible_pairs(S_q: int, S_k: int, causal: bool, window: Optional[int],
                  q_offset: int = 0) -> int:
    """(query, key) pairs a call attends to, summed over its S_q rows: row i
    sits at position ``q_offset + i``; it sees the keys up to its position
    under ``causal``, and the last ``window`` of those with one."""
    pos = q_offset + np.arange(S_q, dtype=np.int64)
    hi = np.minimum(pos + 1, S_k) if causal else np.full(S_q, S_k, np.int64)
    lo = np.maximum(0, pos - window + 1) if window else np.zeros(S_q, np.int64)
    return int(np.sum(np.maximum(hi - lo, 0)))


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flash_flops(q_shape, k_shape, v_shape, causal, window, softcap, q_offset, *,
                 out_shape=None, **kw) -> int:
    """Q K^T and P V: 2 D multiply-adds, 4 D operations, a visible pair and head."""
    B, S_q, H_q, D = q_shape
    return 4 * B * H_q * D * visible_pairs(S_q, k_shape[1], causal, window, q_offset)


def _forward(q, k, v, causal, window, softcap, q_offset):
    if q.device.type == "cpu":
        return ref.attention_plain(q, k, v, causal=causal, window=window,
                                   softcap=softcap, q_offset=q_offset)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"attention: unsupported device {q.device}")
    return torch.ops.repro_torch.flash_attention(q, k, v, causal, window, softcap,
                                                 q_offset)


class _FlashAttention(torch.autograd.Function):
    """``repro/kernels/flash_attention/ops.py::_flash_attn``: the flash forward,
    and a backward that recomputes the plain attention and returns its VJP."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, q_offset):
        ctx.save_for_backward(q, k, v)
        ctx.opts = dict(causal=causal, window=window, softcap=softcap,
                        q_offset=q_offset)
        return _forward(q, k, v, causal, window, softcap, q_offset)

    @staticmethod
    def backward(ctx, g):
        q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = ref.mha_reference(q, k, v, **ctx.opts)
        dq, dk, dv = torch.autograd.grad(out, (q, k, v), g)
        return dq, dk, dv, None, None, None, None


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              softcap: Optional[float] = None, q_offset: int = 0,
              kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Grouped-query attention with optional sliding window / soft-capping.

    q [B, S_q, H_q, D], k/v [B, S_k, H_kv, D] -> [B, S_q, H_q, D].
    """
    if kv_len is not None:
        return ref.attention_plain(q, k, v, causal=causal, window=window,
                                   softcap=softcap, q_offset=q_offset,
                                   kv_len=kv_len)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, window, softcap, q_offset)
    return _forward(q, k, v, causal, window, softcap, q_offset)
