"""Hand-written CUDA kernels for Hopper, one subpackage each.

Each subpackage mirrors the reference's ``repro/kernels/<name>/``:
  csrc/*.cu -- the CUDA C++ kernels, each with a plain C entry point
  ops.py    -- the public wrapper: kernel on a CUDA tensor, plain on the CPU
  ref.py    -- the plain PyTorch twin the kernel is held against

``KERNELS`` lists every kernel of the port, for building them together and
reading their launch counts.
"""

from repro_torch.kernels.flash_attention import ops as _fa_ops
from repro_torch.kernels.rglru import ops as _lru_ops
from repro_torch.kernels.rwkv6 import ops as _wkv_ops

KERNELS = (_fa_ops.KERNEL, _fa_ops.WGMMA_KERNEL, _lru_ops.KERNEL, _wkv_ops.KERNEL)

__all__ = ["KERNELS"]
