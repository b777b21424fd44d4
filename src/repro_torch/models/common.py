"""Shared model pieces: parameters, initializers, norms, RoPE.

Counterpart of ``repro/models/common.py``. Parameters are ``nn.Parameter``s,
shaped exactly as the reference's pytree leaves so weights carry across by
name and shape. They are made without gradients, which serving never needs;
the trainer turns them on (``repro_torch.train.train_loop``).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn


def param(shape: Sequence[int], device, dtype) -> nn.Parameter:
    """An uninitialized parameter; ``init_params`` or a loader fills it."""
    return nn.Parameter(torch.empty(tuple(shape), device=device, dtype=dtype),
                        requires_grad=False)


# ---------------------------------------------------------------------------
# Initializers: the reference's statistics, drawn from a torch.Generator
# ---------------------------------------------------------------------------

@torch.no_grad()
def dense_init_(p: torch.Tensor, gen: torch.Generator, in_axis: int = -2) -> None:
    """Standard normal truncated to [-2, 2], times 1/sqrt(fan_in)."""
    tmp = torch.empty(p.shape, dtype=torch.float32, device=p.device)
    nn.init.trunc_normal_(tmp, 0.0, 1.0, -2.0, 2.0, generator=gen)
    p.copy_(tmp.mul_(1.0 / math.sqrt(p.shape[in_axis])))


@torch.no_grad()
def embed_init_(p: torch.Tensor, gen: torch.Generator) -> None:
    tmp = torch.empty(p.shape, dtype=torch.float32, device=p.device)
    tmp.normal_(0.0, 1.0, generator=gen)
    p.copy_(tmp.mul_(0.02))


# ---------------------------------------------------------------------------
# Norms and rotary embeddings
# ---------------------------------------------------------------------------

def rms_norm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Gemma-style RMSNorm with a (1 + scale) weight, computed in fp32."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * (1.0 + scale.float())).to(x.dtype)


def layer_norm(g: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with gain g and bias b, population variance, in fp32."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * g.float() + b.float()).to(x.dtype)


def norm_init(norm_type: str, d: int, device, dtype):
    """An RMSNorm's (1 + scale) vector, or the reference's layernorm leaves
    ``{"g", "b"}`` as a ParameterDict (state-dict keys ``<name>.g``, ``.b``).
    The norm type is read here only: the functions below go by the
    parameter's type."""
    if norm_type == "rmsnorm":
        return param((d,), device, dtype)
    return nn.ParameterDict({"g": param((d,), device, dtype),
                             "b": param((d,), device, dtype)})


@torch.no_grad()
def reset_norm_(p) -> None:
    """The identity: scale 0 for RMSNorm; g 1 and b 0 for LayerNorm."""
    if isinstance(p, nn.ParameterDict):
        p["g"].fill_(1.0)
        p["b"].zero_()
    else:
        p.zero_()


def apply_norm(p, x: torch.Tensor) -> torch.Tensor:
    """The norm that ``norm_init`` made ``p`` for."""
    if isinstance(p, nn.ParameterDict):
        return layer_norm(p["g"], p["b"], x)
    return rms_norm(p, x)


def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions [*, S] -> (sin, cos) [*, S, head_dim/2]."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=positions.device) / head_dim
    freq = 1.0 / (theta ** exponent)
    ang = positions.float()[..., None] * freq
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """x [B, S, H, D]; sin/cos [S, D/2]. Rotates the two halves of D."""
    sin = sin[None, :, None, :]
    cos = cos[None, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def softmax_xent(logits: torch.Tensor,  # [B, S, V]
                 labels: torch.Tensor,  # [B, S] integer
                 mask: Optional[torch.Tensor] = None,  # [B, S]
                 ) -> torch.Tensor:
    """Mean cross-entropy in fp32 (fp64 logits stay fp64); with ``mask``, the
    masked mean over max(sum(mask), 1). The gold logit is a gather: the
    reference's one-hot contraction is a sharding device and computes the
    same value."""
    logits32 = at_least_fp32(logits)
    logz = torch.logsumexp(logits32, dim=-1)
    gold = logits32.gather(-1, labels.long()[..., None])[..., 0]
    return masked_mean(logz - gold, mask)


def at_least_fp32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in fp32, or fp64 where it is fp64."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def masked_mean(nll: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The mean of ``nll`` [B, S]; with ``mask``, over max(sum(mask), 1)."""
    if mask is not None:
        mask = mask.to(nll.dtype)
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()
