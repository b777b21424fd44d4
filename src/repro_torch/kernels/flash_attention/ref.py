"""Plain PyTorch attention: the twin of the flash kernel and the decode path.

Counterpart of ``repro/kernels/flash_attention/ref.py``. On the CPU the
``ops.attention`` wrapper runs these; on the card they serve as the
reference the CUDA kernel is held against, and decode (``kv_len``) uses
them as the reference model does.

One difference from the kernel: a query row with no visible key gets the
mean of ``v`` here (softmax over equal ``NEG_INF`` scores), as in the JAX
reference, and 0 from the kernel, as from the Pallas kernel.

Two of the reference's knobs are read at each call, as it reads them:
``REPRO_ATTN_CHUNK_THRESHOLD`` (:func:`chunk_threshold`) and
``REPRO_ATTN_BF16_WIRE`` (:func:`mha_reference`).
"""

from __future__ import annotations

import math
import os
from typing import Optional

import torch

NEG_INF = -1e30

# Above this many score elements per (batch, head) the plain path walks the
# queries in chunks so the S_q x S_k matrix is never materialized whole.
CHUNK_THRESHOLD = 4096 * 4096
CHUNK_Q = 1024


def chunk_threshold() -> int:
    """``REPRO_ATTN_CHUNK_THRESHOLD``, else CHUNK_THRESHOLD."""
    return int(os.environ.get("REPRO_ATTN_CHUNK_THRESHOLD", CHUNK_THRESHOLD))


def _bf16_wire() -> bool:
    return os.environ.get("REPRO_ATTN_BF16_WIRE", "0") == "1"


def attention_mask(s_q: int, s_k: int, causal: bool, window: Optional[int],
                   q_offset: int = 0, device=None) -> torch.Tensor:
    """[s_q, s_k] boolean mask; True = attend."""
    iq = torch.arange(s_q, device=device)[:, None] + q_offset
    jk = torch.arange(s_k, device=device)[None, :]
    mask = torch.ones((s_q, s_k), dtype=torch.bool, device=device)
    if causal:
        mask &= jk <= iq
    if window is not None:
        mask &= jk > iq - window
    return mask


def mha_reference(
    q: torch.Tensor,  # [B, S_q, H_q, D]
    k: torch.Tensor,  # [B, S_k, H_kv, D]
    v: torch.Tensor,  # [B, S_k, H_kv, D]
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    q_offset: int = 0,
    kv_len: Optional[torch.Tensor] = None,  # [B] or [1] valid KV lengths
) -> torch.Tensor:
    """Grouped-query attention in fp32 (fp64 inputs in fp64), O(S^2). Returns
    [B, S_q, H_q, D].

    ``REPRO_ATTN_BF16_WIRE=1`` takes the reference's bf16-wire numerics: q
    scaled in its own dtype and the probabilities rounded to it before P V,
    each product accumulated in fp32. A product of two bf16 values is exact
    in fp32, so the fp32 einsum of the widened inputs is the reference's
    bf16-in, fp32-accumulate dot (``preferred_element_type``) up to the
    order of its sums. fp32 and fp64 inputs compute as without the knob."""
    B, S_q, H_q, D = q.shape
    _, S_k, H_kv, _ = k.shape
    if H_q % H_kv:
        raise ValueError(f"H_q={H_q} not a multiple of H_kv={H_kv}")
    group = H_q // H_kv
    scale = 1.0 / math.sqrt(D)
    wire = _bf16_wire()
    # GQA as a grouped einsum: K/V are never broadcast to the q-head width.
    up = torch.promote_types(q.dtype, torch.float32)
    if wire:
        qf = (q * torch.tensor(scale, dtype=q.dtype, device=q.device)).to(up)
    else:
        qf = q.to(up) * scale
    qf = qf.reshape(B, S_q, H_kv, group, D)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.to(up))
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    mask = attention_mask(S_q, S_k, causal, window, q_offset, q.device)
    mask = mask[None, None, None]
    if kv_len is not None:
        valid = torch.arange(S_k, device=q.device)[None, :] < kv_len[:, None]
        mask = mask & valid[:, None, None, None, :]
    scores = torch.where(mask, scores, torch.tensor(NEG_INF, device=q.device))
    probs = torch.softmax(scores, dim=-1)
    if wire:
        probs = probs.to(q.dtype).to(up)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.to(up))
    return out.reshape(B, S_q, H_q, D).to(q.dtype)


def partial_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      valid: torch.Tensor, softcap: Optional[float] = None):
    """``mha_reference``'s softmax over a block of the keys, unnormalized, in
    fp32: q [B, S_q, H_q, D] against k/v [B, S_k, H_kv, D] where ``valid``
    [S_k] -> (row max m, sum l, weighted V o), m and l [B, H_kv, G, S_q, 1],
    o [B, H_kv, G, S_q, D] (G = H_q / H_kv). A block with no valid key gives
    m = NEG_INF, l = 0, o = 0. Blocks merge by log-sum-exp
    (:func:`merge_partials`): decode attention over a sequence-split cache."""
    B, S_q, H_q, D = q.shape
    H_kv = k.shape[2]
    qf = (q.float() * (1.0 / math.sqrt(D))).reshape(B, S_q, H_kv, H_q // H_kv, D)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float())
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    scores = torch.where(valid, scores, torch.tensor(NEG_INF, device=q.device))
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(scores - m), torch.zeros((), device=q.device))
    return m, p.sum(dim=-1, keepdim=True), torch.einsum("bhgqk,bkhd->bhgqd", p, v.float())


def merge_partials(l: torch.Tensor, o: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The attention output [B, S_q, H_q, D] from the blocks' sums, each block's
    l and o already scaled by exp(m - max m) and summed over the blocks."""
    B, H_kv, G, S_q, D = o.shape
    return (o / l).permute(0, 3, 1, 2, 4).reshape(B, S_q, H_kv * G, D).to(dtype)


def mha_chunked(q, k, v, causal: bool = True, window: Optional[int] = None,
                softcap: Optional[float] = None, q_offset: int = 0,
                chunk_q: int = CHUNK_Q) -> torch.Tensor:
    """Exact attention over query chunks (O(chunk * S_k) memory)."""
    S_q = q.shape[1]
    cq = chunk_q
    while S_q % cq:
        cq -= 1
    outs = [
        mha_reference(q[:, i:i + cq], k, v, causal=causal, window=window,
                      softcap=softcap, q_offset=q_offset + i)
        for i in range(0, S_q, cq)
    ]
    return torch.cat(outs, dim=1)


def attention_plain(q, k, v, causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None, q_offset: int = 0,
                    kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The reference backend's choice: chunked above :func:`chunk_threshold`."""
    if kv_len is None and q.shape[1] * k.shape[1] > chunk_threshold():
        return mha_chunked(q, k, v, causal=causal, window=window,
                           softcap=softcap, q_offset=q_offset)
    return mha_reference(q, k, v, causal=causal, window=window,
                         softcap=softcap, q_offset=q_offset, kv_len=kv_len)
