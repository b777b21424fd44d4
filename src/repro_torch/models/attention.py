"""Attention layer: GQA/MQA with RoPE, sliding window, softcap, QK-norm,
and the encoder-decoder's cross-attention.

Counterpart of ``repro/models/attention.py``.

  * forward: full-sequence attention through the flash kernel, no cache
    (training, ``attention_block``): causal self-attention by default, the
    encoder's non-causal self-attention with ``causal=False``, and with
    ``memory`` the cross-attention (K and V projected from the encoder's
    memory, non-causal, no window);
  * prefill: the causal self-attention, and the KV cache filled from the
    same k, v;
  * decode: one query against the cache. Local layers keep a ring of
    ``window`` slots (position p at slot p % window); softmax is
    permutation-invariant, so a validity mask is all decode needs. Decode
    attention stays on the plain path, as in the reference; so does the
    decode cross-attention (``decode_cross``), which projects K and V from
    the memory again at every step, as the reference does (on the rank's
    heads in sharded serving, its ``wq`` and ``wo`` on their ``embed`` block
    under ``serve_2d``).

RoPE is applied only when ``cfg.use_rope`` and only in self-attention.

The cache is updated in place (the reference returns a new one); the
engine allocates it once per batch, which saves a copy per layer and step.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.models import common

Cache = Dict[str, torch.Tensor]


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, dtype, device,
                  local: bool = False) -> Cache:
    length = min(cfg.window, max_len) if (local and cfg.window) else max_len
    shape = (batch, length, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


class Attention(nn.Module):
    """``cross``: the decoder's attention over the encoder's memory, with as
    many K/V heads as query heads (whisper's cross-attention is full MHA)."""

    def __init__(self, cfg: ModelConfig, device, dtype, local: bool = False,
                 cross: bool = False):
        super().__init__()
        d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        if cross:
            hkv = hq
        self.cfg = cfg
        self.cross = cross
        self.window = cfg.window if local else None
        self.wq = common.param((d, hq, hd), device, dtype)
        self.wk = common.param((d, hkv, hd), device, dtype)
        self.wv = common.param((d, hkv, hd), device, dtype)
        self.wo = common.param((hq, hd, d), device, dtype)
        if cfg.qkv_bias:
            self.bq = common.param((hq, hd), device, dtype)
            self.bk = common.param((hkv, hd), device, dtype)
            self.bv = common.param((hkv, hd), device, dtype)
        if cfg.qk_norm:  # qwen3: per-head RMSNorm of q and k, (1 + scale)
            self.q_norm = common.param((hd,), device, dtype)
            self.k_norm = common.param((hd,), device, dtype)

    def reset_parameters(self, gen: torch.Generator) -> None:
        for name in ("wq", "wk", "wv", "wo"):
            common.dense_init_(getattr(self, name), gen, in_axis=0)
        if self.cfg.qkv_bias:
            for name in ("bq", "bk", "bv"):
                getattr(self, name).zero_()
        if self.cfg.qk_norm:
            self.q_norm.zero_()
            self.k_norm.zero_()

    def _project(self, x: torch.Tensor, w: torch.Tensor, name: str,
                 axis=None) -> torch.Tensor:
        """einsum("bsd,dhk->bshk") as one matmul over the flattened heads;
        ``axis`` (a ``LayerAxis``) takes the product where sharded: in
        serving, where ``w`` keeps its ``embed`` block, x's columns of the
        block times it, summed over the block's axes. The bias after."""
        B, S, _ = x.shape
        d, h, hd = w.shape
        w = w.reshape(d, h * hd)
        out = (x @ w if axis is None else axis.column(x, w, name)).view(B, S, h, hd)
        if self.cfg.qkv_bias:
            out = out + getattr(self, "b" + name[1])
        return out

    def _qkv(self, x: torch.Tensor, positions: Optional[torch.Tensor],
             kv_x: Optional[torch.Tensor] = None, axis=None):
        """q from x; k and v from ``kv_x`` (the memory) or x. RoPE at
        ``positions`` on self-attention's q and k when the config uses it.
        ``axis``: the layer's ``LayerAxis`` where sharded (``_project``);
        QK-norm and RoPE come after the products' sums."""
        kv_x = x if kv_x is None else kv_x
        q = self._project(x, self.wq, "wq", axis)
        k = self._project(kv_x, self.wk, "wk", axis)
        v = self._project(kv_x, self.wv, "wv", axis)
        if self.cfg.qk_norm:  # after the bias, before RoPE, as the reference
            q = common.rms_norm(self.q_norm, q)
            k = common.rms_norm(self.k_norm, k)
        if self.cross or not self.cfg.use_rope:
            return q, k, v
        sin, cos = common.rope_angles(positions, self.cfg.head_dim,
                                      self.cfg.rope_theta)
        return common.apply_rope(q, sin, cos), common.apply_rope(k, sin, cos), v

    def _out(self, o: torch.Tensor) -> torch.Tensor:
        """einsum("bshk,hkd->bsd"); where ``wo`` keeps its ``embed`` block in
        serving, the rank's block of the output's columns."""
        B, S, h, hd = o.shape
        return o.reshape(B, S, h * hd) @ self.wo.reshape(h * hd, -1)

    def forward(self, x: torch.Tensor, positions: Optional[torch.Tensor],
                memory: Optional[torch.Tensor] = None, causal: bool = True,
                axis=None) -> torch.Tensor:
        """Attention over the full sequence, no cache: self-attention
        (causal unless ``causal=False``), or with ``memory`` [B, S_m, d] the
        cross-attention, non-causal and without a window. ``axis``: the
        layer's ``tensor_parallel.LayerAxis`` in sharded training (the weights
        are this rank's heads, flash reads the KV heads they read, and the
        output is its term of the sum over ``model``)."""
        if self.cross != (memory is not None):
            raise ValueError("memory is given to the cross-attention, and only to it")
        q, k, v = self._qkv(x, positions, memory, axis)
        if axis is not None:
            k, v = axis.kv_for_queries(k, v)
        if self.cross:
            causal = False
        out = fa_ops.attention(q, k, v, causal=causal,
                               window=None if self.cross else self.window,
                               softcap=self.cfg.attn_softcap)
        return self._out(out)

    def prefill(self, x: torch.Tensor, positions: torch.Tensor,
                cache: Cache, axis=None) -> torch.Tensor:
        """Causal attention over the prompt; fills ``cache`` in place.
        ``axis``: the layer's ``tensor_parallel.LayerAxis`` in sharded
        serving (the weights are this rank's heads; the output is its term of
        the sum over ``model``)."""
        S = x.shape[1]
        q, k, v = self._qkv(x, positions, axis=axis)
        kq, vq = (k, v) if axis is None else axis.kv_for_queries(k, v)
        out = fa_ops.attention(q, kq, vq, causal=True, window=self.window,
                               softcap=self.cfg.attn_softcap)
        if axis is not None:
            axis.fill_cache(cache, k, v)
            return self._out(out)
        L = cache["k"].shape[1]
        for name, t in (("k", k), ("v", v)):
            if L >= S:
                cache[name][:, :S].copy_(t)
                cache[name][:, S:].zero_()
            else:
                # ring shorter than the prompt: keep the last L positions,
                # position p at slot p % L, so decode overwrites the oldest.
                cache[name].copy_(torch.roll(t[:, S - L:], S % L, dims=1))
        return self._out(out)

    def decode(self, x: torch.Tensor, pos: int, cache: Cache, axis=None) -> torch.Tensor:
        """One token at position ``pos`` against the cache (updated in place);
        ``axis`` as in ``prefill``: this rank's block of the cache."""
        positions = torch.arange(pos, pos + 1, device=x.device)  # no host copy
        q, k_new, v_new = self._qkv(x, positions, axis=axis)
        if axis is not None:
            return self._out(axis.decode_attention(q, k_new, v_new, pos, cache,
                                                   self.cfg.attn_softcap))
        length = cache["k"].shape[1]
        slot = pos % length
        cache["k"][:, slot] = k_new[:, 0]
        cache["v"][:, slot] = v_new[:, 0]
        kv_len = torch.full((x.shape[0],), min(pos + 1, length), device=x.device)
        out = fa_ops.attention(q, cache["k"], cache["v"], causal=False,
                               kv_len=kv_len, softcap=self.cfg.attn_softcap)
        return self._out(out)

    def decode_cross(self, x: torch.Tensor, memory: torch.Tensor, axis=None) -> torch.Tensor:
        """One decode step's cross-attention: K and V projected from
        ``memory`` again, the plain path without softcap (the reference's
        ``backend="reference"`` call), no cache. In sharded serving (``axis``:
        the cross-attention's ``LayerAxis``) the weights are the rank's query
        heads and their KV heads (equal in number, ``LayerAxis.cross``), so K
        and V are projected onto those heads and the output is the rank's
        term of the sum over ``model``; where ``wq`` and ``wo`` keep their
        ``embed`` block, q is the partial product summed over it and the
        output the rank's block of columns (``wk`` and ``wv`` are gathered
        over it: plain products with the whole memory)."""
        q, k, v = self._qkv(x, None, memory, axis)
        out = fa_ref.attention_plain(q, k, v, causal=False)
        return self._out(out)
