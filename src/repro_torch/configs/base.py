"""Model configuration schema for the architecture zoo.

One frozen dataclass describes every assigned architecture: dense / MoE /
hybrid (RG-LRU + local attention) / SSM (RWKV6) / encoder-decoder / VLM- and
audio-frontend LMs.  ``reduced()`` derives the CPU-smoke-test variant of any
config (same family and block pattern, tiny dims).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | encdec | vlm | audio

    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # block pattern: mixer type per position, cycled over layers.
    #   "attn" (global), "attn_local" (sliding window), "rglru", "rwkv"
    mixer_pattern: Tuple[str, ...] = ("attn",)

    # attention details
    window: Optional[int] = None            # sliding-window size
    attn_softcap: Optional[float] = None    # gemma2 attention-logit cap
    qkv_bias: bool = False
    qk_norm: bool = False                   # qwen3 per-head q/k RMSNorm
    rope_theta: float = 10000.0
    use_rope: bool = True                   # False: learned absolute (whisper)

    # output head
    final_softcap: Optional[float] = None   # gemma2 final-logit cap
    tie_embeddings: bool = False

    # MLP
    mlp_type: str = "swiglu"                # swiglu | geglu | gelu

    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25

    # recurrent (RG-LRU / RWKV)
    rnn_width: int = 0
    conv_width: int = 4                     # griffin temporal conv
    rwkv_head_dim: int = 64

    # encoder-decoder (whisper)
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0

    # modality frontend stub: None | "audio" | "vision"
    frontend: Optional[str] = None
    frontend_seq_len: int = 0               # frames/patches per sample

    # numerics
    norm_type: str = "rmsnorm"              # rmsnorm | layernorm
    embed_scale: bool = False               # gemma sqrt(d) embedding scale
    max_seq_len: int = 8192

    # citation provenance for the config values
    source: str = ""

    # ------------------------------------------------------------------

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def n_groups_and_tail(self) -> Tuple[int, int]:
        """Layers are organized as scan(n_groups x pattern) + unrolled tail."""
        p = len(self.mixer_pattern)
        return self.n_layers // p, self.n_layers % p

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, ff, V = self.d_model, self.d_ff, self.vocab_size
        n_embed = V * d * (1 if self.tie_embeddings else 2)
        per_layer = {}
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        gates = 3 if self.mlp_type in ("swiglu", "geglu") else 2
        if self.is_moe:
            mlp = self.n_experts * gates * d * ff + d * self.n_experts
        else:
            mlp = gates * d * ff
        rnn = 0
        if "rglru" in self.mixer_pattern:
            w = self.rnn_width or d
            rnn = 2 * d * w + w * d + self.conv_width * w + 3 * w
        rwkv = 0
        if "rwkv" in self.mixer_pattern:
            rwkv = 6 * d * d + 2 * d * ff  # r/k/v/w/g/o + channel-mix
        total = n_embed
        pattern = self.mixer_pattern
        n_layers = self.n_layers + (
            self.n_encoder_layers if self.is_encoder_decoder else 0
        )
        for i in range(self.n_layers):
            m = pattern[i % len(pattern)]
            if m == "rwkv":
                total += rwkv + 2 * d
            elif m == "rglru":
                total += rnn + mlp + 2 * d
            else:
                total += attn + mlp + 2 * d
        if self.is_encoder_decoder:
            total += self.n_encoder_layers * (attn + mlp + 2 * d)
            total += self.n_layers * (attn + d)  # cross-attention
        return total

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: only routed experts)."""
        if not self.is_moe:
            return self.param_count()
        d, ff = self.d_model, self.d_ff
        gates = 3 if self.mlp_type in ("swiglu", "geglu") else 2
        dense_moe = self.n_experts * gates * d * ff
        active_moe = self.experts_per_token * gates * d * ff
        return self.param_count() - self.n_layers * (dense_moe - active_moe)

    def reduced(self) -> "ModelConfig":
        """Tiny same-family variant for CPU smoke tests."""
        p = len(self.mixer_pattern)
        _, tail = self.n_groups_and_tail()
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=2 * p + tail,
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2),
            head_dim=16,
            d_ff=128,
            vocab_size=512,
            n_experts=min(self.n_experts, 8),
            experts_per_token=min(self.experts_per_token, 2),
            rnn_width=64 if self.rnn_width else 0,
            rwkv_head_dim=16,
            window=32 if self.window else None,
            n_encoder_layers=2 if self.is_encoder_decoder else 0,
            frontend_seq_len=16 if self.frontend else 0,
            max_seq_len=128,
        )
