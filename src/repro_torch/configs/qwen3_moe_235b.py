"""qwen3-moe-235b-a22b [moe]: 94L d_model=4096 64H (kv=4) expert d_ff=1536,
vocab=151936, 128 experts top-8, QK-norm.
[hf:Qwen/Qwen3-30B-A3B (family); hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=1536,
    vocab_size=151936,
    n_experts=128,
    experts_per_token=8,
    qk_norm=True,
    rope_theta=1e6,
    max_seq_len=32768,
    source="hf:Qwen/Qwen3-235B-A22B",
)
