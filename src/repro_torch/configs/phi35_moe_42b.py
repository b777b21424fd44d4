"""phi3.5-moe-42b-a6.6b [moe]: 32L d_model=4096 32H (kv=8) expert d_ff=6400,
vocab=32064, 16 experts top-2.
[hf:microsoft/Phi-3.5-MoE-instruct; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=6400,
    vocab_size=32064,
    n_experts=16,
    experts_per_token=2,
    norm_type="layernorm",
    max_seq_len=131072,
    source="hf:microsoft/Phi-3.5-MoE-instruct",
)
