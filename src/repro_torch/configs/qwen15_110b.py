"""qwen1.5-110b [dense]: 80L d_model=8192 64H (kv=8) d_ff=49152,
vocab=152064, QKV bias.
[hf:Qwen/Qwen1.5-110B (family config per assignment); hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-110b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=49152,
    vocab_size=152064,
    qkv_bias=True,
    max_seq_len=32768,
    source="hf:Qwen/Qwen1.5-110B",
)
