"""rwkv6-7b [ssm]: Finch — attention-free, data-dependent decay.

32L d_model=4096 (64 heads x 64 dim) channel-mix d_ff=14336, vocab=65536.
[arXiv:2404.05892; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=64,
    n_kv_heads=64,
    head_dim=64,
    d_ff=14336,
    vocab_size=65536,
    mixer_pattern=("rwkv",),
    rwkv_head_dim=64,
    norm_type="layernorm",
    max_seq_len=1048576,     # state-based: context bounded by memory, not cache
    source="arXiv:2404.05892",
)
